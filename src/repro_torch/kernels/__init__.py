"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: CPU tensors take the plain version, CUDA tensors the kernel."""
from repro_torch.kernels.paged_decode import (paged_attend, paged_attend_plain,
                                              paged_decode_plain,
                                              paged_flash_decode)
from repro_torch.kernels.probe_step import (ProbeStepOut, serving_probe_step,
                                            serving_probe_step_plain)

__all__ = ["ProbeStepOut", "paged_attend", "paged_attend_plain",
           "paged_decode_plain", "paged_flash_decode", "serving_probe_step",
           "serving_probe_step_plain"]
