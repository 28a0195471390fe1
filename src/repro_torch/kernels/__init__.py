"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: CPU tensors take the plain version, CUDA tensors the kernel.

K6 and K7 are reached as modules (``repro_torch.kernels.flash_decode``,
``repro_torch.kernels.flash_attention``): their wrappers carry the
modules' names, so the package does not rebind them."""
from repro_torch.kernels.paged_chunk import (paged_flash_packed_chunk,
                                             paged_flash_prefill_chunk,
                                             paged_packed_chunk_plain,
                                             paged_prefill_chunk_plain)
from repro_torch.kernels.paged_decode import (paged_attend, paged_attend_plain,
                                              paged_decode_plain,
                                              paged_flash_decode)
from repro_torch.kernels.probe_spec import (SpecProbeOut,
                                            serving_probe_spec_step,
                                            serving_probe_spec_step_plain)
from repro_torch.kernels.probe_step import (ProbeStepOut, serving_probe_step,
                                            serving_probe_step_plain)
from repro_torch.kernels.rwkv6_scan import wkv_scan, wkv_scan_plain
from repro_torch.kernels.ttt_scan import (make_unroll_kernel,
                                          ttt_probe_batched,
                                          ttt_probe_batched_plain,
                                          ttt_probe_scan)

__all__ = ["ProbeStepOut", "paged_attend", "paged_attend_plain",
           "paged_decode_plain", "paged_flash_decode",
           "paged_flash_packed_chunk", "paged_flash_prefill_chunk",
           "paged_packed_chunk_plain", "paged_prefill_chunk_plain",
           "SpecProbeOut", "serving_probe_spec_step",
           "serving_probe_spec_step_plain",
           "serving_probe_step", "serving_probe_step_plain",
           "make_unroll_kernel", "ttt_probe_batched",
           "ttt_probe_batched_plain", "ttt_probe_scan", "wkv_scan",
           "wkv_scan_plain"]
