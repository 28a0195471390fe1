"""repro_torch — the PyTorch/CUDA port of ``repro`` for an NVIDIA H100.

Mirrors the JAX package's module names; imports torch and numpy only.
Entry points take ``device=None``, meaning CUDA: without a CUDA device
they raise unless the caller asks for ``device="cpu"`` (see
``resolve_device``).  Kernels dispatch on their tensors' device: CPU
tensors take the plain PyTorch version, CUDA tensors the hand-written
kernel, or an exception.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; a missing CUDA device is an error, never a
    silent move to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU")
    return dev
