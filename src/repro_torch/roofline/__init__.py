"""Roofline arithmetic: the analytic FLOP and byte model and the H100's
constants (``analysis.py``, which reads a compiled XLA artifact, has no
counterpart here)."""
from repro_torch.roofline.analytic import estimate, non_embedding_params
from repro_torch.roofline.constants import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

__all__ = ["estimate", "non_embedding_params", "HBM_BW", "NVLINK_BW",
           "PEAK_FLOPS_BF16"]
