"""NVIDIA H100 SXM constants for the roofline model (one card), from
NVIDIA's H100 Tensor Core GPU data sheet (SXM5 column): dense bf16 on the
tensor cores (the sparse figure is twice this), HBM3 bandwidth, and
NVLink 4 at 900 GB/s both directions together, 450 GB/s each way."""

PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                # bytes/s, HBM3
NVLINK_BW = 450e9               # bytes/s per direction
