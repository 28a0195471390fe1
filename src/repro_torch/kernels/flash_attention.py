"""K7: flash prefill attention — hand-written CUDA kernel + its plain
PyTorch version.

Causal, sliding-window or bidirectional GQA attention of a (B, Sq, H, d)
query block against (B, Sk, KV, d) keys and values, for any Sq and Sk:
query i sees key j iff j <= i (causal, from key 0 also when Sk != Sq) and
j > i - window; with ``causal=False`` (whisper's encoder) every key.
It replaces the TPU kernel ``repro/kernels/flash_attention.py:64
flash_attention`` (body ``_kernel`` :24), whose launcher asserts
Sq % bq == 0.  Its contract is f32 throughout, what the JAX package's
served prefill computes (``repro/models/attention.py:733
attn_prefill_einsum``): q, k and v are upcast, scores, softmax and P.V are
f32, and the output is cast to q's dtype.  The plain version is that
einsum, ``attn_prefill_einsum``.  (The Pallas body rounds q * scale and p
to the input dtype; on bf16 inputs it sits a bf16 rounding away from
both.)

On the card bf16 inputs run on the tensor cores through the tile body K3
shares (``csrc/attn_tile.cuh``: bf16 products with f32 accumulation, p
split into three bf16 terms, so the result stays the f32 one); f32 inputs
run a CUDA-core kernel.

Dispatch is by the input's device: CPU tensors take the plain version,
CUDA tensors the kernel (``csrc/flash_attention.cu``); anything else
raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The head dims the kernel is built for and checked at on the card, each
# for f32 and bf16 and any number of query heads per KV head: smollm-360m's
# d 64 (granite-moe-1b's, hymba-1.5b's causal windowed prefill at G 5 and
# whisper-tiny's non-causal encoder at G 1 too), llama3.2-3b's and
# qwen1.5-32b's d 128, stablelm-3b's d 80.
# csrc/flash_attention.cu builds exactly these (its FLASH_INSTANCE lines);
# every other d is refused.
INSTANCES = (64, 128, 80)


def attn_prefill_einsum(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Plain version of ``flash_attention`` on any device, the comparison
    the kernel is held to (never the serving path's choice): reference
    O(S^2)-memory attention. q (B,Sq,H,d); k,v (B,Sk,KV,d)."""
    b, sq, h, d = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(b, sq, n_kv, h // n_kv, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k.float()) / torch.sqrt(torch.tensor(float(d)))
    qpos = torch.arange(sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def _check(q, k, v, window):
    b, sq, h, d = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention: {q.dtype}; kernel takes f32 or "
                         "bf16")
    if d not in INSTANCES:
        raise ValueError(f"flash_attention: no kernel instance for d={d} "
                         f"(built: {INSTANCES}; other head dims come with "
                         "ROADMAP A7)")
    if n_kv < 1 or h % n_kv or sk < 1:
        raise ValueError(f"flash_attention: {h} heads on {n_kv} KV heads, "
                         f"{sk} keys")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    want = [("q", q, (b, sq, h, d)), ("k", k, (b, sk, n_kv, d)),
            ("v", v, (b, sk, n_kv, d))]
    for name, t, shape in want:
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype or tuple(t.shape) != shape:
            raise ValueError(f"flash_attention: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected {q.dtype} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} not 16-byte aligned")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Blockwise causal / sliding-window GQA prefill attention (B8's
    function for any Sq, Sk).

    q (B, Sq, H, d); k, v (B, Sk, KV, d), one dtype, f32 or bf16.
    -> (B, Sq, H, d) in q's dtype."""
    _build.forward_only("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return attn_prefill_einsum(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device "
                           f"{q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check(q, k, v, window)
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    p = _build.ptr
    err = _build.library().flash_attention_launch(
        p(q), p(k), p(v), p(out), b, sq, k.shape[1], h, k.shape[2], d,
        int(causal), int(window or 0), _DTYPE_CODE[q.dtype],
        float(1.0 / d ** 0.5), _build.stream_of(q))
    _build.check(err, "flash_attention launch")
    _build.count_launch(flash_attention)
    return out


flash_attention.launches = 0
