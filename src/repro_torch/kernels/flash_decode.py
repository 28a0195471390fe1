"""K6: dense flash-decode — hand-written CUDA kernel + its plain PyTorch
version.

Single-query GQA attention where every batch row reads its own contiguous
KV cache (B, KV, S, d), masked by ``valid`` (unwritten tails, sliding-
window rings, parked slots).  It replaces the TPU kernel
``repro/kernels/decode_attention.py:78 flash_decode`` (body ``_kernel``
:44) and keeps the numerics of the JAX jnp path the dense model serves
with (``repro/models/attention.py:854 _decode_partial``): q is cast to the
cache dtype, q, k and v are upcast to f32, p is rounded to the cache dtype
before P.V, and every sum is f32.  The plain version is that jnp path.

A row with no valid position returns m = -1e30, l = 0, o = 0 (the jnp
guard); the Pallas body returns l = S and o = sum V there, and the caller's
``_merge_extra_kv`` weighs the cache at zero either way (ROADMAP C).

On the card a row of more than ``split.SPLIT_MIN_POSITIONS`` positions is
shared over ``split.split_count`` blocks, at most
``split.DECODE_MAX_SPLITS`` (split-KV), whose partials land in scratch
this wrapper allocates and the merge kernel (``csrc/split_merge.cuh``)
folds as ``split.merge_split_partials_plain`` does; each block rounds p
against its own running max.  Up to that (the served and harvest caches)
it is one launch with no merge.

Dispatch is by the input's device: CPU tensors take the plain version,
CUDA tensors the kernel (``csrc/flash_decode.cu``); anything else raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import split as _split

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The (head dim, query heads per KV head) pairs the kernel is built for
# and checked at on the card, each for f32 and bf16 caches: smollm-360m's
# d 64 on 15 heads over 5 KV heads, llama3.2-3b's d 128 on 24 over 8,
# qwen1.5-32b's d 128 on 40 over 40 (its int8 cache dequantised to bf16
# first), stablelm-3b's d 80 on 32 over 32, granite-moe-1b's d 64 on 16
# over 8, phi3.5-moe's d 128 on 32 over 8, llava-next-34b's d 128 on 56
# over 8, hymba-1.5b's d 64 on 25 over 5 (its window ring) and
# whisper-tiny's d 64 on 6 over 6 (its decoder cache and its 1,500 frames
# of cross K/V).  csrc/flash_decode.cu builds exactly these (its
# DECODE_INSTANCE lines); every other pair is refused.
INSTANCES = ((64, 3), (128, 3), (128, 1), (80, 1), (64, 2), (128, 4),
             (128, 7), (64, 5), (64, 1))


def flash_decode_partials_plain(qg, k, v, valid):
    """Plain version of the kernel: (G, d) query rows per (batch row, KV
    head) against that row's cache, the jnp path's numerics.  qg
    (B, KV, G, d); k, v (B, KV, S, d); valid (B, S) -> unnormalised
    (o (B,KV,G,d), l (B,KV,G), m (B,KV,G)), all f32."""
    d = qg.shape[-1]
    sc = torch.einsum("bkgd,bksd->bkgs", qg.to(k.dtype).float(), k.float())
    sc = sc / torch.sqrt(torch.tensor(float(d)))
    ok = valid[:, None, None, :]
    sc = torch.where(ok, sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(-1)
    p = torch.where(ok, torch.exp(sc - m[..., None]), torch.zeros_like(sc))
    l = p.sum(-1)
    o = torch.einsum("bkgs,bksd->bkgd", p.to(v.dtype).float(), v.float())
    return o, l, m


def _check(qg, k, v, valid):
    b, n_kv, r, d = qg.shape
    s = k.shape[2]
    if k.dtype not in _DTYPE_CODE or v.dtype != k.dtype:
        raise ValueError(f"flash_decode: cache {k.dtype}/{v.dtype}; kernel "
                         "takes f32 or bf16 (int8 caches are dequantised "
                         "first)")
    if (d, r) not in INSTANCES:
        raise ValueError(f"flash_decode: no kernel instance for d={d} and "
                         f"{r} query heads per KV head (built: {INSTANCES}; "
                         "other head dims and groups come with ROADMAP A7)")
    want = [("q", qg, k.dtype, (b, n_kv, r, d)),
            ("k", k, k.dtype, (b, n_kv, s, d)),
            ("v", v, k.dtype, (b, n_kv, s, d)),
            ("valid", valid, torch.bool, (b, s))]
    for name, t, dt, shape in want:
        if t.device != qg.device:
            raise ValueError(f"flash_decode: {name} on {t.device}, q on "
                             f"{qg.device}")
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"flash_decode: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected {dt} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"flash_decode: {name} not contiguous")
        if name != "valid" and t.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} not 16-byte aligned")


def flash_decode_partials(qg, k, v, valid):
    """The kernel's contract: (G, d) query rows per (batch row, KV head)
    against that row's cache.  Same arguments and results as
    ``flash_decode_partials_plain``."""
    _build.forward_only("flash_decode", qg, k, v)
    if qg.device.type == "cpu":
        return flash_decode_partials_plain(qg, k, v, valid)
    if qg.device.type != "cuda":
        raise RuntimeError(f"flash_decode: no kernel for device "
                           f"{qg.device}")
    qg = qg.to(k.dtype).contiguous()
    _check(qg, k, v, valid)
    b, n_kv, r, d = qg.shape
    s = k.shape[2]
    n_split = _split.split_count(s, _split.DECODE_MAX_SPLITS)
    o = torch.empty((b, n_kv, r, d), dtype=torch.float32, device=qg.device)
    l = torch.empty((b, n_kv, r), dtype=torch.float32, device=qg.device)
    m = torch.empty((b, n_kv, r), dtype=torch.float32, device=qg.device)
    parts = _split.split_scratch(n_split, o, l, m)
    p = _build.ptr
    err = _build.library().flash_decode_launch(
        p(qg), p(k), p(v), p(valid), p(o), p(l), p(m),
        *(_build.opt_ptr(t) for t in parts), b, n_kv, r, d, s, n_split,
        _DTYPE_CODE[k.dtype], float(1.0 / d ** 0.5), _build.stream_of(qg))
    _build.check(err, "flash_decode launch")
    _build.count_launch(flash_decode)
    return o, l, m


def _decode(partials, q, k, v, valid, return_partials):
    b, h, d = q.shape
    n_kv = k.shape[1]
    o, l, m = partials(q.reshape(b, n_kv, h // n_kv, d), k, v, valid)
    if return_partials:
        return o, l, m
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


def flash_decode(q, k, v, valid, *, return_partials: bool = False):
    """Single-query attention over a dense cache.

    q (B, H, d); k, v (B, KV, S, d) f32 | bf16; valid (B, S) bool.  q is
    cast to the cache dtype.  -> out (B, H, d) in q's dtype, or with
    ``return_partials`` the unnormalised (o (B,KV,G,d), l (B,KV,G),
    m (B,KV,G)) f32."""
    return _decode(flash_decode_partials, q, k, v, valid, return_partials)


def flash_decode_plain(q, k, v, valid, *, return_partials: bool = False):
    """Plain PyTorch version of ``flash_decode`` on any device — the
    comparison the kernel is held to (never the serving path's choice)."""
    return _decode(flash_decode_partials_plain, q, k, v, valid,
                   return_partials)


flash_decode.launches = 0
