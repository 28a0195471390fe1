"""K2: paged flash-decode — hand-written CUDA kernel + its plain PyTorch
version.

Single-query GQA attention where every batch row reads its K/V pages from
a shared pool through its own block table, masked by ``valid``; int8 pages
are dequantised with per-(position, head) scales.  It replaces the TPU
kernel ``repro/kernels/decode_attention.py:231 paged_flash_decode``
(launcher ``_paged_attend`` :164, body ``_paged_kernel`` :113) and keeps its
f32 contract: q is f32 and pages are upcast to f32 (bf16) or dequantised
(int8) before any arithmetic.  The plain version follows
``repro/kernels/ref.py:137 paged_decode_ref``: gather the pages into a
contiguous virtual cache, then one masked softmax.

A row with no valid position returns m = -1e30, l = 0, o = 0 (invalid
positions contribute exactly zero); the caller's ``_merge_extra_kv`` then
weighs the cache at zero either way.

On the card a row of more than ``split.SPLIT_MIN_POSITIONS`` virtual
positions is shared over ``split.split_count`` blocks, at most
``split.DECODE_MAX_SPLITS`` (split-KV), whose partials land in scratch
this wrapper allocates and the merge kernel (``csrc/split_merge.cuh``)
folds as ``split.merge_split_partials_plain`` does; up to that it is one
launch with no merge.

Dispatch is by the input's device: CPU tensors take the plain version,
CUDA tensors the kernel (``csrc/paged_decode.cu``); anything else raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import split as _split

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# The (head dim, query rows per KV head) pairs the kernel is built for and
# checked at on the card, each for f32, bf16 and int8 pages: smollm-360m's
# d 64 on 15 heads over 5 KV heads, llama3.2-3b's d 128 on 24 over 8,
# qwen1.5-32b's d 128 on 40 over 40, stablelm-3b's d 80 on 32 over 32,
# granite-moe-1b's d 64 on 16 over 8, phi3.5-moe's d 128 on 32 over 8 and
# llava-next-34b's d 128 on 56 over 8.  csrc/paged_decode.cu builds
# exactly these (its DECODE_INSTANCE lines); every other pair is refused.
INSTANCES = ((64, 3), (128, 3), (128, 1), (80, 1), (64, 2), (128, 4),
             (128, 7))


def _gather(pages, scales, block_tables):
    """Pages -> per-row contiguous virtual caches (B, KV, nb*bs, d) f32."""
    bt = block_tables.long()
    b, nb = bt.shape
    n_kv, bs = pages.shape[1], pages.shape[2]
    x = pages[bt].float()                        # (B, nb, KV, bs, d)
    if scales is not None:
        x = x * scales[bt].float()
    return x.permute(0, 2, 1, 3, 4).reshape(b, n_kv, nb * bs, -1)


def paged_attend_plain(qg, k_pages, v_pages, block_tables, valid,
                       k_scale_pages=None, v_scale_pages=None):
    """Plain version of the kernel's inner routine: (R, d) query rows per
    (batch row, KV head) against that row's pages.  qg (B, KV, R, d) ->
    unnormalised (o (B,KV,R,d), l (B,KV,R), m (B,KV,R)), all f32."""
    d = qg.shape[-1]
    k = _gather(k_pages, k_scale_pages, block_tables)
    v = _gather(v_pages, v_scale_pages, block_tables)
    s = torch.einsum("bkrd,bksd->bkrs", qg.float() * (1.0 / d ** 0.5), k)
    ok = valid[:, None, None, :]
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)
    p = torch.where(ok, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(-1)
    o = torch.einsum("bkrs,bksd->bkrd", p, v)
    return o, l, m


def _check(qg, k_pages, v_pages, block_tables, valid, k_scale, v_scale):
    b, n_kv, r, d = qg.shape
    nb = block_tables.shape[1]
    bs = k_pages.shape[2]
    if k_pages.dtype not in _DTYPE_CODE or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"paged_flash_decode: pages {k_pages.dtype}/"
                         f"{v_pages.dtype}; kernel takes f32, bf16 or int8")
    if (k_pages.dtype == torch.int8) != (k_scale is not None) \
            or (k_scale is None) != (v_scale is None):
        raise ValueError("paged_flash_decode: int8 pages need both scale "
                         "pools, other dtypes none")
    if (d, r) not in INSTANCES:
        raise ValueError(f"paged_flash_decode: no kernel instance for d={d} "
                         f"and {r} query rows per KV head (built: "
                         f"{INSTANCES}; other head dims and groups come with "
                         "ROADMAP A7)")
    want = [("q", qg, torch.float32, (b, n_kv, r, d)),
            ("k_pages", k_pages, k_pages.dtype, tuple(k_pages.shape)),
            ("v_pages", v_pages, k_pages.dtype, tuple(k_pages.shape)),
            ("block_tables", block_tables, torch.int32, (b, nb)),
            ("valid", valid, torch.bool, (b, nb * bs))]
    if k_scale is not None:
        sshape = tuple(k_pages.shape[:3]) + (1,)
        want += [("k_scale", k_scale, torch.float32, sshape),
                 ("v_scale", v_scale, torch.float32, sshape)]
    if k_pages.shape[1] != n_kv or k_pages.shape[3] != d:
        raise ValueError(f"paged_flash_decode: pages {tuple(k_pages.shape)} "
                         f"do not match q (KV={n_kv}, d={d})")
    for name, t, dt, shape in want:
        if t.device != qg.device:
            raise ValueError(f"paged_flash_decode: {name} on {t.device}, "
                             f"q on {qg.device}")
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"paged_flash_decode: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected {dt} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"paged_flash_decode: {name} not contiguous")
        if name in ("q", "k_pages", "v_pages") and t.data_ptr() % 16:
            raise ValueError(f"paged_flash_decode: {name} not 16-byte "
                             "aligned")


def paged_attend(qg, k_pages, v_pages, block_tables, valid,
                 k_scale_pages=None, v_scale_pages=None):
    """The kernel's inner routine: (R, d) query rows per (batch row, KV
    head) — R = G heads for decode — against that row's pages, through its
    block table.  Same contract as ``paged_attend_plain``."""
    _build.forward_only("paged_flash_decode", qg, k_pages, v_pages,
                        k_scale_pages, v_scale_pages)
    if qg.device.type == "cpu":
        return paged_attend_plain(qg, k_pages, v_pages, block_tables, valid,
                                  k_scale_pages, v_scale_pages)
    if qg.device.type != "cuda":
        raise RuntimeError(f"paged_flash_decode: no kernel for device "
                           f"{qg.device}")
    _check(qg, k_pages, v_pages, block_tables, valid, k_scale_pages,
           v_scale_pages)
    b, n_kv, r, d = qg.shape
    bs, nb = k_pages.shape[2], block_tables.shape[1]
    n_split = _split.split_count(nb * bs, _split.DECODE_MAX_SPLITS)
    o = torch.empty((b, n_kv, r, d), dtype=torch.float32, device=qg.device)
    l = torch.empty((b, n_kv, r), dtype=torch.float32, device=qg.device)
    m = torch.empty((b, n_kv, r), dtype=torch.float32, device=qg.device)
    parts = _split.split_scratch(n_split, o, l, m)
    p, opt = _build.ptr, _build.opt_ptr
    err = _build.library().paged_decode_launch(
        p(qg), p(k_pages), p(v_pages), opt(k_scale_pages),
        opt(v_scale_pages), p(block_tables), p(valid), p(o), p(l), p(m),
        *(opt(t) for t in parts), b, n_kv, r, d, bs, nb, n_split,
        _DTYPE_CODE[k_pages.dtype], float(1.0 / d ** 0.5),
        _build.stream_of(qg))
    _build.check(err, "paged_flash_decode launch")
    _build.count_launch(paged_flash_decode)
    return o, l, m


def _decode(attend, q, k_pages, v_pages, block_tables, valid,
            k_scale_pages, v_scale_pages, return_partials):
    b, h, d = q.shape
    n_kv = k_pages.shape[1]
    o, l, m = attend(q.reshape(b, n_kv, h // n_kv, d), k_pages, v_pages,
                     block_tables, valid, k_scale_pages, v_scale_pages)
    if return_partials:
        return o, l, m
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


def paged_flash_decode(q, k_pages, v_pages, block_tables, valid,
                       k_scale_pages: Optional[torch.Tensor] = None,
                       v_scale_pages: Optional[torch.Tensor] = None, *,
                       return_partials: bool = False):
    """Single-query attention where each batch row gathers its K/V pages
    through its block table.

    q (B, H, d) f32; k/v_pages (P, KV, bs, d) f32 | bf16 | int8 (the whole
    pool); block_tables (B, nb) int32; valid (B, nb*bs) bool; int8 pages
    take k/v_scale_pages (P, KV, bs, 1) f32.  -> out (B, H, d), or with
    ``return_partials`` the unnormalised (o (B,KV,G,d), l (B,KV,G),
    m (B,KV,G))."""
    return _decode(paged_attend, q, k_pages, v_pages, block_tables, valid,
                   k_scale_pages, v_scale_pages, return_partials)


def paged_decode_plain(q, k_pages, v_pages, block_tables, valid,
                       k_scale_pages=None, v_scale_pages=None, *,
                       return_partials: bool = False):
    """Plain PyTorch version of ``paged_flash_decode`` on any device — the
    comparison the kernel is held to (never the serving path's choice)."""
    return _decode(paged_attend_plain, q, k_pages, v_pages, block_tables,
                   valid, k_scale_pages, v_scale_pages, return_partials)


paged_flash_decode.launches = 0
