"""K3: paged chunk attention — hand-written CUDA kernel + its plain PyTorch
versions.

The query tokens of a prefill chunk, each against the KV pages of its own
segment (request), read through that segment's block table and masked by
its validity row; int8 pages are dequantised with per-(position, head)
scales.  One kernel (``csrc/paged_chunk.cu``) replaces two TPU kernels:

* ``repro/kernels/decode_attention.py:298 paged_flash_packed_chunk`` (B4):
  a packed chunk of N tokens of up to R segments, ``seg`` per token;
* ``repro/kernels/decode_attention.py:265 paged_flash_prefill_chunk``
  (B3): B requests of C tokens each, which is B4 with N = B*C,
  ``seg = token // C`` and the requests' own tables and validity rows; its
  launcher reshapes the partials to (B, KV, G, C, ...).

Both keep the Pallas f32 contract: q is f32, pages are upcast to f32
(bf16) or dequantised (int8) before any arithmetic, and the result is the
UNNORMALISED (o, l, m) the caller merges with the chunk's own keys.  The
plain versions follow ``repro/kernels/ref.py:151 paged_prefill_chunk_ref``
and ``ref.py:198 paged_packed_chunk_ref``.

A token whose segment has no valid position (a prompt head with no cache
yet) returns m = -1e30, l = 0, o = 0 (invalid positions contribute exactly
zero); the Pallas kernel returns l = nb*bs and o = sum V there, and the
caller's merge weighs the cache at zero either way (ROADMAP C).

On the card, bf16 and int8 pages run the tensor-core kernel (the tile body
``csrc/attn_tile.cuh``, shared with K7) and f32 pages a CUDA-core kernel.
Past ``SPLIT_MIN_POSITIONS`` virtual positions a segment's positions are
shared over several blocks (split-KV, ``split_count``): each writes
partials to scratch the wrapper allocates, and the merge kernel that K2
and K6 launch too (``csrc/split_merge.cuh``) folds them as
``merge_split_partials_plain`` (``kernels/split.py``) does.

Dispatch is by the input's device: CPU tensors take the plain version,
CUDA tensors the kernel; anything else raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import split as _split
from repro_torch.kernels.paged_decode import _DTYPE_CODE, paged_attend_plain
# re-exported: K3's split policy and plain merge live in kernels/split.py
from repro_torch.kernels.split import (MAX_SPLITS,  # noqa: F401
                                       SPLIT_MIN_POSITIONS,
                                       merge_split_partials_plain)

# The (head dim, query heads per KV head) pairs the kernel is built for
# and checked at on the card, each for f32, bf16 and int8 pages:
# smollm-360m's d 64 on 15 heads over 5 KV heads, llama3.2-3b's d 128 on 24
# over 8, qwen1.5-32b's d 128 on 40 over 40, stablelm-3b's d 80 on 32 over
# 32, granite-moe-1b's d 64 on 16 over 8, phi3.5-moe's d 128 on 32 over 8
# and llava-next-34b's d 128 on 56 over 8.  csrc/paged_chunk.cu builds
# exactly these (its CHUNK_INSTANCE lines); every other pair is refused.
INSTANCES = ((64, 3), (128, 3), (128, 1), (80, 1), (64, 2), (128, 4),
             (128, 7))


# ---------------------------------------------------------------------------
# plain versions

def paged_prefill_chunk_plain(q, k_pages, v_pages, block_tables, valid,
                              k_scale_pages=None, v_scale_pages=None):
    """Plain version of ``paged_flash_prefill_chunk``: every request's C
    chunk queries against its gathered pages, one masked softmax.
    q (B, C, H, d) -> (o (B,KV,G,C,d), l (B,KV,G,C), m (B,KV,G,C))."""
    b, c, h, d = q.shape
    n_kv = k_pages.shape[1]
    g = h // n_kv
    qg = q.reshape(b, c, n_kv, g, d).permute(0, 2, 3, 1, 4) \
        .reshape(b, n_kv, g * c, d)
    o, l, m = paged_attend_plain(qg, k_pages, v_pages, block_tables, valid,
                                 k_scale_pages, v_scale_pages)
    return (o.reshape(b, n_kv, g, c, d), l.reshape(b, n_kv, g, c),
            m.reshape(b, n_kv, g, c))


def paged_packed_chunk_plain(q, k_pages, v_pages, seg, seg_tables,
                             seg_valid, k_scale_pages=None,
                             v_scale_pages=None):
    """Plain version of ``paged_flash_packed_chunk``: every chunk token
    against every segment's gathered pages, then each token keeps the
    partials of its own segment (``seg`` clamped into [0, R), as a JAX
    gather clamps).  q (C, H, d) -> (o (C,KV,G,d), l (C,KV,G),
    m (C,KV,G))."""
    c, h, d = q.shape
    n_kv = k_pages.shape[1]
    g = h // n_kv
    r = seg_tables.shape[0]
    qg = q.reshape(c, n_kv, g, d).permute(1, 0, 2, 3).reshape(n_kv, c * g, d)
    qg = qg[None].expand(r, n_kv, c * g, d)
    o, l, m = paged_attend_plain(qg, k_pages, v_pages, seg_tables, seg_valid,
                                 k_scale_pages, v_scale_pages)
    o = o.reshape(r, n_kv, c, g, d)
    l = l.reshape(r, n_kv, c, g)
    m = m.reshape(r, n_kv, c, g)
    s = seg.long().clamp(0, r - 1)
    tok = torch.arange(c, device=q.device)
    # advanced indices at dims 0 and 2 move to the front: (C, KV, G, ...)
    return o[s, :, tok], l[s, :, tok], m[s, :, tok]


def split_count(n_positions: int, dtype: torch.dtype) -> int:
    """How many blocks share one segment's positions in the kernel: 1 for
    f32 pages (the CUDA-core kernel does not split), else the shared
    policy ``split.split_count``: 1 up to ``SPLIT_MIN_POSITIONS`` virtual
    positions, one per 256 past it, at most ``MAX_SPLITS``."""
    if dtype == torch.float32:
        return 1
    return _split.split_count(n_positions)


# ---------------------------------------------------------------------------
# the kernel

def _check(name, q, k_pages, v_pages, seg, tables, valid, k_scale, v_scale):
    n, h, d = q.shape
    n_kv = k_pages.shape[1]
    r, nb = tables.shape
    bs = k_pages.shape[2]
    if k_pages.dtype not in _DTYPE_CODE or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"{name}: pages {k_pages.dtype}/{v_pages.dtype}; "
                         "kernel takes f32, bf16 or int8")
    if (k_pages.dtype == torch.int8) != (k_scale is not None) \
            or (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: int8 pages need both scale pools, other "
                         "dtypes none")
    if h % n_kv or (d, h // n_kv) not in INSTANCES:
        raise ValueError(f"{name}: no kernel instance for d={d} and {h} "
                         f"heads on {n_kv} KV heads (built: {INSTANCES} as "
                         "(d, heads per KV head); other head dims and groups "
                         "come with ROADMAP A7)")
    if r < 1:
        raise ValueError(f"{name}: no segment for {n} tokens")
    if k_pages.shape[3] != d:
        raise ValueError(f"{name}: pages {tuple(k_pages.shape)} do not match "
                         f"q (d={d})")
    want = [("q", q, torch.float32, (n, h, d)),
            ("k_pages", k_pages, k_pages.dtype, tuple(k_pages.shape)),
            ("v_pages", v_pages, k_pages.dtype, tuple(k_pages.shape)),
            ("tables", tables, torch.int32, (r, nb)),
            ("valid", valid, torch.bool, (r, nb * bs))]
    if seg is not None:
        want.append(("seg", seg, torch.int32, (n,)))
    if k_scale is not None:
        sshape = tuple(k_pages.shape[:3]) + (1,)
        want += [("k_scale", k_scale, torch.float32, sshape),
                 ("v_scale", v_scale, torch.float32, sshape)]
    for what, t, dt, shape in want:
        if t.device != q.device:
            raise ValueError(f"{name}: {what} on {t.device}, q on {q.device}")
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} is {t.dtype} "
                             f"{tuple(t.shape)}, expected {dt} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} not contiguous")
        if what in ("q", "k_pages", "v_pages") and t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} not 16-byte aligned")


def _launch(name, q, k_pages, v_pages, seg, seg_div, tables, valid,
            k_scale, v_scale):
    """One K3 launch: q (N, H, d) -> (o (N,KV,G,d), l, m (N,KV,G))."""
    _check(name, q, k_pages, v_pages, seg, tables, valid, k_scale, v_scale)
    n, h, d = q.shape
    n_kv = k_pages.shape[1]
    g = h // n_kv
    bs, nb = k_pages.shape[2], tables.shape[1]
    n_split = split_count(nb * bs, k_pages.dtype)
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.empty((n, n_kv, g, d), **f32)
    l = torch.empty((n, n_kv, g), **f32)
    m = torch.empty((n, n_kv, g), **f32)
    # the split-KV partials, merged by the launcher
    parts = _split.split_scratch(n_split, o, l, m)
    p, opt = _build.ptr, _build.opt_ptr
    err = _build.library().paged_chunk_launch(
        p(q), opt(seg), seg_div, p(k_pages), p(v_pages), opt(k_scale),
        opt(v_scale), p(tables), p(valid), p(o), p(l), p(m),
        *(opt(t) for t in parts), n, tables.shape[0], n_kv, g, d, bs, nb,
        n_split, _DTYPE_CODE[k_pages.dtype], float(1.0 / d ** 0.5),
        _build.stream_of(q))
    _build.check(err, f"{name} launch")
    return o, l, m


def _no_kernel(name, device):
    return RuntimeError(f"{name}: no kernel for device {device}")


def paged_flash_packed_chunk(q, k_pages, v_pages, seg, seg_tables, seg_valid,
                             k_scale_pages: Optional[torch.Tensor] = None,
                             v_scale_pages: Optional[torch.Tensor] = None):
    """Packed chunk attention over the pages (B4's contract).

    q (C, H, d) f32; k/v_pages (P, KV, bs, d) f32 | bf16 | int8 (the whole
    pool); seg (C,) int32 segment id per token; seg_tables (R, nb) int32;
    seg_valid (R, nb*bs) bool; int8 pages take k/v_scale_pages
    (P, KV, bs, 1) f32.  -> unnormalised per-token partials
    (o (C, KV, G, d), l (C, KV, G), m (C, KV, G))."""
    _build.forward_only("paged_flash_packed_chunk", q, k_pages, v_pages,
                        k_scale_pages, v_scale_pages)
    if q.device.type == "cpu":
        return paged_packed_chunk_plain(q, k_pages, v_pages, seg, seg_tables,
                                        seg_valid, k_scale_pages,
                                        v_scale_pages)
    if q.device.type != "cuda":
        raise _no_kernel("paged_flash_packed_chunk", q.device)
    out = _launch("paged_flash_packed_chunk", q, k_pages, v_pages, seg, 0,
                  seg_tables, seg_valid, k_scale_pages, v_scale_pages)
    _build.count_launch(paged_flash_packed_chunk)
    return out


def paged_flash_prefill_chunk(q, k_pages, v_pages, block_tables, valid,
                              k_scale_pages: Optional[torch.Tensor] = None,
                              v_scale_pages: Optional[torch.Tensor] = None):
    """Chunked-prefill attention over the pages (B3's contract): the C
    chunk queries of each of B requests against that request's pages.

    q (B, C, H, d) f32; block_tables (B, nb) int32; valid (B, nb*bs) bool
    (shared by the request's C queries); pages and scales as
    ``paged_flash_packed_chunk``.  -> unnormalised (o (B,KV,G,C,d),
    l (B,KV,G,C), m (B,KV,G,C))."""
    _build.forward_only("paged_flash_prefill_chunk", q, k_pages, v_pages,
                        k_scale_pages, v_scale_pages)
    if q.device.type == "cpu":
        return paged_prefill_chunk_plain(q, k_pages, v_pages, block_tables,
                                         valid, k_scale_pages, v_scale_pages)
    if q.device.type != "cuda":
        raise _no_kernel("paged_flash_prefill_chunk", q.device)
    b, c, h, d = q.shape
    o, l, m = _launch("paged_flash_prefill_chunk", q.reshape(b * c, h, d),
                      k_pages, v_pages, None, c, block_tables, valid,
                      k_scale_pages, v_scale_pages)
    _build.count_launch(paged_flash_prefill_chunk)
    n_kv = k_pages.shape[1]
    g = h // n_kv
    return (o.view(b, c, n_kv, g, d).permute(0, 2, 3, 1, 4),
            l.view(b, c, n_kv, g).permute(0, 2, 3, 1),
            m.view(b, c, n_kv, g).permute(0, 2, 3, 1))


paged_flash_packed_chunk.launches = 0
paged_flash_prefill_chunk.launches = 0
