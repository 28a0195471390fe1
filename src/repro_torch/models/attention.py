"""GQA attention for the dense family: prefill (einsum), dense-cache decode
and paged decode, int8 KV quantisation (PyTorch).

Layouts (the JAX package's)
---------------------------
q:      (B, S, H, d_head)
k, v:   (B, S, KV, d_head)
cache:  {"k","v"}: (L, B, KV, S_cache, d_head)  (+ "k_scale","v_scale" int8)
pages:  {"k","v"}: (L, P, KV, bs, d_head) — P physical pages shared by all
        requests; row b reads/writes through its block table (B, nb):
        virtual position j lives in page table[j // bs] at offset j % bs.
        Page 0 is the NULL page (``repro_torch.serving.kv_pool.NULL_BLOCK``).

Caches and page pools are updated IN PLACE (the buffers the JAX engine
donates to its jitted step); the write functions return the same dict.
Every kernel below runs its plain version for CPU tensors and its CUDA
kernel for CUDA tensors:

* prefill attention (``attn_prefill``: the harvest, every admission, the
  static-batch engine) goes through K7 (``repro_torch.kernels.
  flash_attention``);
* dense-cache decode attention (``attn_decode``: the harvest's decode,
  dense fleets, the static-batch engine) takes its cache partials from K6
  (``repro_torch.kernels.flash_decode``);
* paged decode attention goes through K2 (``repro_torch.kernels.
  paged_decode.paged_flash_decode``), paged chunked and packed prefill
  attention through K3 (``repro_torch.kernels.paged_chunk``).

Training attention (``attn_prefill_einsum``, every family's ``forward``)
is plain PyTorch that autograd walks: no kernel has a backward, and JAX's
training forward reaches no Pallas kernel either.

The dense chunk and packed paths (``attn_prefill_chunk`` and
``attn_prefill_packed`` on a dense state) stay plain PyTorch: their JAX
counterparts call no Pallas kernel, and B3 and B4 are paged.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.paged_chunk import (paged_flash_packed_chunk,
                                             paged_flash_prefill_chunk)
from repro_torch.kernels.paged_decode import _gather, paged_flash_decode
from repro_torch.models.common import torch_dtype

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# KV cache (de)quantization

def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(position, head) absmax int8 quantization. x: (..., d_head)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(-1, keepdim=True) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def kv_leaves(ks, vs, cache) -> Dict[str, torch.Tensor]:
    """The values to store for (ks, vs) in ``cache``'s format."""
    if "k_scale" in cache:
        kq, ksc = quantize_kv(ks)
        vq, vsc = quantize_kv(vs)
        return {"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc}
    return {"k": ks.to(cache["k"].dtype), "v": vs.to(cache["v"].dtype)}


def init_cache(cfg, batch: int, length: int,
               device=None) -> Dict[str, torch.Tensor]:
    """Stacked-layer KV cache: (L, B, KV, S, d_head)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, length, cfg.d_head)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1] + (1,), device=device),
                "v_scale": torch.zeros(shape[:-1] + (1,), device=device)}
    dt = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def cache_write_stacked(cache: Dict[str, torch.Tensor], ks: torch.Tensor,
                        vs: torch.Tensor, slot: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
    """Write one token for ALL layers, in place: cache (L,B,KV,S,dh), ks/vs
    (L,B,KV,dh); ``slot`` (B,) per-row positions.  Rows whose slot is out of
    range (a parked slot, whose position runs on) do not write: they
    rewrite the last position's old value, which keeps the update free of
    host syncs."""
    s_cache = cache["k"].shape[3]
    ok = (slot < s_cache)[:, None, None, None]
    pos = torch.clamp(slot, max=s_cache - 1).long()
    rows = torch.arange(slot.shape[0], device=slot.device)
    for key, val in kv_leaves(ks, vs, cache).items():
        # advanced indices (row, pos) move to the front: (B, L, KV, d')
        old = cache[key][:, rows, :, pos, :]
        new = val.transpose(0, 1).to(old.dtype)
        cache[key][:, rows, :, pos, :] = torch.where(ok, new, old)
    return cache


def decode_valid_mask(pos: torch.Tensor, batch: int, s_cache: int,
                      window: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cache write slot + readable-entry mask for one decode step.

    Without a window: slot = pos, valid = [0, pos) per row.  With a window
    the cache is a ring buffer (hymba's): slot = pos % window, and index i
    holds the most recent position p <= pos with p % window == i, readable
    iff that position exists and is < pos (the pos entry is stale until the
    write after the layer loop)."""
    pos = pos.to(torch.int32).expand(batch)
    idxs = torch.arange(s_cache, device=pos.device)
    if window is None:
        return pos, idxs[None, :] < pos[:, None]
    stored = pos[:, None] - torch.remainder(pos[:, None] - idxs[None, :],
                                            window)
    return (torch.remainder(pos, window),
            (stored >= 0) & (stored < pos[:, None]))


def cache_kv(cache_l: Dict[str, torch.Tensor], dtype
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    if "k_scale" in cache_l:
        return (dequantize_kv(cache_l["k"], cache_l["k_scale"], dtype),
                dequantize_kv(cache_l["v"], cache_l["v_scale"], dtype))
    return cache_l["k"], cache_l["v"]


# ---------------------------------------------------------------------------
# Paged KV cache

def init_paged_cache(cfg, num_blocks: int, block_size: int, device=None
                     ) -> Dict[str, torch.Tensor]:
    """Stacked-layer paged KV pool: (L, P, KV, bs, d_head)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, num_blocks, cfg.n_kv_heads, block_size, cfg.d_head)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1] + (1,), device=device),
                "v_scale": torch.zeros(shape[:-1] + (1,), device=device)}
    dt = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def cache_write_paged(pages: Dict[str, torch.Tensor], ks: torch.Tensor,
                      vs: torch.Tensor, block_tables: torch.Tensor,
                      pos: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Write one token for ALL layers through the block tables, in place:
    pages (L, P, KV, bs, dh); ks/vs (L, B, KV, dh); row b writes page
    ``table[b, pos_b // bs]`` at offset ``pos_b % bs``.  A position past
    the table (a parked row's) reads the last entry, as the JAX gather
    clamps; parked rows' tables point at the NULL page."""
    bs = pages["k"].shape[3]
    nb = block_tables.shape[1]
    B = ks.shape[1]
    pos = pos.long().expand(B)
    blk = torch.clamp(pos // bs, max=nb - 1)
    page = block_tables[torch.arange(B, device=pos.device), blk].long()
    off = pos % bs
    for key, val in kv_leaves(ks, vs, pages).items():
        pages[key][:, page, :, off, :] = val.transpose(0, 1)
    return pages


def prefill_to_pages(pages: Dict[str, torch.Tensor],
                     prefill_cache: Dict[str, torch.Tensor],
                     block_row: torch.Tensor, n_blocks: int
                     ) -> Dict[str, torch.Tensor]:
    """Scatter ONE request's prefilled dense cache into its pages, in place.
    ``prefill_cache`` leaves are (L, 1, KV, S_pad, dh) with S_pad a multiple
    of the page size; the first ``n_blocks`` entries of ``block_row``
    receive the prompt K/V, page by page."""
    bs = pages["k"].shape[3]
    dst = block_row[:n_blocks].long()
    for key in pages:
        src = prefill_cache[key]                  # (L, 1, KV, S_pad, d')
        L, _, KV, s_pad, dl = src.shape
        src = src.reshape(L, KV, s_pad // bs, bs, dl)[:, :, :n_blocks]
        pages[key][:, dst] = src.transpose(1, 2).to(pages[key].dtype)
    return pages


def copy_pages(pages: Dict[str, torch.Tensor], src: torch.Tensor,
               dst: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Copy physical pages ``src`` -> ``dst`` across all layers, in place
    (a new sharer's private copy of a donor's partial tail page)."""
    for buf in pages.values():
        buf[:, dst.long()] = buf[:, src.long()]
    return pages


def paged_valid_mask(pos: torch.Tensor, batch: int, n_virtual: int
                     ) -> torch.Tensor:
    """Readable virtual positions for a paged decode step: [0, pos) per row
    (also masks NULL and stale table entries)."""
    pos = pos.to(torch.int32).expand(batch)
    return torch.arange(n_virtual, device=pos.device)[None, :] < pos[:, None]


def attn_decode_paged(q, pages_l: Dict[str, torch.Tensor],
                      block_tables: torch.Tensor, valid: torch.Tensor,
                      dtype, extra_kv=None) -> torch.Tensor:
    """Decode attention through a block table.  q (B,H,d); pages_l
    per-layer pages {"k","v": (P,KV,bs,d)} READ-ONLY; valid (B, nb*bs);
    extra_kv the current token's (k, v) each (B,KV,d).

    The cache partials come from K2 (``paged_flash_decode``, f32 contract:
    q f32, pages upcast or dequantised to f32)."""
    b, h, d = q.shape
    n_kv = pages_l["k"].shape[1]
    o, l, m = paged_flash_decode(q.float().contiguous(), pages_l["k"],
                                 pages_l["v"], block_tables, valid,
                                 pages_l.get("k_scale"),
                                 pages_l.get("v_scale"), return_partials=True)
    qg = q.reshape(b, n_kv, h // n_kv, d).float()
    o, l = _merge_extra_kv(qg, o, l, m, extra_kv, d)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, d).to(dtype)


# ---------------------------------------------------------------------------
# Prefill attention

def attn_prefill_einsum(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Reference O(S^2)-memory attention, the training forward's (JAX's
    ``attn_prefill_einsum``): q (B, Sq, H, d); k, v (B, Sk, KV, d), Sk
    free (cross-attention).  f32 scores, softmax and P.V, the output in
    q's dtype.  Plain PyTorch that autograd walks, on any device; serving
    prefill goes through K7 (``attn_prefill``).  It mirrors K7's plain
    version (``kernels/flash_attention.py`` ``attn_prefill_einsum``) line
    for line on purpose: that one is K7's oracle, this one the trainer's,
    and a change to either is made to both."""
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


def attn_prefill(q, k, v, causal: bool = True,
                 window: Optional[int] = None) -> torch.Tensor:
    """Prefill attention, q (B,S,H,d); k,v (B,S,KV,d) -> (B,S,H,d): K7
    (``flash_attention``, f32 contract), whose plain version is
    ``repro_torch.kernels.flash_attention.attn_prefill_einsum``."""
    return flash_attention(q, k, v, causal=causal, window=window)


# ---------------------------------------------------------------------------
# Decode attention (single query against a READ-ONLY cache + current token)

def _merge_extra_kv(qg, o, l, m, extra_kv, d):
    """Fold the current token's (k, v) column into unnormalized online-
    softmax partials (o, l, m).  Shared by the dense and paged paths."""
    if extra_kv is None:
        return o, l
    k_x, v_x = extra_kv
    k_x = k_x.float()
    v_x = v_x.float()
    s_x = torch.einsum("bkgd,bkd->bkg", qg, k_x) / torch.sqrt(
        torch.tensor(float(d)))
    m_f = torch.maximum(m, s_x)
    w_c = torch.where(torch.isfinite(m), torch.exp(m - m_f),
                      torch.zeros_like(m))
    w_x = torch.exp(s_x - m_f)
    o = o * w_c[..., None] + w_x[..., None] * v_x[:, :, None, :]
    l = l * w_c + w_x
    return o, l


def attn_decode(q, cache_l, valid, dtype, extra_kv=None) -> torch.Tensor:
    """q (B,H,d); cache_l per-layer dict (B,KV,S,d) READ-ONLY; valid (B,S);
    extra_kv: optional (k_new, v_new) each (B,KV,d) — the current token.

    The cache partials come from K6 (``flash_decode``, the jnp path's
    numerics: q cast to the cache dtype, f32 sums)."""
    b, h, d = q.shape
    k, v = cache_kv(cache_l, torch.bfloat16)   # int8: bf16 dequant, as JAX
    n_kv = k.shape[1]
    o, l, m = flash_decode(q, k, v, valid, return_partials=True)
    qg = q.reshape(b, n_kv, h // n_kv, d).float()
    o, l = _merge_extra_kv(qg, o, l, m, extra_kv, d)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, d).to(dtype)


# ---------------------------------------------------------------------------
# Chunked and packed prefill
#
# A prefill chunk's queries attend their request's already-written cache
# positions plus, causally, the chunk's own keys (not yet in the cache).
# The paged paths take the cache partials from K3 and fold the chunk's own
# keys in (``_merge_kv_block`` / ``_merge_packed_block``); the dense paths
# run ONE softmax over [cache | chunk], as the JAX jnp path does.

def chunk_write_positions(pos_start, chunk_len, c: int, s_cache: int,
                          device=None) -> torch.Tensor:
    """Target positions for a C-token prefill chunk: ``pos_start + i`` for
    real tokens, ``s_cache`` (out of range: the write is dropped) for
    padding past ``chunk_len``."""
    i = torch.arange(c, device=device)
    return torch.where(i < chunk_len, i + pos_start,
                       torch.full_like(i, s_cache))


def cache_write_chunk(cache: Dict[str, torch.Tensor], ks: torch.Tensor,
                      vs: torch.Tensor, rows: torch.Tensor, pos_start: int,
                      chunk_len: int) -> Dict[str, torch.Tensor]:
    """Write one prefill chunk's K/V for ALL layers into the ``rows`` lanes
    of a dense stacked cache, in place.

    cache (L,B,KV,S,dh); ks/vs (L,Bc,KV,C,dh); rows (Bc,) batch lanes;
    positions [pos_start, pos_start+chunk_len) receive the chunk (host
    ints: the eager caller's loop knows them); padding and positions past
    the cache are dropped."""
    s_cache = cache["k"].shape[3]
    p0 = int(pos_start)
    n = max(min(int(chunk_len), s_cache - p0), 0)
    rows = rows.long()
    for key, val in kv_leaves(ks, vs, cache).items():
        cache[key][:, rows, :, p0:p0 + n] = \
            val[:, :, :, :n].to(cache[key].dtype)
    return cache


def cache_write_chunk_paged(cache: Dict[str, torch.Tensor], ks: torch.Tensor,
                            vs: torch.Tensor, block_rows: torch.Tensor,
                            pos_start, chunk_len) -> Dict[str, torch.Tensor]:
    """Paged variant of :func:`cache_write_chunk`, in place: virtual
    position ``pos_start + i`` of request ``b`` lands in page
    ``block_rows[b, (pos_start+i) // bs]`` at offset ``(pos_start+i) %
    bs``; padded chunk positions are routed to the NULL page (page 0,
    scratch by construction, never allocated to a request)."""
    bs = cache["k"].shape[3]
    c = ks.shape[3]
    block_rows = block_rows.long()
    bc, nb = block_rows.shape
    i = torch.arange(c, device=ks.device)
    vpos = i + pos_start
    blk = torch.clamp(vpos // bs, 0, nb - 1)
    off = vpos % bs
    real = (i < chunk_len)[None, :]                   # (1, C)
    rows = torch.arange(bc, device=ks.device)[:, None]
    page = torch.where(real, block_rows[rows, blk[None, :]],
                       torch.zeros_like(blk)[None, :])       # (Bc, C)
    off_b = off[None, :].expand(bc, c)
    for key, val in kv_leaves(ks, vs, cache).items():
        # advanced indices (page, offset) at axes 1 and 3 -> value (Bc, C,
        # L, KV, dh); duplicate NULL targets may race, NULL is scratch
        cache[key][:, page, :, off_b, :] = \
            val.permute(1, 3, 0, 2, 4).to(cache[key].dtype)
    return cache


def gather_cache_rows(cache_l: Dict[str, torch.Tensor], rows: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer dense cache lanes for a prefill chunk: (Bc, KV, S, d) f32
    (int8 lanes dequantised)."""
    rows = rows.long()
    k = cache_l["k"][rows].float()
    v = cache_l["v"][rows].float()
    if "k_scale" in cache_l:
        k = k * cache_l["k_scale"][rows].float()
        v = v * cache_l["v_scale"][rows].float()
    return k, v


def gather_page_rows(cache_l: Dict[str, torch.Tensor],
                     block_tables: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer paged K/V gathered through block tables into contiguous
    virtual caches: (Bc, KV, nb*bs, d) f32."""
    return (_gather(cache_l["k"], cache_l.get("k_scale"), block_tables),
            _gather(cache_l["v"], cache_l.get("v_scale"), block_tables))


def _merge_kv_block(qc, o, l, m, k_blk, v_blk, mask):
    """Fold a block of keys into unnormalised online-softmax partials.

    qc (B,KV,G,C,d) f32; o (B,KV,G,C,d); l/m (B,KV,G,C); k_blk/v_blk
    (B,KV,T,d); mask (C,T), the causal-within-chunk mask.  A cache pass
    with no valid position (m = -1e30) is weighed at exp(-1e30 - m_f) = 0."""
    d = qc.shape[-1]
    s = torch.einsum("bkgcd,bktd->bkgct", qc, k_blk) / d ** 0.5
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_f = torch.maximum(m, s.amax(-1))
    w_c = torch.exp(m - m_f)
    p = torch.where(mask, torch.exp(s - m_f[..., None]), torch.zeros_like(s))
    o = o * w_c[..., None] + torch.einsum("bkgct,bktd->bkgcd", p, v_blk)
    l = l * w_c + p.sum(-1)
    return o, l


def attn_prefill_chunk(q, k_new, v_new, cache_l: Dict[str, torch.Tensor],
                       valid: torch.Tensor, dtype, *, rows=None,
                       block_tables=None) -> torch.Tensor:
    """Chunked-prefill attention: a C-token query chunk of each request
    attends its already-written cache positions plus causally within the
    chunk.

    q (Bc, C, H, d); k_new/v_new (Bc, C, KV, d), the chunk's own K/V (not
    yet in the cache); cache_l the per-layer dense cache (Bfull, KV, S, dh)
    read through ``rows`` (Bc,), or the paged pools (P, KV, bs, dh) read
    through ``block_tables`` (Bc, nb) by K3; valid (Bc, S_virtual) marks
    readable cache positions.  Returns (Bc, C, H, d)."""
    b, c, h, d = q.shape
    n_kv = k_new.shape[2]
    g = h // n_kv
    qc = q.reshape(b, c, n_kv, g, d).permute(0, 2, 3, 1, 4).float()
    kb = k_new.transpose(1, 2).float()               # (B, KV, C, d)
    vb = v_new.transpose(1, 2).float()
    ar = torch.arange(c, device=q.device)
    causal = ar[:, None] >= ar[None, :]
    if block_tables is not None:
        o, l, m = paged_flash_prefill_chunk(
            q.float().contiguous(), cache_l["k"], cache_l["v"], block_tables,
            valid, cache_l.get("k_scale"), cache_l.get("v_scale"))
        o, l = _merge_kv_block(qc, o, l, m, kb, vb, causal)
        out = o / torch.clamp(l, min=1e-30)[..., None]
    else:
        k_c, v_c = gather_cache_rows(cache_l, rows)
        scale = 1.0 / d ** 0.5
        sc_c = torch.einsum("bkgcd,bksd->bkgcs", qc, k_c) * scale
        sc_c = torch.where(valid[:, None, None, None, :], sc_c,
                           torch.full_like(sc_c, NEG_INF))
        sc_n = torch.einsum("bkgcd,bktd->bkgct", qc, kb) * scale
        sc_n = torch.where(causal, sc_n, torch.full_like(sc_n, NEG_INF))
        # ONE softmax over [cache | chunk], the shape of full prefill
        p = torch.softmax(torch.cat([sc_c, sc_n], dim=-1), dim=-1)
        s_len = k_c.shape[2]
        out = torch.einsum("bkgcs,bksd->bkgcd", p[..., :s_len], v_c) \
            + torch.einsum("bkgct,bktd->bkgcd", p[..., s_len:], vb)
    return out.permute(0, 3, 1, 2, 4).reshape(b, c, h, d).to(dtype)


def packed_chunk_mask(seg: torch.Tensor, valid_tok: torch.Tensor,
                      ancestors: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Block-diagonal mask for a PACKED chunk's own keys.

    Without ``ancestors`` (chunked prefill, linear verify): token i may
    attend chunk token j iff both belong to the same segment, j does not
    follow i (segments are laid out contiguously, so this is per-request
    causality) and j is a real token.

    With ``ancestors`` (C,), per-token parent pointers into the chunk with
    roots pointing at THEMSELVES (tree speculative decode), token i may
    attend chunk token j iff j lies on i's root path (i, its parent, its
    parent's parent, ...).  The closure runs on the device by pointer
    doubling: after step s, ``reach`` holds every ancestor at a distance
    below 2**s and ``jump`` the ancestor at 2**s, so ceil(log2 C) steps
    cover every path (a path of distinct nodes is shorter than C) — the
    set of JAX's C-step walk for any parent array.  The width-one tree
    (ancestors[i] = i - 1 within a segment) gives the causal chain mask bit
    for bit.  seg (C,), valid_tok (C,) -> (C, C)."""
    c = seg.shape[0]
    i = torch.arange(c, device=seg.device)
    base = (seg[:, None] == seg[None, :]) & valid_tok[None, :]
    if ancestors is None:
        return base & (i[None, :] <= i[:, None])
    jump = ancestors.long()
    reach = i[:, None] == i[None, :]
    for _ in range(max(c - 1, 0).bit_length()):
        reach = reach | reach[jump]
        jump = jump[jump]
    return base & reach


def _merge_packed_block(qg, o, l, m, k_new, v_new, mask):
    """Fold a packed chunk's own keys into per-token unnormalised partials.

    qg (C,KV,G,d) f32; o (C,KV,G,d); l/m (C,KV,G); k_new/v_new (C,KV,d);
    mask (C,C) the block-diagonal chunk mask.  Tokens whose cache pass had
    no valid position (m = -1e30) are weighed at exactly zero."""
    d = qg.shape[-1]
    kb = k_new.transpose(0, 1).float()               # (KV, C, d)
    vb = v_new.transpose(0, 1).float()
    s = torch.einsum("ckgd,ktd->ckgt", qg, kb) / d ** 0.5
    mk = mask[:, None, None, :]
    s = torch.where(mk, s, torch.full_like(s, NEG_INF))
    m_f = torch.maximum(m, s.amax(-1))
    w_c = torch.exp(m - m_f)
    p = torch.where(mk, torch.exp(s - m_f[..., None]), torch.zeros_like(s))
    o = o * w_c[..., None] + torch.einsum("ckgt,ktd->ckgd", p, vb)
    l = l * w_c + p.sum(-1)
    return o, l


def attn_prefill_packed(q, k_new, v_new, cache_l: Dict[str, torch.Tensor],
                        seg: torch.Tensor, seg_starts: torch.Tensor,
                        chunk_mask: torch.Tensor, dtype, *, rows=None,
                        seg_tables=None) -> torch.Tensor:
    """Packed multi-request chunk attention: C chunk tokens of up to R
    requests ("segments") each attend THEIR OWN request's already-written
    cache positions plus, under the block-diagonal ``chunk_mask``, the
    chunk tokens of their own segment that precede them.

    q (C, H, d); k_new/v_new (C, KV, d); seg (C,) segment id per token;
    seg_starts (R,) each segment's prefill progress (its readable prefix);
    cache_l the per-layer dense cache read through ``rows`` (C,) per-token
    lanes, or the paged pools read through ``seg_tables`` (R, nb) by K3.
    Returns (C, H, d)."""
    c, h, d = q.shape
    n_kv = k_new.shape[1]
    g = h // n_kv
    qg = q.reshape(c, n_kv, g, d).float()
    if seg_tables is not None:
        n_virtual = seg_tables.shape[1] * cache_l["k"].shape[2]
        seg_valid = (torch.arange(n_virtual, device=q.device)[None, :]
                     < seg_starts[:, None])
        o, l, m = paged_flash_packed_chunk(
            q.float().contiguous(), cache_l["k"], cache_l["v"], seg,
            seg_tables, seg_valid, cache_l.get("k_scale"),
            cache_l.get("v_scale"))
        o, l = _merge_packed_block(qg, o, l, m, k_new, v_new, chunk_mask)
        out = o / torch.clamp(l, min=1e-30)[..., None]
    else:
        kb = k_new.transpose(0, 1).float()           # (KV, C, d)
        vb = v_new.transpose(0, 1).float()
        k_c, v_c = gather_cache_rows(cache_l, rows)  # (C, KV, S, d)
        valid = (torch.arange(k_c.shape[2], device=q.device)[None, :]
                 < seg_starts[seg.long()][:, None])
        scale = 1.0 / d ** 0.5
        sc_c = torch.einsum("ckgd,cksd->ckgs", qg, k_c) * scale
        sc_c = torch.where(valid[:, None, None, :], sc_c,
                           torch.full_like(sc_c, NEG_INF))
        sc_n = torch.einsum("ckgd,ktd->ckgt", qg, kb) * scale
        sc_n = torch.where(chunk_mask[:, None, None, :], sc_n,
                           torch.full_like(sc_n, NEG_INF))
        # ONE softmax over [cache | chunk] per token
        p = torch.softmax(torch.cat([sc_c, sc_n], dim=-1), dim=-1)
        s_len = k_c.shape[2]
        out = torch.einsum("ckgs,cksd->ckgd", p[..., :s_len], v_c) \
            + torch.einsum("ckgt,ktd->ckgd", p[..., s_len:], vb)
    return out.reshape(c, h, d).to(dtype)


def cache_write_packed(cache: Dict[str, torch.Tensor], ks: torch.Tensor,
                       vs: torch.Tensor, rows: torch.Tensor,
                       wpos: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Write a PACKED chunk's K/V for ALL layers into a dense stacked
    cache, in place: every chunk token targets its own (lane, position).

    cache (L,B,KV,S,dh); ks/vs (L,KV,C,dh); rows (C,) per-token lanes;
    wpos (C,) per-token positions, padding routed out of range (>= S) and
    dropped.  A dropped write repeats the chunk's first kept write (same
    target, same value), so the scatter needs no host sync and no two
    targets race."""
    s_cache = cache["k"].shape[3]
    c = wpos.shape[0]
    keep = wpos < s_cache
    first = torch.argmax(keep.to(torch.int32))       # 0 if nothing is kept
    src = torch.where(keep, torch.arange(c, device=wpos.device), first)
    lane = rows.long()[src]
    pos = torch.clamp(wpos.long()[src], max=s_cache - 1)
    kept = keep[src][:, None, None, None]
    for key, val in kv_leaves(ks, vs, cache).items():
        # advanced indices (lane, position) at axes 1 and 3 move to the
        # front: (C, L, KV, dh)
        old = cache[key][:, lane, :, pos, :]
        new = val[:, :, src].permute(2, 0, 1, 3).to(old.dtype)
        cache[key][:, lane, :, pos, :] = torch.where(kept, new, old)
    return cache


def cache_write_packed_paged(cache: Dict[str, torch.Tensor], ks: torch.Tensor,
                             vs: torch.Tensor, tok_tables: torch.Tensor,
                             wpos: torch.Tensor, valid_tok: torch.Tensor
                             ) -> Dict[str, torch.Tensor]:
    """Paged variant of :func:`cache_write_packed`, in place: chunk token t
    lands in page ``tok_tables[t, wpos_t // bs]`` at offset ``wpos_t %
    bs``; padding tokens are routed to the NULL page (page 0, scratch).

    cache k/v (L,P,KV,bs,dh); ks/vs (L,KV,C,dh); tok_tables (C, nb)
    per-token block-table rows; wpos (C,) virtual positions; valid_tok
    (C,) marks real tokens."""
    bs = cache["k"].shape[3]
    c = ks.shape[2]
    nb = tok_tables.shape[1]
    wpos = wpos.long()
    blk = torch.clamp(wpos // bs, 0, nb - 1)
    off = wpos % bs
    page = torch.where(valid_tok,
                       tok_tables.long()[torch.arange(c, device=ks.device),
                                         blk], torch.zeros_like(blk))
    for key, val in kv_leaves(ks, vs, cache).items():
        # advanced indices (page, offset) at axes 1 and 3 -> value (C, L,
        # KV, dh); duplicate NULL targets may race, NULL is scratch
        cache[key][:, page, :, off, :] = \
            val.permute(2, 0, 1, 3).to(cache[key].dtype)
    return cache
