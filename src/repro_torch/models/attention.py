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
Paged decode attention goes through K2 (``repro_torch.kernels.
paged_decode.paged_flash_decode``): the plain version for CPU tensors, the
CUDA kernel for CUDA tensors.  The dense-cache decode used by trajectory
harvesting is plain PyTorch, as the JAX package's is plain jnp.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels.paged_decode import paged_flash_decode
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


def _kv_leaves(ks, vs, cache) -> Dict[str, torch.Tensor]:
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
    for key, val in _kv_leaves(ks, vs, cache).items():
        # advanced indices (row, pos) move to the front: (B, L, KV, d')
        old = cache[key][:, rows, :, pos, :]
        new = val.transpose(0, 1).to(old.dtype)
        cache[key][:, rows, :, pos, :] = torch.where(ok, new, old)
    return cache


def decode_valid_mask(pos: torch.Tensor, batch: int, s_cache: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cache write slot + readable-entry mask for one decode step (no
    sliding window): slot = pos, valid = [0, pos) per row."""
    pos = pos.to(torch.int32).expand(batch)
    idxs = torch.arange(s_cache, device=pos.device)
    return pos, idxs[None, :] < pos[:, None]


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
    for key, val in _kv_leaves(ks, vs, pages).items():
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
                        window: Optional[int] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Reference O(S^2)-memory attention. q (B,Sq,H,d); k,v (B,Sk,KV,d)."""
    b, sq, h, d = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(b, sq, n_kv, h // n_kv, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k.float()) / torch.sqrt(torch.tensor(float(d)))
    qpos = torch.arange(sq, device=q.device) + q_offset
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


# ---------------------------------------------------------------------------
# Decode attention (single query against a READ-ONLY cache + current token)

def _decode_partial(qg, k, v, valid):
    """Unnormalized online-softmax pieces over a dense cache, the JAX jnp
    path's numerics: q cast to the cache dtype, products accumulated in
    f32.  Returns (o_un (B,KV,G,d), l (B,KV,G), m (B,KV,G))."""
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
    extra_kv: optional (k_new, v_new) each (B,KV,d) — the current token."""
    b, h, d = q.shape
    k, v = cache_kv(cache_l, torch.bfloat16)   # int8: bf16 dequant, as JAX
    n_kv = k.shape[1]
    qg = q.reshape(b, n_kv, h // n_kv, d).float()
    o, l, m = _decode_partial(qg, k, v, valid)
    o, l = _merge_extra_kv(qg, o, l, m, extra_kv, d)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, d).to(dtype)
