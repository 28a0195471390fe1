"""Decoder-only transformer, dense family (PyTorch).

Parameters are the JAX package's nested dict with its names and layouts:
``embed`` (V_pad, d), ``final_norm``, ``layers`` with every per-layer leaf
stacked on a leading L axis (``layers.attn.wq`` is (L, d, H*dh)), and
``lm_head`` (d, V_pad) when embeddings are untied.  The layer loop is a
Python loop indexing layer ``l`` of each stacked leaf.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import (Param, apply_norm, apply_rope, cdtype,
                                       norm_decls, stack_decls, swiglu)


# ---------------------------------------------------------------------------
# Declarations

def _attn_decls(cfg) -> Dict[str, Param]:
    d, qo, kvo = cfg.d_model, cfg.attn_out_dim, cfg.kv_out_dim
    out = {"wq": Param((d, qo)), "wk": Param((d, kvo)),
           "wv": Param((d, kvo)), "wo": Param((qo, d))}
    if cfg.qkv_bias:
        out["bq"] = Param((qo,), "zeros")
        out["bk"] = Param((kvo,), "zeros")
        out["bv"] = Param((kvo,), "zeros")
    return out


def _mlp_decls(cfg) -> Dict[str, Param]:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": Param((d, f)), "w_up": Param((d, f)),
            "w_down": Param((f, d))}


def decls(cfg) -> Dict[str, Any]:
    if cfg.moe is not None or cfg.mlp != "swiglu" or cfg.arch_type != "dense":
        raise NotImplementedError(
            f"{cfg.name}: only the dense swiglu family is ported; MoE/VLM "
            "come with ROADMAP queue A (other families)")
    tree: Dict[str, Any] = {
        "embed": Param((cfg.padded_vocab(), cfg.d_model), "embed"),
        "final_norm": norm_decls(cfg),
        "layers": stack_decls({"ln1": norm_decls(cfg), "ln2": norm_decls(cfg),
                               "attn": _attn_decls(cfg),
                               "mlp": _mlp_decls(cfg)}, cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = Param((cfg.d_model, cfg.padded_vocab()))
    return tree


def layer_params(params, l: int):
    """Layer ``l``'s slice of every stacked leaf."""
    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        return tree[l]
    return take(params["layers"])


# ---------------------------------------------------------------------------
# Blocks

def mlp_apply(cfg, p, x):
    dt = x.dtype
    h = swiglu(x @ p["w_gate"].to(dt), x @ p["w_up"].to(dt))
    return h @ p["w_down"].to(dt)


def _qkv(cfg, p, x):
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def layer_prefill(cfg, p, x, positions, window: Optional[int]):
    """x (B,S,d) -> (x', (k, v)) with k/v (B, KV, S, dh) for the cache."""
    b, s, d = x.shape
    h = apply_norm(cfg, p["ln1"], x)
    q, k, v = _qkv(cfg, p["attn"], h)
    q = q.reshape(b, s, cfg.n_heads, cfg.d_head)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)
    o = attn.attn_prefill_einsum(q, k, v, causal=True, window=window)
    o = o.reshape(b, s, cfg.attn_out_dim) @ p["attn"]["wo"].to(x.dtype)
    x = x + o
    h = apply_norm(cfg, p["ln2"], x)
    x = x + mlp_apply(cfg, p["mlp"], h)
    return x, (k.transpose(1, 2), v.transpose(1, 2))


def layer_decode(cfg, p, x, cache_l, pos, valid, block_tables=None):
    """x (B,d); cache_l per-layer (B,KV,S,dh) READ-ONLY — or, with
    ``block_tables`` (B,nb), per-layer pages (P,KV,bs,dh) read through the
    table; pos (B,) absolute positions; valid masks readable cache entries
    (the current token attends via extra_kv and is written after the
    layer loop)."""
    b, d = x.shape
    h = apply_norm(cfg, p["ln1"], x[:, None, :])[:, 0]
    q, k, v = _qkv(cfg, p["attn"], h)
    q = q.reshape(b, cfg.n_heads, cfg.d_head)
    k = k.reshape(b, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(b, cfg.n_kv_heads, cfg.d_head)
    q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta,
                   cfg.rotary_pct)[:, 0]
    k = apply_rope(k[:, None], pos[:, None], cfg.rope_theta,
                   cfg.rotary_pct)[:, 0]
    if block_tables is not None:
        o = attn.attn_decode_paged(q, cache_l, block_tables, valid, x.dtype,
                                   extra_kv=(k, v))
    else:
        o = attn.attn_decode(q, cache_l, valid, x.dtype, extra_kv=(k, v))
    o = o.reshape(b, cfg.attn_out_dim) @ p["attn"]["wo"].to(x.dtype)
    x = x + o
    h = apply_norm(cfg, p["ln2"], x[:, None, :])
    return x + mlp_apply(cfg, p["mlp"], h)[:, 0], (k, v)


# ---------------------------------------------------------------------------
# Embedding / logits

def embed_tokens(cfg, params, tokens):
    return params["embed"].to(cdtype(cfg))[tokens.long()]


def logits_from_hidden(cfg, params, h):
    if cfg.tie_embeddings:
        return h @ params["embed"].to(h.dtype).T
    return h @ params["lm_head"].to(h.dtype)


# ---------------------------------------------------------------------------
# Full passes

@torch.no_grad()
def prefill(cfg, params, batch, cache_len: int):
    """Run the prompt, build the KV cache. Returns (cache, last_hidden,
    h_all)."""
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    ks, vs = [], []
    for l in range(cfg.n_layers):
        x, (k, v) = layer_prefill(cfg, layer_params(params, l), x, positions,
                                  cfg.sliding_window)
        ks.append(k)
        vs.append(v)
    h = apply_norm(cfg, params["final_norm"], x)
    k, v = torch.stack(ks), torch.stack(vs)       # (L, B, KV, S, dh)
    cache = attn.init_cache(cfg, b, cache_len, device=x.device)
    if "k_scale" in cache:
        kq, ksc = attn.quantize_kv(k)
        vq, vsc = attn.quantize_kv(v)
        for key, val in (("k", kq), ("v", vq), ("k_scale", ksc),
                         ("v_scale", vsc)):
            cache[key][:, :, :, :s] = val
    else:
        cache["k"][:, :, :, :s] = k.to(cache["k"].dtype)
        cache["v"][:, :, :, :s] = v.to(cache["v"].dtype)
    return cache, h[:, -1], h


@torch.no_grad()
def decode_step(cfg, params, token, cache, pos):
    """One-token decode. token (B,); pos (B,) int32 per-row absolute
    positions (or a scalar shared by the batch).

    A cache carrying ``block_tables`` is PAGED: per-layer leaves are page
    pools (P,KV,bs,dh) read through each row's table with K2, and the
    new token's K/V lands through the table.  Otherwise the dense cache is
    written at ``pos``.  The cache is updated IN PLACE; returns (logits,
    hidden, cache)."""
    b = token.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32,
                          device=token.device).expand(b).contiguous()
    x = embed_tokens(cfg, params, token)
    paged = "block_tables" in cache
    if paged:
        bt = cache["block_tables"]
        pages = {k: v for k, v in cache.items() if k != "block_tables"}
        valid = attn.paged_valid_mask(pos, b, bt.shape[1]
                                      * pages["k"].shape[3])
    else:
        pages, bt = cache, None
        slot, valid = attn.decode_valid_mask(pos, b, cache["k"].shape[3])
    ks, vs = [], []
    for l in range(cfg.n_layers):
        cache_l = {key: val[l] for key, val in pages.items()}
        x, (k, v) = layer_decode(cfg, layer_params(params, l), x, cache_l,
                                 pos, valid, block_tables=bt)
        ks.append(k)
        vs.append(v)
    ks, vs = torch.stack(ks), torch.stack(vs)
    if paged:
        attn.cache_write_paged(pages, ks, vs, bt, pos)
    else:
        attn.cache_write_stacked(cache, ks, vs, slot)
    h = apply_norm(cfg, params["final_norm"], x[:, None, :])[:, 0]
    return logits_from_hidden(cfg, params, h), h, cache
