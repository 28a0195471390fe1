"""Whisper (PyTorch) — encoder-decoder transformer.  [arXiv:2212.04356]

The mel-spectrogram + conv1d frontend is a stub: requests carry
precomputed frame embeddings ``frames`` (B, n_frames, d_model).  Module
for module the JAX package's ``repro/models/whisper.py``: a bidirectional
encoder with sinusoidal positions, a causal decoder with learned positions
and cross-attention, biased q/k/v projections and MLPs, LayerNorm, logits
tied to the embedding.  Same parameter names and layouts (per-layer
leaves stacked on a leading L axis), same order of casts.

Attention runs through the port's kernels: the encoder through K7
(``attention.attn_prefill``, non-causal over the frames), the decoder's
self-attention through K6 (``attention.attn_decode``) over its cache with
the current token as ``extra_kv``, and its cross-attention through K6
over all frames with an all-true mask.

``forward``, the training forward, runs encoder and decoder with grad,
teacher forced, every attention (self, cross and the encoder's) through
``attention.attn_prefill_einsum``: no kernel has a backward.

The decode state is a flat dict of leaves with the batch on axis 1 (the
serving engine injects, spills and restores it as a KV cache): ``k``,
``v`` (L, B, H, S, dh) the decoder's self-attention cache, which holds
generated tokens only (decode starts at position 0), and ``cross_k``,
``cross_v`` (L, B, H, F, dh) the encoder's keys and values, computed once
at prefill.  ``decode_step`` updates it in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import (Param, apply_norm, cdtype, gelu,
                                       norm_decls, stack_decls)
from repro_torch.models.transformer import layer_params, unstacked_layers

MAX_TARGET_POSITIONS = 32768  # decoder learned positions (extended from 448)


def _attn_decls(cfg):
    d, qo = cfg.d_model, cfg.attn_out_dim
    return {"wq": Param((d, qo)), "wk": Param((d, qo)), "wv": Param((d, qo)),
            "wo": Param((qo, d)), "bq": Param((qo,), "zeros"),
            "bk": Param((qo,), "zeros"), "bv": Param((qo,), "zeros")}


def _mlp_decls(cfg):
    d, f = cfg.d_model, cfg.d_ff
    return {"w_in": Param((d, f)), "b_in": Param((f,), "zeros"),
            "w_out": Param((f, d)), "b_out": Param((d,), "zeros")}


def decls(cfg) -> Dict[str, Any]:
    enc = {"ln1": norm_decls(cfg), "attn": _attn_decls(cfg),
           "ln2": norm_decls(cfg), "mlp": _mlp_decls(cfg)}
    dec = {"ln1": norm_decls(cfg), "self_attn": _attn_decls(cfg),
           "ln2": norm_decls(cfg), "cross_attn": _attn_decls(cfg),
           "ln3": norm_decls(cfg), "mlp": _mlp_decls(cfg)}
    return {
        "embed": Param((cfg.padded_vocab(), cfg.d_model), "embed"),
        "pos_embed": Param((MAX_TARGET_POSITIONS, cfg.d_model), "embed"),
        "enc_layers": stack_decls(enc, cfg.n_encoder_layers),
        "enc_norm": norm_decls(cfg),
        "dec_layers": stack_decls(dec, cfg.n_layers),
        "final_norm": norm_decls(cfg),
    }


def init_state(cfg, batch: int, cache_len: int, device="cpu"):
    """The decode state (module docstring), zeros."""
    shp = (cfg.n_layers, batch, cfg.n_heads, cfg.frontend.n_tokens,
           cfg.d_head)
    dt = cdtype(cfg)
    return dict(attn.init_cache(cfg, batch, cache_len, device=device),
                cross_k=torch.zeros(shp, dtype=dt, device=device),
                cross_v=torch.zeros(shp, dtype=dt, device=device))


def _sinusoid(length: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    inv = torch.exp(-dim * (math.log(10000.0) / max(d // 2 - 1, 1)))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _proj(p, x, name):
    """x @ w<name> + b<name> in x's dtype."""
    dt = x.dtype
    return x @ p["w" + name].to(dt) + p["b" + name].to(dt)


def _mha(cfg, p, xq, xkv, causal: bool, attend=attn.attn_prefill):
    """Multi-head attention of xq over xkv through ``attend`` (K7 by
    default)."""
    b, sq, _ = xq.shape
    f = xkv.shape[1]
    q = _proj(p, xq, "q").reshape(b, sq, cfg.n_heads, cfg.d_head)
    k = _proj(p, xkv, "k").reshape(b, f, cfg.n_heads, cfg.d_head)
    v = _proj(p, xkv, "v").reshape(b, f, cfg.n_heads, cfg.d_head)
    o = attend(q, k, v, causal=causal)
    return o.reshape(b, sq, cfg.attn_out_dim) @ p["wo"].to(xq.dtype)


def _mlp(p, x):
    dt = x.dtype
    h = gelu(x @ p["w_in"].to(dt) + p["b_in"].to(dt))
    return h @ p["w_out"].to(dt) + p["b_out"].to(dt)


@torch.no_grad()
def encode(cfg, params, frames):
    """frames (B, n_frames, d_model) from the stubbed conv frontend ->
    the encoder's output (B, n_frames, d_model), its attention through
    K7."""
    return _encode(cfg, params, frames, attn.attn_prefill)


def _encode(cfg, params, frames, attend):
    """The encoder, its attention through ``attend``."""
    dt = cdtype(cfg)
    x = frames.to(dt) + _sinusoid(frames.shape[1], cfg.d_model,
                                  frames.device).to(dt)[None]
    for p in unstacked_layers(params["enc_layers"], cfg.n_encoder_layers):
        h = apply_norm(cfg, p["ln1"], x)
        x = x + _mha(cfg, p["attn"], h, h, False, attend)
        x = x + _mlp(p["mlp"], apply_norm(cfg, p["ln2"], x))
    return apply_norm(cfg, params["enc_norm"], x)


def forward(cfg, params, batch):
    """Teacher-forced training forward: batch "frames" (B, F, d) and
    "tokens" (B, S).  Returns (logits, hidden, aux), aux 0; the logits
    through the tied embedding."""
    attend = attn.attn_prefill_einsum
    enc = _encode(cfg, params, batch["frames"], attend)
    tokens = batch["tokens"]
    dt = cdtype(cfg)
    s = tokens.shape[1]
    x = params["embed"].to(dt)[tokens.long()] + \
        params["pos_embed"][:s].to(dt)[None]
    for p in unstacked_layers(params["dec_layers"], cfg.n_layers):
        h = apply_norm(cfg, p["ln1"], x)
        x = x + _mha(cfg, p["self_attn"], h, h, True, attend)
        h = apply_norm(cfg, p["ln2"], x)
        x = x + _mha(cfg, p["cross_attn"], h, enc, False, attend)
        x = x + _mlp(p["mlp"], apply_norm(cfg, p["ln3"], x))
    h = apply_norm(cfg, params["final_norm"], x)
    return (h @ params["embed"].to(h.dtype).T, h,
            torch.zeros((), dtype=torch.float32, device=x.device))


@torch.no_grad()
def prefill(cfg, params, batch, cache_len: int):
    """Encode the frames and compute every decoder layer's cross K/V once.
    The prompt tokens are not run (as in JAX: decode starts from token 0
    at position 0).  Returns (state, None, encoder output)."""
    enc = encode(cfg, params, batch["frames"])
    b, f, _ = enc.shape
    state = init_state(cfg, b, cache_len, device=enc.device)
    for l in range(cfg.n_layers):
        pc = layer_params({"layers": params["dec_layers"]}, l)["cross_attn"]
        for name in ("k", "v"):
            state["cross_" + name][l] = _proj(pc, enc, name).reshape(
                b, f, cfg.n_heads, cfg.d_head).transpose(1, 2)
    return state, None, enc


def _heads(cfg, p, h, name):
    return _proj(p, h, name).reshape(h.shape[0], cfg.n_heads, cfg.d_head)


@torch.no_grad()
def decode_step(cfg, params, token, state, pos, *, write_mask=None):
    """One-token decode: token (B,), pos (B,) decoder positions.  The state
    is updated IN PLACE; ``write_mask`` is taken for the serving engine's
    uniform call and ignored, as the JAX registry's wrapper ignores it.
    Returns (logits, hidden, state)."""
    b = token.shape[0]
    dt = cdtype(cfg)
    pos = pos.to(torch.int32).expand(b)
    x = params["embed"].to(dt)[token.long()] + \
        params["pos_embed"].to(dt)[pos.long()]
    slot, valid = attn.decode_valid_mask(pos, b, state["k"].shape[3])
    cvalid = torch.ones((b, state["cross_k"].shape[3]), dtype=torch.bool,
                        device=x.device)
    ks, vs = [], []
    for l in range(cfg.n_layers):
        p = layer_params({"layers": params["dec_layers"]}, l)
        pa, pc = p["self_attn"], p["cross_attn"]
        h = apply_norm(cfg, p["ln1"], x[:, None, :])[:, 0]
        q, k, v = (_heads(cfg, pa, h, n) for n in "qkv")
        o = attn.attn_decode(q, {"k": state["k"][l], "v": state["v"][l]},
                             valid, x.dtype, extra_kv=(k, v))
        x = x + o.reshape(b, cfg.attn_out_dim) @ pa["wo"].to(dt)
        # cross attention against the encoder's K/V
        h = apply_norm(cfg, p["ln2"], x[:, None, :])[:, 0]
        o = attn.attn_decode(_heads(cfg, pc, h, "q"),
                             {"k": state["cross_k"][l],
                              "v": state["cross_v"][l]}, cvalid, x.dtype)
        x = x + o.reshape(b, cfg.attn_out_dim) @ pc["wo"].to(dt)
        h = apply_norm(cfg, p["ln3"], x[:, None, :])[:, 0]
        x = x + _mlp(p["mlp"], h)
        ks.append(k)
        vs.append(v)
    attn.cache_write_stacked(state, torch.stack(ks), torch.stack(vs), slot)
    h = apply_norm(cfg, params["final_norm"], x[:, None, :])[:, 0]
    return h @ params["embed"].to(h.dtype).T, h, state
