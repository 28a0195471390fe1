"""Hymba (PyTorch) — hybrid-head layers: parallel attention + Mamba (SSM)
heads.  [arXiv:2411.13676]

Each layer feeds the same normed input to (i) GQA attention with a sliding
window and (ii) a selective-SSM (Mamba-style) head branch; the two branch
outputs are RMS-normed, weighted by the learnable ``beta`` and summed in
f32.  ``n_meta_tokens`` learnable meta tokens are put in front of the
prompt.  Module for module the JAX package's ``repro/models/hymba.py``:
the same parameter names and layouts (every per-layer leaf stacked on a
leading L axis) and the same order of casts.

Attention runs through the port's kernels: the prefill through K7
(``attention.attn_prefill``, causal with the window), the decode through
K6 (``attention.attn_decode``) over the window's ring with the current
token as ``extra_kv``.  The Mamba recurrence stays plain PyTorch, as JAX
computes it with ``lax.scan`` outside any Pallas kernel: per token
h = exp(dt A) h + dt B x, y = h C, in f32.

The meta tokens sit in the prompt: at decode they are ring entries like
any other position, so once the positions pass the window they leave it
(the JAX module's code; its docstring says they stay attendable).

``forward``, the training forward, runs the same layers with grad: its
attention through ``attention.attn_prefill_einsum`` and its recurrence
through ``selective_scan_autograd``, which autograd walks (no kernel has a
backward, and the serving loop writes its states into a buffer).

The decode state is a flat dict of leaves with the batch on axis 1, so the
serving engine's prefill injection and its spill and restore take it as
they take a KV cache: ``k``, ``v`` (L, B, KV, W, dh) the ring of the last
W = min(cache_len, window) positions, ``conv`` (L, B, conv_dim - 1, di)
the depthwise conv's input history, ``ssm`` (L, B, di, state_dim) f32.
``decode_step`` updates it in place.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models.common import (Param, apply_norm, apply_rope,
                                       apply_rope_tables, cdtype, norm_decls,
                                       rmsnorm, rope_tables, stack_decls)
from repro_torch.models.transformer import (_mlp_decls, _qkv, embed_tokens,
                                            layer_params, logits_from_hidden,
                                            mlp_apply, unstacked_layers)

F32 = "float32"
# positions of the selective scan computed per pass of the token loop: its
# dA and dt*B*x terms and the states it visits, (B, chunk, di, state_dim)
# f32 each, at most a few hundred MB at hymba-1.5b's width
SCAN_CHUNK = 256


# ---------------------------------------------------------------------------
# Mamba branch

def _inner(cfg) -> int:
    return cfg.ssm.expand * cfg.d_model


def mamba_decls(cfg) -> Dict[str, Param]:
    """A_log, D (read through a float32 cast, as in JAX) and beta (in
    ``layer_decls``) stay float32; b_dt, which JAX casts to the activation
    dtype, is stored in it like the weights."""
    d, di, ds = cfg.d_model, _inner(cfg), cfg.ssm.state_dim
    dtr = cfg.ssm.dt_rank or max(1, -(-d // 16))
    return {
        "w_in": Param((d, 2 * di)),
        "conv_w": Param((cfg.ssm.conv_dim, di)),
        "conv_b": Param((di,), "zeros"),
        "w_x_dt": Param((di, dtr)),
        "w_dt": Param((dtr, di)),
        "b_dt": Param((di,), "zeros"),
        "w_B": Param((di, ds)),
        "w_C": Param((di, ds)),
        "A_log": Param((di, ds), "small", dtype=F32),
        "D": Param((di,), "ones", dtype=F32),
        "w_out": Param((di, d)),
    }


def selective_scan(dt_pos, Bm, Cm, xf, A, h):
    """The Mamba recurrence over T tokens, in f32: per token
    h = exp(dt A) h + (dt B) x and y = h C.  dt_pos, xf (B, T, di); Bm, Cm
    (B, T, ds); A (di, ds); h (B, di, ds), the state before the first
    token.  Returns (ys (B, T, di), h after the last token).  The terms
    that do not depend on h are computed for ``SCAN_CHUNK`` tokens at once;
    the loop over tokens carries h alone."""
    t = xf.shape[1]
    ys = []
    for t0 in range(0, t, SCAN_CHUNK):
        sl = slice(t0, min(t0 + SCAN_CHUNK, t))
        dt_c = dt_pos[:, sl, :, None]                          # (B,c,di,1)
        dA = torch.exp(dt_c * A)                               # (B,c,di,ds)
        dBx = dt_c * Bm[:, sl, None, :] * xf[:, sl, :, None]
        hs = torch.empty_like(dA)
        for i in range(dA.shape[1]):
            h = torch.add(dA[:, i] * h, dBx[:, i], out=hs[:, i])
        ys.append(torch.einsum("btds,bts->btd", hs, Cm[:, sl]))
    return torch.cat(ys, dim=1), h


def selective_scan_autograd(dt_pos, Bm, Cm, xf, A, h):
    """``selective_scan`` for the training forward, the same arguments and
    results: dA and dt*B*x for every token at once, then the token loop
    carrying h with no write into a saved buffer, so autograd walks it
    (JAX's ``lax.scan``).  The tokens are taken apart by one ``unbind``
    (its backward is one stack; indexing a token would zero-fill a
    gradient of the whole sequence per token)."""
    dt = dt_pos[..., None]                                     # (B,T,di,1)
    dA = torch.exp(dt * A)                                     # (B,T,di,ds)
    dBx = dt * Bm[:, :, None, :] * xf[..., None]
    hs = []
    for dA_t, dBx_t in zip(dA.unbind(1), dBx.unbind(1)):
        h = dA_t * h + dBx_t
        hs.append(h)
    return torch.einsum("btds,bts->btd", torch.stack(hs, 1), Cm), h


def _mamba_core(cfg, p, xin, conv_state, ssm_state, scan=selective_scan):
    """xin (B, T, di) after the in-projection; returns (y (B, T, di),
    conv_state', ssm_state'); ``scan`` runs the recurrence."""
    t = xin.shape[1]
    dt_ = xin.dtype
    # depthwise causal conv over [conv_state | xin]
    xpad = torch.cat([conv_state.to(dt_), xin], dim=1)
    win = cfg.ssm.conv_dim
    new_conv = xpad[:, -(win - 1):] if win > 1 else conv_state
    xwin = xpad.unfold(1, win, 1)                        # (B, T, di, win)
    xc = (xwin.float() * p["conv_w"].to(dt_).float().T).sum(-1)
    xc = xc.to(dt_) + p["conv_b"].to(dt_)
    xc = F.silu(xc.float()).to(dt_)
    # data-dependent dt, B, C: products in the activation dtype
    dt_lr = (xc @ p["w_x_dt"].to(dt_)) @ p["w_dt"].to(dt_) + \
        p["b_dt"].to(dt_)
    dt_pos = F.softplus(dt_lr.float())                          # (B,T,di)
    Bm = (xc @ p["w_B"].to(dt_)).float()                        # (B,T,ds)
    Cm = (xc @ p["w_C"].to(dt_)).float()
    A = -torch.exp(p["A_log"].float())                          # (di,ds)
    xf = xc.float()
    ys, ssm_state = scan(dt_pos, Bm, Cm, xf, A, ssm_state)
    y = ys + xf * p["D"].float()
    return y.to(dt_), new_conv, ssm_state


def mamba_branch(cfg, p, x, state, scan=selective_scan):
    """x (B, T, d); ``state`` {"conv", "ssm"} before the first token ->
    (out (B, T, d), {"conv", "ssm"} after the last)."""
    dt_ = x.dtype
    xz = x @ p["w_in"].to(dt_)
    di = _inner(cfg)
    xin, z = xz[..., :di], xz[..., di:]
    y, conv_s, ssm_s = _mamba_core(cfg, p, xin, state["conv"], state["ssm"],
                                   scan)
    y = y * F.silu(z.float()).to(dt_)
    return y @ p["w_out"].to(dt_), {"conv": conv_s, "ssm": ssm_s}


# ---------------------------------------------------------------------------
# Hybrid layer

def layer_decls(cfg) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "ln1": norm_decls(cfg), "ln2": norm_decls(cfg),
        "attn": {"wq": Param((d, cfg.attn_out_dim)),
                 "wk": Param((d, cfg.kv_out_dim)),
                 "wv": Param((d, cfg.kv_out_dim)),
                 "wo": Param((cfg.attn_out_dim, d))},
        "mamba": mamba_decls(cfg),
        "norm_attn": {"scale": Param((d,), "ones")},
        "norm_ssm": {"scale": Param((d,), "ones")},
        "beta": Param((2,), "ones", dtype=F32),
        "mlp": _mlp_decls(cfg),
    }


def decls(cfg) -> Dict[str, Any]:
    vpad = cfg.padded_vocab()
    return {
        "embed": Param((vpad, cfg.d_model), "embed"),
        "meta_tokens": Param((cfg.n_meta_tokens, cfg.d_model), "embed"),
        "final_norm": norm_decls(cfg),
        "lm_head": Param((cfg.d_model, vpad)),
        "layers": stack_decls(layer_decls(cfg), cfg.n_layers),
    }


def init_state(cfg, batch: int, cache_len: int, device="cpu"):
    """The decode state (module docstring): the sliding window's KV ring of
    W = min(cache_len, window) positions and the Mamba states, per layer."""
    win = min(cache_len, cfg.sliding_window or cache_len)
    L, di = cfg.n_layers, _inner(cfg)
    dt = cdtype(cfg)
    kv = attn.init_cache(cfg, batch, win, device=device)
    return dict(
        kv,
        conv=torch.zeros((L, batch, cfg.ssm.conv_dim - 1, di), dtype=dt,
                         device=device),
        ssm=torch.zeros((L, batch, di, cfg.ssm.state_dim),
                        dtype=torch.float32, device=device))


def _fuse(p, x, oa, om):
    """Both branches RMS-normed, weighted by beta and summed in f32, then
    added to the residual in x's dtype."""
    beta = p["beta"].float()
    fused = (beta[0] * rmsnorm(oa, p["norm_attn"]["scale"]).float()
             + beta[1] * rmsnorm(om, p["norm_ssm"]["scale"]).float())
    return x + fused.to(x.dtype)


def _layer_prefill(cfg, p, x, positions, mamba_state, train=False):
    """One layer over x (B, S, d): attention through K7 and the serving
    scan, or with ``train`` through ``attn_prefill_einsum`` and
    ``selective_scan_autograd``."""
    b, s, _ = x.shape
    h = apply_norm(cfg, p["ln1"], x)
    q, k, v = _qkv(cfg, p["attn"], h)
    q = apply_rope(q.reshape(b, s, cfg.n_heads, cfg.d_head), positions,
                   cfg.rope_theta, cfg.rotary_pct)
    k = apply_rope(k.reshape(b, s, cfg.n_kv_heads, cfg.d_head), positions,
                   cfg.rope_theta, cfg.rotary_pct)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    attend = attn.attn_prefill_einsum if train else attn.attn_prefill
    oa = attend(q, k, v, causal=True, window=cfg.sliding_window)
    oa = oa.reshape(b, s, cfg.attn_out_dim) @ p["attn"]["wo"].to(x.dtype)
    om, mamba_state = mamba_branch(
        cfg, p["mamba"], h, mamba_state,
        selective_scan_autograd if train else selective_scan)
    x = _fuse(p, x, oa, om)
    x = x + mlp_apply(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
    return x, (k.transpose(1, 2), v.transpose(1, 2)), mamba_state


def _with_meta(cfg, params, tokens):
    x = embed_tokens(cfg, params, tokens)
    meta = params["meta_tokens"].to(x.dtype)
    return torch.cat([meta.expand(x.shape[0], *meta.shape), x], dim=1)


def forward(cfg, params, batch):
    """Training forward: meta tokens + the whole sequence through every
    layer from zero Mamba states.  Returns (logits, hidden, aux), aux 0;
    the logits cover the meta tokens too (``Model.loss`` keeps the
    text's)."""
    x = _with_meta(cfg, params, batch["tokens"])
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    di = _inner(cfg)
    st0 = {"conv": torch.zeros((b, cfg.ssm.conv_dim - 1, di),
                               dtype=x.dtype, device=x.device),
           "ssm": torch.zeros((b, di, cfg.ssm.state_dim),
                              dtype=torch.float32, device=x.device)}
    for p in unstacked_layers(params["layers"], cfg.n_layers):
        x = _layer_prefill(cfg, p, x, positions, st0, train=True)[0]
    h = apply_norm(cfg, params["final_norm"], x)
    return (logits_from_hidden(cfg, params, h), h,
            torch.zeros((), dtype=torch.float32, device=x.device))


@torch.no_grad()
def prefill(cfg, params, batch, cache_len: int):
    """Meta tokens + prompt through every layer.  Returns (state,
    last_hidden, h_all): the ring holds the last W positions in ring order
    (position p at slot p % W) when the sequence fills it, else positions
    0..s-1 with zeros after."""
    x = _with_meta(cfg, params, batch["tokens"])
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    state = init_state(cfg, b, cache_len, device=x.device)
    win = state["k"].shape[3]
    for l in range(cfg.n_layers):
        st = {"conv": state["conv"][l], "ssm": state["ssm"][l]}
        x, (k, v), st = _layer_prefill(cfg, layer_params(params, l), x,
                                       positions, st)
        if s >= win:
            # entry j holds position s-win+j, which belongs at ring slot
            # (s-win+j) % win: roll by (s-win) % win
            k = torch.roll(k[:, :, -win:], (s - win) % win, dims=2)
            v = torch.roll(v[:, :, -win:], (s - win) % win, dims=2)
        state["k"][l, :, :, :min(s, win)] = k.to(state["k"].dtype)
        state["v"][l, :, :, :min(s, win)] = v.to(state["v"].dtype)
        state["conv"][l] = st["conv"]
        state["ssm"][l] = st["ssm"]
    h = apply_norm(cfg, params["final_norm"], x)
    return state, h[:, -1], h


@torch.no_grad()
def decode_step(cfg, params, token, state, pos, *, write_mask=None):
    """One-token decode: token (B,), pos (B,) absolute positions (meta
    tokens included).  Attention reads the ring through K6 with the
    current token as ``extra_kv``; the state is updated IN PLACE.
    ``write_mask`` is taken for the serving engine's uniform call and
    ignored, as the JAX registry's wrapper ignores it.  Returns (logits,
    hidden, state)."""
    b = token.shape[0]
    x = embed_tokens(cfg, params, token)
    win = state["k"].shape[3]
    pos = pos.to(torch.int32).expand(b)
    slot, valid = attn.decode_valid_mask(pos, b, win, win)
    rope = rope_tables(pos[:, None], cfg.d_head, cfg.rope_theta,
                       cfg.rotary_pct)                # one for every layer
    ks, vs = [], []
    for l in range(cfg.n_layers):
        p = layer_params(params, l)
        h = apply_norm(cfg, p["ln1"], x[:, None, :])[:, 0]
        q, k, v = _qkv(cfg, p["attn"], h)
        q = apply_rope_tables(q.reshape(b, 1, cfg.n_heads, cfg.d_head),
                              rope)[:, 0]
        k = apply_rope_tables(k.reshape(b, 1, cfg.n_kv_heads, cfg.d_head),
                              rope)[:, 0]
        v = v.reshape(b, cfg.n_kv_heads, cfg.d_head)
        oa = attn.attn_decode(q, {"k": state["k"][l], "v": state["v"][l]},
                              valid, x.dtype, extra_kv=(k, v))
        oa = oa.reshape(b, cfg.attn_out_dim) @ p["attn"]["wo"].to(x.dtype)
        st = {"conv": state["conv"][l], "ssm": state["ssm"][l]}
        om, st = mamba_branch(cfg, p["mamba"], h[:, None, :], st)
        state["conv"][l] = st["conv"]
        state["ssm"][l] = st["ssm"]
        x = _fuse(p, x, oa, om[:, 0])
        h2 = apply_norm(cfg, p["ln2"], x[:, None, :])
        x = x + mlp_apply(cfg, p["mlp"], h2)[:, 0]
        ks.append(k)
        vs.append(v)
    attn.cache_write_stacked(state, torch.stack(ks), torch.stack(vs), slot)
    h = apply_norm(cfg, params["final_norm"], x[:, None, :])[:, 0]
    return logits_from_hidden(cfg, params, h), h, state
