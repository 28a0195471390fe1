"""RWKV6 "Finch" (PyTorch) — attention-free WKV recurrence with
data-dependent decay.  [arXiv:2404.05892]

Per head h with key/value dims d:

    out_t = r_t^T (diag(u) k_t v_t^T + S_{t-1})
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T

where w_t = exp(-exp(w0 + tanh(x_w A) B)) is the data-dependent decay.
Module for module the JAX package's ``repro/models/rwkv6.py``: the same
parameter names and layouts (every per-layer leaf stacked on a leading L
axis), the same casts.  The layer loop is a Python loop; the recurrence
runs through K8 (``repro_torch.kernels.rwkv6_scan``) on the card, on every
prefill and every decode step.

The state is O(1) in the context: ``wkv`` (L, B, H, d, d) f32 and the
token-shift states ``tm_x`` / ``cm_x`` (L, B, d_model).  ``prefill`` builds
it and ``decode_step`` updates it IN PLACE (K8 writes each layer's final
WKV state straight into it), as the transformer's decode updates its cache.

``forward``, the training forward, runs the recurrence through
``wkv_recurrence`` instead: plain PyTorch that autograd walks, the
counterpart of JAX's ``lax.scan`` ``wkv_scan`` (K8 has no backward in
either package).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import parallel
from repro_torch.kernels.rwkv6_scan import wkv_scan as wkv_kernel
from repro_torch.models.common import (Param, cdtype, layernorm, relu_sq,
                                       stack_decls, vocab_embed,
                                       vocab_logits)
from repro_torch.models.transformer import (layer_params, run_layers,
                                            unstacked_layers)

DECAY_LORA = 64
F32 = "float32"


def layer_decls(cfg) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    H, dh = cfg.n_heads, cfg.ssm.head_dim
    assert H * dh == d
    ln = lambda: {"scale": Param((d,), (None,), "ones", dtype=F32),
                  "bias": Param((d,), (None,), "zeros", dtype=F32)}
    return {
        "ln1": ln(), "ln2": ln(),
        "tm": {
            "mu": Param((5, d), (None, None), "small"),   # r,k,v,w,g shifts
            "w0": Param((d,), (None,), "small", dtype=F32),
            "wA": Param((d, DECAY_LORA), ("embed", None), "small"),
            "wB": Param((DECAY_LORA, d), (None, "embed"), "small"),
            "u": Param((H, dh), ("heads", None), "small", dtype=F32),
            "Wr": Param((d, d), ("embed", "qkv")),
            "Wk": Param((d, d), ("embed", "qkv")),
            "Wv": Param((d, d), ("embed", "qkv")),
            "Wg": Param((d, d), ("embed", "qkv")),
            "Wo": Param((d, d), ("qkv", "embed")),
            "gn_scale": Param((d,), (None,), "ones", dtype=F32),
            "gn_bias": Param((d,), (None,), "zeros", dtype=F32),
        },
        "cm": {
            "mu_k": Param((d,), (None,), "small"),
            "mu_r": Param((d,), (None,), "small"),
            "Wk": Param((d, f), ("embed", "mlp")),
            "Wv": Param((f, d), ("mlp", "embed")),
            "Wr": Param((d, d), ("embed", "embed2")),
        },
    }


def decls(cfg) -> Dict[str, Any]:
    vpad, d = cfg.padded_vocab(), cfg.d_model
    norm = lambda: {"scale": Param((d,), (None,), "ones", dtype=F32),
                    "bias": Param((d,), (None,), "zeros", dtype=F32)}
    return {
        "embed": Param((vpad, d), ("vocab", "embed"), "embed"),
        "ln0": norm(),
        "final_norm": norm(),
        "lm_head": Param((d, vpad), ("embed", "vocab")),
        "layers": stack_decls(layer_decls(cfg), cfg.n_layers, "layers"),
    }


def _group_norm(x, scale, bias, n_groups, eps=64e-5):
    """x (..., d) grouped into n_groups; f32 out."""
    shp = x.shape
    xg = x.reshape(shp[:-1] + (n_groups, shp[-1] // n_groups)).float()
    mu = xg.mean(-1, keepdim=True)
    var = xg.var(-1, unbiased=False, keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return (xg.reshape(shp) * scale + bias).float()


def decay_from_x(tm, xw):
    """Data-dependent decay (the RWKV6 novelty): the LoRA in xw's dtype,
    then exp(-exp(.)) in f32.  xw (..., d) -> w in (0, 1)."""
    dt = xw.dtype
    lora = torch.tanh(xw @ tm["wA"].to(dt)) @ tm["wB"].to(dt)
    logw = tm["w0"].float() + lora.float()
    return torch.exp(-torch.exp(logw))


def wkv_scan(r, k, v, w, u, state0, state_out=None):
    """The WKV recurrence: K8 on the card, its plain version on the CPU.
    r, k, v (B, T, H, dh) go in their compute dtype (bf16 or f32: K8 widens
    bf16 on load and the plain version casts, as the Pallas kernel casts
    every input to f32); w (B, T, H, dh) and u (H, dh) as f32; state0 (B,
    H, dh, dh) f32.  The final state lands in ``state_out`` when given
    (``state0`` itself for an in-place update).  Returns (out (B, T, H, dh)
    f32, state_T)."""
    if r.dtype not in (torch.bfloat16, torch.float32):
        r, k, v = r.float(), k.float(), v.float()
    f32 = lambda t: t.float().contiguous()
    return wkv_kernel(r.contiguous(), k.contiguous(), v.contiguous(), f32(w),
                      f32(u), state0, state_out=state_out)


def wkv_recurrence(r, k, v, w, u, state0):
    """The WKV recurrence token by token in f32, differentiable (JAX's
    ``wkv_scan``): out_t = r_t S_{t-1} + (r_t . u k_t) v_t and S_t =
    diag(w_t) S_{t-1} + k_t v_t^T.  r, k, v, w (B, T, H, dh); u (H, dh);
    state0 (B, H, dh, dh).  Autograd keeps one state a token; the tokens
    are taken apart by one ``unbind`` each (its backward is one stack).
    Returns (out (B, T, H, dh) f32, state_T)."""
    u = u.float()
    S = state0.float()
    outs = []
    for r_t, k_t, v_t, w_t in zip(*(x.float().unbind(1)
                                    for x in (r, k, v, w))):
        bonus = (r_t * u * k_t).sum(-1, keepdim=True)
        outs.append(torch.einsum("bhk,bhkv->bhv", r_t, S) + bonus * v_t)
        S = w_t[..., None] * S + k_t[..., :, None] * v_t[..., None, :]
    return torch.stack(outs, dim=1), S


def _shift(x, x_prev):
    """Token shift: the previous token's values.  x (B, T, d); x_prev
    (B, d) carried state."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def time_mix(cfg, tm, x, x_prev, state0, state_out=None, train=False):
    """x (B, T, d).  Returns (out, new_x_prev, new_state).  ``train`` runs
    the recurrence through ``wkv_recurrence`` (autograd), else through
    ``wkv_scan`` (K8 on the card)."""
    b, t, d = x.shape
    H, dh = cfg.n_heads, cfg.ssm.head_dim
    xs = _shift(x, x_prev)
    mu = tm["mu"].to(x.dtype)
    xr = x + (xs - x) * mu[0]
    xk = x + (xs - x) * mu[1]
    xv = x + (xs - x) * mu[2]
    xw = x + (xs - x) * mu[3]
    xg = x + (xs - x) * mu[4]
    dt = x.dtype
    r = (xr @ tm["Wr"].to(dt)).reshape(b, t, H, dh)
    k = (xk @ tm["Wk"].to(dt)).reshape(b, t, H, dh)
    v = (xv @ tm["Wv"].to(dt)).reshape(b, t, H, dh)
    g = xg @ tm["Wg"].to(dt)
    w = decay_from_x(tm, xw).reshape(b, t, H, dh)
    if train:
        out, state = wkv_recurrence(r, k, v, w, tm["u"], state0)
    else:
        out, state = wkv_scan(r, k, v, w, tm["u"].float(), state0,
                              state_out)
    out = _group_norm(out.reshape(b, t, d), tm["gn_scale"].float(),
                      tm["gn_bias"].float(), H)
    out = out.to(dt) * torch.nn.functional.silu(g.float()).to(dt)
    return out @ tm["Wo"].to(dt), x[:, -1], state


def channel_mix(cfg, cm, x, x_prev):
    xs = _shift(x, x_prev)
    dt = x.dtype
    xk = x + (xs - x) * cm["mu_k"].to(dt)
    xr = x + (xs - x) * cm["mu_r"].to(dt)
    kk = relu_sq(xk @ cm["Wk"].to(dt))
    r = torch.sigmoid((xr @ cm["Wr"].to(dt)).float()).to(dt)
    return r * (kk @ cm["Wv"].to(dt)), x[:, -1]


def init_state(cfg, batch: int, device="cpu"):
    """Recurrent state per layer stack: WKV state + token-shift states."""
    H, dh = cfg.n_heads, cfg.ssm.head_dim
    L, d = cfg.n_layers, cfg.d_model
    dt = cdtype(cfg)
    return {
        "wkv": torch.zeros((L, batch, H, dh, dh), dtype=torch.float32,
                           device=device),
        "tm_x": torch.zeros((L, batch, d), dtype=dt, device=device),
        "cm_x": torch.zeros((L, batch, d), dtype=dt, device=device),
    }


def _layer(cfg, p, x, st):
    """One block on x (B, T, d); ``st`` holds this layer's views of the
    state (``wkv`` (B, H, dh, dh), ``tm_x`` / ``cm_x`` (B, d)), read as
    the carried state and overwritten with the new one."""
    h = layernorm(x, p["ln1"]["scale"], p["ln1"]["bias"])
    out, tm_x, _ = time_mix(cfg, p["tm"], h, st["tm_x"], st["wkv"],
                            state_out=st["wkv"])
    x = x + out
    h = layernorm(x, p["ln2"]["scale"], p["ln2"]["bias"])
    out, cm_x = channel_mix(cfg, p["cm"], h, st["cm_x"])
    st["tm_x"].copy_(tm_x)
    st["cm_x"].copy_(cm_x)
    return x + out


def _embed(cfg, params, tokens):
    x = vocab_embed(params["embed"], tokens, cdtype(cfg), cfg.padded_vocab())
    return layernorm(x, params["ln0"]["scale"], params["ln0"]["bias"])


def _run_layers(cfg, params, x, state):
    for l in range(cfg.n_layers):
        x = _layer(cfg, layer_params(params, l), x,
                   {key: val[l] for key, val in state.items()})
    return layernorm(x, params["final_norm"]["scale"],
                     params["final_norm"]["bias"])


def forward(cfg, params, batch):
    """Training forward over whole sequences, from the zero state.
    Returns (logits, hidden, aux), aux 0."""
    x = parallel.constrain(_embed(cfg, params, batch["tokens"]),
                           "batch", None, None)
    b, _, d = x.shape
    zero_x = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    H, dh = cfg.n_heads, cfg.ssm.head_dim
    zero_s = torch.zeros((b, H, dh, dh), dtype=torch.float32,
                         device=x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    def layer(p, x):
        h = layernorm(x, p["ln1"]["scale"], p["ln1"]["bias"])
        x = x + time_mix(cfg, p["tm"], h, zero_x, zero_s, train=True)[0]
        h = layernorm(x, p["ln2"]["scale"], p["ln2"]["bias"])
        return x + channel_mix(cfg, p["cm"], h, zero_x)[0], zero

    x, aux = run_layers(layer, x, unstacked_layers(params["layers"],
                                                   cfg.n_layers))
    h = layernorm(x, params["final_norm"]["scale"],
                  params["final_norm"]["bias"])
    logits = vocab_logits(h, params["lm_head"], cfg.padded_vocab())
    return parallel.constrain(logits, "batch", None, "vocab"), h, aux


@torch.no_grad()
def prefill(cfg, params, batch, cache_len: int = 0):
    """Returns (state, last_hidden, hidden_all); cache_len unused (O(1)
    state)."""
    x = _embed(cfg, params, batch["tokens"])
    state = init_state(cfg, x.shape[0], device=x.device)
    h = _run_layers(cfg, params, x, state)
    return state, h[:, -1], h


@torch.no_grad()
def decode_step(cfg, params, token, state, pos, *, write_mask=None):
    """One-token decode: token (B,).  The state carries WKV + shift states,
    O(1) in the context, and is updated IN PLACE; ``pos`` and
    ``write_mask`` are taken for the serving engine's uniform call and
    ignored, as the JAX registry's wrapper ignores them.  Returns
    (logits, hidden, state)."""
    x = _embed(cfg, params, token)[:, None, :]              # (B, 1, d)
    h = _run_layers(cfg, params, x, state)[:, 0]
    logits = h @ params["lm_head"].to(h.dtype)
    return logits, h, state
