"""Mixture-of-Experts block: top-k token-choice routing (PyTorch).

The JAX package's ``models/moe.py`` on one device: ``moe_dense``, the
oracle path, runs every expert on every token and combines their outputs
through the top-k gates.  Its expert-parallel path (``moe_ep``, experts
sharded over a mesh axis with capacity dropping) belongs to the
multi-device port and is not here.

Leaves, per layer (stacked with a leading L axis by the transformer):

    router   (d, E)      float32: read through a float32 cast, kept so
    w_gate   (E, d, f)   x @ w_gate[e]
    w_up     (E, d, f)
    w_down   (E, f, d)

The JAX block returns the router's aux loss (GShard load balance on the
top-1 expert plus the z-loss) beside its output for the train loss:
``moe_block`` does so for the training forward, while ``moe_dense``, the
served MLP, returns the output alone and computes no aux loss.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.common import Param, swiglu


def moe_decls(cfg) -> Dict[str, Param]:
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": Param((d, E), "small", dtype="float32"),
        "w_gate": Param((E, d, f)),
        "w_up": Param((E, d, f)),
        "w_down": Param((E, f, d)),
    }


def _router(params, x, cfg):
    """x (T, d) -> logits (T, E), probs (T, E), gates (T, k), idx (T, k):
    float32 logits, softmax, the top-k probabilities renormalised."""
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gates, idx


def router_aux(logits, probs, idx, cfg) -> torch.Tensor:
    """The aux loss JAX's ``_router`` returns: the GShard load-balance
    term on each token's top-1 expert plus the z-loss."""
    E = cfg.moe.n_experts
    me = probs.mean(0)                                # mean prob per expert
    ce = torch.nn.functional.one_hot(idx[:, 0], E).float().mean(0)
    aux = E * torch.sum(me * ce) * cfg.moe.router_aux_coef
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return aux + z * cfg.moe.router_z_coef


def _expert_ffn(w_gate, w_up, w_down, x):
    """x (T, d), the stacked experts' weights -> (E, T, d): three batched
    products, every expert on every token."""
    h = swiglu(torch.matmul(x, w_gate), torch.matmul(x, w_up))
    return torch.bmm(h, w_down)


def moe_dense(params, x, cfg) -> torch.Tensor:
    """Oracle: run all experts on all tokens. x (B, S, d) -> y (B, S, d).
    The experts run in the activation dtype; the gates combine their
    outputs in float32 and the sum is cast back."""
    return _moe(params, x, cfg)[0]


def moe_block(params, x, cfg):
    """The training forward's block, JAX's one-device ``moe_block``:
    ``moe_dense``'s output and the router's aux loss, (y, aux)."""
    y, (logits, probs, idx) = _moe(params, x, cfg)
    return y, router_aux(logits, probs, idx, cfg)


def _moe(params, x, cfg):
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    logits, probs, gates, idx = _router(params, xt, cfg)
    dt = x.dtype
    ye = _expert_ffn(params["w_gate"].to(dt), params["w_up"].to(dt),
                     params["w_down"].to(dt), xt)          # (E, T, d)
    comb = torch.zeros((b * s, cfg.moe.n_experts), dtype=torch.float32,
                       device=x.device).scatter_add_(1, idx, gates)
    y = torch.einsum("etd,te->td", ye.float(), comb)
    return y.reshape(b, s, d).to(dt), (logits, probs, idx)
