"""Mixture-of-Experts block: top-k token-choice routing (PyTorch).

The JAX package's ``models/moe.py``.  Two execution paths:

* ``moe_dense`` — the oracle: every expert runs on every token and the
  top-k gates combine their outputs.  It is the one-device path (the
  served MLP, the training forward outside a mesh) and the reference of
  the expert-parallel one.
* ``moe_ep`` — the expert-parallel path: under a ``ParallelContext`` each
  rank holds the experts of its shard of the ``model`` axis; activations
  are replicated over that axis, so dispatch is local: each rank takes
  the top-capacity tokens of each of its experts (GShard/Switch capacity
  dropping), runs them, scatter-adds into its f32 partial, and the
  partials are summed over ``model`` in the activation dtype.

``moe_block`` picks ``moe_ep`` under a context with ``ep_moe`` and
``moe_dense`` otherwise.

Leaves, per layer (stacked with a leading L axis by the transformer):

    router   (d, E)      float32: read through a float32 cast, kept so
    w_gate   (E, d, f)   x @ w_gate[e]
    w_up     (E, d, f)
    w_down   (E, f, d)

The JAX block returns the router's aux loss (GShard load balance on the
top-1 expert plus the z-loss) beside its output for the train loss:
``moe_block`` does so, while ``moe_dense``, the served MLP outside a mesh,
returns the output alone and computes no aux loss.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import parallel

from repro_torch.models.common import Param, swiglu


def moe_decls(cfg) -> Dict[str, Param]:
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": Param((d, E), (None, None), "small", dtype="float32"),
        "w_gate": Param((E, d, f), ("experts", "embed", "mlp")),
        "w_up": Param((E, d, f), ("experts", "embed", "mlp")),
        "w_down": Param((E, f, d), ("experts", "mlp", "embed")),
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
    """JAX's ``moe_block``: ``moe_ep`` under a context with ``ep_moe``,
    else ``moe_dense``'s output and the router's aux loss; (y, aux)."""
    ctx = parallel.current_ctx()
    if ctx is not None and ctx.ep_moe:
        return moe_ep(params, x, cfg, ctx)
    y, (logits, probs, idx) = _moe(params, x, cfg)
    return y, router_aux(logits, probs, idx, cfg)


def moe_ep(params, x, cfg, ctx: parallel.ParallelContext):
    """Expert-parallel path.  x (B, S, d) this data rank's rows, replicated
    over ``ctx.model_axis``; the expert leaves this rank's shard of E over
    that axis, the router whole.  Returns (y (B, S, d), aux), aux averaged
    over the data axes.

    Each local expert keeps its ``cap = int((T*k/E)*capacity_factor) + 1``
    highest-gated tokens of the rank's T (the rest are dropped); fillers
    score -1.0 and weigh nothing.  The gradient of x and of the gates from
    the local experts is summed over the model axis (``copy_to``), the
    combine passes it through (``reduce_from``)."""
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    ax = ctx.model_axis
    e_loc = params["w_gate"].shape[0]
    assert e_loc * ctx.axis_size(ax) == E, (e_loc, E)
    b, s, d = x.shape
    dt = x.dtype
    T = b * s
    xt = x.reshape(T, d)
    logits, probs, gates, idx = _router(params, xt, cfg)
    aux = router_aux(logits, probs, idx, cfg)
    cap = int((T * k / E) * cfg.moe.capacity_factor) + 1
    # score of each token for each local expert (0 if not routed there)
    local_ids = ctx.axis_rank(ax) * e_loc + torch.arange(e_loc,
                                                         device=x.device)
    xs, gs = parallel.copy_to(xt, ax), parallel.copy_to(gates, ax)
    sel = idx[None] == local_ids[:, None, None]                # (E_loc, T, k)
    score = torch.where(sel, gs[None], torch.zeros_like(gs[None])).sum(-1)
    routed = sel.any(-1)                                        # (E_loc, T)
    # top-capacity tokens per local expert (capacity dropping)
    top_scores, top_idx = torch.topk(
        torch.where(routed, score, torch.full_like(score, -1.0)),
        min(cap, T), dim=-1)                                    # (E_loc, C)
    keep = top_scores > 0.0
    xc = xs[top_idx.reshape(-1)].reshape(e_loc, -1, d).to(dt)
    h = swiglu(torch.bmm(xc, params["w_gate"].to(dt)),
               torch.bmm(xc, params["w_up"].to(dt)))
    yc = torch.bmm(h, params["w_down"].to(dt)).float()
    yc = yc * (top_scores * keep)[..., None]
    out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    out = out.index_add(0, top_idx.reshape(-1), yc.reshape(-1, d))
    # the combine in the activation dtype (JAX's bf16 psum): each rank's
    # partial is an f32 accumulation, only the cross-rank sum is in dt
    out = parallel.reduce_from(out.to(dt), ax).float()
    # aux is the same on every model rank and differs across data ranks:
    # their mean, replicated
    for a in ctx.data_axes:
        n = ctx.axis_size(a)
        if n > 1:
            aux = parallel.reduce_from(aux, a) / n
    return out.reshape(b, s, d).to(dt), aux


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
