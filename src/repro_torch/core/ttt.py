"""TTT inner/outer loops (paper Section 3.2-3.3, Algorithm 1), PyTorch.

Inner loop (per reasoning trajectory, *score-then-update*):
    s_t  = sigma(W_{t-1} . z_Q(phi_t) + b_{t-1})
    l    = (sigma(W_{t-1} . z_K(phi_t) + b_{t-1}) - C_t)^2
    W_t  = W_{t-1} - eta * grad_W l           (online gradient descent)

The unroll is a Python loop over T on a (N, f) batch of fast weights —
the JAX package's ``lax.scan`` under ``vmap`` written out — and the outer
loop differentiates through it with torch autograd in place of
``jax.value_and_grad``.  Only the scan path is ported: the offline Pallas
scan kernel (``kernel=``) is not, as on the JAX package's main path.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import probe as P
from repro_torch.core.probe import ProbeConfig


class UnrollOut(NamedTuple):
    scores: torch.Tensor         # raw (unsmoothed) probe scores, (..., T)
    fast_final: Tuple[torch.Tensor, torch.Tensor]


def _unroll(pc: ProbeConfig, theta, phis, inner_labels, mask) -> UnrollOut:
    """phis (N, T, d_phi); inner_labels/mask (N, T) -> scores (N, T)."""
    n, T = phis.shape[:2]
    eta = P.inner_lr(pc, theta)
    zq, zk = P.features(pc, theta, phis)               # (N, T, f)
    c = (torch.zeros((n, T), dtype=torch.float32, device=phis.device)
         if inner_labels is None else inner_labels.float())
    m = (torch.ones((n, T), dtype=torch.float32, device=phis.device)
         if mask is None else mask.float())
    W0, b0 = P.fast_init(pc, theta)
    W = W0.expand(n, W0.shape[-1])
    b = b0.expand(n)
    trunc = pc.bptt_truncation
    scores = []
    for t in range(T):
        s_t, W_new, b_new = P.score_then_update(W, b, zq[:, t], zk[:, t],
                                                c[:, t], m[:, t], eta)
        if trunc > 0 and t % trunc == 0:
            W_new, b_new = W_new.detach(), b_new.detach()
        W, b = W_new, b_new
        scores.append(s_t)
    s = (torch.stack(scores, dim=1) if scores
         else torch.zeros((n, 0), device=phis.device))
    return UnrollOut(s, (W, b))


def inner_unroll(pc: ProbeConfig, theta, phis: torch.Tensor,
                 inner_labels: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None) -> UnrollOut:
    """Unroll the TTT inner loop over one trajectory: phis (T, d_phi);
    inner_labels (T,) or None (=> zeros, inference mode); mask (T,)."""
    out = _unroll(pc, theta, phis[None],
                  None if inner_labels is None else inner_labels[None],
                  None if mask is None else mask[None])
    return UnrollOut(out.scores[0], (out.fast_final[0][0],
                                     out.fast_final[1][0]))


def batched_unroll(pc: ProbeConfig, theta, phis, inner_labels=None,
                   mask=None) -> torch.Tensor:
    """phis (N, T, d_phi) -> scores (N, T)."""
    return _unroll(pc, theta, phis, inner_labels, mask).scores


# ---------------------------------------------------------------------------
# Outer (meta) objective — Algorithm 1

def outer_loss(pc: ProbeConfig, theta, phis, labels, mask=None) -> torch.Tensor:
    """Mean over problems of sum_t m_t (s_t - C_t^true)^2."""
    inner = None if pc.inner_label_mode == "zero" else labels
    scores = batched_unroll(pc, theta, phis, inner_labels=inner, mask=mask)
    m = torch.ones_like(scores) if mask is None else mask.to(scores.dtype)
    per_problem = torch.sum(m * torch.square(scores - labels), dim=-1)
    return per_problem.mean()


def meta_train(pc: ProbeConfig, theta: Dict[str, torch.Tensor], optimizer,
               phis, labels, mask, *, epochs: int, batch_size: int,
               generator: Optional[torch.Generator] = None,
               eval_fn: Optional[Callable] = None, verbose: bool = False):
    """Full outer-loop training (Algorithm 1). Returns (theta, history).

    The minibatch order comes from ``generator`` (``torch.randperm``), so
    it differs from the JAX package's for one seed; a full-batch run
    (``batch_size == N``) is order-free up to summation order."""
    n = phis.shape[0]
    theta = {k: v.detach().clone() for k, v in theta.items()}
    opt_state = optimizer.init(theta)
    labels = labels.float()
    history = []
    for epoch in range(epochs):
        order = torch.randperm(n, generator=generator).to(phis.device)
        losses = []
        for i in range(0, n - batch_size + 1, batch_size):
            idx = order[i:i + batch_size]
            leaves = {k: v.requires_grad_(True) for k, v in theta.items()}
            loss = outer_loss(pc, leaves, phis[idx], labels[idx], mask[idx])
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
            grads = {k: (g if g is not None else torch.zeros_like(v))
                     for (k, v), g in zip(leaves.items(), grads)}
            updates, opt_state = optimizer.update(grads, opt_state, theta)
            theta = {k: (v.detach() + updates[k]) for k, v in theta.items()}
            losses.append(float(loss.detach()))
        rec = {"epoch": epoch + 1, "loss": sum(losses) / max(len(losses), 1)}
        if eval_fn is not None:
            rec.update(eval_fn(theta))
        history.append(rec)
        if verbose:
            print(f"[meta] epoch {rec['epoch']:3d} loss {rec['loss']:.4f}")
    return theta, history


# ---------------------------------------------------------------------------
# Deployment-time score trajectories (the "deployed procedure" scores)

@torch.no_grad()
def deployed_scores(pc: ProbeConfig, theta, phis, mask=None) -> torch.Tensor:
    """Scores produced by the deployed procedure (C_t = 0 inner updates),
    smoothed with the configured rolling window.  phis (N,T,d) -> (N,T)."""
    raw = batched_unroll(pc, theta, phis, inner_labels=None, mask=mask)
    return P.smooth_scores(raw, pc.smooth_window)
