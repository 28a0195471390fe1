"""TTT inner/outer loops (paper Section 3.2-3.3, Algorithm 1), PyTorch.

Inner loop (per reasoning trajectory, *score-then-update*):
    s_t  = sigma(W_{t-1} . z_Q(phi_t) + b_{t-1})
    l    = (sigma(W_{t-1} . z_K(phi_t) + b_{t-1}) - C_t)^2
    W_t  = W_{t-1} - eta * grad_W l           (online gradient descent)

The differentiable unroll is a Python loop over T on a (N, f) batch of
fast weights — the JAX package's ``lax.scan`` under ``vmap`` written out —
and the outer loop (``outer_loss``, ``meta_train``) differentiates through
it with torch autograd in place of ``jax.value_and_grad``.

``kernel=`` keeps the JAX meaning: a callable (zq, zk, c, m, W0, b0, eta)
-> (scores, W_f, b_f) for ONE trajectory replaces the step loop
(``repro_torch.kernels.ttt_scan.make_unroll_kernel`` is K5's);
``batched_unroll`` calls it per trajectory, as ``vmap`` would.  The
forward-only, label-free ``deployed_scores`` always runs the whole batch
through K5's ``ttt_probe_scan`` (its plain version on CPU tensors), where
the JAX package defaults to ``lax.scan`` with the kernel opt-in.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import probe as P
from repro_torch.core.probe import ProbeConfig
from repro_torch.kernels import ttt_scan


class UnrollOut(NamedTuple):
    scores: torch.Tensor         # raw (unsmoothed) probe scores, (..., T)
    fast_final: Tuple[torch.Tensor, torch.Tensor]


def _labels_and_mask(phis, inner_labels, mask):
    """Inner labels (zeros: inference mode) and update mask, f32, shaped
    like ``phis`` without its feature axis."""
    shape, dev = phis.shape[:-1], phis.device
    c = (torch.zeros(shape, dtype=torch.float32, device=dev)
         if inner_labels is None else inner_labels.float())
    m = (torch.ones(shape, dtype=torch.float32, device=dev)
         if mask is None else mask.float())
    return c, m


def _unroll(pc: ProbeConfig, theta, phis, inner_labels, mask) -> UnrollOut:
    """phis (N, T, d_phi); inner_labels/mask (N, T) -> scores (N, T)."""
    n, T = phis.shape[:2]
    eta = P.inner_lr(pc, theta)
    zq, zk = P.features(pc, theta, phis)               # (N, T, f)
    c, m = _labels_and_mask(phis, inner_labels, mask)
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
                 mask: Optional[torch.Tensor] = None,
                 kernel: Optional[Callable] = None) -> UnrollOut:
    """Unroll the TTT inner loop over one trajectory: phis (T, d_phi);
    inner_labels (T,) or None (=> zeros, inference mode); mask (T,).
    ``kernel`` optionally swaps the step loop for a fused implementation."""
    if kernel is not None:
        zq, zk = P.features(pc, theta, phis)          # (T, f)
        c, m = _labels_and_mask(phis, inner_labels, mask)
        scores, W_f, b_f = kernel(zq, zk, c, m, theta["W0"], theta["b0"],
                                  P.inner_lr(pc, theta))
        return UnrollOut(scores, (W_f, b_f))
    out = _unroll(pc, theta, phis[None],
                  None if inner_labels is None else inner_labels[None],
                  None if mask is None else mask[None])
    return UnrollOut(out.scores[0], (out.fast_final[0][0],
                                     out.fast_final[1][0]))


def batched_unroll(pc: ProbeConfig, theta, phis, inner_labels=None,
                   mask=None, kernel: Optional[Callable] = None
                   ) -> torch.Tensor:
    """phis (N, T, d_phi) -> scores (N, T)."""
    if kernel is None:
        return _unroll(pc, theta, phis, inner_labels, mask).scores
    c, m = _labels_and_mask(phis, inner_labels, mask)
    rows = [inner_unroll(pc, theta, phis[i], c[i], m[i], kernel).scores
            for i in range(phis.shape[0])]
    return (torch.stack(rows) if rows
            else torch.zeros(phis.shape[:2], device=phis.device))


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
def deployed_scores(pc: ProbeConfig, theta, phis, mask=None,
                    kernel: Optional[Callable] = None) -> torch.Tensor:
    """Scores produced by the deployed procedure (C_t = 0 inner updates),
    smoothed with the configured rolling window.  phis (N,T,d) -> (N,T).

    Updating past the stopping time does not change s_1..s_tau (updates
    are causal and label-free), so one pass serves every threshold lambda.
    The pass is forward only, so the slow weights enter it detached: with
    ``kernel=None`` the batch goes through K5 (``ttt_scan.ttt_probe_scan``)
    in one launch on the card; a ``kernel`` callable runs per trajectory."""
    theta = {k: v.detach() for k, v in theta.items()}
    if kernel is not None:
        raw = batched_unroll(pc, theta, phis, inner_labels=None, mask=mask,
                             kernel=kernel)
    else:
        zq, zk = P.features(pc, theta, phis)
        c, m = _labels_and_mask(phis, None, mask)
        W0, b0 = P.fast_init(pc, theta)
        raw, _, _ = ttt_scan.ttt_probe_scan(
            zq.contiguous(), zk.contiguous(), c, m.contiguous(),
            W0.float().contiguous(), b0.float(), P.inner_lr(pc, theta))
    return P.smooth_scores(raw, pc.smooth_window)
