"""ORCA probe: architecture variants of the calibration scorer (PyTorch).

The probe scores a reasoning-step embedding phi_t in R^{d_phi}:

    s_t = sigma( W . z_Q(phi_t) + b )          (score view)
    l_t = ( sigma( W . z_K(phi_t) + b ) - C_t )^2   (update view, Brier)

Fast weights (W, b) are updated online at inference
(``repro_torch.core.ttt``); the feature maps z_Q / z_K and the
initialization (W0, b0, eta) are slow weights meta-learned in the outer
loop.  Slow weights are a dict of float32 tensors with the JAX package's
names and layouts (``W0`` (f,), ``b0`` (), ``theta_q`` (d_phi, d_h), ...).

Variants (paper Section 3.3 + Table 6): no-QK, QK, +layernorm, +residual,
+shared QK, +mlp, learnable eta.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class ProbeConfig:
    d_phi: int
    variant: str = "noqk"        # noqk | qk
    d_h: int = 128
    layernorm: bool = False
    residual: bool = False
    shared_qk: bool = False
    mlp: bool = False
    learnable_eta: bool = False
    eta: float = 0.01            # inner learning rate (init if learnable)
    inner_label_mode: str = "zero"   # zero (inference-consistent) | true
    bptt_truncation: int = 0     # 0 = full backprop through the unroll
    smooth_window: int = 10      # rolling-mean smoothing of the score traj

    @property
    def feat_dim(self) -> int:
        return self.d_phi if self.variant == "noqk" else self.d_h


def init_outer(pc: ProbeConfig, generator: Optional[torch.Generator] = None,
               device=None) -> Dict[str, torch.Tensor]:
    """Slow weights Theta_outer = (theta_{Q,K}, W0, b0, [eta]).

    Same shapes and scales as the JAX package; the draws come from a
    ``torch.Generator`` (CPU), so they differ from ``jax.random`` for one
    seed — parity tests carry the JAX theta over instead."""
    d = pc.feat_dim

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    theta: Dict[str, torch.Tensor] = {
        "W0": normal(d) / math.sqrt(d),
        "b0": torch.zeros((), dtype=torch.float32),
    }
    if pc.variant == "qk":
        scale = 1.0 / math.sqrt(pc.d_phi)
        theta["theta_q"] = normal(pc.d_phi, pc.d_h) * scale
        if not pc.shared_qk:
            theta["theta_k"] = normal(pc.d_phi, pc.d_h) * scale
        if pc.layernorm:
            theta["ln_scale"] = torch.ones(pc.d_h)
            theta["ln_bias"] = torch.zeros(pc.d_h)
        if pc.mlp:
            theta["mlp_w"] = normal(pc.d_h, pc.d_h) / math.sqrt(pc.d_h)
            theta["mlp_b"] = torch.zeros(pc.d_h)
    if pc.learnable_eta:
        theta["log_eta"] = torch.tensor(math.log(pc.eta), dtype=torch.float32)
    return {k: v.to(resolve_device(device)) for k, v in theta.items()}


def inner_lr(pc: ProbeConfig, theta) -> torch.Tensor:
    if pc.learnable_eta:
        return torch.exp(theta["log_eta"])
    return torch.tensor(pc.eta, dtype=torch.float32,
                        device=theta["W0"].device)


def _maybe_ln(pc: ProbeConfig, theta, z):
    if not pc.layernorm:
        return z
    mu = z.mean(-1, keepdim=True)
    var = z.var(-1, unbiased=False, keepdim=True)
    zn = (z - mu) * torch.rsqrt(var + 1e-6)
    return zn * theta["ln_scale"] + theta["ln_bias"]


def features(pc: ProbeConfig, theta, phi) -> Tuple[torch.Tensor, torch.Tensor]:
    """phi (..., d_phi) -> (z_Q, z_K), each (..., feat_dim)."""
    phi = phi.float()
    if pc.variant == "noqk":
        return phi, phi
    zq = phi @ theta["theta_q"]
    zk = zq if pc.shared_qk else phi @ theta.get("theta_k", theta["theta_q"])
    if pc.layernorm or pc.residual:
        zq_n = _maybe_ln(pc, theta, zq)
        zk_n = _maybe_ln(pc, theta, zk)
        if pc.residual:
            zq, zk = zq_n + zq, zk_n + zk
        else:
            zq, zk = zq_n, zk_n
    if pc.mlp:
        gelu = torch.nn.functional.gelu
        zq = gelu(zq @ theta["mlp_w"] + theta["mlp_b"], approximate="tanh")
        zk = gelu(zk @ theta["mlp_w"] + theta["mlp_b"], approximate="tanh")
    return zq, zk


def score_rows(W, b, z) -> torch.Tensor:
    """Row-wise fast weights: sigma(sum(z * W, -1) + b) — each row scored by
    its OWN (W_i, b_i), the layout of the serving engine's per-slot state."""
    return torch.sigmoid((z * W).sum(-1) + b)


def score_then_update(W, b, zq, zk, c, m, eta
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """THE inner-loop step (Algorithm 2 lines 8-16), row-wise state.

    Score the Q view with the current fast weights, then apply one masked
    Brier-gradient update on the K view.  W (..., f), b/c/m (...,); zq/zk
    (..., f); eta scalar.  ``m`` freezes the update (non-boundary tokens,
    stopped slots); the score is still emitted.  Returns (s_q, W', b')."""
    s_q = score_rows(W, b, zq)
    s_k = score_rows(W, b, zk)
    coeff = 2.0 * (s_k - c) * s_k * (1.0 - s_k)
    upd = eta * m
    W_new = W - upd[..., None] * (coeff[..., None] * zk)
    b_new = b - upd * coeff
    return s_q, W_new, b_new


def fast_init(pc: ProbeConfig, theta) -> Tuple[torch.Tensor, torch.Tensor]:
    return theta["W0"], theta["b0"]


def smooth_scores(scores: torch.Tensor, window: int) -> torch.Tensor:
    """Causal rolling mean over the step axis (last axis)."""
    if window <= 1:
        return scores
    c = torch.cumsum(scores, dim=-1)
    shifted = torch.cat([torch.zeros_like(c[..., :window]),
                         c[..., :-window]], dim=-1)
    t = torch.arange(scores.shape[-1], device=scores.device)
    denom = torch.clamp(t + 1, max=window).to(scores.dtype)
    return (c - shifted) / denom
