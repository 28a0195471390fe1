"""Adam(W) with global-norm clipping, on dicts of tensors (no torch.optim).

API mirrors the JAX package's optimizer: ``opt.init(params)``,
``opt.update(grads, state, params) -> (updates, state)`` where
``params + updates`` is the step, so the meta-training loop reads the same
in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch


class AdamState(NamedTuple):
    step: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: Any = 1e-3                    # float or callable(step) -> float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        z = lambda: {k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in params.items()}
        return AdamState(0, z(), z())

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: AdamState,
               params: Optional[Dict[str, torch.Tensor]] = None):
        grads = {k: g.float() for k, g in grads.items()}
        if self.clip_norm is not None:
            gn = global_norm(grads)
            scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-9),
                                max=1.0)
            grads = {k: g * scale for k, g in grads.items()}
        step = state.step + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        mu = {k: self.b1 * state.mu[k] + (1 - self.b1) * g
              for k, g in grads.items()}
        nu = {k: self.b2 * state.nu[k] + (1 - self.b2) * g * g
              for k, g in grads.items()}
        bc1 = 1 - self.b1 ** step
        bc2 = 1 - self.b2 ** step
        updates = {}
        for k in grads:
            u = -(lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps))
            if self.weight_decay and params is not None:
                u = u - lr * self.weight_decay * params[k].float()
            updates[k] = u.to(params[k].dtype) if params is not None else u
        return updates, AdamState(step, mu, nu)
