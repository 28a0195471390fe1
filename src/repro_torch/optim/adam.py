"""Adam(W) with global-norm clipping and a cosine schedule, on dicts of
tensors (no torch.optim).

API mirrors the JAX package's optimizer: ``opt.init(params)``,
``opt.update(grads, state, params) -> (updates, state)`` where
``params + updates`` is the step, so the meta-training loop and the
trainer read the same in both packages.  ``params`` and ``grads`` are
dicts whose values are tensors or dicts of the same kind (the language
model's nested parameter tree; the probe's flat dict is the one-level
case), walked in insertion order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch import parallel


class AdamState(NamedTuple):
    step: int
    mu: Dict[str, Any]
    nu: Dict[str, Any]


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensor leaves of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def global_norm(tree, specs=None) -> torch.Tensor:
    """The l2 norm over every leaf.  Under a ``ParallelContext`` with the
    leaves' ``specs`` (this rank's shards of sharded gradients), each
    logical element counts once: a leaf's squares are summed over the mesh
    axes it is sharded on and not over those it is replicated on."""
    ctx = parallel.current_ctx()
    if specs is None or ctx is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in tree_leaves(tree)))
    by_axes: Dict[tuple, torch.Tensor] = {}
    for x, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        axes = tuple(a for e in spec for a in parallel.axis_names(e))
        sq = torch.sum(torch.square(x.float()))
        by_axes[axes] = by_axes[axes] + sq if axes in by_axes else sq
    return torch.sqrt(sum(parallel.all_reduce_(v, axes)
                          for axes, v in by_axes.items()))


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: Any = 1e-3                    # float or callable(step) -> float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0

    def init(self, params) -> AdamState:
        z = lambda: tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return AdamState(0, z(), z())

    @torch.no_grad()
    def update(self, grads, state: AdamState, params=None, specs=None):
        """``specs``: the leaves' specs when ``grads`` are this rank's
        shards under a ``ParallelContext`` (the clip's norm is then the
        whole gradient's; the moments are shards like their leaves)."""
        grads = tree_map(lambda g: g.float(), grads)
        if self.clip_norm is not None:
            gn = global_norm(grads, specs)
            scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-9),
                                max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        step = state.step + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        mu = tree_map(lambda m, g: self.b1 * m + (1 - self.b1) * g,
                      state.mu, grads)
        nu = tree_map(lambda v, g: self.b2 * v + (1 - self.b2) * g * g,
                      state.nu, grads)
        bc1 = 1 - self.b1 ** step
        bc2 = 1 - self.b2 ** step

        def upd(m, v, p=None):
            u = -(lr * (m / bc1) / (torch.sqrt(v / bc2) + self.eps))
            if self.weight_decay and p is not None:
                u = u - lr * self.weight_decay * p.float()
            return u.to(p.dtype) if p is not None else u

        if params is None:
            updates = tree_map(upd, mu, nu)
        else:
            updates = tree_map(upd, mu, nu, params)
        return updates, AdamState(step, mu, nu)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable:
    """The JAX package's schedule: linear warmup to ``peak_lr`` over
    ``warmup`` steps, then a cosine from ``peak_lr`` down to ``floor *
    peak_lr`` at ``total``, held there after.  lr(step) is a float32
    0-d tensor computed in float32, as JAX computes it."""
    def lr(step):
        s = torch.as_tensor(step, dtype=torch.float32)
        warm = peak_lr * s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(s < warmup, warm, cos)
    return lr
