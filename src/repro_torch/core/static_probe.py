"""Static linear probe baseline (Wu et al., 2025): PCA + logistic regression.

The paper's "Static Probe" row, as the JAX package builds it: PCA via the
numpy float64 SVD of the centred step-embedding matrix; logistic
regression fitted full-batch with the port's Adam (200 steps from zeros,
torch autograd in place of ``jax.value_and_grad``) on ``device``.  At
inference one forward pass per step (no online adaptation), then the same
rolling-window smoothing as the TTT probe; it is calibrated with the same
LTT procedure.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.probe import smooth_scores
from repro_torch.optim import Adam


@dataclasses.dataclass
class StaticProbe:
    mean: np.ndarray          # (d,)
    components: np.ndarray    # (d, k)
    w: np.ndarray             # (k,)
    b: float
    smooth_window: int = 10

    def scores(self, phis: np.ndarray, mask: Optional[np.ndarray] = None
               ) -> np.ndarray:
        """phis (N, T, d) -> smoothed scores (N, T), numpy on the host;
        the smoothing runs in float32, as the JAX package's does."""
        z = (phis - self.mean) @ self.components
        s = 1.0 / (1.0 + np.exp(-(z @ self.w + self.b)))
        s = smooth_scores(torch.as_tensor(s, dtype=torch.float32),
                          self.smooth_window).numpy()
        if mask is not None:
            s = s * mask
        return s


def fit_pca(x: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    mean = x.mean(axis=0)
    xc = x - mean
    # economical SVD on (n, d)
    _, _, vt = np.linalg.svd(xc, full_matrices=False)
    return mean, vt[:k].T.astype(np.float64)


def fit_static_probe(phis: np.ndarray, labels: np.ndarray,
                     mask: Optional[np.ndarray] = None, *,
                     n_components: int = 64, epochs: int = 200,
                     lr: float = 1e-2, smooth_window: int = 10,
                     device=None) -> StaticProbe:
    """phis (N, T, d), labels (N, T) -> fitted PCA+LogReg probe.  The fit
    is deterministic (zeros init, full batch), so it takes no seed."""
    n, t, d = phis.shape
    flat = phis.reshape(n * t, d).astype(np.float64)
    y = labels.reshape(n * t).astype(np.float64)
    if mask is not None:
        keep = np.asarray(mask, bool).reshape(n * t)
        flat, y = flat[keep], y[keep]
    k = min(n_components, d, flat.shape[0])
    mean, comps = fit_pca(flat, k)
    device = resolve_device(device)
    z = torch.as_tensor((flat - mean) @ comps, dtype=torch.float32,
                        device=device)
    yt = torch.as_tensor(y, dtype=torch.float32, device=device)

    params = {"w": torch.zeros((k,), device=device),
              "b": torch.zeros((), device=device)}
    opt = Adam(lr=lr, clip_norm=None)
    state = opt.init(params)
    for _ in range(epochs):
        leaves = {key: v.requires_grad_(True) for key, v in params.items()}
        logit = z @ leaves["w"] + leaves["b"]
        # max(logit, 0) through relu: its gradient at 0 is 0, as
        # jnp.maximum's is here, and every logit is exactly 0 at the init
        loss = torch.mean(torch.relu(logit) - logit * yt
                          + torch.log1p(torch.exp(-torch.abs(logit))))
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        upd, state = opt.update(grads, state, params)
        params = {key: v.detach() + upd[key] for key, v in params.items()}
    return StaticProbe(mean=mean, components=comps,
                       w=params["w"].cpu().numpy().astype(np.float64),
                       b=float(params["b"]), smooth_window=smooth_window)
