"""End-to-end ORCA pipeline: meta-train -> LTT-calibrate -> evaluate
(PyTorch).

Trajectory sets are numpy (``repro_torch.trajectories``); meta-training
runs on ``device`` and the trained slow weights stay there, ready for the
serving engine.  Deployed scores come back to the host, where LTT
calibration and the paper's (savings, error) metrics are the numpy code
shared with the JAX package.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import labels as L
from repro_torch.core import stopping as S
from repro_torch.core import ttt
from repro_torch.core.probe import ProbeConfig, init_outer
from repro_torch.optim import Adam
from repro_torch.trajectories import TrajectorySet


def make_labels(ts: TrajectorySet, mode: str) -> np.ndarray:
    if mode == "supervised":
        return L.supervised_labels(ts.correct, ts.mask)
    if mode == "consistent":
        return L.consistent_labels(ts.answers, ts.mask)
    raise ValueError(mode)


@dataclasses.dataclass
class TrainedProbe:
    pc: ProbeConfig
    theta: Dict[str, torch.Tensor]
    history: List[Dict[str, float]]

    def scores(self, ts: TrajectorySet,
               kernel: Optional[Callable] = None) -> np.ndarray:
        """Deployed smoothed scores (N, T), masked, on the host; computed
        on the device of the slow weights (``kernel``: see
        ``ttt.deployed_scores``)."""
        dev = self.theta["W0"].device
        s = ttt.deployed_scores(self.pc, self.theta,
                                torch.as_tensor(ts.phis, device=dev),
                                torch.as_tensor(ts.mask, device=dev),
                                kernel=kernel)
        return s.cpu().numpy() * ts.mask


def train_ttt_probe(train: TrajectorySet, mode: str, pc: ProbeConfig,
                    *, epochs: int = 40, batch_size: int = 64,
                    outer_lr: float = 1e-2, seed: int = 0,
                    epoch_select: bool = True, select_delta: float = 0.1,
                    verbose: bool = False, device=None,
                    theta0: Optional[Dict[str, torch.Tensor]] = None
                    ) -> TrainedProbe:
    """Meta-train the TTT probe (Algorithm 1) with the paper's epoch-selection
    protocol: every epoch the deployed procedure is scored on a held-out
    slice of the TRAIN split and the epoch with the best LTT-calibrated
    savings at ``select_delta`` is kept.

    The validation split is the JAX package's (``np.random.RandomState``);
    the initial slow weights come from ``init_outer`` with a generator
    seeded by ``seed`` unless ``theta0`` carries them in, and the minibatch
    order from a generator seeded by ``seed + 1``."""
    device = resolve_device(device)
    labels_all = make_labels(train, mode)
    if epoch_select:
        n = len(train)
        n_val = max(8, n // 10)
        order = np.random.RandomState(seed).permutation(n)
        val_idx, tr_idx = order[:n_val], order[n_val:]
        val, tr = train.subset(val_idx), train.subset(tr_idx)
        labels = labels_all[tr_idx]
        val_labels = labels_all[val_idx]
    else:
        tr, labels, val = train, labels_all, None
    if theta0 is None:
        theta0 = init_outer(pc, torch.Generator().manual_seed(seed), device)
    theta = {k: torch.as_tensor(v, dtype=torch.float32).to(device)
             for k, v in theta0.items()}
    opt = Adam(lr=outer_lr, clip_norm=1.0)
    best = {"savings": -1.0, "theta": theta}

    def eval_fn(th):
        s = ttt.deployed_scores(
            pc, th, torch.as_tensor(val.phis, device=device),
            torch.as_tensor(val.mask, device=device)).cpu().numpy() * val.mask
        r = S.calibrate_and_evaluate(s, val_labels, val.mask,
                                     s, val_labels, val.mask,
                                     delta=select_delta)
        if r.savings > best["savings"]:
            best.update(savings=r.savings,
                        theta={k: v.clone() for k, v in th.items()})
        return {"val_savings": r.savings, "val_error": r.error}

    as_dev = lambda a: torch.as_tensor(np.asarray(a), device=device)
    theta, hist = ttt.meta_train(
        pc, theta, opt, as_dev(tr.phis).float(), as_dev(labels).float(),
        as_dev(tr.mask), epochs=epochs, batch_size=batch_size,
        generator=torch.Generator().manual_seed(seed + 1), verbose=verbose,
        eval_fn=eval_fn if epoch_select else None)
    if epoch_select and best["savings"] >= 0:
        theta = best["theta"]
    return TrainedProbe(pc, theta, hist)


@dataclasses.dataclass
class ProcedureEval:
    method: str
    mode: str
    results: List[S.EvalResult]

    def at(self, delta: float) -> S.EvalResult:
        for r in self.results:
            if abs(r.delta - delta) < 1e-9:
                return r
        raise KeyError(delta)


def evaluate_probe(scores_cal: np.ndarray, cal: TrajectorySet,
                   scores_test: np.ndarray, test: TrajectorySet,
                   mode: str, deltas: Sequence[float],
                   eps: float = 0.05, method: str = "ttt") -> ProcedureEval:
    """Calibrate on ``cal`` (labels in the SAME mode the probe was trained
    with — label-free deployment for the consistent mode) and evaluate risk
    against supervised ground truth on ``test`` (what the paper reports)."""
    lab_cal = make_labels(cal, mode)
    lab_test = L.supervised_labels(test.correct, test.mask)
    results = S.sweep_deltas(
        (scores_cal, lab_cal, cal.mask),
        (scores_test, lab_test, test.mask),
        deltas, eps=eps)
    return ProcedureEval(method, mode, results)


def run_orca(train: TrajectorySet, cal: TrajectorySet, test: TrajectorySet,
             *, mode: str = "supervised", pc: Optional[ProbeConfig] = None,
             deltas: Sequence[float] = (0.05, 0.1, 0.15, 0.2),
             epochs: int = 40, eps: float = 0.05, seed: int = 0,
             include_static: bool = True, verbose: bool = False,
             device=None) -> Dict[str, ProcedureEval]:
    """DEPRECATED shim over the ``repro_torch.api`` facade (same numbers
    by construction); ``device`` goes to both calibrators.

    New code:  ``orca.fit(train, mode) -> orca.evaluate(cal, test)``.
    Returns {"ttt": ProcedureEval, "static": ..., "_probe": TrainedProbe,
    "_static": StaticProbe}.
    """
    from repro_torch import api
    warnings.warn(
        "run_orca is a deprecated shim: call repro_torch.api.fit / "
        "repro_torch.api.evaluate directly (same numbers by construction)",
        DeprecationWarning, stacklevel=2)
    pc = pc or ProbeConfig(d_phi=train.phis.shape[-1])
    ttt_cal = api.fit(train, mode=mode, method="ttt", pc=pc, epochs=epochs,
                      seed=seed, verbose=verbose, device=device)
    out: Dict[str, ProcedureEval] = {}
    out["ttt"] = api.evaluate(ttt_cal, cal, test, deltas=deltas, eps=eps)
    out["_probe"] = ttt_cal.probe  # type: ignore
    if include_static:
        static_cal = api.fit(train, mode=mode, method="static", device=device)
        out["static"] = api.evaluate(static_cal, cal, test, deltas=deltas,
                                     eps=eps)
        out["_static"] = static_cal.probe  # type: ignore
    return out
