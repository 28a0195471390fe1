"""repro_torch.api — the ORCA facade: fit -> evaluate -> engine.

    from repro_torch import api as orca

    cal   = orca.fit(train, mode="supervised", method="ttt", epochs=25,
                     device="cuda")
    ev    = orca.evaluate(cal, cal_split, test_split)   # paper metrics
    lam   = orca.calibrated_lambda(cal, cal_split, delta=0.2)
    cfg   = orca.ServeConfig(n_slots=4, paged=True, lam=lam)
    sched = orca.engine(model, params, cal, config=cfg)
    done, fleet = sched.run(requests)

``fit``/``evaluate``/``engine`` work for every registered Calibrator
("ttt", "static"); the static baseline serves through the same fused
step with its weights frozen (eta = 0).  Self-consistency groups serve
with ``ServeConfig(group_size=N, consensus=...)``, the consensus a float
threshold or a ``GroupCalibrator`` calibrated over
``groups_from_trajectories``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.core.calibrator import (Calibrator, GroupCalibrator,
                                         GroupTrace, StaticCalibrator,
                                         TTTCalibrator,
                                         groups_from_trajectories,
                                         make_calibrator)
from repro_torch.core.pipeline import ProcedureEval, evaluate_probe
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.scheduler import OrcaScheduler
from repro_torch.trajectories import TrajectorySet

__all__ = ["Calibrator", "DELTAS", "GroupCalibrator", "GroupTrace",
           "ServeConfig", "StaticCalibrator", "TTTCalibrator",
           "calibrated_lambda", "engine", "evaluate", "fit",
           "groups_from_trajectories", "make_calibrator"]

DELTAS = (0.05, 0.1, 0.15, 0.2)


def fit(train: TrajectorySet, mode: str = "supervised",
        method: str = "ttt", **kwargs) -> Calibrator:
    """Train a calibrator on ``train``; ``kwargs`` go to its constructor
    (e.g. ``epochs=25, seed=1, pc=ProbeConfig(...), device="cuda"``)."""
    return make_calibrator(method, **kwargs).fit(train, mode)


def evaluate(calibrator: Calibrator, cal: TrajectorySet, test: TrajectorySet,
             *, deltas: Sequence[float] = DELTAS,
             eps: float = 0.05) -> ProcedureEval:
    """LTT-calibrate on ``cal`` and report deployed savings/error on ``test``
    (risk against supervised ground truth — what the paper's tables show)."""
    return evaluate_probe(calibrator.scores(cal), cal,
                          calibrator.scores(test), test,
                          calibrator.mode, deltas, eps=eps,
                          method=calibrator.method)


def calibrated_lambda(calibrator: Calibrator, cal: TrajectorySet,
                      delta: float, *, eps: float = 0.05,
                      fallback: float = math.inf) -> float:
    """``calibrate()`` with ONE policy for "LTT selected nothing": the
    honest default keeps lambda* = inf (never stop early); demos on tiny
    random-weight models may pass ``fallback=0.99``."""
    lam = calibrator.calibrate(cal, delta, eps)
    if not math.isfinite(lam):
        return float(fallback)
    return lam


def _resolve_lam(calibrator: Calibrator, lam: Optional[float]) -> float:
    """Explicit lam wins, else the calibrator's LTT threshold; a
    non-finite lambda* serves with stopping disabled — sigmoid scores
    <= 1 never cross 2.0."""
    if lam is None:
        lam = calibrator.threshold()
    lam = float(lam)
    if not math.isfinite(lam):
        lam = 2.0
    return lam


def engine(model, params, calibrator: Calibrator,
           config: Optional[ServeConfig] = None, *,
           lam: Optional[float] = None) -> OrcaScheduler:
    """Build a continuous-batching ``OrcaScheduler`` serving the calibrated
    procedure on the device of ``params``.  The threshold comes from
    ``config.lam`` unless ``lam=`` overrides it; with no config, the
    calibrator's LTT ``threshold()``."""
    if config is None:
        config = ServeConfig(lam=_resolve_lam(calibrator, lam))
    elif lam is not None:
        config = dataclasses.replace(config, lam=float(lam))
    pc, theta = calibrator.serving_params()
    sched = OrcaScheduler(model, params, pc, theta, config)
    sched.group_size = config.group_size  # the configured samples a prompt
    return sched
