"""repro_torch.api — the ORCA facade: fit -> evaluate -> engine / fleet.

    from repro_torch import api as orca

    cal   = orca.fit(train, mode="supervised", method="ttt", epochs=25,
                     device="cuda")
    ev    = orca.evaluate(cal, cal_split, test_split)   # paper metrics
    lam   = orca.calibrated_lambda(cal, cal_split, delta=0.2)
    cfg   = orca.ServeConfig(n_slots=4, paged=True, lam=lam)
    sched = orca.engine(model, params, cal, config=cfg)
    done, fm = orca.serve_requests(sched, prompt_token_rows)

    router = orca.fleet(model, params, cal,      # simulated hosts:
                        config=cfg, n_hosts=2)   # same protocol
    done, fm = orca.serve_requests(router, prompt_token_rows)

``fit``/``evaluate``/``engine`` work for every registered Calibrator
("ttt", "static"); the static baseline serves through the same fused
step with its weights frozen (eta = 0).  Self-consistency groups serve
with ``ServeConfig(group_size=N, consensus=...)``, the consensus a float
threshold or a ``GroupCalibrator`` calibrated over
``groups_from_trajectories``.  ``fleet`` shards the scheduler across
``n_hosts`` simulated hosts that share the weights and, on the card, step
concurrently on their own CUDA streams.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.core.calibrator import (Calibrator, GroupCalibrator,
                                         GroupTrace, StaticCalibrator,
                                         TTTCalibrator,
                                         groups_from_trajectories,
                                         make_calibrator)
from repro_torch.core.pipeline import ProcedureEval, evaluate_probe
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.router import FleetRouter
from repro_torch.serving.scheduler import OrcaScheduler
from repro_torch.trajectories import TrajectorySet

__all__ = ["Calibrator", "DELTAS", "GroupCalibrator", "GroupTrace",
           "ServeConfig", "StaticCalibrator", "TTTCalibrator",
           "calibrated_lambda", "engine", "evaluate", "fit", "fleet",
           "groups_from_trajectories", "make_calibrator", "serve_requests"]

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
           lam: Optional[float] = None,
           serve: Optional[ServeConfig] = None,
           **kwargs) -> OrcaScheduler:
    """Build a continuous-batching ``OrcaScheduler`` serving the calibrated
    procedure on the device of ``params``.  The threshold comes from
    ``config.lam`` unless ``lam=`` overrides it; with no config, the
    calibrator's LTT ``threshold()``.

    The JAX package's older forms still work and emit
    ``DeprecationWarning``: ``ServeConfig`` fields as keywords
    (``n_slots=8, paged=True, ...``) and ``serve=`` (the old name of
    ``config=``)."""
    if serve is not None:
        if config is not None:
            raise ValueError("pass either config= or the deprecated "
                             "serve=, not both")
        if lam is not None or kwargs:
            raise ValueError("pass either a full ServeConfig via serve= or "
                             "lam=/ServeConfig kwargs, not both")
        warnings.warn(
            "engine(serve=...) is deprecated: the step config and the "
            "scheduler kwargs are one ServeConfig now — pass it as "
            "engine(..., config=cfg)", DeprecationWarning, stacklevel=2)
        config = serve
    if config is not None:
        if kwargs:
            raise ValueError(
                f"config= together with ServeConfig kwargs {sorted(kwargs)} "
                "is ambiguous; fix by folding them into the config "
                "(dataclasses.replace(config, ...)) or dropping config=")
        if lam is not None:
            config = dataclasses.replace(config, lam=float(lam))
    else:
        if kwargs:
            warnings.warn(
                "engine(**serving_kwargs) is deprecated: build a "
                "repro.serving.ServeConfig and pass engine(..., "
                "config=cfg) — ServeConfig.from_args converts argparse "
                "namespaces", DeprecationWarning, stacklevel=2)
        # the keywords are validated before the calibrator is asked for
        # its threshold
        config = ServeConfig(**kwargs)
        config = dataclasses.replace(
            config, lam=_resolve_lam(calibrator, lam))
    pc, theta = calibrator.serving_params()
    sched = OrcaScheduler(model, params, pc, theta, config)
    sched.group_size = config.group_size  # serve_requests' default
    return sched


def fleet(model, params, calibrator: Calibrator,
          config: Optional[ServeConfig] = None, *,
          n_hosts: Optional[int] = None, lam: Optional[float] = None,
          placement=None, parallel_hosts: bool = True) -> FleetRouter:
    """Build a ``FleetRouter`` serving the calibrated procedure on
    ``n_hosts`` simulated hosts, each with its own engine, page pool and
    policy, all reading the one set of ``params`` (``config.num_blocks``
    is the fleet's TOTAL page budget, ``config.n_slots`` per host).
    ``n_hosts=``/``lam=``/``placement=`` override the config's fields;
    ``parallel_hosts`` steps the hosts concurrently, on the card each on
    its own CUDA stream.  Stops equal single-host serving's under every
    placement."""
    if config is None:
        config = ServeConfig(lam=_resolve_lam(calibrator, lam))
    elif lam is not None:
        config = dataclasses.replace(config, lam=float(lam))
    pc, theta = calibrator.serving_params()
    return FleetRouter(model, params, pc, theta, config,
                       n_hosts=(n_hosts if n_hosts is not None
                                else config.n_hosts),
                       placement=(placement if placement is not None
                                  else config.placement),
                       parallel_hosts=parallel_hosts)


def serve_requests(server: Union[OrcaScheduler, FleetRouter],
                   prompts: np.ndarray, group_size: Optional[int] = None):
    """One Request per row of ``prompts`` (N, prompt_len), driven through
    ``server``, an ``OrcaScheduler`` or a ``FleetRouter`` (one protocol).
    ``group_size`` (default: the server's configured one) expands each
    prompt into a gang-admitted self-consistency group.  Returns
    (requests, FleetMetrics)."""
    from repro_torch.serving.groups import make_group
    from repro_torch.serving.request import make_request
    if group_size is None:
        group_size = getattr(server, "group_size", 1)
    if group_size > 1:
        reqs = [r for i in range(len(prompts))
                for r in make_group(np.asarray(prompts[i]), group_size,
                                    group_id=i)]
    else:
        reqs = [make_request(np.asarray(prompts[i]))
                for i in range(len(prompts))]
    return server.run(reqs)
