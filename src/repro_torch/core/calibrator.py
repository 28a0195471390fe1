"""Unified ``Calibrator`` protocol: fit -> scores -> calibrate -> threshold.

The port carries the TTT calibrator — the paper's probe, the one the
serving path deploys.  LTT calibration is the numpy code shared verbatim
with the JAX package (``repro_torch.core.calibration``/``stopping``), so
the same scores give the same lambda*.

    cal = TTTCalibrator(epochs=25, device="cuda").fit(train, "consistent")
    lam = cal.calibrate(cal_split, delta=0.1)      # LTT lambda*
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.core import calibration as C
from repro_torch.core import stopping as S
from repro_torch.core.probe import ProbeConfig
from repro_torch.trajectories import TrajectorySet


@runtime_checkable
class Calibrator(Protocol):
    """The probe-side API the facade and drivers are written against."""
    method: str                    # "ttt"
    mode: str                      # label mode bound at fit() time

    def fit(self, train: TrajectorySet, mode: str) -> "Calibrator":
        ...

    def scores(self, ts: TrajectorySet) -> np.ndarray:
        ...

    def calibrate(self, cal: TrajectorySet, delta: float,
                  eps: float = 0.05) -> float:
        ...

    def threshold(self) -> float:
        ...


class _LTTMixin:
    """Shared calibrate/threshold: LTT over the deployed score trajectories,
    with labels in the SAME mode the probe was fitted with."""
    mode: str = ""
    _lam: Optional[float] = None
    _ltt: Optional[C.LTTResult] = None

    def calibrate(self, cal: TrajectorySet, delta: float, eps: float = 0.05,
                  grid: Optional[np.ndarray] = None) -> float:
        from repro_torch.core.pipeline import make_labels
        if not self.mode:
            raise RuntimeError("fit() must run before calibrate()")
        grid = C.default_grid() if grid is None else grid
        labels = make_labels(cal, self.mode)
        s = self.scores(cal)
        tau = S.stop_times(s, grid, cal.mask)
        risk = S.procedure_risk(tau, labels, cal.mask)
        self._ltt = C.ltt_calibrate(risk, grid, delta=delta, eps=eps)
        self._lam = self._ltt.lam
        return self._lam

    def threshold(self) -> float:
        if self._lam is None:
            raise RuntimeError("calibrate() must run before threshold()")
        return self._lam

    @property
    def ltt(self) -> Optional[C.LTTResult]:
        return self._ltt


@dataclasses.dataclass
class TTTCalibrator(_LTTMixin):
    """The paper's probe: meta-trained TTT fast-weight scorer (Algorithm 1),
    trained and scored on ``device``."""
    pc: Optional[ProbeConfig] = None
    epochs: int = 40
    batch_size: int = 64
    outer_lr: float = 1e-2
    seed: int = 0
    epoch_select: bool = True
    verbose: bool = False
    device: Optional[str] = None     # None: CUDA (see resolve_device)
    method: str = dataclasses.field(default="ttt", init=False)
    mode: str = dataclasses.field(default="", init=False)
    probe: Optional[object] = dataclasses.field(default=None, init=False)

    def fit(self, train: TrajectorySet, mode: str,
            theta0=None) -> "TTTCalibrator":
        from repro_torch.core.pipeline import train_ttt_probe
        pc = self.pc or ProbeConfig(d_phi=train.phis.shape[-1])
        self.probe = train_ttt_probe(
            train, mode, pc, epochs=self.epochs, batch_size=self.batch_size,
            outer_lr=self.outer_lr, seed=self.seed,
            epoch_select=self.epoch_select, verbose=self.verbose,
            device=self.device, theta0=theta0)
        self.pc, self.mode = pc, mode
        return self

    def scores(self, ts: TrajectorySet) -> np.ndarray:
        if self.probe is None:
            raise RuntimeError("fit() must run before scores()")
        return self.probe.scores(ts)

    def serving_params(self):
        """(ProbeConfig, theta) for the fused serve step / scheduler,
        checked at the seam: the engine seeds each slot's fast weights from
        ``theta["W0"]``/``["b0"]`` and the probe kernel consumes exactly
        W (B, feat_dim), b (B,)."""
        if self.probe is None:
            raise RuntimeError("fit() must run before serving_params()")
        pc, theta = self.probe.pc, self.probe.theta
        if tuple(theta["W0"].shape) != (pc.feat_dim,):
            raise ValueError(
                f"theta['W0'] {tuple(theta['W0'].shape)} does not round-trip"
                f" into the kernel's per-slot state (expected "
                f"({pc.feat_dim},))")
        return pc, theta


def make_calibrator(method: str, **kwargs) -> Calibrator:
    if method == "ttt":
        return TTTCalibrator(**kwargs)
    raise NotImplementedError(
        f"calibrator method {method!r} is not ported to repro_torch yet; "
        "the static PCA+logreg baseline comes with ROADMAP queue A "
        "(substrates and benchmarks)")
