"""Unified ``Calibrator`` protocol: fit -> scores -> calibrate -> threshold.

Both probes the paper compares are calibrated stopping procedures: the
meta-learned TTT probe (``TTTCalibrator``) and the static PCA+logreg
baseline (``StaticCalibrator``).  Each scores step embeddings, is
LTT-calibrated on a held-out split, and hands (ProbeConfig, theta) to the
fused serving step.  LTT calibration is the numpy code shared verbatim
with the JAX package (``repro_torch.core.calibration``/``stopping``), so
the same scores give the same lambda*.

    cal = TTTCalibrator(epochs=25, device="cuda").fit(train, "consistent")
    lam = cal.calibrate(cal_split, delta=0.1)      # LTT lambda*

Self-consistency group calibration (``GroupCalibrator``) comes with
ROADMAP A4.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import calibration as C
from repro_torch.core import stopping as S
from repro_torch.core.probe import ProbeConfig
from repro_torch.trajectories import TrajectorySet


@runtime_checkable
class Calibrator(Protocol):
    """The probe-side API the facade and drivers are written against."""
    method: str                    # "ttt" | "static"
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


@dataclasses.dataclass
class StaticCalibrator(_LTTMixin):
    """The static baseline: PCA + logistic regression, no online adaptation
    (Wu et al., 2025 — the paper's "Static Probe" row); the logistic
    regression is fitted on ``device``, scores are computed on the host.

    ``serving_params`` flattens PCA+logreg into an equivalent frozen linear
    probe (eta = 0, so K1's score-then-update never moves the weights),
    which lets the same fused serving step deploy the static baseline."""
    n_components: int = 64
    epochs: int = 200
    lr: float = 1e-2
    smooth_window: int = 10
    device: Optional[str] = None     # None: CUDA (see resolve_device)
    method: str = dataclasses.field(default="static", init=False)
    mode: str = dataclasses.field(default="", init=False)
    probe: Optional[object] = dataclasses.field(default=None, init=False)

    def fit(self, train: TrajectorySet, mode: str) -> "StaticCalibrator":
        from repro_torch.core.pipeline import make_labels
        from repro_torch.core.static_probe import fit_static_probe
        self.probe = fit_static_probe(
            train.phis, make_labels(train, mode), train.mask,
            n_components=self.n_components, epochs=self.epochs, lr=self.lr,
            smooth_window=self.smooth_window, device=self.device)
        self.mode = mode
        return self

    def scores(self, ts: TrajectorySet) -> np.ndarray:
        if self.probe is None:
            raise RuntimeError("fit() must run before scores()")
        return self.probe.scores(ts.phis, ts.mask)

    def serving_params(self):
        """Flatten PCA + logreg into kernel state for the fused engine:

        s = sigma(w . P^T (phi - mu) + b) == sigma(W_eff . phi + b_eff)
        with W_eff = P w and b_eff = b - mu . P w, on ``device``; eta = 0
        freezes the inner update, so the served scores equal ``scores()``.
        """
        if self.probe is None:
            raise RuntimeError("fit() must run before serving_params()")
        p = self.probe
        w_eff = p.components @ p.w                     # (d,)
        b_eff = float(p.b - p.mean @ w_eff)
        pc = ProbeConfig(d_phi=int(p.mean.shape[0]), variant="noqk",
                         eta=0.0, smooth_window=p.smooth_window)
        dev = resolve_device(self.device)
        theta = {"W0": torch.as_tensor(w_eff, dtype=torch.float32,
                                       device=dev),
                 "b0": torch.tensor(b_eff, dtype=torch.float32, device=dev)}
        return pc, theta


_REGISTRY = {"ttt": TTTCalibrator, "static": StaticCalibrator}


def make_calibrator(method: str, **kwargs) -> Calibrator:
    """Factory over the registered Calibrator implementations."""
    try:
        cls = _REGISTRY[method]
    except KeyError:
        raise ValueError(f"unknown calibrator {method!r}; "
                         f"known: {sorted(_REGISTRY)}") from None
    return cls(**kwargs)
