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

``GroupCalibrator`` is the self-consistency groups' consensus stop: a
confidence-weighted answer vote over a group's samples, its threshold
LTT-calibrated over groups (``groups_from_trajectories`` forms them with
the JAX package's seeded permutation, so both form the same groups).
"""
from __future__ import annotations

import dataclasses
from typing import (List, NamedTuple, Optional, Protocol, Sequence,
                    runtime_checkable)

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


# ---------------------------------------------------------------------------
# self-consistency group consensus (group serving)


class GroupTrace(NamedTuple):
    """One calibration group: per-sample score/answer trajectories + truth."""
    scores: np.ndarray     # (n, T) smoothed deployed-procedure scores
    answers: np.ndarray    # (n, T) per-step answer hashes
    lengths: np.ndarray    # (n,) trajectory lengths
    truth: int             # the group's reference answer hash (-1: none)


@dataclasses.dataclass
class GroupCalibrator:
    """Conformal consensus stop for self-consistency groups.

    At each reasoning step the samples vote their latest answer hash,
    weighted by their latest smoothed probe score, and the group stops the
    first time the top answer's weight share clears ``lam`` (after
    ``burn_in`` steps, with at least ``min_votes`` live voters).  ``lam``
    is LTT-calibrated over group-level risk (a wrong consensus fired), so
    P(group risk <= delta) >= 1 - eps at the GROUP level: groups, not
    samples, are the exchangeable calibration unit.

    Serving parity: the scheduler's per-step ``decide`` uses each sample's
    LATEST recorded (score, answer).  Under gang admission with admission-
    time prefill the samples advance in lockstep, so the served decisions
    equal the offline ``consensus_trace`` exactly.
    """
    min_votes: int = 2
    burn_in: int = 10
    lam: Optional[float] = None      # consensus threshold (inf: never fire)
    delta: Optional[float] = None    # risk level lam was calibrated at
    _ltt: Optional[C.LTTResult] = dataclasses.field(default=None, init=False)

    def calibrate(self, groups: Sequence[GroupTrace], delta: float,
                  eps: float = 0.05, grid: Optional[np.ndarray] = None,
                  per_sample_lam: Optional[float] = None,
                  per_sample_burn_in: Optional[int] = None) -> float:
        """LTT-calibrate the consensus threshold over ``groups``.

        ``per_sample_lam``: the deployed per-sample ORCA threshold; each
        sample's vote freezes at its own stop, as served (pass the
        engine's lambda*; None: samples vote to their full length)."""
        grid = C.default_grid() if grid is None else grid
        psb = self.burn_in if per_sample_burn_in is None else per_sample_burn_in
        risks = []
        for g in groups:
            if g.scores.shape[0] < self.min_votes:
                risks.append(np.zeros((len(grid),)))   # can never fire
                continue
            tau_i = None
            if per_sample_lam is not None and np.isfinite(per_sample_lam):
                mask = (np.arange(g.scores.shape[1])[None, :]
                        < np.asarray(g.lengths)[:, None])
                tau_i = S.stop_times(g.scores, [per_sample_lam], mask,
                                     burn_in=psb)[:, 0]
            ans_t, agr_t = S.consensus_trace(g.scores, g.answers, g.lengths,
                                             per_sample_tau=tau_i)
            tau_g = S.consensus_stop_times(agr_t, grid, self.burn_in)
            risks.append(S.consensus_risk(tau_g, ans_t, int(g.truth)))
        self._ltt = C.ltt_calibrate(np.stack(risks), grid, delta=delta,
                                    eps=eps)
        self.lam = float(self._ltt.lam)
        self.delta = float(delta)
        return self.lam

    def threshold(self) -> float:
        if self.lam is None:
            raise RuntimeError(
                "GroupCalibrator has no threshold — run calibrate(...) "
                "first, or construct it with an explicit lam=")
        return self.lam

    @property
    def ltt(self) -> Optional[C.LTTResult]:
        return self._ltt

    def decide(self, scores: Sequence[Sequence[float]],
               answers: Sequence[Sequence[int]]):
        """One serving-time consensus check over a group's recorded
        per-sample histories (each sample votes its latest entry).

        Returns ``(fire, answer, agreement)``; ``fire`` is gated on
        ``min_votes`` live voters and the consensus ``burn_in``."""
        lam = self.threshold()
        active = np.array([len(s) > 0 for s in scores], bool)
        t = max((len(s) for s in scores), default=0) - 1
        s = np.array([s[-1] if len(s) else 0.0 for s in scores], np.float64)
        a = np.array([a[-1] if len(a) else -1 for a in answers], np.int64)
        ans, agr = S.weighted_vote(s, a, active)
        fire = (int(active.sum()) >= self.min_votes and t >= self.burn_in
                and agr >= lam)
        return fire, ans, agr


def groups_from_trajectories(ts: TrajectorySet, scores: np.ndarray,
                             group_size: int, *, seed: int = 0,
                             answers: Optional[np.ndarray] = None
                             ) -> List[GroupTrace]:
    """Chunk a TrajectorySet into self-consistency calibration groups.

    A seeded permutation (numpy ``RandomState(seed)``, the JAX package's)
    is cut into consecutive groups of ``group_size`` (remainder dropped):
    iid trajectories make the groups exchangeable, so LTT at the group
    level stays valid.  ``answers`` overrides the per-step answer hashes
    (default ``ts.answers``); the group truth is the confidence-weighted
    vote over the final steps of SOLVED samples (-1, unmatchable, when no
    sample solves the problem)."""
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    answers = ts.answers if answers is None else answers
    order = np.random.RandomState(seed).permutation(len(ts))
    groups = []
    for g0 in range(0, len(order) - group_size + 1, group_size):
        idx = order[g0:g0 + group_size]
        lengths = ts.lengths[idx]
        final = answers[idx, lengths - 1]
        solved = np.array([bool(ts.correct[i].any()) for i in idx])
        if solved.any():
            truth, _ = S.weighted_vote(np.ones_like(final, np.float64),
                                       final, solved)
        else:
            truth = -1
        groups.append(GroupTrace(scores=scores[idx], answers=answers[idx],
                                 lengths=lengths, truth=int(truth)))
    return groups


_REGISTRY = {"ttt": TTTCalibrator, "static": StaticCalibrator}


def make_calibrator(method: str, **kwargs) -> Calibrator:
    """Factory over the registered Calibrator implementations."""
    try:
        cls = _REGISTRY[method]
    except KeyError:
        raise ValueError(f"unknown calibrator {method!r}; "
                         f"known: {sorted(_REGISTRY)}") from None
    return cls(**kwargs)
