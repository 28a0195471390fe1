"""Online recalibration under deployment drift (beyond-paper extension).

The paper's guarantee is marginal over the calibration distribution
(Remark A.3) and Appendix B notes that if the deployment policy or prompt
distribution changes one should re-calibrate.  This module makes that
operational: a rolling-window recalibrator that

  * keeps the most recent W deployed outcomes (score trajectory + label
    feedback, which in consistent-label mode is available label-free),
  * re-runs LTT on the window every ``every`` problems,
  * falls back to never-stop (lambda = inf) whenever the window's evidence
    cannot certify delta — inheriting LTT's finite-sample validity on any
    window that is exchangeable with the near-future.

This restores low risk under distribution shift at the cost of savings
during the adaptation transient — the system-level complement to the
probe-level adaptation ORCA already does.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np

from repro_torch.core import calibration as C
from repro_torch.core import stopping as S


@dataclasses.dataclass
class RecalibratorConfig:
    delta: float = 0.1
    eps: float = 0.05
    window: int = 200            # problems kept for recalibration
    every: int = 25              # recalibrate cadence
    min_window: int = 50         # below this: never stop early
    burn_in: int = 10


class OnlineRecalibrator:
    """Streaming LTT: feed one problem at a time, read lambda* before each."""

    def __init__(self, cfg: RecalibratorConfig,
                 grid: Optional[np.ndarray] = None):
        self.cfg = cfg
        self.grid = C.default_grid() if grid is None else grid
        self._scores: Deque[np.ndarray] = deque(maxlen=cfg.window)
        self._labels: Deque[np.ndarray] = deque(maxlen=cfg.window)
        self._seen = 0
        self.lam = math.inf
        self.history: List[Tuple[int, float]] = []

    def observe(self, scores: np.ndarray, labels: np.ndarray):
        """scores/labels: (T,) one deployed problem's smoothed trajectory and
        its (possibly consistency-mode) cumulative labels."""
        self._scores.append(np.asarray(scores, np.float64))
        self._labels.append(np.asarray(labels, np.float64))
        self._seen += 1
        if self._seen % self.cfg.every == 0:
            self._recalibrate()

    def _recalibrate(self):
        n = len(self._scores)
        if n < self.cfg.min_window:
            self.lam = math.inf
            return
        t_max = max(len(s) for s in self._scores)
        sc = np.zeros((n, t_max))
        lb = np.zeros((n, t_max))
        mk = np.zeros((n, t_max), bool)
        for i, (s, l) in enumerate(zip(self._scores, self._labels)):
            sc[i, :len(s)] = s
            lb[i, :len(l)] = l
            mk[i, :len(s)] = True
        tau = S.stop_times(sc, self.grid, mk, burn_in=self.cfg.burn_in)
        risk = S.procedure_risk(tau, lb, mk)
        res = C.ltt_calibrate(risk, self.grid, delta=self.cfg.delta,
                              eps=self.cfg.eps)
        self.lam = res.lam
        self.history.append((self._seen, self.lam))

    def decide(self, smoothed_scores: np.ndarray) -> int:
        """Stopping step for a new problem at the current lambda* (T if none)."""
        t = len(smoothed_scores)
        if math.isinf(self.lam):
            return t
        idx = np.where((smoothed_scores >= self.lam)
                       & (np.arange(t) >= self.cfg.burn_in))[0]
        return int(idx[0]) if len(idx) else t
