"""The deployed stopping procedure A_lambda and its risk/savings metrics
(paper Section 3.4, Algorithm 2, Section 4.1 Metrics).

Because the inference-time inner updates are label-free and causal, the
score trajectory s_1..s_T of the deployed procedure does not depend on the
threshold; tau_lambda is a simple first-crossing functional of the smoothed
trajectory.  This lets us evaluate the WHOLE grid from one pass — exactly
the structure LTT needs (calibrating the full adaptive procedure).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core import calibration as C


def trajectory_lengths(mask: np.ndarray) -> np.ndarray:
    mask = np.asarray(mask, bool)
    return mask.sum(axis=1).astype(np.int64)


def stop_times(scores: np.ndarray, grid: Sequence[float],
               mask: Optional[np.ndarray] = None,
               burn_in: int = 10) -> np.ndarray:
    """First crossing tau_lambda = min{t : s_t >= lambda} per problem/threshold.

    scores: (N, T) smoothed deployed-procedure scores.
    Returns (N, m) stop indices in [0, T_i]; T_i (budget exhausted) if the
    threshold is never crossed. Index semantics: stopping at index t means
    the answer after step t+1 is emitted; tau == T_i means full budget.

    ``burn_in``: stopping is disabled for the first ``burn_in`` steps of each
    trajectory (the probe's online adaptation warm-up; part of the deployed
    decision rule, hence covered by the LTT calibration of the whole
    procedure).  Applied identically to every probe being compared.
    """
    scores = np.asarray(scores, np.float64)
    n, t = scores.shape
    if mask is None:
        lens = np.full((n,), t, np.int64)
        valid = np.ones_like(scores, bool)
    else:
        valid = np.asarray(mask, bool)
        lens = trajectory_lengths(valid)
    if burn_in > 0:
        valid = valid.copy()
        valid[:, :burn_in] = False
    grid = np.asarray(list(grid), np.float64)
    crossed = (scores[:, :, None] >= grid[None, None, :]) & valid[:, :, None]
    first = np.argmax(crossed, axis=1)                       # 0 if never
    any_cross = crossed.any(axis=1)
    return np.where(any_cross, first, lens[:, None])


def procedure_risk(tau: np.ndarray, labels: np.ndarray,
                   mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Binary loss R = 1{stopped early at a still-incorrect step}.

    tau (N, m); labels (N, T) cumulative.  Stopping at tau < T_i with
    label[tau] == 0 is an error; running to the budget is never charged
    (matches the paper: "only stopping too early leads to an error").
    """
    labels = np.asarray(labels) > 0.5
    n, t = labels.shape
    if mask is None:
        lens = np.full((n,), t, np.int64)
    else:
        lens = trajectory_lengths(mask)
    tau_c = np.minimum(tau, t - 1)
    lab_at_tau = np.take_along_axis(labels, tau_c, axis=1)
    early = tau < lens[:, None]
    return (early & ~lab_at_tau).astype(np.float64)


def step_savings(steps_used: np.ndarray, budget: np.ndarray) -> np.ndarray:
    """THE savings metric: per-problem fraction of the step budget not spent,
    ``1 - steps_used / budget`` (clipped at 0).

    Shared by the offline evaluation (``savings``, budget = per-trajectory
    length T_i) and the serving engine / scheduler (budget =
    max_new_tokens // tokens_per_step), so served savings and
    offline-evaluated savings are directly comparable.
    """
    steps_used = np.asarray(steps_used, np.float64)
    budget = np.asarray(budget, np.float64)
    return np.maximum(1.0 - steps_used / np.maximum(budget, 1.0), 0.0)


def savings(tau: np.ndarray, mask: Optional[np.ndarray] = None,
            lengths: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-problem savings 1 - (tau+1)/T aggregated per threshold (mean).

    tau == T means zero savings.  Matches the paper's step-level metric
    (Fig. 4 reports the same per-problem distribution).
    """
    if lengths is None:
        assert mask is not None
        lengths = trajectory_lengths(mask)
    steps_used = np.minimum(tau + 1, lengths[:, None])
    per_problem = step_savings(steps_used, lengths[:, None])
    return per_problem.mean(axis=0)


@dataclasses.dataclass
class EvalResult:
    delta: float
    lam: float
    savings: float
    error: float
    ltt: C.LTTResult

    def row(self) -> Dict[str, float]:
        return {"delta": self.delta, "lambda": self.lam,
                "savings": self.savings, "error": self.error}


def calibrate_and_evaluate(cal_scores, cal_labels, cal_mask,
                           test_scores, test_labels, test_mask,
                           *, delta: float, eps: float = 0.05,
                           grid: Optional[np.ndarray] = None) -> EvalResult:
    """Full LTT pipeline: calibrate lambda* on the calibration split, then
    report test savings/error of the deployed procedure at lambda*."""
    grid = C.default_grid() if grid is None else grid
    tau_cal = stop_times(cal_scores, grid, cal_mask)
    risk_cal = procedure_risk(tau_cal, cal_labels, cal_mask)
    res = C.ltt_calibrate(risk_cal, grid, delta=delta, eps=eps)
    lam = res.lam
    if math.isinf(lam):
        # never stop early: zero savings, zero stopping risk
        return EvalResult(delta, lam, 0.0, 0.0, res)
    tau = stop_times(test_scores, [lam], test_mask)
    err = procedure_risk(tau, test_labels, test_mask).mean(axis=0)[0]
    sav = savings(tau, test_mask)[0]
    return EvalResult(delta, lam, float(sav), float(err), res)


def sweep_deltas(cal, test, deltas: Sequence[float], eps: float = 0.05,
                 grid: Optional[np.ndarray] = None):
    """cal/test: (scores, labels, mask) triples. Returns list of EvalResult."""
    return [calibrate_and_evaluate(*cal, *test, delta=d, eps=eps, grid=grid)
            for d in deltas]


# ---------------------------------------------------------------------------
# self-consistency group consensus (group-serving subsystem)
#
# A group of N samples of one prompt votes at every reasoning step: each
# sample's vote is its latest answer hash weighted by its latest smoothed
# probe score (the probe's confidence IS the weight — no extra model).  The
# consensus procedure A^g_lambda stops the whole group the first time the
# top answer's weight share crosses lambda.  Like the per-sample procedure,
# the vote trajectory does not depend on the threshold, so one pass
# evaluates the entire LTT grid.


def weighted_vote(scores: np.ndarray, answers: np.ndarray,
                  active: np.ndarray):
    """Confidence-weighted majority vote over a group's current answers.

    scores/answers/active: (n,) per-sample latest smoothed probe score,
    latest answer hash, and liveness (a sample with no recorded score yet
    does not vote).  Returns ``(answer, agreement)`` where agreement is the
    top answer's weight share in [0, 1].  Ties break toward the SMALLER
    answer hash so the served and offline procedures agree bit-for-bit.
    """
    scores = np.asarray(scores, np.float64)
    answers = np.asarray(answers, np.int64)
    active = np.asarray(active, bool)
    w = np.clip(scores, 0.0, None) * active
    total = float(w.sum())
    if total <= 0.0:
        return -1, 0.0
    uniq = np.unique(answers[active])            # sorted: first max wins tie
    weight = np.array([float(w[(answers == a) & active].sum())
                       for a in uniq])
    best = int(np.argmax(weight))
    return int(uniq[best]), float(weight[best] / total)


def consensus_trace(scores: np.ndarray, answers: np.ndarray,
                    lengths: np.ndarray,
                    per_sample_tau: Optional[np.ndarray] = None):
    """Per-step (answer_t, agreement_t) of one group's weighted vote.

    scores/answers: (n, T) per-sample trajectories; lengths: (n,).  Sample
    i's vote at step t is FROZEN at index ``min(t, freeze_i)``: after its
    own ORCA stop (``per_sample_tau``) or budget end the sample keeps voting
    its final answer with its final confidence — exactly what the scheduler
    sees from an evicted sibling's recorded history.  Returns
    ``(answer (Tg,), agreement (Tg,))`` with Tg = max(lengths).
    """
    scores = np.asarray(scores, np.float64)
    answers = np.asarray(answers, np.int64)
    lengths = np.asarray(lengths, np.int64)
    n = scores.shape[0]
    freeze = lengths - 1
    if per_sample_tau is not None:
        freeze = np.minimum(np.asarray(per_sample_tau, np.int64), freeze)
    t_grp = int(lengths.max())
    ans = np.full((t_grp,), -1, np.int64)
    agr = np.zeros((t_grp,), np.float64)
    rows = np.arange(n)
    active = lengths > 0
    for t in range(t_grp):
        idx = np.minimum(t, freeze)
        ans[t], agr[t] = weighted_vote(scores[rows, idx],
                                       answers[rows, idx], active)
    return ans, agr


def consensus_stop_times(agreement: np.ndarray, grid: Sequence[float],
                         burn_in: int = 10) -> np.ndarray:
    """First consensus crossing per threshold: min{t >= burn_in :
    agreement_t >= g}, or Tg (= len(agreement), never fired) per threshold.
    Same first-crossing/burn-in semantics as the per-sample ``stop_times``.
    """
    agreement = np.asarray(agreement, np.float64)
    t_grp = agreement.shape[0]
    valid = np.ones((t_grp,), bool)
    valid[:burn_in] = False
    grid = np.asarray(list(grid), np.float64)
    crossed = (agreement[:, None] >= grid[None, :]) & valid[:, None]
    first = np.argmax(crossed, axis=0)
    return np.where(crossed.any(axis=0), first, t_grp)


def consensus_risk(tau_g: np.ndarray, answer_trace: np.ndarray,
                   truth: int) -> np.ndarray:
    """Group-level binary loss: 1{consensus fired AND its answer is wrong}.

    Conservative relative to the per-sample loss: a wrong consensus is
    charged even when it fires at the final step (the group COMMITS to the
    vote; there is no "ran to budget" escape once it fires).  Never firing
    is never charged — the fleet then falls back to per-sample stops.
    """
    tau_g = np.asarray(tau_g, np.int64)
    t_grp = answer_trace.shape[0]
    fired = tau_g < t_grp
    ans = answer_trace[np.minimum(tau_g, t_grp - 1)]
    return (fired & (ans != truth)).astype(np.float64)
