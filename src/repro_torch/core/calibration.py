"""Conformal / Learn-then-Test calibration (paper Section 3.4, Appendix A).

LTT calibrates the *decision rule*: for an ordered grid of thresholds
lambda_1 > ... > lambda_m (conservative -> aggressive), test the mean-risk
null H_j : r(lambda_j) >= delta with one-sided binomial p-values on the
calibration set, apply fixed-sequence testing (FWER control at eps), and
select the most aggressive rejected threshold lambda*.  Guarantee (Thm A.2):
P(r(lambda*) <= delta) >= 1 - eps.

Also includes the split-conformal quantile (Eq. 4) used for prediction-set
style baselines.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

try:  # exact-ish binomial CDF via the regularized incomplete beta function
    from scipy.stats import binom as _scipy_binom  # pragma: no cover
    _HAVE_SCIPY = True
except Exception:  # pragma: no cover
    _HAVE_SCIPY = False


def binom_cdf(k: int, n: int, p: float) -> float:
    """P(Binom(n, p) <= k), numerically-stable log-space summation."""
    if k < 0:
        return 0.0
    if k >= n:
        return 1.0
    if _HAVE_SCIPY:
        return float(_scipy_binom.cdf(k, n, p))
    # log-space cumulative sum
    logp, log1p_ = math.log(p), math.log1p(-p)
    # log C(n, i) built incrementally
    log_terms = []
    log_c = 0.0
    for i in range(0, k + 1):
        if i > 0:
            log_c += math.log(n - i + 1) - math.log(i)
        log_terms.append(log_c + i * logp + (n - i) * log1p_)
    mx = max(log_terms)
    return float(min(1.0, math.exp(mx) * sum(math.exp(t - mx) for t in log_terms)))


def binomial_pvalue(emp_risk: float, n: int, delta: float) -> float:
    """p^BT = P(Binom(n, delta) <= n * Rhat)  (Eq. 15)."""
    k = int(math.floor(emp_risk * n + 1e-9))
    return binom_cdf(k, n, delta)


def hoeffding_pvalue(emp_risk: float, n: int, delta: float) -> float:
    """Valid p-value for bounded (not necessarily binary) risks (Rmk A.4)."""
    if emp_risk >= delta:
        return 1.0
    return float(math.exp(-2.0 * n * (delta - emp_risk) ** 2))


@dataclasses.dataclass(frozen=True)
class LTTResult:
    lam: float                   # selected lambda* (inf => never stop early)
    rejected: np.ndarray         # bool per grid element
    pvalues: np.ndarray
    emp_risk: np.ndarray
    grid: np.ndarray


def ltt_calibrate(risk_matrix: np.ndarray, grid: Sequence[float],
                  delta: float, eps: float = 0.05,
                  pvalue: str = "binomial") -> LTTResult:
    """Fixed-sequence LTT over a threshold grid.

    risk_matrix: (n_cal, m) binary loss of the deployed procedure run at each
    grid threshold (column j <-> grid[j]).  ``grid`` must be sorted
    conservative -> aggressive (descending thresholds).
    """
    risk_matrix = np.asarray(risk_matrix, np.float64)
    grid = np.asarray(list(grid), np.float64)
    assert np.all(np.diff(grid) <= 1e-12), "grid must be descending (conservative first)"
    n, m = risk_matrix.shape
    assert m == len(grid)
    emp = risk_matrix.mean(axis=0)
    pfun = binomial_pvalue if pvalue == "binomial" else hoeffding_pvalue
    pvals = np.array([pfun(emp[j], n, delta) for j in range(m)])
    rejected = np.zeros(m, bool)
    lam = math.inf                      # sentinel: no rejection => never stop
    for j in range(m):                  # fixed-sequence testing
        if pvals[j] <= eps:
            rejected[j] = True
            lam = float(grid[j])
        else:
            break
    return LTTResult(lam=lam, rejected=rejected, pvalues=pvals,
                     emp_risk=emp, grid=grid)


def conformal_quantile(scores: Sequence[float], eps: float) -> float:
    """Split-conformal quantile (Eq. 4): Quantile_{ceil((n+1)(1-eps))/(n+1)}."""
    u = np.sort(np.asarray(list(scores), np.float64))
    n = len(u)
    k = math.ceil((n + 1) * (1.0 - eps))
    if k > n:
        return math.inf
    return float(u[k - 1])


def default_grid(lo: float = 0.5, hi: float = 0.995, m: int = 100) -> np.ndarray:
    """Descending threshold grid (conservative -> aggressive = high -> low)."""
    return np.linspace(hi, lo, m)
