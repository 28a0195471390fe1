"""Synthetic reasoning-trajectory generator.

Offline stand-in for the paper's data substrate (DeepSeek-R1 rollouts +
teacher labels are unavailable in this container — see DESIGN.md §7).  The
generator reproduces the *structure* the paper's method exploits.  Writing
phi_t's component along the shared "breakthrough" direction u explicitly:

    u . phi_t = u_base_i + walk_i(t) + jump * ramp(t - tau_i) + noise

  * ``u_base_i``  — instance-specific offset (thought-pattern baseline);
    its population spread is what forces a *static* probe to run a
    conservative threshold.  The TTT inner loop (C_t = 0 updates) suppresses
    it within the first few steps of each instance.
  * ``walk_i(t)`` — slow within-trajectory drift (thought patterns change
    across stages of a long CoT — the sample-level shift of Section 1).
    Online adaptation tracks it; a static probe cannot.
  * ``jump``      — the reasoning breakthrough at latent time tau_i
    (some problems never transition).
  * dataset-level OOD shift moves the MEAN of u_base_i (``shift_u``):
    negative => a static threshold goes conservative (low savings, the
    paper's MATH-500 static pattern), positive => static fires prematurely
    (high error, the paper's GPQA static pattern).

Off-u dimensions carry instance baselines, smooth stage drift and iid noise
(what PCA/logreg must average over).  Labels are monotone cumulative
[0..0,1..1]; per-step answers churn before tau and are stable afterwards
(for the consistency-label mode).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TrajectoryDistribution:
    """Parameters of the trajectory-generating process for one 'dataset'."""
    name: str
    d_phi: int = 256
    t_min: int = 40
    t_max: int = 120
    # u-direction (signal) components
    base_u_scale: float = 0.8        # spread of instance offsets along u
    shift_u: float = 0.0             # OOD: mean shift along u
    walk_step: float = 0.08          # per-step std of the within-traj walk
    signal_scale: float = 1.5        # breakthrough jump along u
    ramp_steps: int = 3
    # breakthrough rotation of the INSTANCE subspace: after tau the instance
    # baseline follows an AR(1) rotation (alpha per step), i.e. the
    # post-breakthrough phase is CONTINUALLY novel relative to the adapted
    # pre-transition representation.  A static probe cannot see this
    # (instance-specific); the TTT probe's accumulated suppression decays on
    # the rotating states so its score stays elevated (Appendix B's "no
    # longer well explained by the current adaptation").
    post_alpha: float = 0.7
    # off-u components (PER-DIM scales; |phi|^2 ~ O(d) as for real
    # mean-pooled hidden states — the regime where eta=0.01 inner updates
    # suppress instance offsets within a few steps, see DESIGN.md §7)
    baseline_scale: float = 1.5      # isotropic instance baseline, per-dim
    drift_scale: float = 0.25        # stage drift magnitude, per-dim
    noise_scale: float = 0.35        # per-step iid noise, per-dim
    # difficulty
    p_unsolved: float = 0.08         # problems with no transition
    tau_frac_lo: float = 0.15        # transition time ~ U[lo, hi] * T
    tau_frac_hi: float = 0.7
    answer_vocab: int = 50
    seed_offset: int = 0


# In-distribution corpus (paper's 5K: s1K + OpenR1 + DeepMath mix) and the
# five OOD benchmarks as distribution presets.  shift_u signs follow the
# paper's observed static-probe failure modes (conservative on MATH-500,
# premature on GPQA; AIME: longer traces, later transitions, more unsolved).
DISTRIBUTIONS: Dict[str, TrajectoryDistribution] = {
    "corpus5k": TrajectoryDistribution("corpus5k"),
    "math500": TrajectoryDistribution(
        "math500", shift_u=-1.2, t_min=30, t_max=90, signal_scale=3.0,
        tau_frac_lo=0.1, tau_frac_hi=0.45, p_unsolved=0.03, seed_offset=1),
    "gpqa": TrajectoryDistribution(
        "gpqa", shift_u=+1.0, base_u_scale=0.8, t_min=60, t_max=160,
        tau_frac_lo=0.15, tau_frac_hi=0.6, p_unsolved=0.25, seed_offset=2),
    "aime24": TrajectoryDistribution(
        "aime24", shift_u=-0.6, walk_step=0.08, t_min=80, t_max=200,
        tau_frac_lo=0.4, tau_frac_hi=0.9, p_unsolved=0.35, seed_offset=3),
    "aime25": TrajectoryDistribution(
        "aime25", shift_u=-0.8, walk_step=0.07, t_min=80, t_max=200,
        tau_frac_lo=0.45, tau_frac_hi=0.95, p_unsolved=0.4, seed_offset=4),
    "aime26": TrajectoryDistribution(
        "aime26", shift_u=-0.5, walk_step=0.09, signal_scale=2.4,
        t_min=90, t_max=220, tau_frac_lo=0.5, tau_frac_hi=0.95,
        p_unsolved=0.45, seed_offset=5),
}


@dataclasses.dataclass
class TrajectorySet:
    phis: np.ndarray         # (N, T_max, d_phi) float32
    mask: np.ndarray         # (N, T_max) bool
    correct: np.ndarray      # (N, T_max) bool — per-step correctness
    answers: np.ndarray      # (N, T_max) int — per-step answer ids
    tau: np.ndarray          # (N,) latent transition step (T_i if none)
    lengths: np.ndarray      # (N,)
    dist: TrajectoryDistribution

    def __len__(self):
        return self.phis.shape[0]

    def subset(self, idx) -> "TrajectorySet":
        return TrajectorySet(self.phis[idx], self.mask[idx], self.correct[idx],
                             self.answers[idx], self.tau[idx], self.lengths[idx],
                             self.dist)


def _shared_structure(d_phi: int):
    """Directions shared across ALL datasets (fixed seed): breakthrough u and
    the off-u stage-drift directions."""
    rs = np.random.RandomState(1234)
    u = rs.randn(d_phi)
    u /= np.linalg.norm(u)
    drift_dirs = rs.randn(4, d_phi)
    # orthogonalize drift dirs against u so scales stay interpretable
    drift_dirs -= np.outer(drift_dirs @ u, u)
    drift_dirs /= np.linalg.norm(drift_dirs, axis=1, keepdims=True)
    return u, drift_dirs


def generate(dist: TrajectoryDistribution, n: int, seed: int = 0
             ) -> TrajectorySet:
    rs = np.random.RandomState(seed * 1000 + 7 + dist.seed_offset)
    d = dist.d_phi
    u, drift_dirs = _shared_structure(d)
    t_max = dist.t_max
    lengths = rs.randint(dist.t_min, dist.t_max + 1, size=n)
    phis = np.zeros((n, t_max, d), np.float32)
    mask = np.zeros((n, t_max), bool)
    correct = np.zeros((n, t_max), bool)
    answers = np.zeros((n, t_max), np.int64)
    tau = np.zeros((n,), np.int64)
    for i in range(n):
        T = lengths[i]
        mask[i, :T] = True
        unsolved = rs.rand() < dist.p_unsolved
        if unsolved:
            ti = T
        else:
            ti = int(T * rs.uniform(dist.tau_frac_lo, dist.tau_frac_hi))
            ti = min(max(ti, 1), T - 1)
        tau[i] = ti
        # --- u-direction: base offset + slow walk + breakthrough jump
        u_base = dist.shift_u + rs.randn() * dist.base_u_scale
        walk = np.cumsum(rs.randn(T) * dist.walk_step)
        ramp = np.clip((np.arange(T) - ti + 1) / max(dist.ramp_steps, 1), 0.0, 1.0)
        if unsolved:
            ramp[:] = 0.0
        u_coef = u_base + walk + dist.signal_scale * ramp
        # --- off-u: instance baseline (pre / rotated-post), stage drift, noise
        b = rs.randn(d) * dist.baseline_scale
        b -= (b @ u) * u
        t_ax = np.arange(T)[:, None] / max(T - 1, 1)
        freqs = rs.uniform(0.5, 2.0, size=(1, 4))
        phases = rs.uniform(0, 2 * np.pi, size=(1, 4))
        stages = np.sin(2 * np.pi * freqs * t_ax + phases)          # (T,4)
        drift = stages @ drift_dirs * dist.drift_scale
        noise = rs.randn(T, d) * dist.noise_scale
        # AR(1) rotation of the instance baseline after the breakthrough
        base_t = np.empty((T, d))
        bt = b.copy()
        al = dist.post_alpha
        for tstep in range(T):
            if tstep >= ti and not unsolved:
                xi = rs.randn(d) * dist.baseline_scale
                xi -= (xi @ u) * u
                bt = al * bt + np.sqrt(max(1.0 - al * al, 0.0)) * xi
            base_t[tstep] = bt
        phis[i, :T] = (base_t + drift + noise
                       + u_coef[:, None] * u[None])
        correct[i, :T] = (np.arange(T) >= ti) if not unsolved else False
        # --- answers: churn before the transition, stable afterwards
        final = rs.randint(1, dist.answer_vocab)
        churn = rs.randint(1, dist.answer_vocab, size=T)
        for tstep in range(1, T):
            if rs.rand() < 0.5:
                churn[tstep] = churn[tstep - 1]
        ans = np.where(np.arange(T) >= ti, final, churn)
        if unsolved:
            ans = churn
            ans[-1] = rs.randint(1, dist.answer_vocab)
        answers[i, :T] = ans
    return TrajectorySet(phis, mask, correct, answers, tau, lengths, dist)


def corpus_splits(n_train: int = 600, n_cal: int = 200, n_test: int = 200,
                  d_phi: int = 256, seed: int = 0
                  ) -> Tuple[TrajectorySet, TrajectorySet, TrajectorySet]:
    """The paper's 3:1:1 split of the training corpus."""
    dist = dataclasses.replace(DISTRIBUTIONS["corpus5k"], d_phi=d_phi)
    full = generate(dist, n_train + n_cal + n_test, seed=seed)
    idx = np.random.RandomState(seed).permutation(len(full))
    return (full.subset(idx[:n_train]),
            full.subset(idx[n_train:n_train + n_cal]),
            full.subset(idx[n_train + n_cal:]))


def ood_benchmark(name: str, n: int, d_phi: int = 256, seed: int = 17
                  ) -> TrajectorySet:
    dist = dataclasses.replace(DISTRIBUTIONS[name], d_phi=d_phi)
    return generate(dist, n, seed=seed)
