"""Step-label construction (paper Section 3.2 / 4.1).

Two modes, both monotonized into the cumulative form [0..0,1..1] the paper
assumes (Appendix B, "Detecting the reasoning breakthrough"):

  * supervised — C_t = 1{ans(y_t) correct}; transition at the FIRST correct
    attempt ("step labels are cumulative, flip after first correct attempt").
  * consistent — C_t = 1{ans(y_t) == ans(y_T)}; monotonized by suffix
    stability: transition at the first step after which the answer never
    changes away from the full-budget answer.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def supervised_labels(correct: np.ndarray, mask: Optional[np.ndarray] = None
                      ) -> np.ndarray:
    """correct (N, T) binary per-step correctness -> cumulative labels."""
    correct = np.asarray(correct, bool)
    if mask is not None:
        correct = correct & np.asarray(mask, bool)
    return (np.cumsum(correct, axis=-1) > 0).astype(np.float32)


def consistent_labels(answers: np.ndarray, mask: Optional[np.ndarray] = None
                      ) -> np.ndarray:
    """answers (N, T) int answer ids per step -> suffix-stable labels.

    C_t = 1 iff ans_s == ans_T for all s >= t (within the mask).
    """
    answers = np.asarray(answers)
    n, t = answers.shape
    if mask is None:
        final = answers[:, -1]
        eq = answers == final[:, None]
    else:
        mask = np.asarray(mask, bool)
        last_idx = np.maximum(mask.shape[1] - 1 - np.argmax(mask[:, ::-1], axis=1), 0)
        final = answers[np.arange(n), last_idx]
        eq = (answers == final[:, None]) | ~mask
    # suffix-AND: stable from t to the end
    stable = np.flip(np.cumprod(np.flip(eq, axis=1), axis=1), axis=1)
    out = stable.astype(np.float32)
    if mask is not None:
        out = out * mask
    return out


def transition_time(labels: np.ndarray, mask: Optional[np.ndarray] = None
                    ) -> np.ndarray:
    """First index with label 1; T (i.e. len) if the problem never flips."""
    labels = np.asarray(labels) > 0.5
    if mask is not None:
        labels = labels & np.asarray(mask, bool)
    t = labels.shape[1]
    has = labels.any(axis=1)
    first = np.argmax(labels, axis=1)
    return np.where(has, first, t).astype(np.int64)
