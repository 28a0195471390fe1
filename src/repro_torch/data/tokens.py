"""Synthetic token pipeline for LM training (numpy; the JAX package's
``repro/data/tokens.py``, copied, so batch ``i`` of a seed is the same
array in both packages).

Deterministic, seekable, shardable: batch ``i`` is a pure function of
(seed, i), so resuming from step N needs no state.  The generator is a
Zipf-Markov process: a Zipfian unigram prior blended with a first-order
transition structure, so the loss curve is non-trivial (a model can
learn something).  ``device_batch`` puts a batch on a device as tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    markov_blend: float = 0.5     # P = blend * markov + (1-blend) * zipf
    n_states: int = 64            # markov granularity (token % n_states)


class TokenPipeline:
    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        rs = np.random.RandomState(cfg.seed)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        zipf = ranks ** (-cfg.zipf_a)
        self._zipf = zipf / zipf.sum()
        # per-state preferred continuation distribution: a random
        # permutation of the zipf weights per state
        self._perms = np.stack([rs.permutation(v)
                                for _ in range(cfg.n_states)])

    def _batch_np(self, index: int) -> np.ndarray:
        cfg = self.cfg
        rs = np.random.RandomState((cfg.seed * 1_000_003 + index)
                                   % (2**31 - 1))
        b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        out = np.empty((b, s + 1), np.int32)
        out[:, 0] = rs.randint(0, v, size=b)
        # vectorized Markov-Zipf sampling over time
        for t in range(1, s + 1):
            state = out[:, t - 1] % cfg.n_states
            u = rs.rand(b)
            use_markov = u < cfg.markov_blend
            samp = rs.choice(v, size=b, p=self._zipf)
            permuted = self._perms[state, samp]
            out[:, t] = np.where(use_markov, permuted, samp)
        return out

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        """Global batch ``index``: {"tokens": (B,S), "targets": (B,S)}."""
        seq = self._batch_np(index)
        return {"tokens": seq[:, :-1], "targets": seq[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


def device_batch(batch: Dict[str, np.ndarray], device=None
                 ) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device`` (None: CUDA)."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}
