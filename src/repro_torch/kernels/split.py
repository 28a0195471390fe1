"""Split-KV over blocks, shared by K2 (``paged_decode``), K3
(``paged_chunk``) and K6 (``flash_decode``).

Past ``SPLIT_MIN_POSITIONS`` virtual positions a row's positions are
shared over ``split_count`` blocks.  Each block finds the row's live range
(its first and last valid position) and takes an equal share of it
(``split_ranges``: the kernels' own cut, K2's and K6's in
``csrc/decode_math.cuh``); it writes the partials of its share to scratch
the wrapper allocates, and one merge kernel (``csrc/split_merge.cuh``)
folds them as ``merge_split_partials_plain`` does.  The served shapes (at
most 256 positions) stay one launch with no merge.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

# a row of more virtual positions than this is shared over several blocks:
# one per SPLIT_MIN_POSITIONS, at most MAX_SPLITS for K3 and
# DECODE_MAX_SPLITS for K2 and K6, whose blocks are shorter (chip_smoke.py's
# k2-splits and k6-splits rows time 4, 8, 12 and 16 splits)
SPLIT_MIN_POSITIONS = 256
MAX_SPLITS = 16
DECODE_MAX_SPLITS = 8


def split_count(n_positions: int, max_splits: int = MAX_SPLITS) -> int:
    """How many blocks share one row's ``n_positions`` virtual positions:
    1 up to ``SPLIT_MIN_POSITIONS``, else one per ``SPLIT_MIN_POSITIONS``
    positions, at most ``max_splits``."""
    if n_positions <= SPLIT_MIN_POSITIONS:
        return 1
    return min(max_splits, -(-n_positions // SPLIT_MIN_POSITIONS))


def split_ranges(valid_row, n_split: int) -> List[Tuple[int, int]]:
    """The positions [lo, hi) each of ``n_split`` blocks takes of one row
    whose validity is ``valid_row`` (1-D): the live range [first, last]
    cut into equal shares of ceil((last - first + 1) / n_split) positions,
    the last ones short or empty (lo == hi).  A row with no valid position
    gives every block an empty share."""
    idx = torch.nonzero(torch.as_tensor(valid_row).reshape(-1)).reshape(-1)
    if idx.numel() == 0:
        return [(0, 0)] * n_split
    first, last = int(idx[0]), int(idx[-1])
    per = (last - first + n_split) // n_split
    out = []
    for s in range(n_split):
        lo = first + s * per
        hi = min(lo + per, last + 1)
        out.append((min(lo, hi), hi))
    return out


def merge_split_partials_plain(o, l, m):
    """Fold the partials of S disjoint position ranges into the partials
    of their union (the log-sum-exp rule of the split-KV merge).

    o (S, ..., d), l (S, ...), m (S, ...) -> (o (..., d), l (...),
    m (...)).  An empty range has m = -1e30, l = 0, o = 0 and weighs
    nothing; a row empty in every range keeps m = -1e30, l = 0, o = 0."""
    mx = m.max(dim=0).values
    w = torch.exp(m - mx)
    return (w[..., None] * o).sum(0), (w * l).sum(0), mx


def split_scratch(n_split: int, o, l, m):
    """The partials scratch of an ``n_split``-way launch (n_split times the
    shapes of o, l and m, f32, on their device), or three Nones for one
    split: no scratch and no merge."""
    if n_split == 1:
        return [None] * 3
    return [torch.empty((n_split,) + tuple(t.shape), dtype=torch.float32,
                        device=t.device) for t in (o, l, m)]
