"""Paged KV-cache block pool: fixed-size token blocks, refcounts, prefix
sharing.

The dense serving cache gives every batch slot one max-length lane, so an
ORCA-stopped request frees nothing until its slot is re-admitted and a short
request pays for the longest.  Here HBM is a pool of fixed-size token
blocks; each request holds a *block table* (virtual position ``j`` lives in
physical block ``table[j // block_size]`` at offset ``j % block_size``):

* admission RESERVES ``ceil((prompt_len + max_new) / block_size)`` blocks up
  front — if the pool can't cover it the request stays WAITING (the
  scheduler backpressures instead of over-admitting);
* an ORCA stop returns the request's blocks to the pool immediately — the
  paper's calibrated early stop is literally a memory-reclaim event;
* self-consistency decoding (N samples of one prompt) stores the shared
  prompt prefix ONCE: full prompt blocks are refcounted and shared
  copy-on-write-style (sharers never write them — decode tokens land in
  private tail blocks), keyed by a hash of the prompt tokens.

Physical block 0 is reserved as the NULL block: freed slots point their
block tables at it, so a parked slot's no-op cache write can never corrupt
a block that was reallocated to a live request.

Host-side and synchronous by design — the scheduler owns it; device state
(the page buffers themselves) lives in ``ContinuousServingEngine``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np

NULL_BLOCK = 0


def blocks_needed(n_tokens: int, block_size: int) -> int:
    """Blocks covering ``n_tokens`` virtual positions."""
    return max((int(n_tokens) + block_size - 1) // block_size, 1)


def pad_row(block_row: Sequence[int], max_blocks: int) -> np.ndarray:
    """A request's physical block ids padded to a fixed-width table row
    with NULL blocks — the one layout the engine's device ops (admit,
    finish_prefill, preempt/restore page gather+scatter) all share."""
    row = np.full((int(max_blocks),), NULL_BLOCK, np.int32)
    row[:len(block_row)] = np.asarray(block_row, np.int32)
    return row


def prompt_key(tokens) -> str:
    """Prefix-sharing key: content hash of the prompt token ids."""
    arr = np.asarray(tokens, np.int64).ravel()
    return hashlib.sha1(arr.tobytes()).hexdigest()


@dataclasses.dataclass(frozen=True)
class PrefixEntry:
    """A resident prompt: its shared full blocks + (optional) partial tail.

    ``full_blocks`` cover positions [0, len(full_blocks) * block_size) and
    are shared read-only (new sharers bump their refcount and never write
    them).  ``tail_block`` — when the prompt length is not a block multiple
    — holds the prompt tail; a sharer COPIES it into a private block at
    admission (the donor keeps writing its own decode tokens there, which
    are stale-but-unreadable in the copy, same argument as dense slot
    reuse).  The entry holds no refcounts itself: the pool invalidates it
    the moment any referenced block's refcount hits zero.
    """
    full_blocks: tuple
    tail_block: Optional[int]
    prompt_len: int


class BlockPool:
    """Refcounted fixed-size block allocator with a prefix registry.

    Invariants (asserted, and fuzzed in ``tests/test_paged_kv.py``):
    * a block is either free (refcount 0, on the free list) or owned
      (refcount >= 1, off the free list) — never both, never double-handed;
    * ``allocate`` is all-or-nothing: a request that doesn't fit leaves the
      pool untouched;
    * block 0 (NULL) is never allocated and never freed.
    """

    def __init__(self, num_blocks: int, block_size: int):
        assert num_blocks >= 2, "need at least the null block + one usable"
        assert block_size >= 1
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._refcount = np.zeros(num_blocks, np.int64)
        self._refcount[NULL_BLOCK] = 1          # permanently owned
        self._free: List[int] = list(range(num_blocks - 1, NULL_BLOCK, -1))
        self._prefixes: Dict[str, PrefixEntry] = {}

    # ------------------------------------------------------------------
    @property
    def num_usable(self) -> int:
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return self.num_usable - self.num_free

    def refcount(self, block: int) -> int:
        return int(self._refcount[block])

    # ------------------------------------------------------------------
    def allocate(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` fresh blocks (refcount 0 -> 1), or None if the pool
        can't cover the whole reservation (all-or-nothing)."""
        if n < 0:
            raise ValueError(n)
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            assert self._refcount[b] == 0, f"block {b} double-allocated"
            self._refcount[b] = 1
        return out

    def share(self, blocks: Sequence[int]) -> List[int]:
        """Bump refcounts on already-owned blocks (prefix hit)."""
        for b in blocks:
            assert b != NULL_BLOCK and self._refcount[b] >= 1, \
                f"sharing a dead block {b}"
            self._refcount[b] += 1
        return list(blocks)

    def free(self, blocks: Sequence[int]) -> int:
        """Drop one reference per block; blocks reaching refcount 0 return
        to the free list and invalidate any prefix entry that names them.
        Returns how many blocks DIED (refcount hit 0) — shared prefix pages
        survive their sharers, so the count is what actually returned to
        the pool (the observable group-cancellation reclaims)."""
        died = []
        for b in blocks:
            assert b != NULL_BLOCK, "freeing the null block"
            assert self._refcount[b] >= 1, f"double-free of block {b}"
            self._refcount[b] -= 1
            if self._refcount[b] == 0:
                self._free.append(b)
                died.append(b)
        if died:
            dead = set(died)
            self._prefixes = {
                k: e for k, e in self._prefixes.items()
                if not (dead.intersection(e.full_blocks)
                        or e.tail_block in dead)}
        return len(died)

    # ------------------------------------------------------------------
    # prefix sharing
    def register_prefix(self, key: str, full_blocks: Sequence[int],
                        tail_block: Optional[int], prompt_len: int) -> None:
        """Record a freshly-prefilled prompt so later admissions of the same
        prompt can share its blocks instead of recomputing prefill."""
        if not full_blocks and tail_block is None:
            return
        self._prefixes[key] = PrefixEntry(tuple(full_blocks), tail_block,
                                          int(prompt_len))

    def lookup_prefix(self, key: str) -> Optional[PrefixEntry]:
        """A live PrefixEntry for ``key``, or None.  Entries referencing any
        freed block were already invalidated by ``free``."""
        return self._prefixes.get(key)

    # ------------------------------------------------------------------
    def check(self) -> None:
        """Internal consistency (used by tests after every fuzz op)."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate block on free list"
        assert NULL_BLOCK not in free
        for b in range(1, self.num_blocks):
            if b in free:
                assert self._refcount[b] == 0, (b, self._refcount[b])
            else:
                assert self._refcount[b] >= 1, (b, self._refcount[b])
        for e in self._prefixes.values():
            for b in e.full_blocks + ((e.tail_block,)
                                      if e.tail_block is not None else ()):
                assert self._refcount[b] >= 1, f"prefix names dead block {b}"
