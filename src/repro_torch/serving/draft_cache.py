"""Fleet-wide shared n-gram draft cache: the serving layer's drafter.

Speculative decode is only as good as its drafts, and a dense model's
degenerate self-draft (repeat the last committed token) proposes the right
continuation essentially never.  This module is the cheap fix: a bounded,
host-side table keyed by the last ``ngram`` committed tokens of a request,
whose values are the continuations the VERIFIER itself accepted, promoted
on every commit, so the cache learns exactly the n-gram statistics of the
traffic it serves.  The requests of a scheduler share ONE instance, so a
continuation accepted in one slot drafts for the next request in any slot.

The cache feeds the engine as data: the scheduler calls ``lookup`` per
RUNNING slot, stacks the proposals plus a per-slot hit mask, and hands
both to ``ContinuousServingEngine.step``; slots that miss fall back to the
model family's own drafter inside the same step.  The linear path drafts
one chain (width 1); ``lookup`` also serves the (width, depth) trees of
tree decode (ROADMAP A1b): the top ``width`` remembered continuations
become the tree's chains, and short entries are extended by CHAINED
lookups (the accepted continuation of its own tail), giving depth without
ever storing long values.

The JAX package's ``repro/serving/draft_cache.py``, line for line, with a
lock: a fleet's hosts share one instance across their threads.  Purely
deterministic (insertion-ordered dict, no hashing randomness observable):
two runs over the same traffic draft identically, which the parity tests
rely on.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np


class DraftCache:
    """Bounded LRU of n-gram -> accepted-continuation lists.

    ``capacity`` bounds the number of KEYS (eviction is LRU on key
    touches); each key retains at most ``fanout`` continuations, most
    recently accepted first; ``store_len`` caps the stored continuation
    length (depth beyond it comes from chained lookups).  ``hits`` /
    ``misses`` count top-level lookups only (chained extension lookups
    are internal and free).
    """

    def __init__(self, capacity: int = 4096, ngram: int = 3,
                 fanout: int = 8, store_len: int = 8):
        assert capacity >= 0 and ngram >= 1 and fanout >= 1 \
            and store_len >= 1, (capacity, ngram, fanout, store_len)
        self.capacity = int(capacity)
        self.ngram = int(ngram)
        self.fanout = int(fanout)
        self.store_len = int(store_len)
        self._table: "OrderedDict[tuple, List[tuple]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        # a FleetRouter's hosts share one cache and step in threads: a
        # lookup and a promotion never interleave
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._table)

    # ------------------------------------------------------------------
    def _key(self, context: Sequence[int]) -> Optional[tuple]:
        """The last ``ngram`` tokens as a key; shorter prefixes key on
        what exists (tuples of different lengths never collide)."""
        ctx = tuple(int(t) for t in context[-self.ngram:])
        return ctx if ctx else None

    def _peek(self, context: Sequence[int]) -> List[tuple]:
        """Continuations for ``context`` WITHOUT touching LRU order or
        counters — the chained-extension read."""
        key = self._key(context)
        return list(self._table.get(key, ())) if key is not None else []

    def _chain(self, context: List[int], depth: int) -> List[int]:
        """Extend ``context`` to ``depth`` more tokens by repeatedly
        looking up its own tail's best continuation."""
        out: List[int] = []
        while len(out) < depth:
            conts = self._peek(context + out)
            if not conts:
                break
            nxt = list(conts[0])[:depth - len(out)]
            if not nxt:
                break
            out.extend(nxt)
        return out

    # ------------------------------------------------------------------
    def lookup(self, context: Sequence[int], width: int,
               depth: int) -> Tuple[np.ndarray, bool]:
        """Draft a (width, depth) token tree for a request whose last
        committed tokens are ``context``.

        Returns ``(drafts, hit)``: on a hit, branch b follows the b-th
        most-recently-accepted continuation of the context's n-gram (the
        available ones cycled across branches), each chain extended to
        full depth by chained lookups and padded with its own last token;
        on a miss, zeros and False — the engine substitutes the model
        family's drafter for that slot.
        """
        with self._lock:
            return self._lookup(context, int(width), int(depth))

    def _lookup(self, context: Sequence[int], width: int,
                depth: int) -> Tuple[np.ndarray, bool]:
        drafts = np.zeros((width, depth), np.int32)
        key = self._key(context)
        conts = self._table.get(key) if key is not None else None
        if not conts:
            self.misses += 1
            return drafts, False
        self.hits += 1
        self._table.move_to_end(key)
        ctx = [int(t) for t in context]
        for b in range(width):
            chain = list(conts[b % len(conts)])[:depth]
            if len(chain) < depth:
                chain.extend(self._chain(ctx + chain, depth - len(chain)))
            while len(chain) < depth:          # pad: repeat the tail token
                chain.append(chain[-1] if chain else ctx[-1])
            drafts[b] = np.asarray(chain[:depth], np.int32)
        return drafts, True

    # ------------------------------------------------------------------
    def observe(self, context: Sequence[int],
                accepted: Sequence[int]) -> None:
        """Promote a verifier-accepted continuation: every n-gram of the
        sliding window over ``context + accepted`` that precedes at least
        one accepted token maps to the accepted tokens that follow it
        (front of its MRU list, trimmed to ``fanout``)."""
        if self.capacity == 0 or not len(accepted):
            return
        with self._lock:
            self._observe(context, accepted)

    def _observe(self, context: Sequence[int],
                 accepted: Sequence[int]) -> None:
        toks = [int(t) for t in context] + [int(t) for t in accepted]
        n_ctx = len(toks) - len(accepted)
        lo = max(0, n_ctx - self.ngram)
        for i in range(lo, len(toks) - 1):
            key = tuple(toks[max(0, i + 1 - self.ngram):i + 1])
            cont = tuple(toks[i + 1:i + 1 + self.store_len])
            if not key or not cont:
                continue
            lst = self._table.get(key)
            if lst is None:
                lst = []
                self._table[key] = lst
            # exact or prefix-superseded duplicates collapse to the front
            lst[:] = [c for c in lst if c != cont and cont[:len(c)] != c]
            lst.insert(0, cont)
            del lst[self.fanout:]
            self._table.move_to_end(key)
        while len(self._table) > self.capacity:
            self._table.popitem(last=False)

    # ------------------------------------------------------------------
    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return float(self.hits) / total if total else 0.0
