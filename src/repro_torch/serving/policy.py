"""The scheduling policy of the port's ``OrcaScheduler``: FIFO admission.

The admission loop asks its policy which WAITING unit (a singleton, or a
whole self-consistency group admitted all-or-nothing) takes the free
slots, and whether a unit needing more slots than are free may be passed
over so a smaller one behind it admits.  FIFO takes the queue head; a
skipped unit ages toward a PIN (``max_head_skips``), after which nothing
is admitted past it.  The chunked batch composer asks it how many of the
step's budget tokens go to mid-prefill residents (``prefill_share``):
FIFO gives prefill whatever the decode fleet leaves, halved by the
probe-aware chunk sizing knob (``probe_margin``, off by default) when at
least half the running residents are about to reach a probe boundary.
These are the JAX package's FIFO semantics (``repro/serving/policy.py``);
its priority, EDF and TTFT-aware policies and the fleet placement
policies come with ROADMAP queue A (preemption, groups and fleet), which
wires them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

from repro_torch.serving.request import Request


@dataclasses.dataclass(frozen=True)
class ComposeView:
    """What a policy may observe when sizing the step's prefill share."""
    n_running: int        # resident decode rows this step
    n_slots: int
    n_prefilling: int     # resident mid-prefill rows
    n_waiting: int
    token_budget: int
    chunk_tokens: int
    near_boundary: int    # running residents within probe_margin of a boundary


class FIFOPolicy:
    """Strict arrival order with the anti-starvation aging clock."""

    name = "fifo"

    def __init__(self, *, probe_margin: Optional[int] = None,
                 max_head_skips: int = 8):
        self.probe_margin = probe_margin
        assert max_head_skips >= 1
        self.max_head_skips = int(max_head_skips)
        self._head_skips: Dict[int, int] = {}

    def select_admit_unit(self, units: Sequence[Sequence[Request]],
                          step: int) -> int:
        """Index of the WAITING unit to gang-admit next: the queue head.
        Side-effect free (a paged reservation can fail and admit nobody)."""
        return 0

    def on_admitted_unit(self, units: Sequence[Sequence[Request]],
                         idx: int) -> None:
        """Called AFTER the unit at ``idx`` was admitted: its aging clock
        is done."""
        self._head_skips.pop(units[idx][0].req_id, None)

    def on_skipped_unit(self, units: Sequence[Sequence[Request]],
                        idx: int) -> bool:
        """The scheduler wants to pass over the selected unit at ``idx``
        (a gang needing more slots than are free).  True allows the skip
        and ages the unit; False once it was skipped ``max_head_skips``
        times — it is PINNED and the scheduler waits for capacity."""
        rid = units[idx][0].req_id
        n = self._head_skips.get(rid, 0)
        if n >= self.max_head_skips:
            return False
        self._head_skips[rid] = n + 1
        return True

    def prefill_share(self, view: ComposeView) -> int:
        """Budget tokens this step's packed prefill chunk may spend."""
        share = min(view.chunk_tokens, view.token_budget - view.n_running)
        return self._probe_shrink(share, view)

    def _probe_shrink(self, share: int, view: ComposeView) -> int:
        """Probe-aware chunk sizing: when at least half the running
        residents are about to hit a probe boundary, halve the prefill
        share so their stop decisions (and the page reclaim a stop
        triggers) land sooner in wall-clock."""
        if (self.probe_margin is None or view.n_running == 0
                or share <= 1):
            return share
        if 2 * view.near_boundary >= view.n_running:
            return max(share // 2, 1)
        return share
