"""The scheduling policy of the port's ``OrcaScheduler``: FIFO admission.

The admission loop asks its policy which WAITING unit (a singleton, or a
whole self-consistency group admitted all-or-nothing) takes the free
slots, and whether a unit needing more slots than are free may be passed
over so a smaller one behind it admits.  FIFO takes the queue head; a
skipped unit ages toward a PIN (``max_head_skips``), after which nothing
is admitted past it.  These are the JAX package's FIFO semantics
(``repro/serving/policy.py``); its priority, EDF and TTFT-aware policies
and the fleet placement policies come with ROADMAP queue A (preemption,
groups and fleet), which wires them.
"""
from __future__ import annotations

from typing import Dict, Sequence

from repro_torch.serving.request import Request


class FIFOPolicy:
    """Strict arrival order with the anti-starvation aging clock."""

    name = "fifo"

    def __init__(self, *, max_head_skips: int = 8):
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

