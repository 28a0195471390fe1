"""Scheduling policies of the port's ``OrcaScheduler``.

The batch composer asks its policy three questions every iteration:

* **whom to admit** (``select_admit``) — which WAITING request (or, with
  ``select_admit_unit``, which gang unit: a whole self-consistency group or
  a singleton) takes the free slots.  FIFO takes the queue head; the
  priority policy serves latency-sensitive classes first with an
  anti-starvation aging guard for the batch class; the EDF policy ranks by
  per-request deadline (falling back to per-class SLOs, which
  ``EDFPolicy.from_metrics`` derives from a previous run's
  ``c<class>_ttft_ms_p99`` fleet metrics).
* **whom to preempt** (``select_victim``) — when capacity (slots or pages)
  fails for a strictly-higher-priority unit, which resident is spilled to
  host RAM to make room.  Least-important class first, newest admission
  first; only strictly-lower-priority residents are eligible, so the
  preemption relation is a DAG and a restored victim can never preempt
  its preemptor (no livelock).
* **how much prefill** (``prefill_share``) — how many of the step's budget
  tokens go to mid-prefill residents.  FIFO gives prefill whatever the
  decode fleet leaves; the TTFT-aware policy throttles it to
  ``busy_share`` once every slot is occupied.

All policies share one aging clock (``max_head_skips``): a unit passed
over — by a priority queue-jump or because it is a gang needing more slots
than are free while a smaller unit admits past it — ages toward a PIN,
after which nothing is admitted past it.  Every policy carries the
probe-aware chunk sizing knob (``probe_margin``, off by default): when at
least half the running residents are within ``probe_margin`` tokens of a
probe boundary, the prefill share is halved.  Policies move WHEN work
happens, never what the probe sees.

One level up, the ``FleetRouter`` asks a ``PlacementPolicy`` which host
a unit lands on, fed by each host's ``HostPressure`` (the snapshot
``OrcaScheduler.pressure()`` exports): ``PressurePlacement`` (least
outstanding samples, prefix affinity first) or ``RoundRobinPlacement``
(locality-blind rotation).

These are the JAX package's policies (``repro/serving/policy.py``), host
code kept here as the port's own copy.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Sequence, Union

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


class SchedulingPolicy:
    """Base policy: FIFO admission, greedy prefill share, lowest-class /
    newest-first victim selection."""

    name = "fifo"

    def __init__(self, *, probe_margin: Optional[int] = None,
                 max_head_skips: int = 8):
        self.probe_margin = probe_margin
        assert max_head_skips >= 1
        self.max_head_skips = int(max_head_skips)
        self._head_skips: Dict[int, int] = {}

    # -- admission -----------------------------------------------------
    def select_admit(self, waiting: Sequence[Request], step: int) -> int:
        """Index into ``waiting`` of the request to admit next.  Side-effect
        free: a paged reservation can fail and admit nobody."""
        return 0

    def on_admitted(self, waiting: Sequence[Request], idx: int) -> None:
        """Called AFTER the request at ``idx`` was admitted: the place for
        aging bookkeeping, so iterations that admit nobody never advance
        the clocks."""
        self._head_skips.pop(waiting[idx].req_id, None)

    def on_skipped_unit(self, units: Sequence[Sequence[Request]],
                        idx: int) -> bool:
        """The scheduler wants to pass over the selected unit at ``idx`` (a
        gang needing more slots than are free).  True allows the skip and
        ages the unit; False once it was skipped ``max_head_skips`` times —
        it is PINNED and the scheduler waits for capacity."""
        rid = units[idx][0].req_id
        n = self._head_skips.get(rid, 0)
        if n >= self.max_head_skips:
            return False
        self._head_skips[rid] = n + 1
        return True

    # -- preemption ----------------------------------------------------
    def select_victim(self, residents: Sequence[Request],
                      for_priority: int) -> Optional[int]:
        """Index into ``residents`` of the request to spill to make room for
        an admission of class ``for_priority``, or None to refuse.  Only
        strictly-lower-priority residents (``priority > for_priority``) are
        eligible.  Side-effect free: the scheduler runs a feasibility
        simulation before any spill.  Least-important class first, newest
        admission first within a class (its KV investment is smallest)."""
        eligible = [i for i, r in enumerate(residents)
                    if r.priority > for_priority]
        if not eligible:
            return None
        return max(eligible, key=lambda i: (residents[i].priority,
                                            residents[i].admitted_step,
                                            residents[i].req_id))

    # -- gang admission ------------------------------------------------
    def select_admit_unit(self, units: Sequence[Sequence[Request]],
                          step: int) -> int:
        """Index of the WAITING unit to gang-admit next: ``select_admit``
        over the unit heads."""
        return self.select_admit([u[0] for u in units], step)

    def on_admitted_unit(self, units: Sequence[Sequence[Request]],
                         idx: int) -> None:
        """Unit-level ``on_admitted``."""
        self.on_admitted([u[0] for u in units], idx)

    # -- composition ---------------------------------------------------
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


class FIFOPolicy(SchedulingPolicy):
    """Strict arrival order, greedy prefill share."""

    name = "fifo"


class PriorityPolicy(SchedulingPolicy):
    """Priority-class admission: lower ``Request.priority`` first, FIFO
    within a class.  The queue head is never skipped more than
    ``max_head_skips`` times — after that it is admitted regardless of
    class, so the batch class always makes progress."""

    name = "priority"

    def __init__(self, *, max_head_skips: int = 8,
                 probe_margin: Optional[int] = None):
        super().__init__(probe_margin=probe_margin,
                         max_head_skips=max_head_skips)

    def select_admit(self, waiting: Sequence[Request], step: int) -> int:
        if self._head_skips.get(waiting[0].req_id, 0) >= self.max_head_skips:
            return 0
        return min(range(len(waiting)), key=lambda i: waiting[i].priority)

    def on_admitted(self, waiting: Sequence[Request], idx: int) -> None:
        # the aging clock counts ACTUAL queue-jumps only
        head = waiting[0]
        if idx != 0:
            self._head_skips[head.req_id] = \
                self._head_skips.get(head.req_id, 0) + 1
        self._head_skips.pop(waiting[idx].req_id, None)


class EDFPolicy(PriorityPolicy):
    """Earliest-deadline-first admission.  A request's deadline is its own
    ``deadline_ms`` when set, else its class's SLO (``class_slo_ms``), else
    ``default_slo_ms * (priority + 1)`` — so unconfigured EDF is priority
    order.  ``submitted_step`` then ``req_id`` break ties.  Inherits the
    priority policy's head-pin aging and the base victim selection."""

    name = "edf"

    def __init__(self, *, class_slo_ms: Optional[Dict[int, float]] = None,
                 default_slo_ms: float = 1000.0, max_head_skips: int = 8,
                 probe_margin: Optional[int] = None):
        super().__init__(max_head_skips=max_head_skips,
                         probe_margin=probe_margin)
        self.class_slo_ms = {int(k): float(v)
                             for k, v in (class_slo_ms or {}).items()}
        self.default_slo_ms = float(default_slo_ms)

    @classmethod
    def from_metrics(cls, per_class: Dict[str, float], *,
                     slack: float = 1.0, **kwargs) -> "EDFPolicy":
        """An EDF policy whose class SLOs are a previous run's observed
        ``c<class>_ttft_ms_p99`` (``FleetMetrics.per_class``), scaled by
        ``slack`` (>1 loosens, <1 tightens)."""
        slo = {}
        for key, val in (per_class or {}).items():
            m = re.fullmatch(r"c(\d+)_ttft_ms_p99", key)
            if m:
                slo[int(m.group(1))] = float(val) * float(slack)
        return cls(class_slo_ms=slo, **kwargs)

    def _deadline(self, r: Request) -> float:
        if r.deadline_ms is not None:
            return float(r.deadline_ms)
        return self.class_slo_ms.get(
            r.priority, self.default_slo_ms * (r.priority + 1))

    def select_admit(self, waiting: Sequence[Request], step: int) -> int:
        if self._head_skips.get(waiting[0].req_id, 0) >= self.max_head_skips:
            return 0
        return min(range(len(waiting)),
                   key=lambda i: (self._deadline(waiting[i]),
                                  waiting[i].submitted_step,
                                  waiting[i].req_id))


class TTFTAwarePolicy(SchedulingPolicy):
    """TTFT-aware prefill sizing: while slots are free the prefill share is
    everything the budget allows; once every slot is occupied it is
    throttled to ``busy_share`` tokens a step (default half a chunk),
    bounding the stall each decoding resident pays.  Admission is FIFO."""

    name = "ttft"

    def __init__(self, *, busy_share: Optional[int] = None,
                 probe_margin: Optional[int] = None):
        super().__init__(probe_margin=probe_margin)
        self.busy_share = busy_share

    def prefill_share(self, view: ComposeView) -> int:
        share = min(view.chunk_tokens, view.token_budget - view.n_running)
        # running and mid-prefill residents partition the fleet
        if view.n_running + view.n_prefilling >= view.n_slots:
            busy = self.busy_share
            if busy is None:
                busy = max(view.chunk_tokens // 2, 1)
            share = min(share, busy)
        return self._probe_shrink(share, view)


_POLICIES = {
    "fifo": FIFOPolicy,
    "priority": PriorityPolicy,
    "edf": EDFPolicy,
    "ttft": TTFTAwarePolicy,
}


def make_policy(policy: Union[str, SchedulingPolicy, None]
                ) -> SchedulingPolicy:
    """Resolve a policy spec: an instance passes through, a name builds
    the registered class with defaults, None means FIFO."""
    if policy is None:
        return FIFOPolicy()
    if isinstance(policy, SchedulingPolicy):
        return policy
    try:
        return _POLICIES[policy]()
    except (KeyError, TypeError):
        raise ValueError(f"unknown scheduling policy {policy!r} "
                         f"(expected one of {sorted(_POLICIES)})") from None


@dataclasses.dataclass(frozen=True)
class HostPressure:
    """One scheduler's pressure: occupancy and page counts, the snapshot
    ``OrcaScheduler.pressure()`` exports (the per-host view a fleet
    router's placement policy reads)."""

    host: int
    n_slots: int
    n_running: int
    n_prefilling: int
    n_swapped: int
    n_waiting: int            # queued admission units (gangs count once)
    queued_samples: int       # queued individual requests (gang members)
    free_slots: int
    pool_blocks: int          # usable pages (0 when the host is not paged)
    free_blocks: int
    blocks_in_use: int
    max_resident_priority: Optional[int] = None

    @property
    def outstanding(self) -> int:
        """Samples this host still owes work: queued + resident + swapped."""
        return (self.queued_samples + self.n_running
                + self.n_prefilling + self.n_swapped)


class PlacementPolicy:
    """Chooses the host a gang-admission unit is routed to: the fleet
    analogue of ``select_admit`` (the router's own ``SchedulingPolicy``
    still orders its queue; this class only places the unit it picked).
    Stateless by default, so one instance may serve many routers."""

    def select_host(self, unit: Sequence[Request],
                    pressures: Sequence[HostPressure], *,
                    need_slots: int, need_pages: int,
                    affine_host: Optional[int] = None) -> Optional[int]:
        """The host index for ``unit``, or None when NO host can ever fit
        it (total capacity, not current load: the router raises on None
        rather than queueing forever).  ``affine_host`` is the host already
        holding donor pages for the unit's prompt hash, or None."""
        feasible = [p for p in pressures
                    if p.n_slots >= need_slots
                    and (need_pages == 0 or p.pool_blocks >= need_pages)]
        if not feasible:
            return None
        # prefix affinity wins whenever the donor host can fit the unit:
        # landing there turns the whole prompt prefill into a page-table
        # copy (prefill_skipped)
        if affine_host is not None:
            for p in feasible:
                if p.host == affine_host:
                    return p.host
        return self.rank(unit, feasible)

    def rank(self, unit: Sequence[Request],
             feasible: Sequence[HostPressure]) -> int:
        """Pick among feasible hosts (affinity already handled): least
        outstanding samples, pages in use breaking ties, then the host
        index, so placement is deterministic."""
        best = min(feasible, key=lambda p: (p.outstanding,
                                            p.blocks_in_use, p.host))
        return best.host


class PressurePlacement(PlacementPolicy):
    """Least-outstanding-samples placement with prefix affinity (default)."""


class RoundRobinPlacement(PlacementPolicy):
    """Rotate placements across feasible hosts, ignoring pressure and
    prefix affinity: stop decisions must not move even under this
    locality-blind policy."""

    def __init__(self) -> None:
        self._next = 0

    def select_host(self, unit: Sequence[Request],
                    pressures: Sequence[HostPressure], *,
                    need_slots: int, need_pages: int,
                    affine_host: Optional[int] = None) -> Optional[int]:
        feasible = [p for p in pressures
                    if p.n_slots >= need_slots
                    and (need_pages == 0 or p.pool_blocks >= need_pages)]
        if not feasible:
            return None
        pick = feasible[self._next % len(feasible)]
        self._next += 1
        return pick.host


_PLACEMENTS = {
    "pressure": PressurePlacement,
    "roundrobin": RoundRobinPlacement,
}


def make_placement(placement: Union[str, PlacementPolicy, None]
                   ) -> PlacementPolicy:
    """Resolve a placement spec: an instance passes through, a name builds
    the registered class, None means pressure-balanced with prefix
    affinity."""
    if placement is None:
        return PressurePlacement()
    if isinstance(placement, PlacementPolicy):
        return placement
    try:
        return _PLACEMENTS[placement]()
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown placement policy {placement!r} (expected one of "
            f"{sorted(_PLACEMENTS)}); fix by passing 'pressure' "
            "(load-balanced + prefix-affine) or 'roundrobin', or a "
            "PlacementPolicy instance") from None
