"""Self-consistency group serving: the gang-scheduled request unit.

ORCA's self-consistency traffic arrives as *groups* of N samples of one
prompt.  ``RequestGroup`` makes the group a scheduling unit:

* **gang admission**: all N samples are admitted atomically (slots AND
  pages reserved all-or-nothing), so a group is never half-resident;
* **shared prompt pages**: the siblings share the first sample's full
  prompt pages by refcount and skip prefill;
* **consensus stop**: each step the ``GroupCalibrator``
  (``repro_torch.core.calibrator``) turns the samples' latest probe scores
  into a confidence-weighted answer vote; once the vote clears its
  LTT-calibrated threshold, every sibling still running is CANCELLED
  mid-flight (slot, pages and probe row back to the fleet; a SWAPPED
  sibling's spill is dropped, never restored), and the samples' unspent
  budget becomes ``FleetMetrics.group_savings``.

With ``group_id=None`` requests (or the consensus off) the layer is
inert: stops equal the ungrouped fleet's under every policy, packing and
paging.  Preemption treats a group's samples as residents like any other
(a victim is one sample, spilled and restored alone).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.request import Request, RequestState, make_request


@dataclasses.dataclass
class RequestGroup:
    """One self-consistency group: N samples of one prompt, gang-scheduled
    and consensus-stopped as a unit."""
    group_id: int
    requests: List[Request]
    # consensus outcome (set by the scheduler when the vote fires)
    consensus_step: int = -1        # ENGINE step the decision fired (-1: no)
    consensus_index: int = -1       # reasoning-step index of the decision
    consensus_answer: int = -1      # the winning answer hash
    consensus_agreement: float = 0.0

    @property
    def size(self) -> int:
        return len(self.requests)

    @property
    def decided(self) -> bool:
        return self.consensus_step >= 0

    @property
    def done(self) -> bool:
        return all(r.done for r in self.requests)

    @property
    def n_cancelled(self) -> int:
        return sum(r.state is RequestState.CANCELLED for r in self.requests)

    def budget_steps(self, tokens_per_step: int, default_max_new: int) -> int:
        """Total reasoning-step budget across the group's samples."""
        return sum(max((r.max_new_tokens or default_max_new)
                       // tokens_per_step, 1) for r in self.requests)

    def steps_spent(self) -> int:
        return sum(r.steps_run for r in self.requests)

    def savings(self, tokens_per_step: int, default_max_new: int) -> float:
        """Group-level savings 1 - spent/budget: unlike the per-request
        metric this COUNTS a cancelled sample's unspent budget (what the
        consensus cancellation is for) instead of dropping it."""
        budget = self.budget_steps(tokens_per_step, default_max_new)
        return max(1.0 - self.steps_spent() / max(budget, 1), 0.0)


def make_group(tokens: np.ndarray, n_samples: int, *, group_id: int,
               extra: Optional[Dict] = None,
               max_new_tokens: Optional[int] = None,
               priority: int = 0) -> List[Request]:
    """Build N sample Requests of one prompt sharing a ``group_id``."""
    if n_samples < 1:
        raise ValueError(f"n_samples must be >= 1, got {n_samples}")
    return [make_request(tokens, extra=extra, max_new_tokens=max_new_tokens,
                         priority=priority, group_id=group_id, sample_idx=j)
            for j in range(n_samples)]


def group_requests(requests: Sequence[Request]
                   ) -> Tuple[List[List[Request]], List[RequestGroup]]:
    """Partition a request sequence into gang-admission units.

    A unit is the atomic thing the admission loop schedules: a singleton
    for an ungrouped request, the whole group otherwise.  Units keep
    arrival order (a group sits at its FIRST member's position); within a
    group, samples are ordered by ``sample_idx`` (normalized to arrival
    order when callers left them all at the default 0).  Returns
    ``(units, groups)``; with no grouped requests ``units`` is exactly the
    one-request-per-unit sequence, so the grouped admission loop reduces
    to the classic one byte-for-byte.
    """
    units: List[List[Request]] = []
    by_group: Dict[int, List[Request]] = {}
    for req in requests:
        if req.group_id is None:
            units.append([req])
            continue
        members = by_group.get(req.group_id)
        if members is None:
            members = by_group[req.group_id] = [req]
            units.append(members)
        else:
            members.append(req)
    groups = []
    for gid, members in by_group.items():
        if len({r.sample_idx for r in members}) != len(members):
            for j, r in enumerate(members):      # normalize duplicate idxs
                r.sample_idx = j
        members.sort(key=lambda r: (r.sample_idx, r.req_id))
        groups.append(RequestGroup(group_id=gid, requests=list(members)))
    return units, groups
