"""Self-consistency group serving: the gang-scheduled request unit.

ORCA's self-consistency traffic arrives as *groups* of N samples of one
prompt.  ``RequestGroup`` makes the group a scheduling unit: all N samples
are admitted atomically (slots AND pages reserved all-or-nothing), and the
siblings share the first sample's full prompt pages by refcount.  With
``group_id=None`` requests the layer is inert: every unit is a singleton.
Preemption treats a group's samples as residents like any other (a
victim is one sample, spilled and restored alone).  The JAX package's
consensus stop, which cancels the still-running siblings once the group's
vote clears its threshold, comes with ROADMAP A4.2 (groups and consensus).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.request import Request, make_request


@dataclasses.dataclass
class RequestGroup:
    """One self-consistency group: N samples of one prompt, gang-scheduled
    as a unit."""
    group_id: int
    requests: List[Request]

    @property
    def size(self) -> int:
        return len(self.requests)


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
