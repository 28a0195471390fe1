"""FleetRouter: fleet serving over simulated hosts.

The scheduler stack is host-local by construction: the paged
``BlockPool``, the unified token-budget step and the ``SchedulingPolicy``
instance all live inside one ``OrcaScheduler``.  This module shards that
scheduler across N *simulated* hosts: each host owns its own engine, pool
and policy instance, and the router owns only PLACEMENT, the host a
gang-admission unit lands on.

* The router's own policy instance orders the cross-host queue with the
  same ``select_admit_unit`` semantics (priority, aging, gangs as atomic
  units) the host admission loop uses.
* A ``PlacementPolicy`` then picks the host from each host's
  ``HostPressure`` snapshot (``OrcaScheduler.pressure()``).
* Prefix-affine placement routes same-prompt traffic (whole
  self-consistency gangs too) to the host already holding the donor
  pages, so the follower's prefill collapses to a page-table copy there
  (``prefill_skipped``) instead of a cold prefill elsewhere.

Each host runs the unchanged single-host scheduler, so a request's stop
decision depends only on its own trajectory: stops and tokens equal
single-host serving's under every placement and host count.  A gang is
never split across hosts.  The router owns no device state: every host
reads the one set of weights the caller passed.

With ``parallel_hosts`` (the default, for ``n_hosts > 1``) the hosts step
concurrently in a thread pool, and on a CUDA device each host works on a
``torch.cuda.Stream`` of its own: its step, its admissions, its engine
and pool building all run with that stream current in the thread doing
them (the current stream is per thread), so the kernels, which launch on
the current stream, follow, and the step's one synchronous host read
waits for that host's stream alone.  Everything a host allocates it
allocates and uses on its own stream; the weights and probe are made on
the caller's stream, which every host stream waits on once at
construction, and the caller's stream waits on every host stream after
each fleet step, so whatever the caller does next (reading an engine,
freeing the weights) follows the hosts' work.  With serial stepping, or
on the CPU, no stream is made.

The JAX package's ``repro/serving/router.py`` in this port's idiom: the
router speaks the scheduler's ``submit()`` / ``step()`` / ``drain()`` /
``run()`` protocol, so ``repro_torch.api.serve_requests`` drives either.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serving.config import ServeConfig
from repro_torch.serving.draft_cache import DraftCache
from repro_torch.serving.engine import params_device, prefix_len
from repro_torch.serving.groups import RequestGroup, group_requests
from repro_torch.serving.kv_pool import prompt_key
from repro_torch.serving.policy import (HostPressure, PlacementPolicy,
                                        SchedulingPolicy, make_placement,
                                        make_policy)
from repro_torch.serving.request import (FleetMetrics, Request, latency_stats,
                                         spec_stats)
from repro_torch.serving.scheduler import _UNSET, OrcaScheduler, _pick


def _clone_policy(spec: Any) -> SchedulingPolicy:
    """A fresh policy instance per host (and one for the router): aging
    state must be host-local, never shared."""
    if spec is None or isinstance(spec, str):
        return make_policy(spec)
    return copy.deepcopy(spec)


class FleetRouter:
    """Shards ``OrcaScheduler`` across ``n_hosts`` simulated hosts.

    Speaks the scheduler's ``submit``/``step``/``drain``/``run`` protocol;
    build it through ``repro_torch.api.fleet`` in application code.  After
    a ``drain``, ``host_metrics`` holds each host's ``FleetMetrics`` and
    ``step_ms`` the wall time of every fleet step of the session.
    """

    def __init__(self, model, params, probe_config, theta,
                 cfg: Optional[ServeConfig] = None, *,
                 n_hosts: Any = _UNSET, placement: Any = _UNSET,
                 parallel_hosts: bool = True) -> None:
        cfg = cfg if cfg is not None else ServeConfig()
        self.n_hosts = int(_pick(n_hosts, cfg.n_hosts))
        if self.n_hosts < 1:
            raise ValueError(
                f"n_hosts={self.n_hosts} must be >= 1; fix by passing a "
                "positive host count (1 behaves like a single scheduler)")
        self.cfg = dataclasses.replace(cfg, n_hosts=self.n_hosts)
        self.model = model
        self.placement: PlacementPolicy = make_placement(
            _pick(placement, cfg.placement))
        # the router's own ordering policy: the hosts' select_admit_unit
        # semantics, applied to the cross-host queue
        self.policy = _clone_policy(cfg.policy)
        self.parallel_hosts = bool(parallel_hosts) and self.n_hosts > 1

        # cfg.num_blocks is the TOTAL fleet budget, split as evenly as
        # pages allow (the first hosts take the remainder)
        shares: List[Optional[int]] = [None] * self.n_hosts
        if cfg.num_blocks:
            per, rem = divmod(int(cfg.num_blocks), self.n_hosts)
            if per < 1:
                raise ValueError(
                    f"num_blocks={cfg.num_blocks} split across "
                    f"{self.n_hosts} hosts leaves a host with an empty "
                    "pool; fix by raising num_blocks to >= "
                    f"{self.n_hosts} or lowering n_hosts")
            shares = [per + (1 if i < rem else 0)
                      for i in range(self.n_hosts)]
        # ONE draft cache for the whole fleet: a continuation accepted on
        # any host drafts for every other host's traffic (it locks itself
        # against the hosts' threads)
        spec_on = bool(cfg.spec_tokens or cfg.spec_tree)
        self.draft_cache: Optional[DraftCache] = (
            DraftCache(capacity=cfg.draft_cache_size)
            if spec_on and cfg.draft_cache_size
            and getattr(model, "self_draft", False) else None)
        self.hosts: List[OrcaScheduler] = []
        for share in shares:
            host_cfg = dataclasses.replace(
                cfg, n_hosts=1, num_blocks=share,
                policy=_clone_policy(cfg.policy))
            self.hosts.append(OrcaScheduler(
                model, params, probe_config, theta, host_cfg,
                draft_cache=self.draft_cache))
        # the resolved single-host attributes callers introspect
        h0 = self.hosts[0]
        self.n_slots = h0.n_slots            # PER HOST
        self.paged = h0.paged
        self.block_size = h0.block_size
        self.prefix_sharing = h0.prefix_sharing
        self.consensus = h0.consensus
        self.group_size = cfg.group_size
        device = params_device(params if params is not None else theta)
        self._streams: List[Optional[torch.cuda.Stream]] = \
            [None] * self.n_hosts
        if self.parallel_hosts and device.type == "cuda":
            made_on = torch.cuda.current_stream(device)
            self._streams = [torch.cuda.Stream(device)
                             for _ in range(self.n_hosts)]
            for s in self._streams:
                s.wait_stream(made_on)     # the weights and the probe
        self._device = device
        self._pool = (ThreadPoolExecutor(
            max_workers=self.n_hosts, thread_name_prefix="fleet-host")
            if self.parallel_hosts else None)
        self.host_metrics: List[FleetMetrics] = []
        self._session_open = False
        self._reset_session()

    def close(self) -> None:
        """Stop the host threads (a closed router still steps serially)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # ------------------------------------------------------------------
    def _reset_session(self) -> None:
        self._queue: List[List[Request]] = []    # unplaced admission units
        self._population: List[Request] = []     # every submitted request
        self._prefix_home: Dict[str, int] = {}   # prompt hash -> host
        self._steps = 0
        self._routed_affine = 0
        self.step_ms: List[float] = []
        self._t0 = time.perf_counter()

    def _host_call(self, i: int, fn, *args):
        """``fn(host i, *args)`` with host ``i``'s stream current in this
        thread (``torch.cuda.stream(None)`` without streams is a no-op)."""
        with torch.cuda.stream(self._streams[i]):
            return fn(self.hosts[i], *args)

    def _join(self) -> None:
        """The caller's stream waits for every host stream's work."""
        if self._streams[0] is not None:
            cur = torch.cuda.current_stream(self._device)
            for s in self._streams:
                cur.wait_stream(s)

    @property
    def has_work(self) -> bool:
        """True while any request is unplaced, queued, swapped or
        resident on any host."""
        return bool(self._queue) or any(h.has_work for h in self.hosts)

    @property
    def groups(self) -> List[RequestGroup]:
        """Consensus outcomes across the fleet (host-owned groups)."""
        out: List[RequestGroup] = []
        for h in self.hosts:
            out.extend(h.groups)
        return out

    def pressures(self) -> List[HostPressure]:
        """The per-host snapshots the placement policy reads."""
        return [h.pressure(i) for i, h in enumerate(self.hosts)]

    # ------------------------------------------------------------------
    def _prepare_hosts(self) -> None:
        for i in range(self.n_hosts):
            self._host_call(i, OrcaScheduler.prepare, self._population)
        self._join()

    def prepare(self, requests: Sequence[Request]) -> None:
        """Size every host's engine and pool for ``requests`` (cumulative
        with earlier submissions) without enqueueing them."""
        if not self._session_open:
            self._reset_session()
            self._session_open = True
        self._population.extend(requests)
        self._prepare_hosts()

    def submit(self, requests: Sequence[Request]) -> None:
        """Enqueue ``requests`` and place them onto hosts, eagerly: the
        placement queue drains by total-capacity feasibility, so a unit no
        host can EVER fit raises instead of waiting forever."""
        requests = list(requests)
        fresh = not self._session_open
        if fresh:
            self._reset_session()
            self._session_open = True
        if not requests:
            return
        self._population.extend(requests)
        # every host sizes for the full population up front: placement
        # must never trigger a mid-flight engine rebuild on a busy host
        self._prepare_hosts()
        units, groups = group_requests(requests)
        for grp in groups:
            if grp.size > self.n_slots:
                raise ValueError(
                    f"group {grp.group_id} has {grp.size} samples but "
                    f"each host has {self.n_slots} slots: a gang is "
                    "never split across hosts, so the whole group must "
                    "fit one host; fix by raising n_slots to >= "
                    f"{grp.size} or lowering the group size")
        if fresh:
            self._t0 = time.perf_counter()
        self._queue.extend(units)
        self._place()

    def run(self, requests: Sequence[Request]
            ) -> Tuple[List[Request], FleetMetrics]:
        """Submit + drain (the scheduler's ``run`` contract)."""
        if self._session_open and self.has_work:
            raise RuntimeError(
                "run() while a fleet session is active would reset "
                "resident state; drive incremental traffic through "
                "submit()/step()/drain() instead")
        self._session_open = False
        self.submit(requests)
        return self.drain()

    # ------------------------------------------------------------------
    def _affinity_key(self, req: Request) -> Optional[str]:
        """The prompt hash the prefix registry would file this request
        under, computed router-side (the scheduler's ``_sharing_key``
        conditions, without a live engine)."""
        if not (self.paged and self.prefix_sharing
                and self.model.supports_paged):
            return None
        if set(req.inputs) != {"tokens"}:
            return None
        if prefix_len(self.model.cfg, req.inputs, req.prompt_len) \
                != req.prompt_len:
            return None
        return prompt_key(np.asarray(req.inputs["tokens"]))

    def _place(self) -> None:
        """Drain the placement queue: the router policy picks the next
        unit, the placement policy its host from the hosts' pressures."""
        while self._queue:
            pressures = self.pressures()
            cand = self._queue
            sel = self.policy.select_admit_unit(cand, self._steps)
            unit = cand[sel]
            members = [r for r in unit if not r.done]
            if not members:          # fully cancelled before placement
                del self._queue[sel]
                continue
            need_pages = 0
            if self.paged:
                need_pages = sum(self.hosts[0]._request_blocks(r)
                                 for r in members)
            key = self._affinity_key(members[0])
            affine = self._prefix_home.get(key) if key else None
            host_idx = self.placement.select_host(
                members, pressures, need_slots=len(members),
                need_pages=need_pages, affine_host=affine)
            if host_idx is None:
                what = (f"group {members[0].group_id}"
                        if members[0].group_id is not None
                        else f"request {members[0].req_id}")
                raise RuntimeError(
                    f"{what} needs {len(members)} slots and "
                    f"{need_pages} pages but no host can ever fit it "
                    f"(per-host: {self.n_slots} slots, "
                    f"{pressures[0].pool_blocks} pages); fix by raising "
                    "n_slots/num_blocks or lowering the group size")
            self.policy.on_admitted_unit(cand, sel)
            del self._queue[sel]
            if affine is not None and host_idx == affine:
                self._routed_affine += 1
            if key is not None and key not in self._prefix_home:
                self._prefix_home[key] = host_idx
            for r in members:
                r.host = host_idx
            self._host_call(host_idx, OrcaScheduler.submit, members)
        self._join()

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One fleet iteration: place unrouted units, then step every host
        with work, concurrently with ``parallel_hosts``.  Returns False
        when the fleet is idle."""
        if not self.has_work:
            return False
        t0 = time.perf_counter()
        self._place()
        active = [i for i, h in enumerate(self.hosts) if h.has_work]
        if self._pool is not None and len(active) > 1:
            list(self._pool.map(
                lambda i: self._host_call(i, OrcaScheduler.step), active))
        else:
            for i in active:
                self._host_call(i, OrcaScheduler.step)
        self._join()
        self._steps += 1
        self.step_ms.append((time.perf_counter() - t0) * 1e3)
        return True

    def drain(self) -> Tuple[List[Request], FleetMetrics]:
        """Step until every host is idle; return all requests (submission
        order) and the fleet's aggregated metrics."""
        while self.step():
            pass
        wall = max(time.perf_counter() - self._t0, 1e-9)
        # hosts idle: their drain only closes the session and counts
        self.host_metrics = [h.drain()[1] for h in self.hosts]
        metrics = self._aggregate(self.host_metrics, wall)
        requests = list(self._population)
        self._session_open = False
        return requests, metrics

    # ------------------------------------------------------------------
    def _aggregate(self, host_metrics: List[FleetMetrics],
                   wall: float) -> FleetMetrics:
        """Fleet-level FleetMetrics: counters sum, rates recompute over the
        union at the FLEET wall clock, percentiles recompute over the
        request union (never averaged across hosts: wrong for tails), and
        the stall tail is the worst host's (hosts step concurrently)."""
        requests = self._population
        n = len(requests)
        total_tokens = sum(len(r.tokens) for r in requests)
        sav = [r.savings(self.cfg.tokens_per_step, self.cfg.max_new_tokens)
               for r in requests]
        queue = [r.queue_steps for r in requests]
        ttft_p50, ttft_p99, per_class = latency_stats(list(requests))
        steps = self._steps
        active = sum(m.active_slot_steps for m in host_metrics)
        fired_steps = [(m.consensus_steps, m.consensus_groups)
                       for m in host_metrics if m.consensus_groups]
        n_fired = sum(k for _, k in fired_steps)
        groups = [g for g in self.groups if g.size >= 2]
        tps, dmn = self.cfg.tokens_per_step, self.cfg.max_new_tokens
        g_sav = [g.savings(tps, dmn) for g in groups]
        return FleetMetrics(
            **spec_stats(list(requests)),
            n_requests=n, n_slots=self.n_slots, engine_steps=steps,
            active_slot_steps=active, wall_time_s=wall,
            requests_per_s=n / wall, tokens_per_s=total_tokens / wall,
            slot_utilization=(active / max(steps * self.n_slots
                                           * self.n_hosts, 1)),
            mean_step_savings=float(np.mean(sav)) if sav else 0.0,
            mean_queue_steps=float(np.mean(queue)) if queue else 0.0,
            pool_blocks=sum(m.pool_blocks for m in host_metrics),
            peak_blocks_in_use=sum(m.peak_blocks_in_use
                                   for m in host_metrics),
            prefill_skips=sum(m.prefill_skips for m in host_metrics),
            ttft_ms_p50=ttft_p50, ttft_ms_p99=ttft_p99,
            stall_ms_p50=max(m.stall_ms_p50 for m in host_metrics),
            stall_ms_p99=max(m.stall_ms_p99 for m in host_metrics),
            prefill_chunks=sum(m.prefill_chunks for m in host_metrics),
            packed_chunks=sum(m.packed_chunks for m in host_metrics),
            peak_step_tokens=max(m.peak_step_tokens
                                 for m in host_metrics),
            per_class=per_class,
            samples_cancelled=sum(m.samples_cancelled
                                  for m in host_metrics),
            consensus_groups=n_fired,
            consensus_steps=(sum(s * k for s, k in fired_steps)
                             / n_fired if n_fired else 0.0),
            group_savings=sum(m.group_savings for m in host_metrics),
            group_savings_mean=float(np.mean(g_sav)) if g_sav else 0.0,
            cancel_freed_blocks=sum(m.cancel_freed_blocks
                                    for m in host_metrics),
            preemptions=sum(m.preemptions for m in host_metrics),
            restores=sum(m.restores for m in host_metrics),
            spilled_blocks=sum(m.spilled_blocks for m in host_metrics),
            n_hosts=self.n_hosts, routed_affine=self._routed_affine)
