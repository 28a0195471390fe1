"""OrcaScheduler: continuous batching with ORCA-stop eviction.

The JAX package's scheduler (``repro/serving/scheduler.py``), cut to what
the port's engine serves: admission-time or chunked, packed prefill, gang
admission under the FIFO, priority, EDF or TTFT-aware policy, involuntary
preemption, one-token, linear or tree speculative decode with the shared
draft cache, dense or paged KV with prefix sharing.  The admission loop,
batch composer, token collection and metrics are the JAX package's line
for line, so per-request stop steps, tokens, admission, restore and
completion steps match it exactly on the same model outputs.  The
``FleetRouter`` (``serving/router.py``) shards it across simulated hosts.

Self-consistency groups (``group_id`` on the requests): a group is
admitted as one unit, its siblings share the first sample's prompt pages
and skip prefill, and with ``consensus`` (a ``GroupCalibrator`` or a
float threshold) each open group's confidence-weighted vote is checked
after every step's collection; the first crossing CANCELS every sibling
still running, mid-flight: slot, pages and probe row back to the fleet
(``engine.cancel``), a SWAPPED sibling's spill dropped unrestored.

Preemption (``preemption=True``, the default): when capacity (slots or
pages) fails for a unit strictly MORE urgent than some resident, the
policy's ``select_victim`` picks strictly-lower-priority victims (newest
first) and ``engine.preempt`` spills each one's KV pages and probe state
to host RAM (``engine.Spill``).  Spilled requests sit in a SWAPPED queue
that restores BEFORE the waiting queue, into any free slot and any free
pages, and a swapped head that cannot yet restore barriers its own class.
A feasibility simulation over the pool's refcounts runs before any spill,
so no victim is spilled for a unit that still would not fit, and the
preemption relation is a DAG: no livelock.  The round trip is bit-exact,
so stop decisions do not move under any preemption schedule.

Speculative decode (``spec_tokens=k``): each RUNNING slot claims up to
k - 1 draft tokens beyond its current token from the same token budget
(capped by its remaining decode budget), drafted by the shared n-gram
``DraftCache`` where it hits and by the model's self-draft elsewhere; the
accepted prefix lands in order, one score is collected per probe boundary
it crosses, collection stops at the stop step, and what landed is
promoted into the cache.  Tree speculative decode (``spec_tree="W.D"``)
claims up to 1 + W*D NODES a slot, capped at ``W * (remaining - 1)``
extra (the accepted path holds one node a depth), drafts a (W, D) tree
from the cache, and lands the longest accepted root path.

Chunked prefill (``chunk_tokens=N``) turns prefill into schedulable work:
an admitted request becomes a resident PREFILL row, and each engine
iteration carries every resident decode token plus, up to
``token_budget`` tokens, a PACKED prefill chunk of up to ``chunk_tokens``
prompt tokens drawn from up to ``pack_max`` mid-prefill residents in
admission order (``pack_chunks=False``: one request per chunk).

The scheduler owns the request lifecycle (queues, admission, eviction,
metrics) and — in paged mode — the KV block pool; the engine owns device
state.  Waiting requests are admitted into fixed-shape batch slots; the
moment the calibrated ORCA threshold test stops a sequence, its slot (and
its pages) is released and refilled from the queue on the next step.

Paged admission reserves ``ceil((prompt_len + max_new) / block_size)``
pages all-or-nothing (a request that does not fit stays WAITING); a prompt
already resident is admitted as a block-table copy + refcount bump on the
shared full prompt pages, with only the partial tail page copied.

Families without a page layout, chunked prefill or speculative decode
(RWKV6: an O(1) recurrent state) are served as in the JAX package: with
``paged=True`` the pool still admission-controls while the engine keeps a
dense state, and ``chunk_tokens`` / ``spec_tokens`` warn and fall back to
admission-time prefill and one-token decode.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.calibrator import GroupCalibrator
from repro_torch.core.probe import ProbeConfig
from repro_torch.models.registry import Model
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.engine import (ChunkSeg, ChunkWork,
                                        ContinuousServingEngine, Spill,
                                        chunk_supported, prefix_len)
from repro_torch.serving.draft_cache import DraftCache
from repro_torch.serving.groups import RequestGroup, group_requests
from repro_torch.serving.kv_pool import BlockPool, blocks_needed, prompt_key
from repro_torch.serving.policy import (ComposeView, HostPressure,
                                        SchedulingPolicy, make_policy)
from repro_torch.serving.request import (FleetMetrics, Request, RequestState,
                                         latency_stats, spec_stats)


@dataclasses.dataclass(frozen=True)
class _AdmitPlan:
    """One request's reserved pages + how to fill them."""
    row: List[int]               # physical pages, virtual order
    n_shared: int                # leading pages refcount-shared with a donor
    skip_prefill: bool
    copy_tail: Optional[Tuple[int, int]]   # (donor tail page, private copy)
    register_key: Optional[str]  # register as prefix donor after admission


# constructor-keyword sentinel: "not passed" (resolve from ServeConfig)
# versus an explicit None (meaningful for cache_len / num_blocks)
_UNSET: object = object()


def _pick(explicit, cfg_value):
    """An explicitly passed constructor keyword wins over the config."""
    return cfg_value if explicit is _UNSET else explicit


class OrcaScheduler:
    """Admit waiting requests into slots; evict on ORCA stop or budget.

    Driving protocol: ``submit(requests)``, ``step()`` (one iteration;
    False once idle), ``drain()`` -> (requests, FleetMetrics), and
    ``run(requests)`` = submit + drain.  ``prepare(requests)`` sizes the
    engine and pool for a population without enqueueing it, and
    ``pressure()`` exports the scheduler's ``HostPressure`` snapshot.
    """

    def __init__(self, model: Model, params, pc: ProbeConfig, theta,
                 cfg: ServeConfig, *, n_slots: int = _UNSET,
                 cache_len: Optional[int] = _UNSET, paged: bool = _UNSET,
                 block_size: int = _UNSET,
                 num_blocks: Optional[int] = _UNSET,
                 prefix_sharing: bool = _UNSET,
                 chunk_tokens: Optional[int] = _UNSET,
                 token_budget: Optional[int] = _UNSET,
                 pack_chunks: bool = _UNSET, pack_max: int = _UNSET,
                 policy: Union[str, SchedulingPolicy, None] = _UNSET,
                 consensus: Union[GroupCalibrator, float, None] = _UNSET,
                 preemption: bool = _UNSET,
                 spec_tokens: Optional[int] = _UNSET,
                 spec_tree: Optional[str] = _UNSET,
                 draft_cache: Optional[DraftCache] = None):
        self.model, self.params, self.pc, self.theta, self.cfg = \
            model, params, pc, theta, cfg
        n_slots = int(_pick(n_slots, cfg.n_slots))
        chunk_tokens = _pick(chunk_tokens, cfg.chunk_tokens)
        token_budget = _pick(token_budget, cfg.token_budget)
        spec_tokens = _pick(spec_tokens, cfg.spec_tokens)
        self.n_slots = n_slots
        self.cache_len = _pick(cache_len, cfg.cache_len)
        self.paged = bool(_pick(paged, cfg.paged))
        self.block_size = int(_pick(block_size, cfg.block_size))
        self.num_blocks = _pick(num_blocks, cfg.num_blocks)
        self.prefix_sharing = bool(_pick(prefix_sharing, cfg.prefix_sharing))
        # chunked prefill: each engine iteration carries every resident
        # decode token plus up to ``chunk_tokens`` prompt tokens of
        # mid-prefill residents (PACKED across up to ``pack_max`` requests
        # unless ``pack_chunks=False``), bounded by ``token_budget`` tokens
        # per step (default: n_slots decode tokens + one full chunk)
        self.chunk_tokens = int(chunk_tokens) if chunk_tokens else None
        if self.chunk_tokens is not None and not model.supports_chunked:
            warnings.warn(
                f"chunk_tokens={self.chunk_tokens} ignored: model family "
                f"{model.cfg.name!r} has no chunked/packed prefill — "
                "serving falls back to admission-time (one-shot) prefill; "
                "drop chunk_tokens or use a family with "
                "supports_chunked=True to silence this",
                RuntimeWarning, stacklevel=2)
            self.chunk_tokens = None      # family without prefill_chunk
        # speculative draft-verify decode: each RUNNING slot may ride the
        # packed verify chunk with up to spec_tokens tokens per step, drawn
        # from the same token budget the prefill share composes against
        self.spec_tokens = int(spec_tokens) if spec_tokens else None
        if self.spec_tokens is not None and not model.supports_spec:
            warnings.warn(
                f"spec_tokens={self.spec_tokens} ignored: model family "
                f"{model.cfg.name!r} has no draft/verify speculative "
                "decode — serving falls back to one-token decode; drop "
                "spec_tokens or use a family with supports_spec=True to "
                "silence this",
                RuntimeWarning, stacklevel=2)
            self.spec_tokens = None       # family without verify_packed
        # tree speculative decode: "W.D" makes the verify block 1 + W*D
        # candidate NODES a slot; self.spec_tokens becomes that node count
        # so every budget computation below stays unit-correct
        spec_tree = _pick(spec_tree, cfg.spec_tree)
        self.spec_tree: Optional[Tuple[int, int]] = None
        if spec_tree:
            if self.spec_tokens is not None:
                raise ValueError(
                    f"spec_tree={spec_tree!r} with spec_tokens="
                    f"{self.spec_tokens} is ambiguous — they are two "
                    "shapes of the same verify segment; fix by passing "
                    "ONE of them")
            if isinstance(spec_tree, (tuple, list)):
                shape = (int(spec_tree[0]), int(spec_tree[1]))
            else:
                shape = dataclasses.replace(
                    cfg, spec_tree=str(spec_tree),
                    spec_tokens=None).tree_shape()
            if not model.supports_tree:
                warnings.warn(
                    f"spec_tree={spec_tree!r} ignored: model family "
                    f"{model.cfg.name!r} has no tree speculative decode "
                    "— serving falls back to one-token decode; drop "
                    "spec_tree or use a family with supports_tree=True "
                    "to silence this",
                    RuntimeWarning, stacklevel=2)
            else:
                self.spec_tree = shape
                self.spec_tokens = 1 + shape[0] * shape[1]
        # shared n-gram draft cache: the serving layer's drafter for
        # families whose own draft is the degenerate repeat-last-token
        # self-draft; an explicit instance fronts any family
        if draft_cache is not None:
            self.draft_cache: Optional[DraftCache] = draft_cache
        elif (self.spec_tokens is not None and model.self_draft
                and cfg.draft_cache_size):
            self.draft_cache = DraftCache(capacity=cfg.draft_cache_size)
        else:
            self.draft_cache = None
        if self.spec_tokens is None:
            self.draft_cache = None       # nothing to draft for
        if token_budget is not None:
            token_budget = int(token_budget)
            floor = n_slots if (self.chunk_tokens is not None
                                or self.spec_tokens is not None) else 1
            if token_budget < floor:
                raise ValueError(
                    f"token_budget={token_budget} < n_slots={n_slots}: "
                    "every resident decode token rides each unified step, "
                    "so this budget can never be honored and would "
                    "silently starve prefill; fix by raising token_budget "
                    f"to >= n_slots (default n_slots + chunk_tokens = "
                    f"{n_slots + (self.chunk_tokens or 0)}) or lowering "
                    "n_slots")
        # default budget: one decode token per slot (spec_tokens of them
        # in draft-verify mode) plus the prefill chunk; an EXPLICIT budget
        # instead throttles spec extras before prefill share
        self.token_budget = (token_budget if token_budget
                             else n_slots * (self.spec_tokens or 1)
                             + (self.chunk_tokens or 0))
        self.pack_chunks = bool(_pick(pack_chunks, cfg.pack_chunks))
        self.pack_max = int(_pick(pack_max, cfg.pack_max))
        # the composer's policy: admission order, prefill share, victims
        self.policy = make_policy(_pick(policy, cfg.policy))
        # group consensus stop: a calibrated GroupCalibrator, a raw
        # agreement threshold in (0, 1], or None (groups still
        # gang-schedule and share prompt pages, but every sample runs to
        # its own per-request stop)
        consensus = _pick(consensus, cfg.consensus)
        if isinstance(consensus, bool):
            raise ValueError(
                f"consensus={consensus!r} is not a threshold: pass a float "
                "agreement threshold in (0, 1], a calibrated "
                "GroupCalibrator, or None to disable the consensus stop")
        if isinstance(consensus, (int, float)):
            thr = float(consensus)
            if not 0.0 < thr <= 1.0:
                raise ValueError(
                    f"consensus={thr} is outside (0, 1]: the threshold is "
                    "the weight share the top answer must reach; fix by "
                    "passing a float in (0, 1] or a calibrated "
                    "GroupCalibrator")
            consensus = GroupCalibrator(lam=thr, burn_in=cfg.burn_in)
        elif consensus is not None:
            if not isinstance(consensus, GroupCalibrator):
                raise ValueError(
                    f"consensus must be a GroupCalibrator, a float in "
                    f"(0, 1] or None, got {type(consensus).__name__}")
            if consensus.lam is None:
                raise ValueError(
                    "consensus GroupCalibrator has no threshold — run "
                    "GroupCalibrator.calibrate(...) first or pass "
                    "consensus=<float threshold>")
        self.consensus: Optional[GroupCalibrator] = consensus
        # involuntary preemption: capacity failures for strictly-more-
        # urgent units spill lower-priority residents instead of waiting
        self.preemption = bool(_pick(preemption, cfg.preemption))
        self.pool: Optional[BlockPool] = None
        self._engine: Optional[ContinuousServingEngine] = None
        self._session_open = False
        self._reset_session()

    # ------------------------------------------------------------------
    # serving-session state: queues, residents and counters for ONE
    # submit..drain cycle; engine, pool and policy survive across sessions
    def _reset_session(self) -> None:
        self._waiting: deque = deque()            # gang-admission units
        self._swapped: deque = deque()            # (request, Spill) pairs
        self._running: Dict[int, Request] = {}    # slot -> request
        self._prefilling: Dict[int, Request] = {}  # slot -> mid-prefill req
        self._plans: Dict[int, _AdmitPlan] = {}   # deferred donor registry
        self._free: List[int] = list(range(self.n_slots))
        self._requests: List[Request] = []        # submission order
        self.groups: List[RequestGroup] = []      # consensus outcomes
        self._open_groups: List[RequestGroup] = []
        self._steps = 0
        self._active_slot_steps = 0
        self._total_tokens = self._n_chunks = self._n_packed = 0
        self._peak_blocks = self._prefill_skips = self._peak_step_tokens = 0
        self._n_preempted = self._n_restored = self._n_spilled_blocks = 0
        self._n_cancelled = self._cancel_freed = 0
        self._stalls: List[float] = []
        self._t0 = time.perf_counter()

    @property
    def has_work(self) -> bool:
        """True while any request is queued, swapped or resident."""
        return bool(self._waiting or self._swapped or self._running
                    or self._prefilling)

    def _resident(self) -> bool:
        return bool(self._running or self._prefilling or self._swapped)

    @property
    def engine(self) -> Optional[ContinuousServingEngine]:
        return self._engine

    def _refuse_rebuild(self, what: str, have, need) -> None:
        raise RuntimeError(
            f"submit() needs {what} of {need} but the live session has "
            f"{have} with requests resident — a rebuild would discard "
            "their KV/probe state; fix by sizing the fleet up front via "
            "prepare(<full request population>) (or an explicit "
            "cache_len/num_blocks) before serving starts")

    def _ensure_engine(self, requests: Sequence[Request]
                       ) -> ContinuousServingEngine:
        cache_len = self.cache_len
        if cache_len is None:
            mcfg = self.model.cfg
            max_prompt = max((prefix_len(mcfg, r.inputs, r.prompt_len)
                              for r in requests), default=0)
            if mcfg.arch_type == "audio":
                max_prompt = 0  # decoder cache holds generated tokens only
            max_new = max([r.max_new_tokens or self.cfg.max_new_tokens
                           for r in requests] + [self.cfg.max_new_tokens])
            cache_len = max_prompt + max_new
        rebuild = self._engine is None or self._engine.cache_len < cache_len
        # device-paged only for families with a page layout; every family
        # still gets pool-based admission control (backpressure)
        device_paged = self.paged and self.model.supports_paged
        if self.paged:
            cache_len = max([cache_len]
                            + [self._request_tokens(r) for r in requests])
            max_blocks = blocks_needed(cache_len, self.block_size)
            if self.num_blocks:
                num_blocks = int(self.num_blocks)
            else:
                num_blocks = self.n_slots * max_blocks + 1
                if self.pool is not None:
                    # derived sizing never shrinks a live pool
                    num_blocks = max(num_blocks, self.pool.num_blocks)
            if self.pool is not None and self.pool.num_blocks != num_blocks \
                    and (self.pool.blocks_in_use or self._resident()):
                if num_blocks > self.pool.num_blocks:
                    self._refuse_rebuild("a page pool",
                                         self.pool.num_blocks, num_blocks)
                num_blocks = self.pool.num_blocks   # big enough: keep it
            if self.pool is None or self.pool.num_blocks != num_blocks:
                self.pool = BlockPool(num_blocks, self.block_size)
            rebuild = self._engine is None or \
                self._engine.cache_len < cache_len
        else:
            num_blocks = None
        if rebuild:
            if self._engine is not None and self._resident():
                self._refuse_rebuild("an engine cache_len",
                                     self._engine.cache_len, cache_len)
            self._engine = ContinuousServingEngine(
                self.model, self.params, self.pc, self.theta, self.cfg,
                self.n_slots, cache_len, paged=device_paged,
                block_size=self.block_size, num_blocks=num_blocks,
                chunk_tokens=self.chunk_tokens, pack_max=self.pack_max,
                spec_tokens=None if self.spec_tree else self.spec_tokens,
                spec_tree=self.spec_tree)
        return self._engine

    # ------------------------------------------------------------------
    # paged admission: reserve pages (all-or-nothing) + prefix sharing
    def _request_tokens(self, req: Request) -> int:
        """Virtual positions this request needs: prefill prefix + budget
        (the budget alone for audio, whose decoder cache holds generated
        tokens only)."""
        mcfg = self.model.cfg
        max_new = req.max_new_tokens or self.cfg.max_new_tokens
        if mcfg.arch_type == "audio":
            return max_new
        return prefix_len(mcfg, req.inputs, req.prompt_len) + max_new

    def _request_blocks(self, req: Request) -> int:
        return blocks_needed(self._request_tokens(req), self.block_size)

    def _draft_context(self, req: Request, before: int = 0) -> List[int]:
        """The request's last draft-cache n-gram of committed tokens
        (prompt tail + decoded tokens), as plain ints.  ``before`` drops
        that many just-landed trailing tokens: the PRE-step context the
        promotion path keys on."""
        n = self.draft_cache.ngram
        toks = req.tokens[:len(req.tokens) - before] if before \
            else req.tokens
        if len(toks) >= n:
            return [int(t) for t in toks[-n:]]
        prompt = (np.asarray(req.inputs["tokens"][0]).tolist()
                  if "tokens" in req.inputs else [])
        need = n - len(toks)
        return ([int(t) for t in prompt[max(len(prompt) - need, 0):]]
                + [int(t) for t in toks])

    def _sharing_key(self, req: Request) -> Optional[str]:
        if not (self.prefix_sharing and self._engine is not None
                and self._engine.paged):
            return None
        if set(req.inputs) != {"tokens"}:      # multimodal prefixes differ
            return None
        if prefix_len(self.model.cfg, req.inputs, req.prompt_len) \
                != req.prompt_len:
            return None
        return prompt_key(np.asarray(req.inputs["tokens"]))

    def _reserve(self, req: Request) -> Optional[_AdmitPlan]:
        """Try to reserve this request's pages; None = pool exhausted (the
        request stays WAITING — backpressure, not over-admission)."""
        pool = self.pool
        n_total = self._request_blocks(req)
        key = self._sharing_key(req)
        entry = pool.lookup_prefix(key) if key else None
        if entry is not None and entry.prompt_len == req.prompt_len \
                and len(entry.full_blocks) <= n_total:
            private = pool.allocate(n_total - len(entry.full_blocks))
            if private is None:
                return None
            shared = pool.share(entry.full_blocks)
            copy_tail = None
            if entry.tail_block is not None and private:
                copy_tail = (entry.tail_block, private[0])
            return _AdmitPlan(row=shared + private, n_shared=len(shared),
                              skip_prefill=True, copy_tail=copy_tail,
                              register_key=None)
        row = pool.allocate(n_total)
        if row is None:
            return None
        return _AdmitPlan(row=row, n_shared=0, skip_prefill=False,
                          copy_tail=None, register_key=key)

    def _register_donor(self, req: Request, plan: _AdmitPlan) -> None:
        if plan.register_key is None:
            return
        bs = self.block_size
        n_full = req.prompt_len // bs
        tail = plan.row[n_full] if (req.prompt_len % bs
                                    and n_full < len(plan.row)) else None
        self.pool.register_prefix(plan.register_key, plan.row[:n_full],
                                  tail, req.prompt_len)

    def _chunks_prefill(self, req: Request) -> bool:
        """Will this request's prompt prefill in scheduled chunks (its
        pages only hold the prompt K/V once the LAST chunk lands)?"""
        return bool(self._engine is not None and self._engine.chunk_tokens
                    and chunk_supported(self.model, req.inputs))

    def _share_from_donor(self, donor, req: Request) -> Optional[_AdmitPlan]:
        """Intra-gang prefix sharing off the unit leader's fresh prompt
        pages (refcount bump + private pages for the tail/decode)."""
        key, row, d_prompt = donor
        n_total = self._request_blocks(req)
        n_full = req.prompt_len // self.block_size
        if d_prompt != req.prompt_len or n_full > len(row) \
                or n_total < n_full:
            return None
        private = self.pool.allocate(n_total - n_full)
        if private is None:
            return None
        shared = self.pool.share(row[:n_full])
        copy_tail = None
        if req.prompt_len % self.block_size and n_full < len(row) \
                and private:
            copy_tail = (row[n_full], private[0])
        return _AdmitPlan(row=shared + private, n_shared=n_full,
                          skip_prefill=True, copy_tail=copy_tail,
                          register_key=None)

    def _reserve_unit(self, members: Sequence[Request]
                      ) -> Optional[List[_AdmitPlan]]:
        """ALL-OR-NOTHING page reservation for a gang-admission unit: the
        first sample reserves (or prefix-hits) the prompt pages, siblings
        share its full prompt pages by refcount (only when the leader's
        prompt lands in one admission shot: chunked prefill defers the
        donor until the last chunk); any failure rolls the whole unit
        back."""
        plans: List[_AdmitPlan] = []
        donor = None
        for req in members:
            plan = None
            key = self._sharing_key(req)
            if donor is not None and key is not None and key == donor[0]:
                plan = self._share_from_donor(donor, req)
            if plan is None:
                plan = self._reserve(req)
                if plan is not None and plan.register_key is not None \
                        and donor is None and not self._chunks_prefill(req):
                    donor = (plan.register_key, plan.row, req.prompt_len)
            if plan is None:
                for p in plans:
                    self.pool.free(p.row)
                return None
            plans.append(plan)
        return plans

    # ------------------------------------------------------------------
    # involuntary preemption: spill residents to host RAM, restore later
    def _spill(self, req: Request) -> None:
        """Preempt one resident: engine state to host RAM, pages back to
        the pool, slot back to the fleet, request onto the SWAPPED queue."""
        eng = self._engine
        slot = req.slot
        spill = eng.preempt(
            slot,
            block_row=(req.block_ids if eng.paged and req.block_ids
                       else None),
            armed=req.state is RequestState.RUNNING,
            prompt_len=req.prefill_progress)
        if self.paged and req.block_ids:
            self._n_spilled_blocks += len(req.block_ids)
            self.pool.free(req.block_ids)
        req.block_ids = []
        req.n_shared_blocks = 0
        self._running.pop(slot, None)
        self._prefilling.pop(slot, None)
        # a mid-prefill victim's deferred donor plan names the pages just
        # freed: dropped (the restored request registers no prefix)
        self._plans.pop(slot, None)
        self._free.append(slot)
        req.slot = -1
        req.state = RequestState.SWAPPED
        req.n_preempted += 1
        self._n_preempted += 1
        self._swapped.append((req, spill))

    def _restore(self, req: Request, spill: Spill,
                 row: Optional[List[int]], steps: int) -> None:
        """Resume a spilled request in a free slot on ``row``'s pages (not
        the originals: only the block-table indirection changes); it
        re-enters RUNNING, or PREFILL with its remaining chunks to ride."""
        eng = self._engine
        slot = self._free.pop()
        eng.restore(slot, spill, block_row=(row if eng.paged else None))
        if row is not None:
            req.block_ids = list(row)
            req.n_shared_blocks = 0
        req.slot = slot
        req.restored_step = steps
        self._n_restored += 1
        if spill.armed:
            req.state = RequestState.RUNNING
            self._running[slot] = req
        else:
            req.state = RequestState.PREFILL
            self._prefilling[slot] = req

    def _preempt_for(self, members: Sequence[Request], prio: int) -> bool:
        """Make room (slots and, paged, pages) for ``members`` by spilling
        strictly-lower-priority residents.  A FEASIBILITY SIMULATION runs
        first — victims chosen by the policy over a shrinking candidate
        list, simulated refcount decrements tracking which shared pages
        would actually return — and no spill runs unless the unit fits
        afterwards."""
        if not self.preemption:
            return False
        cand = list(self._running.values()) + list(self._prefilling.values())
        victims: List[Request] = []
        sim_slots, need_slots = len(self._free), len(members)
        sim_pages = self.pool.num_free if self.paged else 0
        need_pages = (sum(self._request_blocks(r) for r in members)
                      if self.paged else 0)
        sim_dec: Dict[int, int] = {}
        while sim_slots < need_slots or sim_pages < need_pages:
            vi = self.policy.select_victim(cand, prio)
            if vi is None:
                return False
            victim = cand.pop(vi)
            victims.append(victim)
            sim_slots += 1
            for b in victim.block_ids:
                d = sim_dec.get(b, 0) + 1
                sim_dec[b] = d
                # a shared page only returns with its LAST owner
                if self.pool.refcount(b) - d == 0:
                    sim_pages += 1
        for victim in victims:
            self._spill(victim)
        return True

    # ------------------------------------------------------------------
    # the submit/step/drain protocol
    def prepare(self, requests: Sequence[Request]) -> None:
        """Size the engine and (paged) the page pool for a request
        population WITHOUT enqueueing it."""
        fresh = not self._session_open
        if fresh:
            self._reset_session()
            self._session_open = True
        if requests:
            self._ensure_engine(requests)
        if fresh:
            self._t0 = time.perf_counter()

    def submit(self, requests: Sequence[Request]) -> None:
        """Enqueue ``requests`` as gang-admission units, opening a fresh
        serving session if none is active."""
        requests = list(requests)
        fresh = not self._session_open
        if fresh:
            self._reset_session()
            self._session_open = True
        if not requests:
            return
        self._ensure_engine(requests)
        units, groups = group_requests(requests)
        for grp in groups:
            if grp.size > self.n_slots:
                raise ValueError(
                    f"group {grp.group_id} has {grp.size} samples but the "
                    f"fleet has {self.n_slots} slots: gang admission needs "
                    "every sample resident at once; fix by raising n_slots "
                    f"to >= {grp.size} or lowering the group size")
        if fresh:
            # the serving clock starts once the first batch is staged
            self._t0 = time.perf_counter()
        self._requests.extend(requests)
        self.groups.extend(groups)
        if self.consensus is not None:
            # groups whose consensus may still fire (a lone sample never
            # votes)
            self._open_groups.extend(g for g in groups if g.size >= 2)
        self._waiting.extend(units)

    def run(self, requests: Sequence[Request]
            ) -> Tuple[List[Request], FleetMetrics]:
        """Drive every request to a terminal state; return them + metrics."""
        if self._session_open and self.has_work:
            raise RuntimeError(
                "run() while a serving session is active would reset "
                "resident state; drive incremental traffic through "
                "submit()/step()/drain() instead")
        self._session_open = False     # fresh session even after a drain
        self.submit(requests)
        return self.drain()

    def drain(self) -> Tuple[List[Request], FleetMetrics]:
        """Step until the fleet is idle, close the session and return
        every submitted request plus the session's ``FleetMetrics``."""
        while self.step():
            pass
        wall = max(time.perf_counter() - self._t0, 1e-9)
        requests = list(self._requests)
        metrics = self._metrics(requests, wall)
        self._session_open = False
        return requests, metrics

    def step(self) -> bool:
        """ONE scheduler iteration: admission -> batch composition -> the
        fused engine step -> token collection / ORCA eviction -> prefill
        bookkeeping.  Returns False when idle."""
        if not self.has_work:
            return False
        eng = self._engine
        chunked = bool(eng.chunk_tokens)
        waiting, swapped = self._waiting, self._swapped
        running, free = self._running, self._free
        prefilling, plans = self._prefilling, self._plans
        steps = self._steps
        t_iter = time.perf_counter()

        # admission: refill free slots before the next fused step.  SWAPPED
        # requests (preemption victims) restore FIRST, ahead of every
        # WAITING unit, and a swapped head that cannot yet restore BARRIERS
        # its own class: only strictly-more-urgent units admit past it.
        # Then the POLICY picks which WAITING unit (a whole group, or a
        # singleton) takes the free slots — all-or-nothing on slots and, in
        # paged mode, pages, whether the prompt then prefills in one shot or
        # in chunks.  When capacity fails for a unit strictly MORE urgent
        # than some resident, ``_preempt_for`` spills policy-chosen victims
        # until it fits; a gang needing more slots than are free may be
        # skipped (bounded by the policy's aging guard) so smaller units
        # behind it admit.
        tried: set = set()        # id(unit) passed over this round
        barrier_prio: Optional[int] = None
        while swapped or waiting:
            if swapped and barrier_prio is None:
                req, spill = swapped[0]
                if free:
                    row = None
                    if self.paged:
                        row = self.pool.allocate(self._request_blocks(req))
                    if row is not None or not self.paged:
                        swapped.popleft()
                        self._restore(req, spill, row, steps)
                        if self.paged:
                            self._peak_blocks = max(self._peak_blocks,
                                                    self.pool.blocks_in_use)
                        continue
                if self._preempt_for([req], req.priority):
                    continue      # room made: retry the restore
                if not (running or prefilling):
                    raise RuntimeError(
                        f"swapped request {req.req_id} cannot restore with "
                        "the fleet empty — slot/page accounting is corrupt")
                barrier_prio = req.priority
            if not waiting:
                break
            cand_idx = [i for i, u in enumerate(waiting)
                        if id(u) not in tried]
            if not cand_idx:
                break
            cand = [waiting[i] for i in cand_idx]
            sel = self.policy.select_admit_unit(cand, steps)
            idx = cand_idx[sel]
            unit = waiting[idx]
            members = [r for r in unit if r.state is RequestState.WAITING]
            if not members:
                del waiting[idx]
                continue
            prio = min(r.priority for r in members)
            if barrier_prio is not None and prio >= barrier_prio:
                break     # nothing more urgent than the blocked head
            if len(members) > len(free):
                # slot shortage: preempt strictly-less-urgent residents;
                # else let the policy skip the oversized unit so smaller
                # units behind it still admit
                if not self._preempt_for(members, prio):
                    if free and len(cand) > 1 \
                            and self.policy.on_skipped_unit(cand, sel):
                        tried.add(id(unit))
                        continue
                    break
            if self.paged:
                mplans = self._reserve_unit(members)
                if mplans is None and self._preempt_for(members, prio):
                    mplans = self._reserve_unit(members)
                if mplans is None:
                    if not (running or prefilling or swapped):
                        need = sum(self._request_blocks(r) for r in members)
                        what = (f"group {members[0].group_id}"
                                if members[0].group_id is not None
                                else f"request {members[0].req_id}")
                        raise RuntimeError(
                            f"{what} needs {need} pages but the pool holds "
                            f"{self.pool.num_usable}; nothing left to evict")
                    break
            else:
                mplans = [None] * len(members)
            self.policy.on_admitted_unit(cand, sel)
            del waiting[idx]
            for req, plan in zip(members, mplans):
                slot = free.pop()
                req.slot, req.admitted_step = slot, steps
                req.queue_wait_s = time.perf_counter() - self._t0
                req.state = RequestState.PREFILL
                skip = plan.skip_prefill if plan is not None else False
                if plan is not None:
                    req.block_ids = list(plan.row)
                    req.n_shared_blocks = plan.n_shared
                    req.prefill_skipped = skip
                    self._prefill_skips += int(skip)
                    self._peak_blocks = max(self._peak_blocks,
                                            self.pool.blocks_in_use)
                if chunked and not skip \
                        and chunk_supported(self.model, req.inputs):
                    # prefill is schedulable work, not an admission event:
                    # the slot becomes a resident PREFILL row and the
                    # prompt rides the unified step in token-budget chunks
                    eng.begin_prefill(slot)
                    req.prefill_progress = 0
                    prefilling[slot] = req
                    if plan is not None:
                        # donor registration deferred: the pages only hold
                        # the prompt K/V once the last chunk lands
                        plans[slot] = plan
                    continue
                if plan is not None and eng.paged:
                    eng.admit(slot, req.inputs, req.prompt_len,
                              block_row=plan.row, skip_prefill=skip,
                              copy_tail=plan.copy_tail)
                else:
                    # family without a page layout: the pool still
                    # admission-controls, the device state stays dense
                    eng.admit(slot, req.inputs, req.prompt_len)
                if plan is not None:
                    self._register_donor(req, plan)
                req.state = RequestState.RUNNING
                running[slot] = req

        # batch composer: every resident decode token rides this step; in
        # spec mode each RUNNING slot additionally claims up to
        # spec_tokens - 1 extra verify tokens (greedy in slot order, capped
        # by its remaining decode budget) from the SAME token budget; the
        # POLICY then sizes the prefill share of what is left, and the
        # share is PACKED across mid-prefill residents in admission order —
        # the tail of one prompt and the head of the next fuse into one
        # block-diagonal chunk (pack_chunks=False: one request per chunk)
        spec_lens = spec_drafts = spec_have = None
        draft_ctx: Dict[int, List[int]] = {}
        spec_total = len(running)
        if self.spec_tokens:
            spec_lens = np.zeros((self.n_slots,), np.int32)
            budget_left = self.token_budget - len(running)
            # tree mode: the accepted path holds one node a DEPTH, so nodes
            # beyond width * (remaining - 1) can never commit (width 1 is
            # the linear cap)
            width = self.spec_tree[0] if self.spec_tree else 1
            for slot in sorted(running):
                req = running[slot]
                max_new = req.max_new_tokens or self.cfg.max_new_tokens
                remaining = max_new - len(req.tokens)
                extra = max(min(self.spec_tokens - 1,
                                width * (remaining - 1), budget_left), 0)
                spec_lens[slot] = 1 + extra
                budget_left -= extra
            spec_total = int(spec_lens.sum())
            if self.draft_cache is not None:
                # shared-cache drafts for every slot drafting this step;
                # misses keep have=False and take the family drafter
                w_, d_ = self.spec_tree or (1, self.spec_tokens - 1)
                spec_drafts = np.zeros((self.n_slots, w_, d_), np.int32)
                spec_have = np.zeros((self.n_slots,), bool)
                for slot in sorted(running):
                    if spec_lens[slot] < 2:
                        continue
                    req = running[slot]
                    ctx = self._draft_context(req)
                    draft_ctx[slot] = ctx
                    spec_drafts[slot], hit = self.draft_cache.lookup(
                        ctx, w_, d_)
                    spec_have[slot] = hit
                    if hit:
                        req.draft_hits += 1
                    else:
                        req.draft_misses += 1
        chunk = None
        if prefilling:
            share = self.policy.prefill_share(self._compose_view(
                running, prefilling, waiting, eng))
            share = min(share, eng.chunk_tokens,
                        self.token_budget - spec_total)
            segs: List[ChunkSeg] = []
            residents = list(prefilling.items())
            if any(r.group_id is not None for r in prefilling.values()):
                # sample spreading: one packed chunk carries sample k of
                # SEVERAL groups rather than all samples of one, so siblings
                # finish prefill on different steps; ungrouped fleets keep
                # admission order
                residents.sort(key=lambda kv: (kv[1].sample_idx,
                                               kv[1].admitted_step,
                                               kv[1].req_id))
            for slot, req in residents:
                if share <= 0 or len(segs) >= eng.max_pack:
                    break
                n = min(share, req.prompt_len - req.prefill_progress)
                if n <= 0:
                    continue
                segs.append(ChunkSeg(
                    slot=slot, tokens=np.asarray(req.inputs["tokens"][0]),
                    start=req.prefill_progress, length=int(n),
                    row=(np.asarray(req.block_ids, np.int32)
                         if eng.paged and req.block_ids else None)))
                share -= n
                if not self.pack_chunks:
                    break
            if segs:
                chunk = ChunkWork(segs=tuple(segs))
                self._n_chunks += 1
                self._n_packed += int(len(segs) >= 2)
        self._peak_step_tokens = max(
            self._peak_step_tokens,
            spec_total + (chunk.total_tokens if chunk else 0))

        if self.spec_tokens:
            view = eng.step(chunk, spec_lens=spec_lens,
                            spec_drafts=spec_drafts, spec_have=spec_have)
        else:
            view = eng.step(chunk) if chunked else eng.step()
        steps = self._steps = self._steps + 1
        self._active_slot_steps += len(running)
        now = time.perf_counter()

        for slot, req in list(running.items()):
            if req.first_token_step < 0:
                req.first_token_step = steps
                req.ttft_s = now - self._t0
            if self.spec_tokens:
                self._collect_spec(req, slot, view, int(spec_lens[slot]),
                                   draft_ctx.get(slot))
            else:
                req.tokens.append(int(view.tokens[slot]))
                self._total_tokens += 1
                if int(view.n_scores[slot]) > len(req.scores):
                    req.scores.append(float(view.smoothed[slot]))
                    # the step's answer proxy: the token just decoded
                    req.answers.append(int(view.tokens[slot]))
            n_scores = int(view.n_scores[slot])
            max_new = req.max_new_tokens or self.cfg.max_new_tokens
            if bool(view.stopped[slot]):
                # ORCA stop: evict NOW — the slot is free next step
                req.stop_step = int(view.stop_step[slot])
                req.steps_run = req.stop_step
                self._complete(req, RequestState.STOPPED, steps)
            elif len(req.tokens) >= max_new:
                req.stop_step = -1
                req.steps_run = n_scores
                self._complete(req, RequestState.FINISHED, steps)
            else:
                continue
            eng.release(slot)
            if self.paged and req.block_ids:
                # the stop IS the reclaim: pages return to the pool now
                self.pool.free(req.block_ids)
            free.append(slot)
            del running[slot]

        # prefill bookkeeping AFTER token collection: every segment of the
        # packed chunk advances; a request whose last chunk just landed
        # decodes its first token NEXT step
        if chunk is not None:
            for seg in chunk.segs:
                req = prefilling[seg.slot]
                req.prefill_progress += seg.length
                if req.prefill_progress >= req.prompt_len:
                    eng.finish_prefill(
                        seg.slot, req.inputs, req.prompt_len,
                        block_row=(req.block_ids
                                   if eng.paged and req.block_ids else None))
                    del prefilling[seg.slot]
                    plan = plans.pop(seg.slot, None)
                    if plan is not None:
                        self._register_donor(req, plan)
                    req.state = RequestState.RUNNING
                    running[seg.slot] = req

        # consensus stop: after this step's scores landed and the ORCA
        # evictions ran (a sample stopping at this very boundary still
        # votes its frozen score), each open group's vote is re-checked;
        # the first crossing CANCELS every sibling still running
        if self._open_groups:
            self._open_groups = [grp for grp in self._open_groups
                                 if not self._consensus_check(grp, steps)]
        self._stalls.append((time.perf_counter() - t_iter) * 1e3)
        return True

    def _consensus_check(self, grp: RequestGroup, steps: int) -> bool:
        """Run ``decide`` on the group's latest (score, answer) per sample;
        when it fires, cancel every sibling not yet done.  Returns True when
        the group leaves the open list (fired, or every sample done)."""
        fire, ans, agr = self.consensus.decide(
            [r.scores for r in grp.requests],
            [r.answers for r in grp.requests])
        if not fire:
            return grp.done
        grp.consensus_step = steps
        grp.consensus_index = max(len(r.scores) for r in grp.requests) - 1
        grp.consensus_answer = int(ans)
        grp.consensus_agreement = float(agr)
        for sib in grp.requests:
            if sib.done:
                continue
            if sib.state is RequestState.SWAPPED:
                # a spilled sibling holds no slot and no pages (both went
                # back at the spill): its queued restore is dropped
                for qi, (q, _) in enumerate(self._swapped):
                    if q is sib:
                        del self._swapped[qi]
                        break
            else:
                slot = sib.slot
                self._engine.cancel(slot)
                if self.paged and sib.block_ids:
                    self._cancel_freed += self.pool.free(sib.block_ids)
                self._free.append(slot)
                self._running.pop(slot, None)
                if slot in self._prefilling:
                    # cancel mid-prefill: the row sat parked at NULL the
                    # whole prefill; its deferred donor plan goes with it
                    del self._prefilling[slot]
                    self._plans.pop(slot, None)
            sib.steps_run = len(sib.scores)
            sib.stop_step = -1
            self._complete(sib, RequestState.CANCELLED, steps)
            self._n_cancelled += 1
        return True

    def _collect_spec(self, req: Request, slot: int, view, lp: int,
                      ctx: Optional[List[int]]) -> None:
        """A speculative block's collection: the slot proposed ``lp``
        tokens and the verifier accepted a prefix of ``view.gen[slot]``.
        Append the accepted tokens in order, collecting each probe
        boundary's (score, answer) as it lands, and TRUNCATE at the stop
        boundary: tokens past the stop were never emitted (the one-token
        engine would have evicted the slot there).  What landed is
        promoted into the draft cache."""
        g = int(view.gen[slot])
        req.spec_proposed += max(lp - 1, 0)
        req.spec_accepted += max(g - 1, 0)
        if lp > 0:
            req.accepted_lens.append(g)
            if self.spec_tree:
                req.tree_nodes += max(lp - 1, 0)
                req.tree_path_lens.append(g)
        stopped_now = bool(view.stopped[slot])
        stop_at = int(view.stop_step[slot]) if stopped_now else -1
        landed: List[int] = []
        for j in range(g):
            tok = int(view.seq[slot, j])
            req.tokens.append(tok)
            landed.append(tok)
            self._total_tokens += 1
            nsj = int(view.seq_n[slot, j])
            if nsj > len(req.scores):
                req.scores.append(float(view.seq_scores[slot, j]))
                req.answers.append(tok)
            if stopped_now and nsj == stop_at:
                break
        if self.draft_cache is not None and landed:
            # promote what the VERIFIER accepted: the cache learns exactly
            # the continuations this traffic commits
            if ctx is None:
                ctx = self._draft_context(req, before=len(landed))
            self.draft_cache.observe(ctx, landed)

    # ------------------------------------------------------------------
    def pressure(self, host: int = 0) -> HostPressure:
        """This scheduler's occupancy and page counts as a ``HostPressure``
        snapshot.  Valid at any point of a session, before the first
        submit too."""
        residents = list(self._running.values()) \
            + list(self._prefilling.values())
        return HostPressure(
            host=int(host), n_slots=self.n_slots,
            n_running=len(self._running),
            n_prefilling=len(self._prefilling),
            n_swapped=len(self._swapped), n_waiting=len(self._waiting),
            queued_samples=sum(len(u) for u in self._waiting),
            free_slots=len(self._free),
            pool_blocks=self.pool.num_usable if self.pool else 0,
            free_blocks=self.pool.num_free if self.pool else 0,
            blocks_in_use=self.pool.blocks_in_use if self.pool else 0,
            max_resident_priority=(max(r.priority for r in residents)
                                   if residents else None))

    # ------------------------------------------------------------------
    def _compose_view(self, running: Dict[int, Request],
                      prefilling: Dict[int, Request], waiting,
                      eng: ContinuousServingEngine) -> ComposeView:
        near = 0
        margin = self.policy.probe_margin
        if margin is not None and running:
            tps = self.cfg.tokens_per_step
            # tokens still owed before each resident's next probe boundary
            # (the step a stop decision can fire)
            near = sum(1 for r in running.values()
                       if tps - (len(r.tokens) % tps) <= margin)
        return ComposeView(n_running=len(running), n_slots=self.n_slots,
                           n_prefilling=len(prefilling),
                           n_waiting=len(waiting),
                           token_budget=self.token_budget,
                           chunk_tokens=eng.chunk_tokens,
                           near_boundary=near)

    # ------------------------------------------------------------------
    @staticmethod
    def _complete(req: Request, state: RequestState, step: int) -> None:
        req.state = state
        req.completed_step = step

    def _metrics(self, requests: Sequence[Request],
                 wall: float) -> FleetMetrics:
        n = len(requests)
        sav = [r.savings(self.cfg.tokens_per_step, self.cfg.max_new_tokens)
               for r in requests]
        queue = [r.queue_steps for r in requests]
        ttft_p50, ttft_p99, per_class = latency_stats(list(requests))
        st = np.asarray(self._stalls if self._stalls else [0.0])
        steps = self._steps
        # group accounting: savings COUNT a cancelled sample's unspent
        # budget; group_savings is the total of unspent steps across groups,
        # group_savings_mean the mean of the per-group fractions
        tps, dmn = self.cfg.tokens_per_step, self.cfg.max_new_tokens
        real_groups = [g for g in self.groups if g.size >= 2]
        g_sav = [g.savings(tps, dmn) for g in real_groups]
        fired = [g for g in real_groups if g.decided]
        g_unspent = [max(g.budget_steps(tps, dmn) - g.steps_spent(), 0)
                     for g in real_groups]
        return FleetMetrics(
            n_requests=n, n_slots=self.n_slots, engine_steps=steps,
            active_slot_steps=self._active_slot_steps, wall_time_s=wall,
            requests_per_s=n / wall, tokens_per_s=self._total_tokens / wall,
            slot_utilization=(self._active_slot_steps
                              / max(steps * self.n_slots, 1)),
            mean_step_savings=float(np.mean(sav)) if sav else 0.0,
            mean_queue_steps=float(np.mean(queue)) if queue else 0.0,
            pool_blocks=self.pool.num_usable if self.pool else 0,
            peak_blocks_in_use=self._peak_blocks,
            prefill_skips=self._prefill_skips,
            ttft_ms_p50=ttft_p50, ttft_ms_p99=ttft_p99,
            stall_ms_p50=float(np.percentile(st, 50)),
            stall_ms_p99=float(np.percentile(st, 99)),
            prefill_chunks=self._n_chunks, packed_chunks=self._n_packed,
            peak_step_tokens=self._peak_step_tokens, per_class=per_class,
            preemptions=self._n_preempted, restores=self._n_restored,
            spilled_blocks=self._n_spilled_blocks,
            samples_cancelled=self._n_cancelled,
            consensus_groups=len(fired),
            consensus_steps=(float(np.mean([g.consensus_index
                                            for g in fired]))
                             if fired else 0.0),
            group_savings=float(sum(g_unspent)),
            group_savings_mean=float(np.mean(g_sav)) if g_sav else 0.0,
            cancel_freed_blocks=self._cancel_freed,
            **spec_stats(list(requests)))
