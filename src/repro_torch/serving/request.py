"""Request-centric serving: lifecycle + per-request / fleet metrics.

A ``Request`` is one user sequence moving through the ORCA server:

    WAITING -> PREFILL -> RUNNING -> STOPPED | FINISHED | CANCELLED
                  ^          |
                  +- SWAPPED +   (involuntary preemption: spilled to host,
                                  re-admitted before WAITING)

``STOPPED`` means the calibrated ORCA threshold test fired (the paper's
early stop — the request's remaining step budget is *returned to the
fleet* by evicting its slot); ``FINISHED`` means the token budget ran out
without a stop.  ``SWAPPED`` is *involuntary* and *temporary*: the
scheduler preempted the request to make room for a strictly-higher-priority
admission, spilling its KV pages AND its probe fast-weight state to host
RAM (``engine.Spill``); it re-enters PREFILL or RUNNING via ``restore``
with bit-identical state, so its eventual stop decision is unchanged.
``CANCELLED`` means a *voluntary* mid-flight release: the request's
self-consistency group reached its calibrated consensus and the scheduler
evicted the still-running sibling (no per-request stop fired:
``stop_step`` stays -1).  Metrics use the shared savings helper
(``repro_torch.core.stopping.step_savings``) so served savings are directly
comparable with offline-evaluated savings; a cancelled sample's *unspent*
budget is counted as group savings (``FleetMetrics.group_savings``, the
TOTAL unspent reasoning steps across groups; ``group_savings_mean`` is the
per-group mean fraction), and CANCELLED requests are left out of the TTFT
and queue-wait percentiles and the speculative-decode statistics, so
by-design cancellations do not pollute the latency tails.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import stopping as S


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"      # RESIDENT: owns a slot; the prompt prefills
    #                          in one shot at admission, or in chunks
    RUNNING = "running"
    STOPPED = "stopped"      # ORCA threshold fired -> slot evicted
    FINISHED = "finished"    # token budget exhausted without a stop
    CANCELLED = "cancelled"  # voluntary release: group consensus fired and
    #                          the scheduler evicted this still-running
    #                          sibling mid-flight (stop_step stays -1)
    SWAPPED = "swapped"      # involuntarily preempted: KV + probe state
    #                          spilled to host RAM, queued for restore
    #                          ahead of WAITING admissions


_req_counter = itertools.count()


@dataclasses.dataclass
class Request:
    """One sequence request plus everything observed while serving it."""
    inputs: Dict[str, np.ndarray]         # batch-1 host-side model inputs
    prompt_len: int
    max_new_tokens: Optional[int] = None  # None -> engine default
    # priority class for the scheduling policy: lower = more
    # latency-sensitive (0 = interactive, 1 = batch by convention); FIFO
    # admission ignores it, PriorityPolicy admits lower classes first and
    # preemption spills only strictly-lower classes
    priority: int = 0
    # optional per-request latency deadline for the EDF policy (ms from
    # submission); None -> the policy falls back to the class SLO
    deadline_ms: Optional[float] = None
    # self-consistency group membership: samples sharing a group_id are
    # gang-admitted atomically and consensus-stopped together (None = the
    # classic independent request; the group code is then inert)
    group_id: Optional[int] = None
    sample_idx: int = 0                   # position within the group
    req_id: int = dataclasses.field(default_factory=lambda: next(_req_counter))

    # lifecycle (owned by the scheduler)
    state: RequestState = RequestState.WAITING
    slot: int = -1
    submitted_step: int = 0               # engine step at enqueue
    admitted_step: int = -1               # engine step at slot admission
    completed_step: int = -1              # engine step at stop/finish
    host: int = -1                        # fleet host that served it (-1 =
    #                                       single-host / not yet placed)
    # chunked prefill (PREFILL is a RESIDENT phase: the request owns a slot
    # and its prompt is processed in token-budget chunks by the unified step)
    prefill_progress: int = 0             # prompt tokens already prefilled
    first_token_step: int = -1            # engine step of the first decode token
    ttft_s: float = -1.0                  # wall-clock time to first token
    queue_wait_s: float = -1.0            # wall-clock WAITING -> PREFILL

    # observations
    tokens: List[int] = dataclasses.field(default_factory=list)
    scores: List[float] = dataclasses.field(default_factory=list)
    # per-reasoning-step answer hash (the token decoded at each probe
    # boundary)
    answers: List[int] = dataclasses.field(default_factory=list)
    stop_step: int = -1                   # reasoning step at ORCA stop (-1 budget)
    steps_run: int = 0                    # reasoning steps actually executed

    # paged-KV bookkeeping (owned by the scheduler's BlockPool)
    block_ids: List[int] = dataclasses.field(default_factory=list)
    n_shared_blocks: int = 0              # prefix pages shared with a donor
    prefill_skipped: bool = False         # prompt was resident: no prefill

    # preemption bookkeeping (owned by the scheduler)
    n_preempted: int = 0                  # times spilled to host RAM
    restored_step: int = -1               # engine step of the last restore

    # speculative decode (owned by the scheduler; stay 0/empty without it)
    spec_proposed: int = 0                # draft tokens proposed (excl. the
    #                                       current token of each block)
    spec_accepted: int = 0                # draft tokens the verifier kept
    accepted_lens: List[int] = dataclasses.field(default_factory=list)
    #                                       per-step accepted length g (incl.
    #                                       the current token; g in [0, k])
    draft_hits: int = 0                   # shared draft-cache lookups that hit
    draft_misses: int = 0                 # ... that missed (self-draft fallback)
    # tree speculative decode (stay 0/empty without spec_tree)
    tree_nodes: int = 0                   # tree nodes proposed (excl. roots)
    tree_path_lens: List[int] = dataclasses.field(default_factory=list)
    #                                       per-step accepted root-to-leaf
    #                                       path length (incl. the root)

    @property
    def done(self) -> bool:
        return self.state in (RequestState.STOPPED, RequestState.FINISHED,
                              RequestState.CANCELLED)

    @property
    def queue_steps(self) -> int:
        """Engine steps spent waiting for a slot."""
        return max(self.admitted_step - self.submitted_step, 0)

    def savings(self, tokens_per_step: int, default_max_new: int) -> float:
        """Fraction of the reasoning-step budget returned to the fleet."""
        budget = max((self.max_new_tokens or default_max_new)
                     // tokens_per_step, 1)
        return float(S.step_savings(self.steps_run, budget))


def make_request(tokens: np.ndarray, *, extra: Optional[Dict] = None,
                 max_new_tokens: Optional[int] = None,
                 priority: int = 0, group_id: Optional[int] = None,
                 sample_idx: int = 0) -> Request:
    """Build a Request from a 1-D prompt token array (+ optional extra
    modalities, e.g. ``patch_embeds`` / ``frames`` with a leading batch-1
    axis).  ``priority`` is the scheduling class (lower = more
    latency-sensitive); ``group_id``/``sample_idx`` mark a self-consistency
    sample (see ``repro_torch.serving.groups.make_group``).

    Inputs stay host-side numpy arrays (a torch tensor is accepted and
    copied to the host); the engine moves them to its device at admission,
    so the scheduler's prompt hashing never touches the card."""
    if hasattr(tokens, "detach"):
        tokens = tokens.detach().cpu().numpy()
    tokens = np.asarray(tokens, np.int32)
    assert tokens.ndim == 1, "one request = one unbatched prompt"
    inputs: Dict[str, np.ndarray] = {"tokens": tokens[None]}
    if extra:
        inputs.update({k: np.asarray(v) for k, v in extra.items()})
    return Request(inputs=inputs, prompt_len=int(tokens.shape[0]),
                   max_new_tokens=max_new_tokens, priority=int(priority),
                   group_id=group_id, sample_idx=int(sample_idx))


@dataclasses.dataclass
class FleetMetrics:
    """Aggregate serving metrics over one scheduler run."""
    n_requests: int
    n_slots: int
    engine_steps: int            # fused decode steps executed
    active_slot_steps: int       # slot-steps spent on live requests
    wall_time_s: float
    requests_per_s: float
    tokens_per_s: float
    slot_utilization: float      # active_slot_steps / (engine_steps * n_slots)
    mean_step_savings: float     # mean over requests (shared metric)
    mean_queue_steps: float
    # paged-KV pool stats (zero when serving from the dense cache)
    pool_blocks: int = 0         # usable pages in the pool
    peak_blocks_in_use: int = 0  # high-water mark across the run
    prefill_skips: int = 0       # admissions served from a resident prefix
    # latency distribution.  A "stall" is one scheduler iteration's wall
    # time — the latency every resident decode slot pays before its next
    # token; an admission-time prefill (one batch-1 full-prompt prefill)
    # spikes the tail, the chunked unified step bounds every iteration by
    # the token budget.
    ttft_ms_p50: float = 0.0     # wall-clock time-to-first-token percentiles
    ttft_ms_p99: float = 0.0
    stall_ms_p50: float = 0.0    # per-step decode-stall percentiles
    stall_ms_p99: float = 0.0
    prefill_chunks: int = 0      # chunk launches (0 = admission-time prefill)
    packed_chunks: int = 0       # chunk launches carrying >= 2 requests
    peak_step_tokens: int = 0    # max decode+prefill tokens in one step
    # per-priority-class latency: {"c<priority>_<metric>": value} for
    # ttft_ms_p50/p99 and queue_wait_ms_p50/p99 (WAITING -> PREFILL wall
    # time)
    per_class: Dict[str, float] = dataclasses.field(default_factory=dict)
    # group serving: consensus and cancellation
    samples_cancelled: int = 0   # siblings evicted by consensus
    consensus_groups: int = 0    # groups whose consensus fired
    consensus_steps: float = 0.0  # mean reasoning-step index of consensus
    group_savings: float = 0.0   # TOTAL unspent reasoning steps across all
    #                              groups: cancelled samples' UNSPENT budget
    #                              (what the fleet actually got back)
    group_savings_mean: float = 0.0  # mean over groups of 1 - spent/budget
    cancel_freed_blocks: int = 0  # KV pages that died at cancellation
    # preemption: victims spilled to host RAM and resumed
    preemptions: int = 0         # victims spilled to host RAM
    restores: int = 0            # spilled requests resumed
    spilled_blocks: int = 0      # KV pages copied out across all spills
    # fleet serving (``FleetRouter``): n_slots above is PER HOST
    n_hosts: int = 1
    routed_affine: int = 0       # placements that followed prefix affinity
    # speculative decode: acceptance and shared draft-cache accounting
    # (``spec_stats``)
    spec_tokens_proposed: int = 0   # draft tokens proposed fleet-wide
    spec_tokens_accepted: int = 0   # draft tokens the verifier kept
    acceptance_rate: float = 0.0    # accepted / proposed (0 when disabled)
    accepted_len_p50: float = 0.0   # per-step accepted length percentiles
    accepted_len_p99: float = 0.0   # (incl. the block's current token)
    tree_nodes_proposed: int = 0    # candidate tree nodes verified (excl.
    #                                 roots; 0 for linear/disabled runs)
    tree_path_accepted_p50: float = 0.0  # accepted root-to-leaf path length
    tree_path_accepted_p99: float = 0.0  # percentiles (incl. the root)
    draft_cache_hits: int = 0       # shared draft-cache lookups that hit
    draft_cache_misses: int = 0     # ... that missed (self-draft fallback)
    draft_cache_hit_rate: float = 0.0    # hits / lookups (0 when disabled)

    def row(self) -> Dict[str, float]:
        return {
            **self.per_class,
            "spec_tokens_proposed": self.spec_tokens_proposed,
            "spec_tokens_accepted": self.spec_tokens_accepted,
            "acceptance_rate": self.acceptance_rate,
            "accepted_len_p50": self.accepted_len_p50,
            "accepted_len_p99": self.accepted_len_p99,
            "tree_nodes_proposed": self.tree_nodes_proposed,
            "tree_path_accepted_p50": self.tree_path_accepted_p50,
            "tree_path_accepted_p99": self.tree_path_accepted_p99,
            "draft_cache_hits": self.draft_cache_hits,
            "draft_cache_misses": self.draft_cache_misses,
            "draft_cache_hit_rate": self.draft_cache_hit_rate,
            "n_hosts": self.n_hosts,
            "routed_affine": self.routed_affine,
            "samples_cancelled": self.samples_cancelled,
            "consensus_groups": self.consensus_groups,
            "consensus_steps": self.consensus_steps,
            "group_savings": self.group_savings,
            "group_savings_mean": self.group_savings_mean,
            "cancel_freed_blocks": self.cancel_freed_blocks,
            "preemptions": self.preemptions,
            "restores": self.restores,
            "spilled_blocks": self.spilled_blocks,
            "packed_chunks": self.packed_chunks,
            "peak_step_tokens": self.peak_step_tokens,
            "requests": self.n_requests, "slots": self.n_slots,
            "engine_steps": self.engine_steps,
            "requests_per_s": self.requests_per_s,
            "tokens_per_s": self.tokens_per_s,
            "slot_utilization": self.slot_utilization,
            "mean_step_savings": self.mean_step_savings,
            "mean_queue_steps": self.mean_queue_steps,
            "pool_blocks": self.pool_blocks,
            "peak_blocks_in_use": self.peak_blocks_in_use,
            "prefill_skips": self.prefill_skips,
            "ttft_ms_p50": self.ttft_ms_p50,
            "ttft_ms_p99": self.ttft_ms_p99,
            "stall_ms_p50": self.stall_ms_p50,
            "stall_ms_p99": self.stall_ms_p99,
            "prefill_chunks": self.prefill_chunks,
        }


def latency_stats(requests: List[Request]
                  ) -> "tuple[float, float, Dict[str, float]]":
    """TTFT percentiles + per-priority-class latency tails for a served
    population: ``(ttft_ms_p50, ttft_ms_p99, per_class)``.  CANCELLED
    requests are left out: a cancellation is a by-design eviction, not a
    latency event."""
    kept = [r for r in requests if r.state is not RequestState.CANCELLED]
    ttft = np.array([r.ttft_s for r in kept if r.ttft_s >= 0]) * 1e3
    per_class: Dict[str, float] = {}
    for cls in sorted({r.priority for r in kept}):
        in_cls = [r for r in kept if r.priority == cls]
        c_ttft = np.array([r.ttft_s for r in in_cls
                           if r.ttft_s >= 0]) * 1e3
        c_wait = np.array([r.queue_wait_s for r in in_cls
                           if r.queue_wait_s >= 0]) * 1e3
        for key, arr in (("ttft_ms", c_ttft), ("queue_wait_ms", c_wait)):
            if arr.size:
                per_class[f"c{cls}_{key}_p50"] = \
                    float(np.percentile(arr, 50))
                per_class[f"c{cls}_{key}_p99"] = \
                    float(np.percentile(arr, 99))
    return (float(np.percentile(ttft, 50)) if ttft.size else 0.0,
            float(np.percentile(ttft, 99)) if ttft.size else 0.0,
            per_class)



def spec_stats(requests: List[Request]) -> Dict[str, float]:
    """Speculative-decode aggregation over a served population, as
    ``FleetMetrics`` keyword arguments: linear acceptance accounting,
    tree-path percentiles and shared draft-cache hit rates, computed from
    per-request counters (the JAX package's ``spec_stats``), CANCELLED
    requests left out as in the latency tails."""
    live = [r for r in requests if r.state is not RequestState.CANCELLED]
    sp = sum(r.spec_proposed for r in live)
    sa = sum(r.spec_accepted for r in live)
    alens = np.asarray([g for r in live for g in r.accepted_lens],
                       np.float64)
    plens = np.asarray([g for r in live for g in r.tree_path_lens],
                       np.float64)
    hits = sum(r.draft_hits for r in live)
    misses = sum(r.draft_misses for r in live)
    return {
        "spec_tokens_proposed": int(sp),
        "spec_tokens_accepted": int(sa),
        "acceptance_rate": float(sa / sp) if sp else 0.0,
        "accepted_len_p50": (float(np.percentile(alens, 50))
                             if alens.size else 0.0),
        "accepted_len_p99": (float(np.percentile(alens, 99))
                             if alens.size else 0.0),
        "tree_nodes_proposed": int(sum(r.tree_nodes for r in live)),
        "tree_path_accepted_p50": (float(np.percentile(plens, 50))
                                   if plens.size else 0.0),
        "tree_path_accepted_p99": (float(np.percentile(plens, 99))
                                   if plens.size else 0.0),
        "draft_cache_hits": int(hits),
        "draft_cache_misses": int(misses),
        "draft_cache_hit_rate": (float(hits / (hits + misses))
                                 if (hits + misses) else 0.0),
    }
