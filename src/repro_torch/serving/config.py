"""ServeConfig: ONE frozen config object for the port's serving stack.

The fields are the JAX package's (``repro/serving/config.py``) so one
description drives either stack.  The port serves admission-time or
chunked, packed prefill, the FIFO, priority, EDF and TTFT-aware policies
with involuntary preemption (on by default, as in the JAX package),
one-token, linear or tree speculative decode with the shared draft
cache, dense or paged KV, self-consistency groups with the consensus
stop, on one host or on ``n_hosts`` simulated hosts behind a
``FleetRouter`` (``placement`` picks the host of each unit; ``n_slots``
is per host, ``num_blocks`` the fleet's total).  The probe-dispatch
fields of the JAX config (``probe_impl``/``interpret``) have no
counterpart: the device of the tensors picks K1 or its plain version.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

from repro_torch.serving.policy import make_policy


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Every serving knob, validated once at construction."""

    # -- fused serve step -------------------------------------------------
    tokens_per_step: int = 16     # tokens per "reasoning step" for phi_t
    max_new_tokens: int = 256
    lam: float = 0.9              # LTT-calibrated threshold lambda*
    burn_in: int = 10             # steps before stopping is allowed
    greedy: bool = True

    # -- fleet shape --------------------------------------------------------
    n_slots: int = 4              # batch slots
    cache_len: Optional[int] = None   # None -> sized from the requests

    # -- paged KV -----------------------------------------------------------
    paged: bool = False
    block_size: int = 16
    num_blocks: Optional[int] = None  # pool pages; None -> dense-equivalent
    prefix_sharing: bool = True

    # -- chunked / packed prefill ---------------------------------------------
    chunk_tokens: Optional[int] = None
    token_budget: Optional[int] = None
    pack_chunks: bool = True
    pack_max: int = 4

    # -- speculative decode ---------------------------------------------------
    spec_tokens: Optional[int] = None  # draft-verify block length per slot
    #                               (current token + spec_tokens-1 drafts
    #                               scored in one fused pass); None/0
    #                               keeps one-token decode
    spec_tree: Optional[str] = None  # tree speculative decode "W.D": W
    #                               draft chains of depth D under the
    #                               current token, 1 + W*D nodes a slot;
    #                               exclusive with spec_tokens
    draft_cache_size: int = 4096  # shared n-gram draft cache entries (LRU);
    #                               0 disables the cache (self-draft only)

    # -- scheduling policy ----------------------------------------------------
    policy: Any = None            # "fifo"/"priority"/"edf"/"ttft", a
    #                               SchedulingPolicy instance, or None (FIFO)

    # -- preemption -----------------------------------------------------------
    preemption: bool = True       # spill strictly-lower-priority residents
    #                               to host RAM when capacity fails for a
    #                               more urgent unit; False waits only

    # -- self-consistency groups ----------------------------------------------
    group_size: int = 1
    consensus: Any = None         # GroupCalibrator | float in (0,1] | None
    consensus_delta: Optional[float] = None

    # -- fleet serving ----------------------------------------------------------
    n_hosts: int = 1
    placement: Any = None         # "pressure"/"roundrobin", a
    #                               PlacementPolicy instance, or None

    def __post_init__(self) -> None:
        # normalize the optional ints the CLI passes as 0-for-disabled
        for field in ("cache_len", "num_blocks", "chunk_tokens",
                      "token_budget", "spec_tokens"):
            val = getattr(self, field)
            if val is not None:
                val = int(val)
                object.__setattr__(self, field, val if val > 0 else None)
        # spec_tree: (W, D) tuples and "" reach here from programmatic and
        # CLI paths; the canonical form is the "W.D" string
        if self.spec_tree is not None:
            tree = self.spec_tree
            if isinstance(tree, (tuple, list)):
                tree = ".".join(str(int(x)) for x in tree)
            tree = str(tree).strip()
            object.__setattr__(self, "spec_tree", tree or None)
        self.validate()

    def tree_shape(self) -> Optional[tuple]:
        """Parsed ``spec_tree``: (width, depth) ints, or None."""
        if self.spec_tree is None:
            return None
        parts = str(self.spec_tree).split(".")
        if len(parts) != 2:
            raise ValueError(
                f"spec_tree={self.spec_tree!r} is not 'W.D': the tree "
                "shape is width.depth (e.g. '3.4' = 3 draft chains of "
                "depth 4); fix by passing two dot-separated positive ints")
        try:
            w, d = int(parts[0]), int(parts[1])
        except ValueError:
            raise ValueError(
                f"spec_tree={self.spec_tree!r} is not 'W.D': both parts "
                "must be ints (e.g. '3.4'); fix by passing two "
                "dot-separated positive ints") from None
        return (w, d)

    def validate(self) -> None:
        """Cross-field validation — every error names the fix."""
        make_policy(self.policy)      # an unknown name raises here
        if isinstance(self.tokens_per_step, bool) or self.tokens_per_step < 1:
            raise ValueError(
                f"tokens_per_step={self.tokens_per_step!r} must be an int "
                ">= 1: the probe pools this many tokens per reasoning "
                "step; fix by passing a positive count")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens={self.max_new_tokens} must be >= 1: a "
                "request with no decode budget can never emit a token; "
                "fix by passing a positive budget")
        if self.block_size < 1:
            raise ValueError(
                f"block_size={self.block_size} must be >= 1: a KV page "
                "holds this many token positions; fix by passing a "
                "positive page size (16 is the default)")
        if self.n_slots < 1:
            raise ValueError(
                f"n_slots={self.n_slots} must be >= 1; fix by passing a "
                "positive slot count")
        if self.pack_max < 1:
            raise ValueError(
                f"pack_max={self.pack_max} must be >= 1: a packed chunk "
                "carries at least its own request; fix by passing a "
                "positive count (1 behaves like pack_chunks=False)")
        if self.spec_tokens is not None:
            if self.spec_tokens < 2:
                raise ValueError(
                    f"spec_tokens={self.spec_tokens} must be >= 2: a "
                    "verify block is the current token plus at least one "
                    "draft; fix by passing spec_tokens >= 2 (or None/0 "
                    "for one-token decode)")
            if self.chunk_tokens is not None \
                    and self.spec_tokens >= self.chunk_tokens:
                raise ValueError(
                    f"spec_tokens={self.spec_tokens} >= chunk_tokens="
                    f"{self.chunk_tokens}: a verify block must fit inside "
                    "the fused step's fixed chunk capacity alongside the "
                    "prefill share; fix by lowering spec_tokens to < "
                    f"{self.chunk_tokens} or raising chunk_tokens")
            if self.token_budget is not None \
                    and self.spec_tokens > self.token_budget:
                raise ValueError(
                    f"spec_tokens={self.spec_tokens} > token_budget="
                    f"{self.token_budget}: one slot's verify block alone "
                    "would blow the per-step token budget; fix by "
                    "lowering spec_tokens to <= "
                    f"{self.token_budget} or raising token_budget")
        if self.spec_tree is not None:
            if self.spec_tokens is not None:
                raise ValueError(
                    f"spec_tree={self.spec_tree!r} with spec_tokens="
                    f"{self.spec_tokens} is ambiguous — they are two "
                    "shapes of the same verify segment; fix by passing "
                    "ONE of them (spec_tree='1.k-1' is the linear "
                    "spec_tokens=k path)")
            w, d = self.tree_shape()
            if w < 1 or d < 1:
                raise ValueError(
                    f"spec_tree={self.spec_tree!r} needs width >= 1 and "
                    "depth >= 1: a tree is at least one draft chain of "
                    "one token; fix by passing e.g. '2.3' (or None for "
                    "one-token decode)")
            nodes = 1 + w * d
            if self.chunk_tokens is not None and nodes >= self.chunk_tokens:
                raise ValueError(
                    f"spec_tree={self.spec_tree!r} needs {nodes} nodes "
                    f">= chunk_tokens={self.chunk_tokens}: the verify "
                    "tree must fit inside the fused step's fixed chunk "
                    "capacity alongside the prefill share; fix by "
                    "shrinking the tree or raising chunk_tokens to > "
                    f"{nodes}")
            if self.token_budget is not None and nodes > self.token_budget:
                raise ValueError(
                    f"spec_tree={self.spec_tree!r} needs {nodes} nodes "
                    f"> token_budget={self.token_budget}: one slot's "
                    "verify tree alone would blow the per-step token "
                    "budget; fix by shrinking the tree or raising "
                    f"token_budget to >= {nodes}")
        if int(self.draft_cache_size) < 0:
            raise ValueError(
                f"draft_cache_size={self.draft_cache_size} must be >= 0: "
                "the shared draft cache's entry bound (0 disables it); "
                "fix by passing a non-negative count")
        if isinstance(self.n_hosts, bool) or int(self.n_hosts) < 1:
            raise ValueError(
                f"n_hosts={self.n_hosts!r} must be an int >= 1: the number "
                "of simulated hosts the FleetRouter shards the scheduler "
                "across; fix by passing a positive count (1 serves "
                "single-host)")
        group_size = self.group_size
        if isinstance(group_size, bool) or int(group_size) < 1:
            raise ValueError(
                f"group_size={group_size!r} must be an int >= 1: the number "
                "of self-consistency samples per prompt; fix by passing a "
                "positive count (1 disables grouping)")
        object.__setattr__(self, "group_size", int(group_size))
        if self.group_size > self.n_slots:
            raise ValueError(
                f"group_size={self.group_size} > n_slots={self.n_slots}: "
                "gang admission needs every sample of a group resident at "
                "once; fix by raising n_slots to >= "
                f"{self.group_size} or lowering group_size")
        if self.consensus is not None and self.group_size == 1:
            raise ValueError(
                "consensus= with group_size=1 can never fire (every request "
                "is its own singleton and a lone sample never votes); fix by "
                "passing group_size >= 2 (or grouping requests yourself via "
                "repro.serving.make_group) or dropping consensus=")
        if isinstance(self.consensus, bool):
            raise ValueError(
                f"consensus={self.consensus!r} is not a threshold: pass a "
                "float agreement threshold in (0, 1], a calibrated "
                "GroupCalibrator, or None to disable the consensus stop")
        if isinstance(self.consensus, (int, float)) \
                and not 0.0 < float(self.consensus) <= 1.0:
            raise ValueError(
                f"consensus={float(self.consensus)} is outside (0, 1]: the "
                "threshold is the weight share the top answer must reach; "
                "fix by passing a float in (0, 1] or a calibrated "
                "GroupCalibrator")
        if self.consensus_delta is not None:
            from repro_torch.core.calibrator import GroupCalibrator
            if self.consensus is None:
                raise ValueError(
                    "consensus_delta= without consensus= does nothing; fix "
                    "by passing consensus=<GroupCalibrator calibrated at "
                    f"delta={self.consensus_delta}> (or a float threshold, "
                    "and dropping consensus_delta)")
            if isinstance(self.consensus, GroupCalibrator) \
                    and self.consensus.delta is not None \
                    and not math.isclose(float(self.consensus.delta),
                                         float(self.consensus_delta)):
                raise ValueError(
                    f"consensus_delta={self.consensus_delta} does not match "
                    "the GroupCalibrator's calibrated delta="
                    f"{self.consensus.delta}; fix by re-running "
                    "GroupCalibrator.calibrate(..., delta="
                    f"{self.consensus_delta}) or passing consensus_delta="
                    f"{self.consensus.delta}")

    # CLI flag names (launch/serve.py) -> field, and "invert" for the
    # negative flags
    _ARG_FIELDS = (
        ("tokens_per_step", "tokens_per_step", None),
        ("max_new_tokens", "max_new_tokens", None),
        ("burn_in", "burn_in", None),
        ("slots", "n_slots", None),
        ("paged", "paged", None),
        ("block_size", "block_size", None),
        ("num_blocks", "num_blocks", None),      # 0 -> None in __post_init__
        ("chunk_tokens", "chunk_tokens", None),  # 0 -> None
        ("token_budget", "token_budget", None),  # 0 -> None
        ("spec_tokens", "spec_tokens", None),    # 0 -> None
        ("spec_tree", "spec_tree", None),        # "" -> None
        ("draft_cache", "draft_cache_size", None),
        ("policy", "policy", None),
        ("no_pack", "pack_chunks", "invert"),
        ("pack_max", "pack_max", None),
        ("group_size", "group_size", None),
        ("no_preempt", "preemption", "invert"),
        ("hosts", "n_hosts", None),
    )

    @classmethod
    def from_args(cls, args, **overrides) -> "ServeConfig":
        """Build a ServeConfig from an ``argparse`` namespace using the
        ``launch/serve.py`` flag names; only attributes present on the
        namespace are read, and ``overrides`` win (the place for
        runtime-computed values like the calibrated ``lam``)."""
        fields: dict = {}
        for arg_name, field, transform in cls._ARG_FIELDS:
            if not hasattr(args, arg_name):
                continue
            val = getattr(args, arg_name)
            fields[field] = (not val) if transform == "invert" else val
        fields.update(overrides)
        return cls(**fields)
