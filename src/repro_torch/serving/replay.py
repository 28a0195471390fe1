"""Replay model: serve synthetic trajectories through the REAL engines.

The conformal guarantee attaches to the deployed procedure (decode + probe
+ calibrated threshold), so group serving and the consensus stop are
tested end to end through ``ContinuousServingEngine``/``OrcaScheduler``.
The engines consume a model only through its ``Model`` functions, so a
"model" that replays pre-generated step embeddings as its hidden states
drives the whole serving stack over a ``TrajectorySet``:

* each request's prompt encodes its trajectory id (token 0);
* ``decode_step`` looks up phi_t for the slot's trajectory at its decode
  position: per-slot ``pos`` vectors index independent trajectories;
* with ``tokens_per_step = 1`` the engine's step-embedding pooling is
  exact, so the served score trajectory equals the offline deployed
  scores and every stop decision can be checked exactly.

The JAX package's ``repro/serving/replay.py`` on tensors, written to the
port's ``Model`` interface: its state and bank live on the device of the
``replay_params`` (on a CUDA device the probe step still runs K1), and
``_draft_coin`` gives the JAX drafters' coins bit for bit.
``serve_replay`` is the fleet harness: one whole session through an
``OrcaScheduler`` or a ``FleetRouter``, so stops compare across host
counts.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.registry import Model
from repro_torch.serving.request import Request, make_request


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    name: str
    d_model: int
    vocab_size: int = 8
    arch_type: str = "dense"
    prompt_len: int = 1
    tokens_per_step: int = 1


_M32 = 0xFFFFFFFF


def _u32(x):
    """``x`` as uint32 bits held in int64 (negative ints wrap mod 2^32)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def _draft_coin(traj, step, branch):
    """Deterministic per-(trajectory, step, branch) hash in [0, 1000): the
    wrong-branch coin for the replay drafters.  Pure integer mixing (no RNG
    state), so the same (traj, step, branch) always lands the same way:
    branch 0 of the tree drafter reproduces the linear drafter bit for
    bit.  The JAX package's uint32 arithmetic, done in int64 with every
    product and sum cut to its low 32 bits."""
    h = ((_u32(traj) * 2654435761) & _M32) \
        + ((_u32(step) * 40503) & _M32) \
        + ((_u32(branch) * 2246822519) & _M32) + 977
    h = h & _M32
    h = ((h ^ (h >> 13)) * 0x5bd1e995) & _M32
    h = h ^ (h >> 15)
    return (h % 1000).to(torch.int32)


def replay_model(phis: np.ndarray, *, prompt_len: int = 1,
                 tokens_per_step: int = 1,
                 answers: Optional[np.ndarray] = None,
                 draft_wrong_rate: float = 0.0) -> Model:
    """Model whose decode-step hidden states replay ``phis`` (N, T, d).

    The decode state is {"traj": (1, B) int32}, batch axis 1 like every
    real family, so the engine's per-slot lane writes, spills and restores
    work unchanged.

    ``answers`` (N,) makes the greedy decode emit each trajectory's answer
    hash (one-hot logits) instead of token 0: the scheduler's per-boundary
    answer recording then sees exactly the per-sample answer the group
    consensus aggregates.  Pass the same array to ``replay_params``.

    ``draft_wrong_rate`` in [0, 1] corrupts each drafted token with that
    probability (deterministic per (trajectory, step, branch), see
    ``_draft_coin``), so the verifier rejects corrupted drafts and accepted
    lengths vary; branch b of the tree drafter flips its coins apart from
    branch b', so a sibling can rescue a wrong branch-0 guess.  0.0 keeps
    the always-right drafter."""
    phis = np.asarray(phis, np.float32)
    n, t, d = phis.shape
    vocab = max(8, n)
    if answers is not None:
        vocab = max(vocab, int(np.asarray(answers).max()) + 1)
    if not 0.0 <= draft_wrong_rate <= 1.0:
        raise ValueError(f"draft_wrong_rate={draft_wrong_rate} is outside "
                         "[0, 1]")
    wrong_mil = int(round(float(draft_wrong_rate) * 1000))
    cfg = ReplayConfig(name=f"replay-{n}x{t}", d_model=d,
                       vocab_size=vocab, prompt_len=prompt_len,
                       tokens_per_step=tokens_per_step)

    def _i32(x, device):
        return torch.as_tensor(x, device=device).to(torch.int32)

    def _steps(cfg, pos):
        # reasoning step of each sequence position (floor division, as jnp)
        return (pos - cfg.prompt_len) // cfg.tokens_per_step

    def _lookup(cfg, params, traj, step):
        """(hidden, logits) at ``step`` of each ``traj``: the bank's phi and
        the one-hot of the trajectory's answer (zeros without answers)."""
        bank = params["phis"]                             # (N, T, d)
        idx = torch.clamp(step, 0, bank.shape[1] - 1)
        hidden = bank[traj.long(), idx.long()]
        if "answers" in params:
            logits = torch.nn.functional.one_hot(
                params["answers"][traj.long()].long(),
                cfg.vocab_size).to(torch.float32)
        else:
            logits = torch.zeros((hidden.shape[0], cfg.vocab_size),
                                 dtype=torch.float32, device=hidden.device)
        return hidden, logits

    def prefill(cfg, params, batch, cache_len):
        tokens = batch["tokens"]
        traj = tokens[:, 0].to(torch.int32)
        state = {"traj": traj[None, :].clone()}           # (L=1, B)
        hidden = torch.zeros((tokens.shape[0], tokens.shape[1], cfg.d_model),
                             dtype=torch.float32, device=tokens.device)
        return state, hidden[:, -1], hidden

    def decode_step(cfg, params, token, state, pos, window=None,
                    write_mask=None):
        traj = state["traj"][0]                           # (B,)
        hidden, logits = _lookup(cfg, params, traj,
                                 _steps(cfg, _i32(pos, traj.device)))
        return logits, hidden, state

    def prefill_chunk(cfg, params, tokens, state, rows, pos_start, chunk_len,
                      block_rows=None):
        # the whole "prompt" is the trajectory id in token 0: only the chunk
        # holding position 0 carries information, later chunks are no-ops
        traj = state["traj"]
        rows = _i32(rows, traj.device).long()
        first = (_i32(pos_start, traj.device) == 0) \
            & (_i32(chunk_len, traj.device) > 0)
        new = torch.where(first, tokens[:, 0].to(torch.int32), traj[0, rows])
        traj[0, rows] = new
        return state

    def prefill_packed(cfg, params, tokens, state, seg, slots, starts,
                       lengths, block_rows=None):
        # packed chunk: each SEGMENT whose slice starts at position 0
        # carries its request's trajectory id in its first chunk token
        traj = state["traj"]
        dev = traj.device
        lengths, starts = _i32(lengths, dev), _i32(starts, dev)
        slots = _i32(slots, dev).long()
        offsets = torch.cumsum(lengths, 0) - lengths
        ids = tokens[torch.clamp(offsets, 0, tokens.shape[0] - 1).long()] \
            .to(torch.int32)                                  # (R,)
        first = (starts == 0) & (lengths > 0)
        new = torch.where(first, ids, traj[0, slots])
        # unused (zero-length) segments are dropped, so their placeholder
        # slot can't race a real segment's write
        live = lengths > 0
        traj[0, slots[live]] = new[live]
        return state

    def init_decode_state(batch: int, cache_len: int, device=None):
        return {"traj": torch.zeros((1, batch), dtype=torch.int32,
                                    device=resolve_device(device))}

    def _true_token(params, traj):
        if "answers" in params:
            return params["answers"][traj.long()].to(torch.int32)
        return torch.zeros_like(traj)

    def draft(cfg, params, state, token, pos, k):
        # the replay model drafts from its own trajectory: every decode
        # step emits answers[traj] (or token 0 without answers), so that
        # token is the draft the verifier accepts in full; with a wrong
        # rate each drafted token is corrupted by its branch-0 coin (this
        # chain is the tree drafter's branch 0)
        traj = state["traj"][0]                           # (B,)
        tok = _true_token(params, traj)
        drafts = tok[:, None].expand(traj.shape[0], k - 1)
        if wrong_mil:
            dd = torch.arange(1, k, dtype=torch.int32,
                              device=traj.device)[None, :]
            step = _steps(cfg, _i32(pos, traj.device)[:, None] + dd)
            bad = _draft_coin(traj[:, None], step, 0) < wrong_mil
            drafts = torch.where(bad, (drafts + 1) % cfg.vocab_size, drafts)
        return drafts.to(torch.int32).contiguous()

    def draft_tree(cfg, params, state, token, pos, width, depth):
        # W independent draft chains from the root: branch b repeats the
        # trajectory's true continuation, each token corrupted under its
        # OWN (traj, step, branch) coin, so the best accepted path is the
        # max over W partially-right chains; branch 0 == ``draft``
        traj = state["traj"][0]                           # (B,)
        b = traj.shape[0]
        tok = _true_token(params, traj)
        drafts = tok[:, None, None].expand(b, width, depth)
        if wrong_mil:
            dev = traj.device
            dd = torch.arange(1, depth + 1, dtype=torch.int32,
                              device=dev)[None, None, :]
            br = torch.arange(width, dtype=torch.int32,
                              device=dev)[None, :, None]
            step = _steps(cfg, _i32(pos, dev)[:, None, None] + dd)
            bad = _draft_coin(traj[:, None, None], step, br) < wrong_mil
            drafts = torch.where(bad, (drafts + 1 + br) % cfg.vocab_size,
                                 drafts)
        return drafts.to(torch.int32).contiguous()

    def verify_packed(cfg, params, tokens, state, seg, slots, starts,
                      lengths, block_rows=None):
        # packed verify: position c is token j of segment seg[c] at
        # sequence position starts[seg[c]] + j, the SAME bank lookup (and
        # one-hot logits) as decode_step there, so the spec path equals
        # one-token replay decode
        traj_all = state["traj"][0]                       # (B,)
        dev = traj_all.device
        seg = _i32(seg, dev).long()
        lengths, starts = _i32(lengths, dev), _i32(starts, dev)
        offsets = torch.cumsum(lengths, 0) - lengths
        traj = traj_all[_i32(slots, dev).long()[seg]]     # (C,)
        j = torch.arange(tokens.shape[0], dtype=torch.int32,
                         device=dev) - offsets[seg]
        hidden, logits = _lookup(cfg, params, traj,
                                 _steps(cfg, starts[seg] + j))
        return logits, hidden, state

    def verify_tree(cfg, params, tokens, state, seg, slots, starts,
                    lengths, depths, ancestors, block_rows=None):
        # tree verify: node c sits at sequence position starts[seg[c]] +
        # depths[c], the SAME bank lookup as decode_step there whatever
        # branch it came from, so the accepted path equals one-token
        # decode; no KV cache: ks/vs are None and commit_kv is a no-op
        traj_all = state["traj"][0]                       # (B,)
        dev = traj_all.device
        seg = _i32(seg, dev).long()
        starts, depths = _i32(starts, dev), _i32(depths, dev)
        traj = traj_all[_i32(slots, dev).long()[seg]]     # (C,)
        hidden, logits = _lookup(cfg, params, traj,
                                 _steps(cfg, starts[seg] + depths))
        return logits, hidden, None, None

    def commit_kv(cfg, state, ks, vs, slots, seg, positions, valid,
                  block_rows=None):
        return state                 # replay carries no KV cache

    return Model(cfg=cfg, decls=None, prefill=prefill,
                 decode_step=decode_step, init_decode_state=init_decode_state,
                 prefill_chunk=prefill_chunk, prefill_packed=prefill_packed,
                 verify_packed=verify_packed, draft=draft,
                 verify_tree=verify_tree, commit_kv=commit_kv,
                 draft_tree=draft_tree)


def replay_params(phis: np.ndarray, answers: Optional[np.ndarray] = None,
                  *, device=None):
    """The replay model's "weights" on ``device`` (None: CUDA): the
    trajectory bank itself (+ the optional per-trajectory answer hashes
    the decode emits)."""
    dev = resolve_device(device)
    params = {"phis": torch.as_tensor(np.asarray(phis, np.float32),
                                      device=dev)}
    if answers is not None:
        params["answers"] = torch.as_tensor(np.asarray(answers, np.int32),
                                            device=dev)
    return params


def replay_requests(lengths: Sequence[int], *, prompt_len: int = 1,
                    tokens_per_step: int = 1) -> List[Request]:
    """One Request per trajectory: prompt = its id, budget = its length."""
    return [make_request(np.full((prompt_len,), i, np.int64),
                         max_new_tokens=int(T) * tokens_per_step)
            for i, T in enumerate(lengths)]


def served_stop_times(requests: Sequence[Request],
                      lengths: Sequence[int]) -> np.ndarray:
    """Map served outcomes onto offline ``stopping.stop_times`` semantics:
    0-based stop index, or T_i when the budget ran out (never charged).

    ``stop_step >= 0`` means "stopped"; comparing against 0 would misread
    a step-0 stop as budget-exhausted.  The 0-based index floors at 0: the
    offline grid cannot stop before its first score."""
    return np.array([max(r.stop_step - 1, 0) if r.stop_step >= 0 else int(T)
                     for r, T in zip(requests, lengths)], np.int64)


@dataclasses.dataclass(frozen=True)
class GroupFleet:
    """A replay fleet of self-consistency groups (``make_group_fleet``)."""
    model: Model
    params: dict
    requests: List[Request]
    members: np.ndarray      # (G, group_size) trajectory index per sample
    truth: np.ndarray        # (G,) reference answer hash (-1: none solves)
    answer_hash: np.ndarray  # (N,) per-trajectory answer the decode emits


def make_group_fleet(ts, group_size: int, *, seed: int = 0,
                     tokens_per_step: int = 1, device=None) -> GroupFleet:
    """Self-consistency groups over a TrajectorySet, served by replay, with
    the bank on ``device`` (None: CUDA).

    A seeded permutation (numpy ``RandomState(seed)``, the JAX package's)
    is cut into consecutive groups of ``group_size`` trajectories
    (remainder dropped).  A SOLVED sample (``correct.any()``) votes its
    group's id, an unsolved one a unique wrong hash (``n_groups +
    trajectory_id``), so the group truth is the group id when any sample
    solves, else -1.  The replay decode emits these hashes as its greedy
    tokens, so the scheduler's answer recording drives the consensus stop
    end to end."""
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    n = len(ts)
    order = np.random.RandomState(seed).permutation(n)
    n_groups = n // group_size
    members = order[:n_groups * group_size].reshape(n_groups, group_size)
    answer_hash = np.arange(n, dtype=np.int64) + n_groups  # default: wrong
    truth = np.full((n_groups,), -1, np.int64)
    requests: List[Request] = []
    for g in range(n_groups):
        for j, i in enumerate(members[g]):
            if bool(ts.correct[i].any()):
                answer_hash[i] = g
                truth[g] = g
            requests.append(make_request(
                np.full((1,), i, np.int64),
                max_new_tokens=int(ts.lengths[i]) * tokens_per_step,
                group_id=int(g), sample_idx=j))
    model = replay_model(ts.phis, tokens_per_step=tokens_per_step,
                         answers=answer_hash)
    params = replay_params(ts.phis, answers=answer_hash, device=device)
    return GroupFleet(model=model, params=params, requests=requests,
                      members=members, truth=truth,
                      answer_hash=answer_hash)


def serve_replay(phis: np.ndarray, theta, *, n_hosts: int = 1,
                 cfg=None, placement=None, lengths=None,
                 priorities: Optional[Sequence[int]] = None,
                 parallel_hosts: bool = True, device=None,
                 **cfg_overrides):
    """Drive a replay-model fleet end to end on ``device`` (None: CUDA) and
    return ``(requests, metrics, server)``.

    Builds the replay model and its bank from ``phis``, a ``ServeConfig``
    (``cfg``, or ``tokens_per_step=1`` + ``cfg_overrides``) and either a
    single ``OrcaScheduler`` (``n_hosts=1``) or a ``FleetRouter``, then
    runs one whole session.  Both servers speak the same protocol and
    replay is deterministic, so the stops compare directly across host
    counts.  ``theta`` is the probe's slow weights (arrays or tensors)."""
    from repro_torch.core.probe import ProbeConfig
    from repro_torch.serving.config import ServeConfig
    from repro_torch.serving.router import FleetRouter
    from repro_torch.serving.scheduler import OrcaScheduler

    phis = np.asarray(phis)
    if cfg is None:
        cfg = ServeConfig(tokens_per_step=1,
                          max_new_tokens=int(phis.shape[1]),
                          **cfg_overrides)
    elif cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    dev = resolve_device(device)
    theta = {k: torch.as_tensor(v, dtype=torch.float32).to(dev)
             for k, v in theta.items()}
    pc = ProbeConfig(d_phi=int(phis.shape[2]), smooth_window=4)
    model, params = replay_model(phis), replay_params(phis, device=dev)
    if n_hosts == 1:
        server = OrcaScheduler(model, params, pc, theta, cfg)
    else:
        server = FleetRouter(model, params, pc, theta, cfg,
                             n_hosts=n_hosts, placement=placement,
                             parallel_hosts=parallel_hosts)
    if lengths is None:
        lengths = [int(phis.shape[1])] * int(phis.shape[0])
    requests = replay_requests(lengths)
    if priorities is not None:
        for r, p in zip(requests, priorities):
            r.priority = int(p)
    requests, metrics = server.run(requests)
    return requests, metrics, server
