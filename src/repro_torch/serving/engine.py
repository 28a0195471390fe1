"""Batched serving engine with ORCA risk-controlled early stopping (PyTorch).

``serve_step`` fuses one decode step of the base model with the ORCA probe:
step-embedding accumulation (mean-pooled hidden states over
``tokens_per_step`` tokens), then K1 (``repro_torch.kernels.probe_step``)
for score-then-update of the per-slot fast weights, rolling smoothing and
the calibrated threshold test.  The decode attention inside the model
step is K2 (``repro_torch.kernels.paged_decode``) on a paged state and K6
(``repro_torch.kernels.flash_decode``) on a dense one; every one-shot
prompt prefill (admission, the harvest of ``extract_trajectories``) runs
its attention through K7 (``repro_torch.kernels.flash_attention``).  A
RWKV6 model has no attention: its O(1) recurrent state (L, B, ...) rides
the same dense-state paths, and every prefill and decode step runs its
WKV recurrence through K8 (``repro_torch.kernels.rwkv6_scan``).

``ContinuousServingEngine`` is the slot-level engine: each batch row
("slot") carries its own request at its own position (vector ``pos``), its
own prefill-injected KV (a dense lane or a block-table row into the page
pool) and its own freshly reset probe state; the moment ORCA stops a
sequence the scheduler releases its slot and refills it.

With ``chunk_tokens`` set, the step is the UNIFIED token-budget step:
a packed prefill chunk of up to ``pack_max`` mid-prefill requests runs
through ``model.prefill_packed`` (K3 on a paged state) before the decode
of every slot.

With ``spec_tokens = k`` the decode half is linear DRAFT-VERIFY
speculative decode: every running slot's [current token, k - 1 drafts]
block rides one packed verify chunk (``model.verify_packed``, K3 on a
paged state), the accepted prefix commits, and K4
(``repro_torch.kernels.probe_spec``) advances the probe over exactly the
accepted tokens.  With ``spec_tree = (W, D)`` the block is a token tree
verified under the ancestor mask (K3 on a paged state), and K4 advances
the probe over its longest accepted root path, a chain.

``ServingEngine`` is the deprecated static-batch baseline: prefill a
batch once (K7), then loop the fused step on a dense cache (K6) until the
slowest row finishes (``serve_queue_static`` serves a queue in such
groups).

Involuntary preemption: ``preempt`` copies a slot's whole request
identity to host RAM (``Spill``: its probe row, token, position, and its
KV pages or dense lane) and ``restore`` writes it back into any free slot
and any free pages, bit for bit, so the resumed request stops on the
reasoning step it would have stopped on undisturbed.

Buffers the JAX engine donates to its jitted step — the KV cache or page
pool and the probe state — are updated IN PLACE here.  Ported: admission-
time and chunked, packed prefill, one-token, linear and tree speculative
decode, dense and paged caches, spill and restore, and ``cancel``, the
voluntary release the scheduler's group consensus calls.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import parallel
from repro_torch.core import probe as P
from repro_torch.core import stopping as S
from repro_torch.core.probe import ProbeConfig
from repro_torch.kernels.probe_spec import serving_probe_spec_step
from repro_torch.kernels.probe_step import serving_probe_step
from repro_torch.models import attention as A
from repro_torch.models.registry import Model
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.kv_pool import NULL_BLOCK, blocks_needed, pad_row


class ProbeState(NamedTuple):
    """Vectorized fast-weight + smoothing state for a batch of sequences."""
    W: torch.Tensor          # (B, f) f32
    b: torch.Tensor          # (B,) f32
    hid_sum: torch.Tensor    # (B, d_phi) f32 accumulating the current step
    tok_count: torch.Tensor  # (B,) i32 tokens into the current step
    ring: torch.Tensor       # (B, window) f32 last raw scores
    n_scores: torch.Tensor   # (B,) i32 number of scores emitted
    smoothed: torch.Tensor   # (B,) f32 current smoothed score
    stopped: torch.Tensor    # (B,) bool
    stop_step: torch.Tensor  # (B,) i32 reasoning step at stop (-1 active)


def init_probe_state(pc: ProbeConfig, theta, batch: int,
                     d_phi: int) -> ProbeState:
    f = pc.feat_dim
    dev = theta["W0"].device
    i32 = torch.int32
    return ProbeState(
        W=theta["W0"].float().expand(batch, f).clone(),
        b=theta["b0"].float().expand(batch).clone(),
        hid_sum=torch.zeros((batch, d_phi), device=dev),
        tok_count=torch.zeros((batch,), dtype=i32, device=dev),
        ring=torch.zeros((batch, pc.smooth_window), device=dev),
        n_scores=torch.zeros((batch,), dtype=i32, device=dev),
        smoothed=torch.zeros((batch,), device=dev),
        stopped=torch.zeros((batch,), dtype=torch.bool, device=dev),
        stop_step=torch.full((batch,), -1, dtype=i32, device=dev),
    )


def write_probe_slot(st: ProbeState, slot: int,
                     rows: Sequence[torch.Tensor]) -> ProbeState:
    """Write ONE row of a batched ProbeState, in place, from one
    batch-axis-free row per leaf."""
    for full, part in zip(st, rows):
        full[slot] = part
    return st


def reset_probe_slot(pc: ProbeConfig, theta, st: ProbeState, slot: int,
                     active: bool = True) -> ProbeState:
    """Reset ONE row of a batched ProbeState in place.

    ``active=True`` (admission): fast weights back to (W0, b0), empty ring,
    zero counters — the slot's score trajectory is that of a fresh
    single-request run.  ``active=False`` (eviction / empty slot): the same
    reset, parked with ``stopped=True`` so the fused step treats the row as
    no-op compute."""
    one = init_probe_state(pc, theta, 1, st.hid_sum.shape[-1])
    if not active:
        one.stopped.fill_(True)
    return write_probe_slot(st, slot, [leaf[0] for leaf in one])


def params_device(params) -> torch.device:
    """The device of the model's weights: that of their first tensor (a
    transformer's embedding, the replay model's trajectory bank)."""
    leaf = params
    while not isinstance(leaf, torch.Tensor):
        leaf = next(iter(leaf.values() if isinstance(leaf, dict) else leaf))
    return leaf.device


def to_device_inputs(batch: Dict[str, np.ndarray], device
                     ) -> Dict[str, torch.Tensor]:
    """Host-side request inputs -> model inputs on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


@torch.no_grad()
def inject_prefill(model: Model, params, state, batch_one, slot: int,
                   cache_len: int):
    """Prefill ONE request (batch 1) and write its decode state into batch
    row ``slot`` of a running dense state, in place.  Stale KV beyond the
    new prompt is never readable: the valid mask exposes [0, pos)."""
    sub, _, _ = model.prefill(model.cfg, params, batch_one, cache_len)
    for key, full in state.items():
        full[:, slot] = sub[key][:, 0].to(full.dtype)
    return state


class ChunkSeg(NamedTuple):
    """One request's contribution to a (possibly packed) prefill chunk:
    prompt positions [start, start + length) of the request resident in
    batch row ``slot``."""
    slot: int
    tokens: np.ndarray               # (S,) the FULL prompt token ids
    start: int
    length: int
    row: Optional[np.ndarray] = None  # paged: the request's physical pages


class ChunkWork(NamedTuple):
    """Host-side descriptor of one fused prefill chunk for the unified
    step: up to ``engine.max_pack`` segments of DIFFERENT requests packed
    back to back (the tail of one prompt rides with the head of the next),
    block-diagonally isolated on the device.  A single-segment chunk is the
    unpacked chunk."""
    segs: Tuple[ChunkSeg, ...]

    @property
    def total_tokens(self) -> int:
        return sum(s.length for s in self.segs)


def chunk_supported(model: Model, inputs: Dict[str, np.ndarray]) -> bool:
    """A prompt can be prefilled in chunks iff the family exposes
    ``prefill_chunk`` and the prompt is pure text with no hidden prefix
    (vlm patches and meta tokens prefill in one shot at admission)."""
    mcfg = model.cfg
    return (model.prefill_chunk is not None
            and set(inputs) == {"tokens"}
            and mcfg.arch_type != "audio"
            and not (getattr(mcfg, "n_meta_tokens", 0) or 0))


@torch.no_grad()
def chunked_prefill(model: Model, params, batch, cache_len: int, *,
                    chunk_tokens: Optional[int] = None):
    """Build a dense decode state for ``batch``: the one prompt-prefill
    helper behind ``extract_trajectories``.

    ``chunk_tokens=None`` (or unsupported inputs) runs one full-prompt
    ``model.prefill``.  Otherwise the prompt runs through fixed-shape
    ``chunk_tokens``-wide ``model.prefill_chunk`` calls, the last one
    zero-padded.  Returns the decode state."""
    mcfg = model.cfg
    if not chunk_tokens or not chunk_supported(model, batch):
        state, _, _ = model.prefill(mcfg, params, batch, cache_len)
        return state
    tokens = batch["tokens"]
    b, s = tokens.shape
    c = int(chunk_tokens)
    device = tokens.device
    state = model.init_decode_state(b, cache_len, device=device)
    rows = torch.arange(b, device=device)
    for start in range(0, s, c):
        n = min(c, s - start)
        buf = torch.zeros((b, c), dtype=torch.int32, device=device)
        buf[:, :n] = tokens[:, start:start + n]
        state = model.prefill_chunk(mcfg, params, buf, state, rows, start, n)
    return state


def probe_update(pc: ProbeConfig, theta, st: ProbeState, hidden: torch.Tensor,
                 lam: float, tokens_per_step: int, burn_in: int,
                 eta: float) -> ProbeState:
    """Accumulate one token's hidden state; run K1 for every slot.

    The JAX engine skips its probe kernel under a ``lax.cond`` unless some
    row is at a boundary; deciding that on the host would cost a device
    sync per token, so K1 launches every token instead.  Its boundary mask
    leaves W, b, ring, n_scores, stopped and stop_step untouched on
    non-boundary rows, and ``smoothed`` recomputes to the value it had.
    Updates ``st`` in place and returns it."""
    st.hid_sum.add_(hidden.float())
    st.tok_count.add_(1)
    boundary = (st.tok_count >= tokens_per_step) & ~st.stopped
    # step-embedding pooling: running mean of the step's hidden states
    phi = st.hid_sum / torch.clamp(st.tok_count, min=1)[:, None]
    zq, zk = P.features(pc, theta, phi)
    out = serving_probe_step(zq.contiguous(), zk.contiguous(), boundary,
                             st.W, st.b, st.ring, st.n_scores, st.stopped,
                             st.stop_step, eta, lam, burn_in=int(burn_in))
    st.smoothed.copy_(out.smoothed)
    # reset the accumulators at boundaries
    st.hid_sum.masked_fill_(boundary[:, None], 0.0)
    st.tok_count.masked_fill_(boundary, 0)
    return st


def probe_update_spec(pc: ProbeConfig, theta, st: ProbeState,
                      hidden_seq: torch.Tensor, accept: torch.Tensor,
                      lam: float, tokens_per_step: int, burn_in: int,
                      eta: float) -> Tuple[ProbeState, torch.Tensor,
                                           torch.Tensor]:
    """Multi-token probe advance for speculative decode: consume the T
    verify positions' hidden states (B, T, d) of every slot, but let only
    the first ``accept[i]`` tokens of slot i touch probe state, so the
    chain equals ``accept[i]`` sequential ``probe_update`` calls.

    The per-token pooling (hid_sum / tok_count accumulate-and-reset, gated
    by ``accept``) runs here, giving the (B, T) feature and boundary
    sequences; the stateful score-then-update, smoothing and threshold
    chain then runs in ONE K4 call.  Like K1, K4 launches on every spec
    step: the JAX engine skips it under a ``lax.cond`` when no row is at a
    boundary, which would cost a device sync here.  Tokens past an
    in-chain stop are frozen inside K4 by its carried stopped flag.
    Updates ``st`` in place; returns (st, smoothed_seq (B, T), n_seq
    (B, T)): token t of slot i emitted a score iff n_seq[i, t] exceeds the
    count before it."""
    hid_sum, tok_count = st.hid_sum, st.tok_count
    phis, bnds = [], []
    for t in range(hidden_seq.shape[1]):
        m = t < accept
        hid_sum = torch.where(m[:, None], hid_sum + hidden_seq[:, t].float(),
                              hid_sum)
        tok_count = torch.where(m, tok_count + 1, tok_count)
        bnd = m & (tok_count >= tokens_per_step)
        # step-embedding pooling: running mean of the step's hidden states
        phis.append(hid_sum / torch.clamp(tok_count, min=1)[:, None])
        bnds.append(bnd)
        hid_sum = hid_sum.masked_fill(bnd[:, None], 0.0)
        tok_count = tok_count.masked_fill(bnd, 0)
    zq, zk = P.features(pc, theta, torch.stack(phis, dim=1))
    out = serving_probe_spec_step(
        zq.contiguous(), zk.contiguous(), torch.stack(bnds, dim=1), accept,
        st.W, st.b, st.ring, st.n_scores, st.stopped, st.stop_step, eta, lam,
        burn_in=int(burn_in))
    st.smoothed.copy_(out.smoothed)
    st.hid_sum.copy_(hid_sum)
    st.tok_count.copy_(tok_count)
    return st, out.smoothed_seq, out.n_seq


def make_serve_step(model: Model, pc: ProbeConfig, theta, cfg: ServeConfig,
                    *, mask_stopped_writes: bool = False,
                    spec_tokens: int = 0,
                    spec_tree: Optional[Tuple[int, int]] = None):
    """Build the fused decode + ORCA step:
    (params, token, cache, pos, probe_state, chunk=None) -> (next_token,
    cache, probe_state); cache and probe state are updated in place.

    ``chunk`` (the unified token-budget step of a chunked engine) is the
    device descriptor of a packed prefill chunk: it runs through
    ``model.prefill_packed`` before the decode of every slot.  The JAX step
    decides that under a ``lax.cond`` on the device; here the host knows
    whether the composer built a chunk, so it passes one or None and no
    device value is read.  Mid-prefill slots ride the decode as parked
    rows (probe ``stopped=True``, so K1 leaves their state untouched); with
    ``mask_stopped_writes`` their dense decode write is dropped so it never
    clobbers chunk-written prompt K/V (paged parked rows write the NULL
    page).

    With ``spec_tokens = k >= 2`` the decode half becomes linear
    DRAFT-VERIFY speculative decode and the step takes a trailing ``spec``
    descriptor: ``lens`` (B,) each slot's verify-block length in [0, k],
    drawn by the scheduler from the token budget, and host drafts
    ``drafts`` (B, k - 1) with their per-slot ``have`` mask (the shared
    draft cache; slots without one take ``model.draft``).  The step runs
    one packed verify chunk (``model.verify_packed``) whose segment r is
    slot r's [current token, drafts...] at positions pos..pos+len-1,
    computes each slot's accepted prefix, advances the probe over exactly
    those tokens (``probe_update_spec``, K4) and returns a 4th element,
    ``{"gen", "seq", "seq_scores", "seq_n"}``: each slot commits ``gen`` in
    [1, len] tokens (0 for parked rows).  Rejected K/V writes need no undo:
    validity masks expose only [0, pos), and the next verify block
    overwrites them before ``pos`` reaches them.

    With ``spec_tree = (W, D)`` the verify segment is a token TREE: W draft
    chains of depth D hang off the current token (the BFS comb: node
    ``1 + j*W + b`` is branch b at depth j + 1, its parent ``i - W`` or the
    root), ``1 + W*D`` nodes a slot, and ``drafts`` is (B, W, D).  Each
    slot's ``lens`` truncates its tree breadth-first (a truncated tree is a
    tree).  The verify runs through ``model.verify_tree`` (the ancestor
    mask, K/V writes deferred); a node is accepted iff its parent is and
    it equals the model's output after its parent, and the step takes the
    longest accepted root path, a chain, so K4 consumes it unchanged and
    stops equal one-token decode.  Only that path's K/V lands, through
    ``model.commit_kv``.  The 4th element's ``seq`` is then (B, D + 1), the
    path's committed tokens.  W = 1 is the linear step of k = D + 1.

    Under a decode ``ParallelContext`` (``launch.shardings.make_context``
    of a decode shape), active when the step is built and when it runs,
    the one-token step is sharded: ``params`` are this rank's shards under
    the serve rules (tensor-parallel over ``model``), the dense cache is
    this rank's (L, B/data, KV, S/model, d) slice, written only where the
    rank holds the position, and ``token``, ``pos`` and the probe state
    are its data rows (K1 on them, theta whole); the logits' vocab shards
    are gathered for the argmax.  The chunked and speculative steps are
    not sharded, and the recurrent and hybrid families' sharded serving
    (their states sharded on heads and channels) is ROADMAP A9b: both
    raise."""
    mcfg = model.cfg
    eta = float(P.inner_lr(pc, theta))
    _check_sharded(model, spec_tokens or spec_tree)

    def run_chunk(params, cache, chunk):
        # prefill work first, decode after: the chunk's slots are parked,
        # and no other slot reads their pages or lanes
        return model.prefill_packed(mcfg, params, chunk["tokens"], cache,
                                    chunk["seg"], chunk["slots"],
                                    chunk["starts"], chunk["lengths"],
                                    chunk.get("rows"))

    def lay_out(lens, blk, c):
        """Segments back to back in slot order (the packed chunk's
        layout): (dst (B, k) chunk index of each block entry, c for those
        past the slot's length; offs (B,) each segment's start; scat(src)
        the (B, k) ``src`` scattered to the chunk, tail zero)."""
        bsz, k = blk.shape
        offs = torch.cumsum(lens, 0) - lens
        jj = torch.arange(k, device=blk.device)[None, :]
        dst = torch.where(jj < lens[:, None], offs[:, None] + jj, c)
        flat = dst.reshape(-1)

        def scat(src):
            out = torch.zeros(c + 1, dtype=src.dtype, device=blk.device)
            out[flat] = src.expand(bsz, k).reshape(-1)
            return out[:c]
        return dst, offs, scat

    if spec_tree is not None:
        tw, td = int(spec_tree[0]), int(spec_tree[1])
        assert tw >= 1 and td >= 1, spec_tree
        assert model.supports_tree, \
            f"{mcfg.name}: no tree speculative decode for this family"
        kk = 1 + tw * td
        # the static BFS comb: node 0 the root, node 1 + j*W + b branch b
        # at depth j + 1, its parent one level up on the same branch (the
        # root at j = 0).  Index order is BFS order, so truncating a slot's
        # nodes by count keeps every parent.
        par_np = np.zeros((kk,), np.int64)
        dep_np = np.zeros((kk,), np.int32)
        for j in range(td):
            for b_ in range(tw):
                i = 1 + j * tw + b_
                dep_np[i] = j + 1
                par_np[i] = 0 if j == 0 else i - tw
        dev0 = theta["W0"].device
        par_l = torch.as_tensor(par_np, device=dev0)
        dep_l = torch.as_tensor(dep_np, device=dev0)

        @torch.no_grad()
        def tree_step(params, token, cache, pos, st: ProbeState, chunk,
                      spec):
            if chunk is not None:
                cache = run_chunk(params, cache, chunk)
            bsz, c = token.shape[0], token.shape[0] * kk
            dev = token.device
            lens = torch.where(st.stopped, 0, spec["lens"])
            drafts = torch.where(spec["have"][:, None, None], spec["drafts"],
                                 model.draft_tree(mcfg, params, cache, token,
                                                  pos, tw, td))
            # BFS layout: blk[:, 1 + j*W + b] = drafts[:, b, j]
            blk = torch.cat([token[:, None],
                             drafts.transpose(1, 2).reshape(bsz, tw * td)],
                            dim=1)                              # (B, k)
            dst, offs, scat = lay_out(lens, blk, c)
            slots = torch.arange(bsz, dtype=torch.int32, device=dev)
            toks_c = scat(blk)
            seg_c = scat(slots[:, None])
            dep_c = scat(dep_l[None, :])
            # global parent pointers: the root points at itself; the
            # chunk's tail keeps 0, invalid by length
            anc_c = scat(offs[:, None] + par_l[None, :])
            rows_arg = cache.get("block_tables")
            logits, hidden, ks, vs = model.verify_tree(
                mcfg, params, toks_c, cache, seg_c, slots, pos, lens, dep_c,
                anc_c, rows_arg)
            out_c = torch.argmax(logits[:, :mcfg.vocab_size],
                                 dim=-1).to(torch.int32)
            out_blk = out_c[torch.clamp(dst, max=c - 1)]        # (B, k)
            # per-node acceptance, rooted, one depth at a time: node i
            # survives iff its parent did, it lies within the slot's
            # length and it equals the model's output after its parent
            nodes = torch.arange(kk, device=dev)
            acc = (lens > 0)[:, None].expand(bsz, kk).clone()
            for j in range(td):
                lvl = slice(1 + j * tw, 1 + (j + 1) * tw)
                par = par_l[lvl]
                acc[:, lvl] = (acc[:, par] & (nodes[lvl][None, :]
                                              < lens[:, None])
                               & (blk[:, lvl] == out_blk[:, par]))
            plen = torch.where(acc, dep_l[None, :] + 1, 0)
            g = plen.max(1).values.to(torch.int32)   # path length, root too
            best = torch.argmax(plen, dim=1)
            # the root-first path by the ancestor walk from ``best``: entry
            # d is best's ancestor at distance dep[best] - d (clamped; the
            # tail repeats ``best``, masked by d < g below)
            curs = [best]
            for _ in range(td):
                curs.append(par_l[curs[-1]])
            curs = torch.stack(curs, dim=1)                    # (B, D + 1)
            dd = torch.arange(td + 1, device=dev)
            walk = torch.clamp(dep_l[best][:, None] - dd[None, :], 0, td)
            path = torch.gather(curs, 1, walk)
            pdx = torch.clamp(offs[:, None] + path, max=c - 1)
            seq = out_c[pdx]                                   # (B, D + 1)
            # the accepted path is a chain: K4 consumes it as it consumes a
            # linear block, so stops equal one-token decode
            st, sm_seq, n_seq = probe_update_spec(
                pc, theta, st, hidden[pdx], g, cfg.lam, cfg.tokens_per_step,
                cfg.burn_in, eta)
            # commit only the accepted path's K/V: one node a depth, no two
            # targets alike
            on_path = ((path[:, :, None] == nodes[None, None, :])
                       & (dd[None, :, None] < g[:, None, None])).any(1)
            pos_c = scat(pos[:, None] + dep_l[None, :])
            cache = model.commit_kv(mcfg, cache, ks, vs, slots, seg_c, pos_c,
                                    scat(on_path), rows_arg)
            last = torch.gather(seq, 1,
                                torch.clamp(g.long() - 1, 0, td)[:, None])
            nxt = torch.where(g > 0, last[:, 0], token)
            return nxt, cache, st, {"gen": g, "seq": seq,
                                    "seq_scores": sm_seq, "seq_n": n_seq}

        return tree_step

    if spec_tokens:
        assert spec_tokens >= 2, "spec_tokens < 2 is one-token decode"
        assert model.supports_spec, \
            f"{mcfg.name}: no speculative decode for this family"
        kk = int(spec_tokens)

        @torch.no_grad()
        def spec_step(params, token, cache, pos, st: ProbeState, chunk,
                      spec):
            if chunk is not None:
                cache = run_chunk(params, cache, chunk)
            bsz, c = token.shape[0], token.shape[0] * kk
            dev = token.device
            # parked rows contribute nothing: no writes, no probe, no
            # advance
            lens = torch.where(st.stopped, 0, spec["lens"])
            drafts = torch.where(spec["have"][:, None], spec["drafts"],
                                 model.draft(mcfg, params, cache, token, pos,
                                             kk))
            blk = torch.cat([token[:, None], drafts], dim=1)     # (B, k)
            # tokens past a slot's length scatter to a dropped tail slot,
            # and the chunk's tail keeps seg 0, invalid by length
            dst, _, scat = lay_out(lens, blk, c)
            slots = torch.arange(bsz, dtype=torch.int32, device=dev)
            logits, hidden, cache = model.verify_packed(
                mcfg, params, scat(blk), cache, scat(slots[:, None]), slots,
                pos, lens, cache.get("block_tables"))
            out_c = torch.argmax(logits[:, :mcfg.vocab_size],
                                 dim=-1).to(torch.int32)
            gdx = torch.clamp(dst, max=c - 1)
            out_blk = out_c[gdx]                                 # (B, k)
            # accepted prefix: draft j+1 survives iff it equals the model's
            # output after consuming draft j; the first miss is replaced by
            # the model's own token, so gen = accepted drafts + 1
            jj = torch.arange(1, kk, device=dev)[None, :]
            ok = (blk[:, 1:] == out_blk[:, :-1]) & (jj < lens[:, None])
            n_acc = torch.cumprod(ok.to(torch.int32), dim=1).sum(1)
            g = torch.where(lens > 0, n_acc + 1, 0).to(torch.int32)
            st, sm_seq, n_seq = probe_update_spec(
                pc, theta, st, hidden[gdx], g, cfg.lam, cfg.tokens_per_step,
                cfg.burn_in, eta)
            last = torch.gather(out_blk, 1,
                                torch.clamp(g.long() - 1, 0, kk - 1)[:, None])
            nxt = torch.where(g > 0, last[:, 0], token)
            return nxt, cache, st, {"gen": g, "seq": out_blk,
                                    "seq_scores": sm_seq, "seq_n": n_seq}

        return spec_step

    @torch.no_grad()
    def serve_step(params, token, cache, pos, st: ProbeState, chunk=None):
        if chunk is not None:
            _check_sharded(model, True)
            cache = run_chunk(params, cache, chunk)
        write_mask = ~st.stopped if mask_stopped_writes else None
        logits, hidden, cache = model.decode_step(mcfg, params, token, cache,
                                                  pos, write_mask=write_mask)
        logits = _whole_vocab(mcfg, logits)
        prev_stopped = st.stopped.clone()
        st = probe_update(pc, theta, st, hidden, cfg.lam, cfg.tokens_per_step,
                          cfg.burn_in, eta)
        nxt = torch.argmax(logits[:, :mcfg.vocab_size], dim=-1).to(torch.int32)
        # the step on which the stop FIRES still emits its genuinely decoded
        # token; only already-frozen sequences repeat (no-op compute slot)
        nxt = torch.where(prev_stopped, token, nxt)
        return nxt, cache, st

    return serve_step


def _check_sharded(model: Model, unsharded_work) -> None:
    """Raise where a sharded serve step is asked for what it does not
    do."""
    if parallel.current_ctx() is None:
        return
    if model.cfg.arch_type not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"{model.cfg.name}: sharded serving of the {model.cfg.arch_type} "
            "family's state (heads and channels over the model axis) is "
            "ROADMAP A9b")
    if unsharded_work:
        raise NotImplementedError(
            "the sharded serve step is the one-token step: chunked prefill "
            "and speculative decode run without a ParallelContext")


def _whole_vocab(mcfg, logits: torch.Tensor) -> torch.Tensor:
    """Logits over the whole padded vocab: a vocab shard (a sharded serve
    step's) gathered over the rules' vocab axes."""
    ctx = parallel.current_ctx()
    if ctx is None or logits.shape[-1] == mcfg.padded_vocab():
        return logits
    axes = ctx.rules["vocab"]
    for a in reversed(parallel.axis_names(axes)):
        logits = parallel.all_gather(logits, a, -1)
    return logits


def prefix_len(mcfg, batch_one: Dict[str, np.ndarray],
               prompt_len: int) -> int:
    """Sequence length ``model.prefill`` actually runs for one request."""
    n = prompt_len
    if mcfg.arch_type == "vlm" and "patch_embeds" in batch_one:
        n += mcfg.frontend.n_tokens
    n += getattr(mcfg, "n_meta_tokens", 0) or 0
    return n


def decode_start(mcfg, batch_one: Dict[str, np.ndarray],
                 prompt_len: int) -> int:
    """The position a request's first decode step runs at: after the whole
    prefill prefix (vlm patches and meta tokens included), or 0 for an
    audio encoder-decoder, whose decoder cache holds generated tokens
    only."""
    if mcfg.arch_type == "audio":
        return 0
    return prefix_len(mcfg, batch_one, prompt_len)


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray        # (B, n_decode_iters) tokens actually decoded
    stop_step: np.ndarray     # (B,) reasoning step at stop (-1 = budget)
    steps_run: np.ndarray     # (B,) reasoning steps actually executed
    savings: float
    scores: np.ndarray        # (B, n_steps) smoothed score at each step


class ServingEngine:
    """Minimal batched server: prefill once, loop the fused serve_step.

    DEPRECATED as a serving path: stopped sequences keep occupying their
    batch slot as no-op compute until the slowest sequence finishes.  Use
    ``OrcaScheduler`` (continuous batching with ORCA-stop eviction) for
    throughput; this class remains as the static-batch baseline it is
    compared against.  Dense cache; the prompt prefills in one shot
    through ``chunked_prefill``."""

    def __init__(self, model: Model, params, pc: ProbeConfig, theta,
                 cfg: ServeConfig):
        self.model, self.params, self.pc, self.theta, self.cfg = \
            model, params, pc, theta, cfg
        self._step_fn = make_serve_step(model, pc, theta, cfg)

    @torch.no_grad()
    def serve(self, batch: Dict[str, np.ndarray], prompt_len: int,
              cache_len: Optional[int] = None) -> ServeResult:
        warnings.warn(
            "ServingEngine.serve is deprecated as a serving path (stopped "
            "sequences occupy their slot as no-op compute until the slowest "
            "finishes); serve through repro_torch.serving.OrcaScheduler / "
            "repro_torch.api.engine for continuous batching — this class "
            "remains only as the static-batch baseline",
            DeprecationWarning, stacklevel=2)
        model, cfg = self.model, self.cfg
        mcfg = model.cfg
        device = self.params["embed"].device
        batch = to_device_inputs(batch, device)
        B = next(iter(batch.values())).shape[0]
        pre = prefix_len(mcfg, batch, prompt_len)
        cache_len = cache_len or (pre + cfg.max_new_tokens)
        state = chunked_prefill(model, self.params, batch, cache_len)
        st = init_probe_state(self.pc, self.theta, B, mcfg.d_model)
        token = torch.zeros((B,), dtype=torch.int32, device=device)
        toks: List[torch.Tensor] = []
        scores: List[np.ndarray] = []
        last_max_n = 0
        pos0 = decode_start(mcfg, batch, prompt_len)
        for i in range(cfg.max_new_tokens):
            pos = torch.full((B,), pos0 + i, dtype=torch.int32,
                             device=device)
            token, state, st = self._step_fn(self.params, token, state, pos,
                                             st)
            toks.append(token)
            # ONE host copy a step: max n_scores, all stopped, smoothed
            obs = torch.cat([st.n_scores.max().reshape(1).float(),
                             st.stopped.all().reshape(1).float(),
                             st.smoothed]).cpu().numpy()
            max_n = int(obs[0])
            if max_n > last_max_n:
                scores.append(obs[2:])
                last_max_n = max_n
            if obs[1] > 0.5:
                break
        stop_step = st.stop_step.cpu().numpy()
        steps_run = np.where(stop_step >= 0, stop_step,
                             st.n_scores.cpu().numpy())
        total = max(cfg.max_new_tokens // cfg.tokens_per_step, 1)
        savings = float(np.mean(S.step_savings(steps_run, total)))
        return ServeResult(
            tokens=(torch.stack(toks, dim=1).cpu().numpy() if toks
                    else np.zeros((B, 0), np.int32)),
            stop_step=stop_step, steps_run=steps_run, savings=savings,
            scores=(np.stack(scores, axis=1) if scores
                    else np.zeros((B, 0))))


@dataclasses.dataclass
class StaticQueueResult:
    """Aggregate of serving a request queue in fixed static-batch groups."""
    stop_step: np.ndarray        # (N,) per request
    steps_run: np.ndarray        # (N,)
    scores: List[np.ndarray]     # per request, (n_steps,)
    engine_steps: int            # total fused decode steps across groups
    active_slot_steps: int       # slot-steps before each sequence stopped
    total_slot_steps: int        # engine_steps x group width
    wall_time_s: float


def serve_queue_static(engine: ServingEngine, batch: Dict[str, np.ndarray],
                       prompt_len: int, n_slots: int) -> StaticQueueResult:
    """Serve a queue in fixed groups of ``n_slots`` through the deprecated
    static-batch path (no eviction: each group runs until its slowest
    member finishes).  The baseline the serving driver's
    ``--static-baseline`` compares the scheduler against."""
    n = next(iter(batch.values())).shape[0]
    stop_steps, steps_run, scores = [], [], []
    engine_steps = active = total = 0
    t0 = time.perf_counter()
    for lo in range(0, n, n_slots):
        group = {k: v[lo:lo + n_slots] for k, v in batch.items()}
        with warnings.catch_warnings():
            # this helper IS the sanctioned baseline use of the deprecated
            # path — don't repeat its own deprecation per group
            warnings.simplefilter("ignore", DeprecationWarning)
            res = engine.serve(group, prompt_len=prompt_len)
        iters = res.tokens.shape[1]
        b = next(iter(group.values())).shape[0]
        engine_steps += iters
        total += iters * b
        # a slot is useful until its sequence stops; frozen after
        active += int(np.minimum(
            res.steps_run * engine.cfg.tokens_per_step, iters).sum())
        stop_steps.extend(res.stop_step.tolist())
        steps_run.extend(res.steps_run.tolist())
        scores.extend(res.scores[i] for i in range(res.scores.shape[0]))
    return StaticQueueResult(
        stop_step=np.array(stop_steps), steps_run=np.array(steps_run),
        scores=scores, engine_steps=engine_steps, active_slot_steps=active,
        total_slot_steps=total, wall_time_s=time.perf_counter() - t0)


@torch.no_grad()
def extract_trajectories(model: Model, params, batch, prompt_len: int,
                         max_new_tokens: int, tokens_per_step: int,
                         cache_len: Optional[int] = None,
                         chunk_tokens: Optional[int] = None):
    """Run the model WITHOUT stopping and harvest step embeddings phi_t —
    the trajectory source for meta-training probes on a real model.  Decodes
    through the DENSE cache, as the JAX package does (K6 on the card); the
    prompt prefills through ``chunked_prefill`` (``chunk_tokens=None``
    keeps the one-shot prefill, K7 on the card).
    batch: {"tokens": (B, S)} numpy or tensors; returns numpy
    (phis (B, n_steps, d), tokens (B, max_new_tokens))."""
    mcfg = model.cfg
    device = params["embed"].device
    batch = to_device_inputs(batch, device)
    B = batch["tokens"].shape[0]
    pre = prefix_len(mcfg, batch, prompt_len)
    cache_len = cache_len or (pre + max_new_tokens)
    state = chunked_prefill(model, params, batch, cache_len,
                            chunk_tokens=chunk_tokens)
    token = torch.zeros((B,), dtype=torch.int32, device=device)
    acc = torch.zeros((B, mcfg.d_model), device=device)
    phis: List[torch.Tensor] = []
    tokens: List[torch.Tensor] = []
    cnt = 0
    pos0 = decode_start(mcfg, batch, prompt_len)
    for i in range(max_new_tokens):
        pos = torch.full((B,), pos0 + i, dtype=torch.int32, device=device)
        logits, hidden, state = model.decode_step(mcfg, params, token, state,
                                                  pos)
        token = torch.argmax(logits[:, :mcfg.vocab_size], -1).to(torch.int32)
        tokens.append(token)
        acc = acc + hidden.float()
        cnt += 1
        if cnt == tokens_per_step:
            phis.append(acc / cnt)
            acc, cnt = torch.zeros_like(acc), 0
    phis_np = (torch.stack(phis, dim=1).cpu().numpy() if phis
               else np.zeros((B, 0, mcfg.d_model), np.float32))
    return phis_np, torch.stack(tokens, dim=1).cpu().numpy()


class SlotStepView(NamedTuple):
    """Host-visible per-slot observation after one fused engine step.

    The four trailing fields are only set by speculative steps
    (``spec_tokens > 0``); one-token steps leave them None."""
    tokens: np.ndarray      # (n_slots,) token decoded this step
    stopped: np.ndarray     # (n_slots,) bool — ORCA threshold crossed
    stop_step: np.ndarray   # (n_slots,) reasoning step at stop (-1 active)
    n_scores: np.ndarray    # (n_slots,) scores emitted since admission
    smoothed: np.ndarray    # (n_slots,) current smoothed score
    gen: Optional[np.ndarray] = None         # (n_slots,) tokens committed
    seq: Optional[np.ndarray] = None         # (n_slots, k) committed tokens
    seq_scores: Optional[np.ndarray] = None  # (n_slots, k) smoothed / token
    seq_n: Optional[np.ndarray] = None       # (n_slots, k) n_scores / token


@dataclasses.dataclass
class Spill:
    """Everything a preempted request needs to resume bit-identically,
    copied to host RAM (CPU tensors; never device memory).

    The per-request TTT calibrator (W_i, b_i, smoothing ring, counters)
    *is* the request's identity — restoring it exactly, together with the
    KV it conditions on and the position it decodes from, is what makes a
    preempted-then-resumed request stop on the same reasoning step as an
    undisturbed one.
    """
    probe: Tuple[torch.Tensor, ...]  # one row per ProbeState leaf
    token: int                       # last decoded token (decode input)
    pos: int                         # sequence position to resume from
    armed: bool                      # True: was RUNNING; False: mid-prefill
    prompt_len: int = 0              # prefill progress bookkeeping (host side)
    # paged: the victim's pages, (L, n_blocks, ...) per page leaf, in the
    # order of its block row
    pages: Optional[Dict[str, torch.Tensor]] = None
    n_blocks: int = 0                # physical blocks the pages cover
    # dense: the slot's decode-state lane (axis-1 slice of every leaf)
    lane: Optional[Dict[str, torch.Tensor]] = None

    @property
    def nbytes(self) -> int:
        """Host RAM this spill's KV payload occupies."""
        leaves = (self.pages if self.pages is not None
                  else self.lane if self.lane is not None else {})
        return int(sum(t.numel() * t.element_size()
                       for t in leaves.values()))


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` that shares no memory with it.  From a CUDA
    tensor the copy is synchronous: it has landed before the caller hands
    the source pages or slot to anyone else."""
    return t.to("cpu", copy=True)


class ContinuousServingEngine:
    """Fixed-shape batch of ``n_slots`` whose rows live independent lives.

    * ``pos`` is a per-slot host vector; the model's ``decode_step`` takes
      (B,) positions (per-row valid masks, per-row cache writes).
    * ``admit`` prefills ONE request (batch 1) into the slot — a dense lane,
      or (``paged=True``) page by page through the request's block row,
      reserved by the scheduler's ``BlockPool``; a prefix hit skips prefill
      and copies only the donor's partial tail page — then resets the
      slot's probe state to (W0, b0).
    * ``release`` parks the slot (probe ``stopped=True``); paged, its table
      row points at the NULL page so a parked write never touches a page
      the pool hands to someone else.
    * With ``chunk_tokens`` (chunked prefill), prefill is a resident phase:
      ``begin_prefill`` parks the slot, the unified ``step(chunk)`` runs up
      to ``chunk_tokens`` prompt tokens of up to ``max_pack`` requests
      before the decode, and ``finish_prefill`` arms the slot after its
      last chunk.
    * With ``spec_tokens = k`` (or ``spec_tree = (W, D)``, 1 + W*D nodes a
      slot), ``step`` takes each slot's verify length and host drafts, and
      each slot's ``pos`` advances by the tokens it committed.
    * ``preempt`` spills a slot to host RAM and releases it; ``restore``
      resumes a ``Spill`` in any free slot, on any free pages.

    The scheduler owns queues, lifecycles, the block pool and metrics; this
    class owns device state only.  The device is the parameters' device.
    """

    def __init__(self, model: Model, params, pc: ProbeConfig, theta,
                 cfg: ServeConfig, n_slots: int, cache_len: int, *,
                 paged: bool = False, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 chunk_tokens: Optional[int] = None, pack_max: int = 4,
                 spec_tokens: Optional[int] = None,
                 spec_tree: Optional[Tuple[int, int]] = None):
        self.model, self.params, self.pc, self.theta, self.cfg = \
            model, params, pc, theta, cfg
        self.device = params_device(params)
        mcfg = model.cfg
        self.paged = bool(paged)
        if self.paged:
            assert model.supports_paged, \
                f"{mcfg.name}: no paged cache layout for this family"
            self.block_size = int(block_size)
            self.max_blocks = blocks_needed(cache_len, block_size)
            cache_len = self.max_blocks * self.block_size
            self.num_blocks = int(num_blocks or
                                  (n_slots * self.max_blocks + 1))
            self.state = model.init_paged_state(
                n_slots, self.num_blocks, self.block_size, self.max_blocks,
                device=self.device)
        else:
            self.state = model.init_decode_state(n_slots, cache_len,
                                                 device=self.device)
        self.n_slots, self.cache_len = n_slots, cache_len
        # chunked prefill: the step becomes the unified token-budget step
        # (decode every slot + up to chunk_tokens prompt tokens, PACKED
        # across up to max_pack mid-prefill requests)
        self.chunk_tokens = int(chunk_tokens or 0)
        self.max_pack = max(min(int(pack_max), self.chunk_tokens), 1) \
            if self.chunk_tokens else 0
        if self.chunk_tokens:
            assert model.supports_chunked, \
                f"{mcfg.name}: no chunked prefill for this family"
        # speculative draft-verify decode: every RUNNING slot may ride the
        # packed verify chunk with up to spec_tokens tokens per step;
        # spec_tree = (W, D) makes it a tree of 1 + W*D NODES a slot, and
        # spec_tokens that node count (the scheduler's unit either way)
        self.spec_tree = (tuple(int(x) for x in spec_tree) if spec_tree
                          else None)
        self.spec_tokens = int(spec_tokens or 0)
        if self.spec_tree:
            assert not self.spec_tokens, \
                "spec_tree and spec_tokens are mutually exclusive"
            assert model.supports_tree, \
                f"{mcfg.name}: no tree speculative decode for this family"
            self.spec_tokens = 1 + self.spec_tree[0] * self.spec_tree[1]
        elif self.spec_tokens:
            assert model.supports_spec, \
                f"{mcfg.name}: no speculative decode for this family"
        self.st = init_probe_state(pc, theta, n_slots, mcfg.d_model)
        self.st.stopped.fill_(True)
        self.token = torch.zeros((n_slots,), dtype=torch.int32,
                                 device=self.device)
        self.pos = np.zeros((n_slots,), np.int32)
        self._step_fn = make_serve_step(
            model, pc, theta, cfg, mask_stopped_writes=bool(self.chunk_tokens),
            spec_tokens=0 if self.spec_tree else self.spec_tokens,
            spec_tree=self.spec_tree)

    def _pages(self):
        return {k: v for k, v in self.state.items() if k != "block_tables"}

    def _set_row(self, slot: int, row) -> None:
        self.state["block_tables"][slot] = torch.as_tensor(
            np.asarray(row, np.int32), device=self.device)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def admit(self, slot: int, batch_one: Dict[str, np.ndarray],
              prompt_len: int, *, block_row=None, skip_prefill: bool = False,
              copy_tail=None) -> None:
        """Prefill + inject one request into ``slot`` and arm its probe.

        Paged mode takes the request's reserved physical block ids
        (``block_row``); ``skip_prefill`` marks a prefix hit (the shared
        full pages already hold the prompt K/V) and ``copy_tail`` is the
        (src, dst) page pair for the donor's partial tail page."""
        inputs = to_device_inputs(batch_one, self.device)
        if self.paged:
            assert block_row is not None, "paged admit needs a block row"
            row = pad_row(block_row, self.max_blocks)
            self._set_row(slot, row)
            if copy_tail is not None:
                src, dst = copy_tail
                A.copy_pages(self._pages(),
                             torch.tensor([src], device=self.device),
                             torch.tensor([dst], device=self.device))
            if not skip_prefill:
                pre = prefix_len(self.model.cfg, batch_one, prompt_len)
                n_blocks = blocks_needed(pre, self.block_size)
                assert n_blocks <= len(block_row), \
                    "block row shorter than the prefill prefix"
                sub, _, _ = self.model.prefill(
                    self.model.cfg, self.params, inputs,
                    n_blocks * self.block_size)
                A.prefill_to_pages(self._pages(), sub,
                                   torch.as_tensor(row, device=self.device),
                                   n_blocks)
        else:
            assert block_row is None and copy_tail is None and not skip_prefill
            inject_prefill(self.model, self.params, self.state, inputs, slot,
                           self.cache_len)
        reset_probe_slot(self.pc, self.theta, self.st, slot, active=True)
        self.token[slot] = 0
        # decode resumes AFTER the whole prefill prefix (at 0 for audio)
        self.pos[slot] = decode_start(self.model.cfg, batch_one, prompt_len)

    def release(self, slot: int) -> None:
        """Evict the slot's request: park the probe row as no-op compute.
        Paged: the slot's table row is pointed at the NULL page."""
        reset_probe_slot(self.pc, self.theta, self.st, slot, active=False)
        if self.paged:
            self._set_row(slot, np.full((self.max_blocks,), NULL_BLOCK))
        self.pos[slot] = 0

    def cancel(self, slot: int) -> None:
        """Voluntary mid-flight release: the release path (park the probe
        row, NULL the table row, zero the position), safe mid-prefill too —
        a resident PREFILL row already sits parked at the NULL page."""
        self.release(slot)

    # ------------------------------------------------------------------
    # involuntary preemption: spill to host RAM, restore bit for bit
    def _page_index(self, block_row) -> torch.Tensor:
        """A victim's physical pages as a device index.  Every entry must
        be a real page, once: a NULL entry would copy into the NULL page
        and a repeated one would scatter twice, so both are refused on the
        host (the JAX package drops such rows past the pool instead)."""
        row = [int(b) for b in block_row]
        if not row or NULL_BLOCK in row or len(set(row)) != len(row) \
                or max(row) >= self.num_blocks or min(row) < 0:
            raise ValueError(
                f"block row {row} is not a list of distinct real pages in "
                f"[1, {self.num_blocks}): a spill or restore moves exactly "
                "the request's own pages; fix by passing the scheduler's "
                "block_ids for the request")
        return torch.tensor(row, dtype=torch.long, device=self.device)

    @torch.no_grad()
    def preempt(self, slot: int, *, block_row=None, armed: bool = True,
                prompt_len: int = 0) -> Spill:
        """INVOLUNTARY eviction: copy the slot's request identity to host
        RAM, then release the slot.  ``restore`` resumes it later.

        Paged mode takes the victim's physical block ids (``block_row`` —
        the scheduler's view, because a mid-prefill victim's table row is
        still NULL while its chunks write through explicit rows) and copies
        those pages out, every page leaf (int8 scales too); dense mode
        copies the slot's lane of every state leaf (a KV lane, or RWKV6's
        recurrent state).  ``armed=False`` marks a mid-prefill victim."""
        probe = tuple(_host(leaf[slot]) for leaf in self.st)
        token = int(self.token[slot])
        pos = int(self.pos[slot])
        pages = lane = None
        n_blocks = 0
        if self.paged:
            assert block_row is not None, "paged preempt needs the block row"
            idx = self._page_index(block_row)
            n_blocks = int(idx.numel())
            pages = {k: _host(v[:, idx]) for k, v in self._pages().items()}
        else:
            assert block_row is None
            lane = {k: _host(v[:, slot]) for k, v in self.state.items()}
        self.release(slot)
        return Spill(probe=probe, token=token, pos=pos, armed=bool(armed),
                     prompt_len=int(prompt_len), pages=pages,
                     n_blocks=n_blocks, lane=lane)

    @torch.no_grad()
    def restore(self, slot: int, spill: Spill, *, block_row=None) -> None:
        """Resume a spilled request in ``slot``: page copy-back (or dense
        lane write), block-table rewrite, probe row reloaded exactly, token
        and position restored.  The new ``block_row`` need not be the
        victim's original pages — only the table indirection changes.  A
        mid-prefill victim's table row stays NULL: its remaining chunks
        write through the explicit row and ``finish_prefill`` arms it."""
        if self.paged:
            assert block_row is not None, "paged restore needs a block row"
            assert len(block_row) == spill.n_blocks, \
                (len(block_row), spill.n_blocks)
            idx = self._page_index(block_row)
            for k, v in self._pages().items():
                v[:, idx] = spill.pages[k].to(self.device, v.dtype)
            self._set_row(slot, pad_row(block_row, self.max_blocks)
                          if spill.armed
                          else np.full((self.max_blocks,), NULL_BLOCK))
        else:
            assert block_row is None
            for k, v in self.state.items():
                v[:, slot] = spill.lane[k].to(self.device, v.dtype)
        write_probe_slot(self.st, slot,
                         [p.to(self.device) for p in spill.probe])
        self.token[slot] = spill.token
        self.pos[slot] = spill.pos

    # ------------------------------------------------------------------
    # chunked prefill: PREFILL is a resident phase, not an admission event
    def begin_prefill(self, slot: int) -> None:
        """Make ``slot`` a resident PREFILL row.  The probe is parked
        (``stopped=True``): the unified step treats the row as no-op decode,
        K1 leaves its state untouched and its dense K/V write is dropped.
        Paged: the slot's table row STAYS at NULL for the whole prefill
        (chunks write through their explicit block row), so the parked
        decode write cannot touch the reserved pages."""
        assert self.chunk_tokens, "engine built without chunk_tokens"
        reset_probe_slot(self.pc, self.theta, self.st, slot, active=False)
        if self.paged:
            self._set_row(slot, np.full((self.max_blocks,), NULL_BLOCK))
        self.token[slot] = 0
        self.pos[slot] = 0

    def finish_prefill(self, slot: int, batch_one: Dict[str, np.ndarray],
                       prompt_len: int, *, block_row=None) -> None:
        """Arm ``slot`` after its last prefill chunk: point its table row at
        the now-filled pages (paged), reset the probe to (W0, b0) and resume
        decode at the prompt length — the slot state of a full-prefill
        ``admit``."""
        assert self.chunk_tokens, "engine built without chunk_tokens"
        if self.paged:
            assert block_row is not None, "paged finish_prefill needs a row"
            self._set_row(slot, pad_row(block_row, self.max_blocks))
        reset_probe_slot(self.pc, self.theta, self.st, slot, active=True)
        self.token[slot] = 0
        self.pos[slot] = prefix_len(self.model.cfg, batch_one, prompt_len)

    def _chunk_to_device(self, chunk: ChunkWork) -> Dict[str, torch.Tensor]:
        """Lower a (possibly packed) ChunkWork to the fixed-shape device
        descriptor: segments laid out back to back in ``tokens``/``seg``,
        per-segment (slot, start, length, pages) arrays padded to
        ``max_pack`` rows with zero-length segments.  Trailing token
        padding keeps the LAST segment's id, which places it past that
        segment's length: invalid by construction, dropped at the write.
        The descriptor goes to the device in one copy."""
        c, r = self.chunk_tokens, self.max_pack
        segs = chunk.segs
        assert 1 <= len(segs) <= r, (len(segs), r)
        nb = self.max_blocks if self.paged else 0
        buf = np.zeros((2 * c + 3 * r + r * nb,), np.int32)
        toks, seg = buf[:c], buf[c:2 * c]
        slots, starts, lengths = (buf[2 * c + i * r:2 * c + (i + 1) * r]
                                  for i in range(3))
        rows = buf[2 * c + 3 * r:].reshape(r, nb)
        seg[:] = len(segs) - 1
        rows[:] = NULL_BLOCK
        off = 0
        for si, s in enumerate(segs):
            assert off + s.length <= c, "packed segments exceed the chunk"
            toks[off:off + s.length] = np.asarray(
                s.tokens[s.start:s.start + s.length])
            seg[off:off + s.length] = si
            slots[si], starts[si], lengths[si] = s.slot, s.start, s.length
            if self.paged and s.row is not None:
                rows[si, :len(s.row)] = np.asarray(s.row, np.int32)
            off += s.length
        dev = torch.as_tensor(buf).to(self.device)
        out = {"tokens": dev[:c], "seg": dev[c:2 * c]}
        for i, key in enumerate(("slots", "starts", "lengths")):
            out[key] = dev[2 * c + i * r:2 * c + (i + 1) * r]
        if self.paged:
            out["rows"] = dev[2 * c + 3 * r:].view(r, nb)
        return out

    # ------------------------------------------------------------------
    def _spec_to_device(self, spec_lens, spec_drafts, spec_have
                        ) -> Dict[str, torch.Tensor]:
        """Lower the host spec descriptor (None = zeros) to the device in
        one copy: lens (n,), have (n,), drafts (n, k - 1), or (n, W, D) on
        a tree engine."""
        n = self.n_slots
        shape = ((n,) + self.spec_tree if self.spec_tree
                 else (n, self.spec_tokens - 1))
        buf = np.zeros((2 * n + int(np.prod(shape)),), np.int32)
        if spec_lens is not None:
            buf[:n] = np.asarray(spec_lens, np.int32)
        if spec_drafts is not None:
            assert spec_have is not None, \
                "spec_drafts needs its per-slot have mask"
            buf[n:2 * n] = np.asarray(spec_have, bool)
            buf[2 * n:] = np.asarray(spec_drafts, np.int32).reshape(-1)
        dev = torch.as_tensor(buf).to(self.device)
        return {"lens": dev[:n], "have": dev[n:2 * n].bool(),
                "drafts": dev[2 * n:].view(shape)}

    def step(self, chunk: Optional[ChunkWork] = None, spec_lens=None,
             spec_drafts=None, spec_have=None) -> SlotStepView:
        """One fused decode + probe step for every slot (vector pos) — and,
        in chunked mode, up to ``chunk_tokens`` prompt tokens of up to
        ``max_pack`` mid-prefill requests packed into ``chunk`` first (None
        = decode only).

        A spec engine also takes ``spec_lens``, per-slot verify lengths in
        [0, spec_tokens] (None = 0 everywhere), and advances each slot's
        ``pos`` by the tokens it committed; ``spec_drafts``/``spec_have``
        inject host drafts (the shared draft cache), and slots with
        ``have=False`` take the model family's own drafter.  A tree engine
        takes drafts (n_slots, W, D), and ``spec_lens`` counts NODES in
        [0, 1 + W*D].  The view's spec fields carry the committed
        multi-token sequences; the step's host reads are one device-to-host
        copy."""
        assert chunk is None or self.chunk_tokens, \
            "engine built without chunk_tokens"
        dev_chunk = None if chunk is None else self._chunk_to_device(chunk)
        pos = torch.as_tensor(self.pos, device=self.device)
        if self.spec_tokens:
            spec = self._spec_to_device(spec_lens, spec_drafts, spec_have)
            self.token, self.state, self.st, extras = self._step_fn(
                self.params, self.token, self.state, pos, self.st, dev_chunk,
                spec)
            st = self.st
            # one copy: the f32 fields travel as their int32 bit patterns
            parts = [self.token, st.stopped.to(torch.int32), st.stop_step,
                     st.n_scores, extras["gen"], extras["seq"],
                     extras["seq_n"], st.smoothed.view(torch.int32),
                     extras["seq_scores"].contiguous().view(torch.int32)]
            host = torch.cat([t.reshape(-1) for t in parts]).cpu().numpy()
            fields, off = [], 0
            for t in parts:
                fields.append(host[off:off + t.numel()].reshape(t.shape))
                off += t.numel()
            tokens, stopped, stop_step, n_scores, gen, seq, seq_n, \
                smoothed, seq_scores = fields
            self.pos = self.pos + gen
            return SlotStepView(
                tokens=tokens, stopped=stopped > 0, stop_step=stop_step,
                n_scores=n_scores, smoothed=smoothed.view(np.float32),
                gen=gen, seq=seq, seq_scores=seq_scores.view(np.float32),
                seq_n=seq_n)
        assert spec_lens is None and spec_drafts is None, \
            "engine built without spec_tokens"
        self.token, self.state, self.st = self._step_fn(
            self.params, self.token, self.state, pos, self.st, dev_chunk)
        self.pos = self.pos + 1
        st = self.st
        return SlotStepView(tokens=self.token.cpu().numpy(),
                            stopped=st.stopped.cpu().numpy(),
                            stop_step=st.stop_step.cpu().numpy(),
                            n_scores=st.n_scores.cpu().numpy(),
                            smoothed=st.smoothed.cpu().numpy())
