"""Decoder-only transformer, dense, MoE and VLM families (PyTorch).

Parameters are the JAX package's nested dict with its names and layouts:
``embed`` (V_pad, d), ``final_norm``, ``layers`` with every per-layer leaf
stacked on a leading L axis (``layers.attn.wq`` is (L, d, H*dh)), and
``lm_head`` (d, V_pad) when embeddings are untied.  The layer loop is a
Python loop indexing layer ``l`` of each stacked leaf.  An MoE config
(``cfg.moe``) takes ``moe.moe_decls`` for ``layers.mlp`` and routes every
token of every pass (prefill, decode, the chunks and the verify passes)
through ``moe.moe_dense``, JAX's one-device path.  The VLM
(``arch_type == "vlm"``) adds ``projector``: a two-layer gelu MLP over
precomputed patch embeddings (the vision tower is a stub), whose output
``prefill`` puts in front of the embedded prompt; after that the patch
prefix is cache like any other, and decode, the chunks and the verify
passes are the dense model's.

``forward`` is the training forward (JAX's ``forward``): the whole
sequence, teacher forced, with grad, its attention through
``attention.attn_prefill_einsum`` (plain PyTorch: no kernel has a
backward) and an MoE config's aux loss summed over the layers.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models.common import (Param, apply_norm, apply_rope, cdtype,
                                       gelu, norm_decls, stack_decls, swiglu)


# ---------------------------------------------------------------------------
# Declarations

def _attn_decls(cfg) -> Dict[str, Param]:
    d, qo, kvo = cfg.d_model, cfg.attn_out_dim, cfg.kv_out_dim
    out = {"wq": Param((d, qo)), "wk": Param((d, kvo)),
           "wv": Param((d, kvo)), "wo": Param((qo, d))}
    if cfg.qkv_bias:
        out["bq"] = Param((qo,), "zeros")
        out["bk"] = Param((kvo,), "zeros")
        out["bv"] = Param((kvo,), "zeros")
    return out


def _mlp_decls(cfg) -> Dict[str, Param]:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": Param((d, f)), "w_up": Param((d, f)),
            "w_down": Param((f, d))}


def decls(cfg) -> Dict[str, Any]:
    if cfg.mlp != "swiglu" or cfg.arch_type not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: the decoder-only transformer takes the dense, MoE "
            "and VLM swiglu families; rwkv6, hymba and whisper have modules "
            "of their own (models/registry.py)")
    mlp = moe.moe_decls(cfg) if cfg.moe is not None else _mlp_decls(cfg)
    tree: Dict[str, Any] = {
        "embed": Param((cfg.padded_vocab(), cfg.d_model), "embed"),
        "final_norm": norm_decls(cfg),
        "layers": stack_decls({"ln1": norm_decls(cfg), "ln2": norm_decls(cfg),
                               "attn": _attn_decls(cfg), "mlp": mlp},
                              cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = Param((cfg.d_model, cfg.padded_vocab()))
    if cfg.arch_type == "vlm":
        d = cfg.d_model
        tree["projector"] = {"w1": Param((cfg.frontend.embed_dim, d)),
                             "b1": Param((d,), "zeros"),
                             "w2": Param((d, d)), "b2": Param((d,), "zeros")}
    if cfg.n_meta_tokens:
        tree["meta_tokens"] = Param((cfg.n_meta_tokens, cfg.d_model),
                                    "embed")
    return tree


def layer_params(params, l: int):
    """Layer ``l``'s slice of every stacked leaf."""
    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        return tree[l]
    return take(params["layers"])


def unstacked_layers(layers, n: int):
    """Every layer's slice of the stacked leaves of ``layers``, for the
    training forward: one ``unbind`` a leaf, whose backward stacks the
    layers' gradients once (indexing each layer instead would build a
    zero-filled gradient of the whole stack per layer and add them)."""
    def split(tree):
        if isinstance(tree, dict):
            return {k: split(v) for k, v in tree.items()}
        return torch.unbind(tree, 0)

    def pick(tree, l):
        if isinstance(tree, dict):
            return {k: pick(v, l) for k, v in tree.items()}
        return tree[l]
    parts = split(layers)
    return [pick(parts, l) for l in range(n)]


# ---------------------------------------------------------------------------
# Blocks

def mlp_apply(cfg, p, x):
    """The MLP of a (B, S, d) block: the experts of an MoE config, else
    the swiglu."""
    if cfg.moe is not None:
        return moe.moe_dense(p, x, cfg)
    dt = x.dtype
    h = swiglu(x @ p["w_gate"].to(dt), x @ p["w_up"].to(dt))
    return h @ p["w_down"].to(dt)


def _qkv(cfg, p, x):
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def _attn_block(cfg, p, x, positions):
    """ln1 + the q/k/v projections + rope of a (B, S, d) block:
    q (B,S,H,dh), k/v (B,S,KV,dh)."""
    b, s, _ = x.shape
    h = apply_norm(cfg, p["ln1"], x)
    q, k, v = _qkv(cfg, p["attn"], h)
    q = q.reshape(b, s, cfg.n_heads, cfg.d_head)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)
    return q, k, v


def _finish_block(cfg, p, x, o):
    """wo, the residual, ln2 and the MLP after attention output o."""
    b, s = x.shape[:2]
    x = x + o.reshape(b, s, cfg.attn_out_dim) @ p["attn"]["wo"].to(x.dtype)
    return x + mlp_apply(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))


def layer_prefill(cfg, p, x, positions, window: Optional[int]):
    """x (B,S,d) -> (x', (k, v)) with k/v (B, KV, S, dh) for the cache."""
    q, k, v = _attn_block(cfg, p, x, positions)
    o = attn.attn_prefill(q, k, v, causal=True, window=window)
    return _finish_block(cfg, p, x, o), (k.transpose(1, 2), v.transpose(1, 2))


def layer_decode(cfg, p, x, cache_l, pos, valid, block_tables=None):
    """x (B,d); cache_l per-layer (B,KV,S,dh) READ-ONLY — or, with
    ``block_tables`` (B,nb), per-layer pages (P,KV,bs,dh) read through the
    table; pos (B,) absolute positions; valid masks readable cache entries
    (the current token attends via extra_kv and is written after the
    layer loop)."""
    b, d = x.shape
    h = apply_norm(cfg, p["ln1"], x[:, None, :])[:, 0]
    q, k, v = _qkv(cfg, p["attn"], h)
    q = q.reshape(b, cfg.n_heads, cfg.d_head)
    k = k.reshape(b, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(b, cfg.n_kv_heads, cfg.d_head)
    q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta,
                   cfg.rotary_pct)[:, 0]
    k = apply_rope(k[:, None], pos[:, None], cfg.rope_theta,
                   cfg.rotary_pct)[:, 0]
    if block_tables is not None:
        o = attn.attn_decode_paged(q, cache_l, block_tables, valid, x.dtype,
                                   extra_kv=(k, v))
    else:
        o = attn.attn_decode(q, cache_l, valid, x.dtype, extra_kv=(k, v))
    o = o.reshape(b, cfg.attn_out_dim) @ p["attn"]["wo"].to(x.dtype)
    x = x + o
    h = apply_norm(cfg, p["ln2"], x[:, None, :])
    return x + mlp_apply(cfg, p["mlp"], h)[:, 0], (k, v)


# ---------------------------------------------------------------------------
# Embedding / logits

def embed_tokens(cfg, params, tokens):
    return params["embed"].to(cdtype(cfg))[tokens.long()]


def logits_from_hidden(cfg, params, h):
    if cfg.tie_embeddings:
        return h @ params["embed"].to(h.dtype).T
    return h @ params["lm_head"].to(h.dtype)


def project_patches(cfg, params, patch_embeds):
    """Patch embeddings (B, P, embed_dim) -> the patch prefix (B, P, d),
    JAX's order of precision: cast to the compute dtype, w1 + b1, gelu,
    w2 + b2."""
    p = params["projector"]
    dt = cdtype(cfg)
    h = gelu(patch_embeds.to(dt) @ p["w1"].to(dt) + p["b1"].to(dt))
    return h @ p["w2"].to(dt) + p["b2"].to(dt)


# ---------------------------------------------------------------------------
# Full passes

def layer_forward(cfg, p, x, positions, window: Optional[int]):
    """One layer of the training forward, JAX's ``layer_prefill`` without
    the cache: attention through ``attn_prefill_einsum``; returns (x',
    aux), aux the MoE router's loss or None."""
    q, k, v = _attn_block(cfg, p, x, positions)
    o = attn.attn_prefill_einsum(q, k, v, causal=True, window=window)
    b, s = x.shape[:2]
    x = x + o.reshape(b, s, cfg.attn_out_dim) @ p["attn"]["wo"].to(x.dtype)
    h = apply_norm(cfg, p["ln2"], x)
    if cfg.moe is not None:
        m, aux = moe.moe_block(p["mlp"], h, cfg)
        return x + m, aux
    return x + mlp_apply(cfg, p["mlp"], h), None


def forward(cfg, params, batch):
    """Training forward over whole sequences.  Returns (logits, hidden,
    aux): aux the sum of the layers' MoE router losses (0. without
    experts).  batch: {"tokens": (B, S_text)} + a VLM's "patch_embeds"
    (B, P, embed_dim), projected in front of the text, as are a config's
    meta tokens; attention is causal over the whole sequence, windowed by
    ``cfg.sliding_window``."""
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    prefix = []
    if cfg.arch_type == "vlm":
        prefix.append(project_patches(cfg, params, batch["patch_embeds"]))
    if cfg.n_meta_tokens:
        meta = params["meta_tokens"].to(x.dtype)
        prefix.append(meta.expand(x.shape[0], *meta.shape))
    if prefix:
        x = torch.cat(prefix + [x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in unstacked_layers(params["layers"], cfg.n_layers):
        x, a = layer_forward(cfg, p, x, positions, cfg.sliding_window)
        if a is not None:
            aux = aux + a
    h = apply_norm(cfg, params["final_norm"], x)
    return logits_from_hidden(cfg, params, h), h, aux


@torch.no_grad()
def prefill(cfg, params, batch, cache_len: int):
    """Run the prompt, build the KV cache. Returns (cache, last_hidden,
    h_all).  A VLM batch with ``patch_embeds`` prefills the projected
    patches in front of the prompt: the cache then holds prefix and
    prompt, and h_all covers both."""
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    if cfg.arch_type == "vlm" and "patch_embeds" in batch:
        x = torch.cat([project_patches(cfg, params, batch["patch_embeds"]),
                       x], 1)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    cache = attn.init_cache(cfg, b, cache_len, device=x.device)
    for l in range(cfg.n_layers):
        x, (k, v) = layer_prefill(cfg, layer_params(params, l), x, positions,
                                  cfg.sliding_window)
        # each layer's K/V (B, KV, S, dh) into the cache as it comes, int8
        # quantised per (position, head): no stack of every layer's K/V in
        # float32 (5 GB for qwen1.5-32b's harvest of 8 x 160 tokens)
        for key, val in attn.kv_leaves(k, v, cache).items():
            cache[key][l, :, :, :s] = val
    h = apply_norm(cfg, params["final_norm"], x)
    return cache, h[:, -1], h


@torch.no_grad()
def decode_step(cfg, params, token, cache, pos, *,
                write_mask: Optional[torch.Tensor] = None):
    """One-token decode. token (B,); pos (B,) int32 per-row absolute
    positions (or a scalar shared by the batch).

    A cache carrying ``block_tables`` is PAGED: per-layer leaves are page
    pools (P,KV,bs,dh) read through each row's table with K2, and the
    new token's K/V lands through the table.  Otherwise the dense cache is
    written at ``pos``; ``write_mask`` (B,) bool drops the dense write of
    False rows (parked, mid-prefill slots of the chunked serving engine,
    whose lanes hold chunk-written prompt K/V a no-op decode write must not
    clobber); paged rows ignore it, their parked writes land in the NULL
    page.  The cache is updated IN PLACE; returns (logits, hidden,
    cache)."""
    b = token.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32,
                          device=token.device).expand(b).contiguous()
    x = embed_tokens(cfg, params, token)
    paged = "block_tables" in cache
    if paged:
        bt = cache["block_tables"]
        pages = {k: v for k, v in cache.items() if k != "block_tables"}
        valid = attn.paged_valid_mask(pos, b, bt.shape[1]
                                      * pages["k"].shape[3])
    else:
        pages, bt = cache, None
        s_cache = cache["k"].shape[3]
        slot, valid = attn.decode_valid_mask(pos, b, s_cache)
        if write_mask is not None:
            # masked rows route their write out of range: dropped
            slot = torch.where(write_mask, slot,
                               torch.full_like(slot, s_cache))
    ks, vs = [], []
    for l in range(cfg.n_layers):
        cache_l = {key: val[l] for key, val in pages.items()}
        x, (k, v) = layer_decode(cfg, layer_params(params, l), x, cache_l,
                                 pos, valid, block_tables=bt)
        ks.append(k)
        vs.append(v)
    ks, vs = torch.stack(ks), torch.stack(vs)
    if paged:
        attn.cache_write_paged(pages, ks, vs, bt, pos)
    else:
        attn.cache_write_stacked(cache, ks, vs, slot)
    h = apply_norm(cfg, params["final_norm"], x[:, None, :])[:, 0]
    return logits_from_hidden(cfg, params, h), h, cache


# ---------------------------------------------------------------------------
# Chunked and packed prefill

def layer_prefill_chunk(cfg, p, x, cache_l, rows, block_rows, positions,
                        valid):
    """One layer of chunked prefill: x (Bc, C, d) at absolute ``positions``
    (Bc, C); the chunk attends readable cache entries (``valid``) plus
    causally within itself.  Returns (x', (k, v)) with k/v (Bc, KV, C, dh)
    for the cache write after the layer loop."""
    q, k, v = _attn_block(cfg, p, x, positions)
    o = attn.attn_prefill_chunk(q, k, v, cache_l, valid, x.dtype, rows=rows,
                                block_tables=block_rows)
    return _finish_block(cfg, p, x, o), (k.transpose(1, 2), v.transpose(1, 2))


@torch.no_grad()
def prefill_chunk(cfg, params, tokens, state, rows, pos_start: int,
                  chunk_len: int, block_rows=None):
    """Chunked prefill: run C prompt tokens of each request through the
    stack and write their K/V into the request's resident cache, resuming
    at ``pos_start`` (the request's ``prefill_progress``).

    tokens (Bc, C) int32, zero-padded past ``chunk_len``; rows (Bc,) batch
    rows of ``state`` (a dense stacked cache — or, when the state carries
    ``block_tables``, the paged pool written through ``block_rows``
    (Bc, nb), the requests' physical pages).  ``pos_start`` and
    ``chunk_len`` are host ints.  Queries attend [0, pos_start) plus
    causally within the chunk; padded positions have their K/V writes
    dropped (dense) or routed to the NULL page (paged).  The state is
    updated IN PLACE and returned."""
    bc, c = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    positions = (torch.arange(c, device=x.device) + pos_start).expand(bc, c)
    paged = "block_tables" in state
    if paged:
        assert block_rows is not None, "paged prefill_chunk needs block rows"
        pools = {k: v for k, v in state.items() if k != "block_tables"}
        block_rows = block_rows.to(torch.int32).contiguous()
        n_virtual = block_rows.shape[1] * pools["k"].shape[3]
    else:
        pools = state
        n_virtual = state["k"].shape[3]
    valid = (torch.arange(n_virtual, device=x.device)[None, :]
             < pos_start).expand(bc, n_virtual).contiguous()
    ks, vs = [], []
    for l in range(cfg.n_layers):
        cache_l = {key: val[l] for key, val in pools.items()}
        x, (k, v) = layer_prefill_chunk(cfg, layer_params(params, l), x,
                                        cache_l, rows, block_rows, positions,
                                        valid)
        ks.append(k)
        vs.append(v)
    ks, vs = torch.stack(ks), torch.stack(vs)     # (L, Bc, KV, C, dh)
    if paged:
        attn.cache_write_chunk_paged(pools, ks, vs, block_rows, pos_start,
                                     chunk_len)
    else:
        attn.cache_write_chunk(state, ks, vs, rows, pos_start, chunk_len)
    return state


def layer_prefill_packed(cfg, p, x, cache_l, rows, seg_tables, positions,
                         seg, seg_starts, chunk_mask):
    """One layer of PACKED chunked prefill: x (1, C, d) holds C tokens of
    up to R requests at per-token absolute ``positions`` (C,); each token
    attends its own request's readable cache prefix plus its own segment's
    preceding chunk tokens (``chunk_mask``).  Returns (x', (k, v)) with
    k/v (KV, C, dh) for the per-token cache write after the layer loop."""
    q, k, v = _attn_block(cfg, p, x, positions[None])
    o = attn.attn_prefill_packed(q[0], k[0], v[0], cache_l, seg, seg_starts,
                                 chunk_mask, x.dtype, rows=rows,
                                 seg_tables=seg_tables)
    return _finish_block(cfg, p, x, o[None]), (k[0].transpose(0, 1),
                                              v[0].transpose(0, 1))


def _packed_chunk_core(cfg, params, tokens, state, seg, slots, starts,
                       lengths, block_rows=None, *, depths=None,
                       ancestors=None, write: bool = True):
    """Run one fused C-token packed chunk through the stack and (``write``)
    scatter each token's K/V into its own request's resident cache, in
    place.  Returns ``(state, x, ks, vs)`` with x (1, C, d) the post-stack
    activations and ks/vs (L, KV, C, dh) the chunk's own K/V.

    A segment is a causal CHAIN at positions starts[r] + 0..len-1 (a
    prompt chunk, a linear verify block).  ``depths``/``ancestors`` (C,)
    make it a candidate TREE (tree verify): a token's position becomes
    starts[seg] + depths and the chunk mask follows the ancestor closure.
    ``write=False`` leaves the cache untouched (same-depth siblings share
    a position, so only the accepted path may land, through
    ``commit_packed_kv``); chunk tokens never read the cache for each
    other, so the forward does not depend on the write."""
    c = tokens.shape[0]
    seg = seg.to(torch.int32)
    segl = seg.long()
    offsets = torch.cumsum(lengths, 0) - lengths         # exclusive prefix
    off = torch.arange(c, device=tokens.device) - offsets[segl]
    valid_tok = (off >= 0) & (off < lengths[segl])
    positions = starts[segl] + (off if depths is None else depths)   # (C,)
    rows = slots[segl]                                   # (C,)
    chunk_mask = attn.packed_chunk_mask(seg, valid_tok, ancestors)
    x = embed_tokens(cfg, params, tokens[None])          # (1, C, d)
    paged = "block_tables" in state
    if paged:
        assert block_rows is not None, "paged packed prefill needs block rows"
        pools = {k: v for k, v in state.items() if k != "block_tables"}
        seg_tables = block_rows.to(torch.int32).contiguous()   # (R, nb)
    else:
        pools = state
        seg_tables = None
    ks, vs = [], []
    for l in range(cfg.n_layers):
        cache_l = {key: val[l] for key, val in pools.items()}
        x, (k, v) = layer_prefill_packed(cfg, layer_params(params, l), x,
                                         cache_l, rows, seg_tables,
                                         positions, seg, starts, chunk_mask)
        ks.append(k)
        vs.append(v)
    ks, vs = torch.stack(ks), torch.stack(vs)           # (L, KV, C, dh)
    if write:
        commit_packed_kv(cfg, state, ks, vs, slots, seg, positions,
                         valid_tok, block_rows)
    return state, x, ks, vs


@torch.no_grad()
def prefill_packed_chunk(cfg, params, tokens, state, seg, slots, starts,
                         lengths, block_rows=None):
    """PACKED chunked prefill: run one fused C-token chunk carrying prompt
    tokens of up to R requests through the stack and scatter each token's
    K/V into ITS OWN request's resident cache, in place.

    tokens (C,) int32, segments laid out contiguously in request order and
    zero-padded at the tail; seg (C,) int32 segment id per token; slots
    (R,) batch rows; starts (R,) each segment's prefill progress (its
    readable cache prefix AND the position of its first chunk token);
    lengths (R,) tokens each segment contributes (0 = unused segment).
    Dense states scatter through per-token (lane, position); a state
    carrying ``block_tables`` writes through ``block_rows`` (R, nb), each
    segment's reserved pages.  All of seg/slots/starts/lengths are device
    data, so every packing shape of every prompt length runs the same
    code; the single-segment call IS the unpacked chunk path.  Returns the
    updated state."""
    state, _, _, _ = _packed_chunk_core(cfg, params, tokens, state, seg,
                                        slots, starts, lengths,
                                        block_rows=block_rows)
    return state


@torch.no_grad()
def verify_packed_chunk(cfg, params, tokens, state, seg, slots, starts,
                        lengths, block_rows=None):
    """Speculative VERIFY pass: the packed-chunk forward with the language
    head kept.  Layout and cache semantics are ``prefill_packed_chunk``'s:
    each segment is one request's draft block (current token + proposed
    continuations) at absolute positions starts[r]..starts[r]+L-1,
    attending its own committed cache prefix plus causally within the
    block; the post-stack activations feed final_norm and the LM head, so
    position j of each segment scores the model's next token after
    consuming draft token j.  Rejected positions need no undo: validity
    masks derived from ``pos`` hide them and the next verify block
    overwrites them before ``pos`` reaches them.  The cache is updated IN
    PLACE; returns (logits (C, vocab), hidden (C, d), state)."""
    state, x, _, _ = _packed_chunk_core(cfg, params, tokens, state, seg,
                                        slots, starts, lengths,
                                        block_rows=block_rows)
    h = apply_norm(cfg, params["final_norm"], x)[0]        # (C, d)
    return logits_from_hidden(cfg, params, h), h, state


@torch.no_grad()
def verify_packed_tree(cfg, params, tokens, state, seg, slots, starts,
                       lengths, depths, ancestors, block_rows=None):
    """TREE speculative verify: the packed verify pass where each segment
    carries a candidate token TREE instead of a chain.  The layout is the
    packed chunk's; ``depths`` (C,) places each token at starts[r] +
    depth (same-depth siblings SHARE a position, as the committed sequence
    would) and ``ancestors`` (C,), parent pointers into the chunk (roots
    self-pointing), makes each token attend its own root path.  Position j
    scores the model's next token after consuming node j's root path.

    The cache write is DEFERRED: siblings would race on one (lane,
    position) and a rejected sibling could shadow the accepted token, so
    nothing lands here; the caller commits only the accepted root-to-leaf
    path through ``commit_packed_kv``.  Returns (logits (C, vocab), hidden
    (C, d), ks, vs) with ks/vs (L, KV, C, dh) the chunk's K/V."""
    _, x, ks, vs = _packed_chunk_core(cfg, params, tokens, state, seg,
                                      slots, starts, lengths, block_rows,
                                      depths=depths, ancestors=ancestors,
                                      write=False)
    h = apply_norm(cfg, params["final_norm"], x)[0]        # (C, d)
    return logits_from_hidden(cfg, params, h), h, ks, vs


@torch.no_grad()
def commit_packed_kv(cfg, state, ks, vs, slots, seg, positions, valid,
                     block_rows=None):
    """Land a packed chunk's K/V in the resident caches, in place: chunk
    token t writes its (lane, position) iff ``valid[t]``.  A tree verify
    sets ``valid`` exactly on the accepted root-to-leaf path, one node a
    depth, so no two targets race.  ks/vs (L, KV, C, dh); slots (R,); seg
    (C,); positions (C,) absolute targets; dense lanes or paged pools
    through ``block_rows`` (R, nb), f32, bf16 or int8 (quantised per
    (position, head)).  Returns the state."""
    segl = seg.long()
    if "block_tables" in state:
        assert block_rows is not None, "paged commit needs block rows"
        pools = {k: v for k, v in state.items() if k != "block_tables"}
        attn.cache_write_packed_paged(
            pools, ks, vs, block_rows.to(torch.int32)[segl], positions,
            valid)
        return state
    wpos = torch.where(valid, positions,
                       torch.full_like(positions, state["k"].shape[3]))
    attn.cache_write_packed(state, ks, vs, slots[segl], wpos)
    return state


def draft_tree_tokens(cfg, params, state, token, pos, width: int,
                      depth: int):
    """Default tree self-draft, ``draft_tokens`` lifted to a (width, depth)
    tree: every branch repeats the last committed token.  Reached only
    where the serving layer's shared draft cache misses.  token (B,)
    int32; returns (B, width, depth) int32."""
    return token[:, None, None].expand(token.shape[0], width, depth)


def draft_tokens(cfg, params, state, token, pos, k: int):
    """Default self-draft: propose ``k - 1`` repeats of the last committed
    token (the degenerate n-gram drafter: no extra forward, no extra
    state; acceptance pays for whatever it gets right).  The serving
    layer's shared draft cache overrides it per slot on a hit.  token (B,)
    int32; returns (B, k - 1) int32."""
    return token[:, None].expand(token.shape[0], k - 1)
