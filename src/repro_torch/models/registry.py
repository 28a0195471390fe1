"""Model registry: one uniform API over the ported families.

``build(cfg)`` returns a ``Model`` whose functions mirror the JAX
package's:

    init(generator, device, dtype=None) -> params
    abstract_params(dtype=None) -> the parameter tree on the meta device
    forward(cfg, params, batch) -> (logits, hidden, aux)   # teacher forced
    loss(params, batch) -> (loss, {"xent", "aux"})
    text_len(shape) / make_batch(generator, shape, device) -> batches
    prefill(cfg, params, batch, cache_len) -> (state, last_hidden, hidden)
    decode_step(cfg, params, token, state, pos) -> (logits, hidden, state)
    init_decode_state(batch, cache_len, device) -> dense KV state (the
        recurrent O(1) state for RWKV6, ``cache_len`` unused)
    init_paged_state(batch, num_blocks, block_size, max_blocks, device)
    prefill_chunk(cfg, params, tokens, state, rows, pos_start, chunk_len,
                  block_rows=None) -> state
    prefill_packed(cfg, params, tokens, state, seg, slots, starts,
                   lengths, block_rows=None) -> state
    verify_packed(cfg, params, tokens, state, seg, slots, starts, lengths,
                  block_rows=None) -> (logits, hidden, state)
    draft(cfg, params, state, token, pos, k) -> (B, k - 1) drafts
    verify_tree(cfg, params, tokens, state, seg, slots, starts, lengths,
                depths, ancestors, block_rows=None) -> (logits, hidden,
                                                        ks, vs)
    commit_kv(cfg, state, ks, vs, slots, seg, positions, valid,
              block_rows=None) -> state
    draft_tree(cfg, params, state, token, pos, width, depth)
        -> (B, width, depth) drafts

Every family of the JAX package is ported: the dense family, the MoE
family (the dense model with ``moe.moe_dense`` as its MLP), the VLM (the
dense model with a patch projector in front of its prefill), RWKV6
(``ssm``), hymba (``hybrid``: attention and Mamba heads, a sliding-window
ring) and whisper (``audio``: encoder-decoder over stub frames).  RWKV6,
hymba and whisper have no page layout, no chunked or packed prefill and
no speculative decode, linear or tree, as in the JAX package: the serving
layer falls back to a dense state, admission-time prefill and one-token
decode for them.  Every family trains: ``forward`` runs with grad and
reaches no kernel (the kernels refuse inputs that require grad).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import InputShape, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import hymba, rwkv6, transformer, whisper
from repro_torch.models.common import (cdtype, init_params, param_shapes,
                                       softmax_xent, torch_dtype)

# contexts up to this length decode with the native full cache; the
# sliding-window variant is only the documented long-context carve-out
# (JAX's registry; ``roofline.analytic`` reads it)
NATIVE_DECODE_MAX = 131_072


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    decls: Any
    prefill: Callable
    decode_step: Callable
    init_decode_state: Callable
    # paged-KV serving: (batch, num_blocks, block_size, max_blocks, device)
    # -> page pools + a per-row "block_tables" array
    init_paged_state: Optional[Callable] = None
    # chunked prefill: (cfg, params, tokens (Bc, C), state, rows (Bc,),
    # pos_start, chunk_len, block_rows=None) -> state, C prompt tokens of
    # each request resumed at its prefill progress
    prefill_chunk: Optional[Callable] = None
    # PACKED chunked prefill: (cfg, params, tokens (C,), state, seg (C,),
    # slots (R,), starts (R,), lengths (R,), block_rows=None) -> state, one
    # chunk carrying tokens of up to R requests, block-diagonally isolated;
    # the single-segment call IS the unpacked chunk, so the unified serving
    # step runs every chunk through it
    prefill_packed: Optional[Callable] = None
    # speculative decode, the VERIFY pass: ``prefill_packed`` with the LM
    # head kept -> (logits (C, vocab), hidden (C, d), state); position j of
    # each segment scores the next token after consuming draft token j
    verify_packed: Optional[Callable] = None
    # draft source for speculative decode: (cfg, params, state, token (B,),
    # pos (B,), k) -> (B, k - 1) int32 proposed continuations
    draft: Optional[Callable] = None
    # TREE speculative verify: the packed verify pass over a candidate
    # token tree -> (logits (C, vocab), hidden (C, d), ks, vs); the cache
    # write is DEFERRED (same-depth siblings share a position), the engine
    # commits only the accepted root-to-leaf path through ``commit_kv``
    verify_tree: Optional[Callable] = None
    # lands a deferred verify chunk's K/V where ``valid`` (the accepted
    # path): (cfg, state, ks, vs, slots, seg, positions (C,), valid (C,),
    # block_rows=None) -> state
    commit_kv: Optional[Callable] = None
    # tree draft source, the device-side fallback where the shared draft
    # cache misses: (cfg, params, state, token (B,), pos (B,), width,
    # depth) -> (B, width, depth) int32
    draft_tree: Optional[Callable] = None
    # True when ``draft`` is the degenerate repeat-last-token self-draft:
    # the signal for the serving layer to put the fleet-wide shared draft
    # cache in front of it
    self_draft: bool = False
    # the training forward: (cfg, params, batch) -> (logits, hidden, aux),
    # with grad, through no kernel
    forward: Optional[Callable] = None

    @property
    def supports_paged(self) -> bool:
        return self.init_paged_state is not None

    @property
    def supports_chunked(self) -> bool:
        return (self.prefill_chunk is not None
                and self.prefill_packed is not None)

    @property
    def supports_spec(self) -> bool:
        return (self.verify_packed is not None and self.draft is not None
                and self.supports_chunked)

    @property
    def supports_tree(self) -> bool:
        return (self.verify_tree is not None and self.draft_tree is not None
                and self.commit_kv is not None and self.supports_spec)

    def _store(self, dtype) -> torch.dtype:
        if dtype is None:
            return cdtype(self.cfg)
        return torch_dtype(dtype) if isinstance(dtype, str) else dtype

    def init(self, generator: Optional[torch.Generator] = None,
             device=None, dtype=None):
        """Random parameters on ``device`` (None: CUDA), drawn from
        ``generator`` (on a device other than the CPU, from a generator
        there that one draw from ``generator`` seeds; ``init_params``).
        Stored in ``dtype``: None is the compute dtype (what serving
        keeps; the leaves declared float32 stay float32), "float32" the
        trainer's float32 masters."""
        return init_params(self.decls, generator, self._store(dtype),
                           resolve_device(device))

    def abstract_params(self, dtype=None):
        """The tree ``init`` gives, as meta tensors (shapes and dtypes)."""
        return param_shapes(self.decls, self._store(dtype))

    def loss(self, params, batch):
        """Teacher-forced next-token loss (JAX's ``Model.loss``): the
        logits of the last ``targets.shape[1]`` positions, the vocab
        padding masked to -1e30, ``softmax_xent`` (with ``batch["mask"]``
        if given) plus the forward's aux.  Returns (loss, {"xent",
        "aux"})."""
        logits, _, aux = self.forward(self.cfg, params, batch)
        targets = batch["targets"]
        logits = logits[:, -targets.shape[1]:]
        vpad, v = self.cfg.padded_vocab(), self.cfg.vocab_size
        if vpad != v:
            pad = torch.arange(vpad, device=logits.device) >= v
            logits = logits.masked_fill(pad, -1e30)
        xent = softmax_xent(logits, targets, batch.get("mask"))
        return xent + aux, {"xent": xent, "aux": aux}

    def text_len(self, shape: InputShape) -> int:
        """Tokens fed as text so the model's whole sequence is
        ``shape.seq_len`` (a VLM's patches and meta tokens take the
        rest)."""
        s = shape.seq_len
        if self.cfg.arch_type == "vlm":
            s -= self.cfg.frontend.n_tokens
        if self.cfg.n_meta_tokens:
            s -= self.cfg.n_meta_tokens
        return max(s, 8)

    def make_batch(self, generator: Optional[torch.Generator],
                   shape: InputShape, device=None):
        """A random batch of ``shape`` drawn on the CPU from
        ``generator`` and moved to ``device`` (None: CUDA): "tokens" (and
        for a train shape "targets") (B, text_len) int32, a VLM's
        "patch_embeds", an audio model's "frames", normal in the compute
        dtype; a decode shape "token" (B,) and "pos" (JAX's
        ``make_batch``, another generator)."""
        cfg, dev = self.cfg, resolve_device(device)
        B = shape.global_batch

        def toks(shp):
            return torch.randint(0, cfg.vocab_size, shp, generator=generator,
                                 dtype=torch.int32).to(dev)

        def dense(shp):
            return torch.randn(shp, generator=generator).to(
                device=dev, dtype=cdtype(cfg))

        if shape.kind == "decode":
            return {"token": toks((B,)),
                    "pos": torch.tensor(shape.seq_len - 1,
                                        dtype=torch.int32, device=dev)}
        st = self.text_len(shape)
        out = {"tokens": toks((B, st))}
        if shape.kind == "train":
            out["targets"] = toks((B, st))
        if cfg.arch_type == "vlm":
            out["patch_embeds"] = dense(
                (B, cfg.frontend.n_tokens, cfg.frontend.embed_dim))
        if cfg.arch_type == "audio":
            out["frames"] = dense((B, cfg.frontend.n_tokens, cfg.d_model))
        return out


def _build_dense(cfg: ModelConfig) -> Model:
    def init_decode_state(batch: int, cache_len: int, device=None):
        return attn.init_cache(cfg, batch, cache_len, device=device)

    def init_paged_state(batch: int, num_blocks: int, block_size: int,
                         max_blocks: int, device=None):
        pages = attn.init_paged_cache(cfg, num_blocks, block_size,
                                      device=device)
        bt = torch.zeros((batch, max_blocks), dtype=torch.int32,
                         device=pages["k"].device)                  # -> NULL page
        return dict(pages, block_tables=bt)

    return Model(cfg=cfg, decls=transformer.decls(cfg),
                 forward=transformer.forward, prefill=transformer.prefill,
                 decode_step=transformer.decode_step,
                 init_decode_state=init_decode_state,
                 init_paged_state=init_paged_state,
                 prefill_chunk=transformer.prefill_chunk,
                 prefill_packed=transformer.prefill_packed_chunk,
                 verify_packed=transformer.verify_packed_chunk,
                 draft=transformer.draft_tokens,
                 verify_tree=transformer.verify_packed_tree,
                 commit_kv=transformer.commit_packed_kv,
                 draft_tree=transformer.draft_tree_tokens, self_draft=True)


def _build_rwkv(cfg: ModelConfig) -> Model:
    def init_decode_state(batch: int, cache_len: int, device=None):
        return rwkv6.init_state(cfg, batch, device=resolve_device(device))

    return Model(cfg=cfg, decls=rwkv6.decls(cfg), forward=rwkv6.forward,
                 prefill=rwkv6.prefill,
                 decode_step=rwkv6.decode_step,
                 init_decode_state=init_decode_state)


def _build_family(cfg: ModelConfig, module) -> Model:
    """hymba or whisper: the module's decls, forward, prefill, decode step
    and decode state (``module.init_state(cfg, batch, cache_len,
    device)``)."""
    def init_decode_state(batch: int, cache_len: int, device=None):
        return module.init_state(cfg, batch, cache_len,
                                 device=resolve_device(device))

    return Model(cfg=cfg, decls=module.decls(cfg), forward=module.forward,
                 prefill=module.prefill,
                 decode_step=module.decode_step,
                 init_decode_state=init_decode_state)


_BUILDERS = {"dense": _build_dense, "moe": _build_dense, "vlm": _build_dense,
             "ssm": _build_rwkv,
             "hybrid": lambda cfg: _build_family(cfg, hymba),
             "audio": lambda cfg: _build_family(cfg, whisper)}


def build(cfg: ModelConfig) -> Model:
    if cfg.arch_type not in _BUILDERS:
        raise ValueError(f"{cfg.name}: unknown arch_type {cfg.arch_type!r}")
    return _BUILDERS[cfg.arch_type](cfg)
