"""Model registry: one uniform API over the ported families.

``build(cfg)`` returns a ``Model`` whose functions mirror the JAX
package's:

    init(generator, device) -> params
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
decode for them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import hymba, rwkv6, transformer, whisper
from repro_torch.models.common import cdtype, init_params


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

    def init(self, generator: Optional[torch.Generator] = None,
             device=None):
        """Random parameters in the compute dtype (the leaves declared
        float32 stay float32) on ``device`` (None: CUDA), drawn from
        ``generator`` (on a device other than the CPU, from a generator
        there that one draw from ``generator`` seeds; ``init_params``)."""
        return init_params(self.decls, generator, cdtype(self.cfg),
                           resolve_device(device))


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
                 prefill=transformer.prefill,
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

    return Model(cfg=cfg, decls=rwkv6.decls(cfg), prefill=rwkv6.prefill,
                 decode_step=rwkv6.decode_step,
                 init_decode_state=init_decode_state)


def _build_family(cfg: ModelConfig, module) -> Model:
    """hymba or whisper: the module's decls, prefill, decode step and
    decode state (``module.init_state(cfg, batch, cache_len, device)``)."""
    def init_decode_state(batch: int, cache_len: int, device=None):
        return module.init_state(cfg, batch, cache_len,
                                 device=resolve_device(device))

    return Model(cfg=cfg, decls=module.decls(cfg), prefill=module.prefill,
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
