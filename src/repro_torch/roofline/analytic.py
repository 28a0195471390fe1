"""Analytic FLOP / byte models per (architecture x input shape): the JAX
package's ``repro/roofline/analytic.py`` arithmetic, copied.

MODEL_FLOPS convention: train 6*N*D, prefill 2*N*D, decode 2*N_active per
token; N excludes embeddings, D = tokens processed.  The trainer reports
its model FLOP/s against ``constants.PEAK_FLOPS_BF16``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import InputShape, ModelConfig


def _block_params(cfg: ModelConfig) -> Dict[str, float]:
    d = cfg.d_model
    attn = d * cfg.attn_out_dim + 2 * d * cfg.kv_out_dim + cfg.attn_out_dim * d
    ffn_one = (3 if cfg.mlp == "swiglu" else 2) * d * cfg.d_ff
    out = {"attn": attn, "ffn_one": ffn_one}
    if cfg.arch_type == "ssm":
        di = d
        out["attn"] = 6 * d * d          # r,k,v,g,w(out) projections
    if cfg.arch_type == "hybrid" and cfg.ssm is not None:
        di = cfg.ssm.expand * d
        out["mamba"] = 2 * d * di + di * d + di * (cfg.ssm.state_dim * 2)
    return out


def non_embedding_params(cfg: ModelConfig, active: bool = False) -> float:
    bp = _block_params(cfg)
    ffn = bp["ffn_one"]
    if cfg.moe is not None:
        ffn = ffn * (cfg.moe.top_k if active else cfg.moe.n_experts)
    block = bp["attn"] + ffn + bp.get("mamba", 0.0)
    n = cfg.n_layers * block
    if cfg.is_encoder_decoder:
        n += cfg.n_encoder_layers * (bp["attn"] + bp["ffn_one"])
        n += cfg.n_layers * bp["attn"]          # cross attention
    return float(n)


def attention_context(cfg: ModelConfig, shape: InputShape) -> float:
    """Effective attended length per query token."""
    s = shape.seq_len
    if shape.kind == "decode":
        if cfg.arch_type == "ssm":
            return 0.0
        if cfg.arch_type == "hybrid":
            return float(cfg.sliding_window or s)
        from repro_torch.models.registry import NATIVE_DECODE_MAX
        if cfg.long_context_variant == "sliding" and s > NATIVE_DECODE_MAX:
            return float(cfg.long_context_window)
        return float(s)
    # train / prefill: causal average s/2, or window
    w = cfg.sliding_window
    return float(min(w, s) if w else s / 2)


@dataclasses.dataclass
class FlopBytes:
    flops: float
    bytes: float
    model_flops: float


def estimate(cfg: ModelConfig, shape: InputShape) -> FlopBytes:
    n_full = non_embedding_params(cfg)
    n_act = non_embedding_params(cfg, active=True)
    b = shape.global_batch
    s = shape.seq_len
    ctx = attention_context(cfg, shape)
    hd = cfg.attn_out_dim
    wbytes_train = 4        # f32 master weights
    wbytes_serve = 2        # bf16

    if shape.kind == "train":
        tokens = b * s
        mm = 6.0 * n_act * tokens
        attn = 6.0 * 2.0 * cfg.n_layers * b * s * ctx * hd
        flops = mm + attn
        # fwd+bwd read params, optimizer rw (m, v, p in f32)
        n_store = non_embedding_params(cfg)     # all experts stored
        bytes_ = (3 * n_store * wbytes_train            # fwd/bwd/update reads
                  + 3 * n_store * 4 * 2                 # adam m,v + param rw
                  + tokens * cfg.d_model * 4 * 2 * cfg.n_layers * 0.25)  # remat acts
        return FlopBytes(flops, bytes_, 6.0 * n_act * tokens)
    if shape.kind == "prefill":
        tokens = b * s
        mm = 2.0 * n_act * tokens
        attn = 2.0 * 2.0 * cfg.n_layers * b * s * ctx * hd
        flops = mm + attn
        cache = 2 * cfg.n_layers * b * cfg.kv_out_dim * s * \
            (1 if cfg.kv_cache_dtype == "int8" else 2)
        bytes_ = n_full * wbytes_serve + tokens * cfg.d_model * 2 * 4 + cache
        return FlopBytes(flops, bytes_, 2.0 * n_act * tokens)
    # decode: one token for the whole batch
    mm = 2.0 * n_act * b
    attn = 2.0 * 2.0 * cfg.n_layers * b * ctx * hd
    flops = mm + attn
    cache_entry = (1 if cfg.kv_cache_dtype == "int8" else 2)
    cache_read = 2 * cfg.n_layers * b * cfg.kv_out_dim * ctx * cache_entry
    state_bytes = 0.0
    if cfg.arch_type == "ssm":
        state_bytes = cfg.n_layers * b * cfg.n_heads * cfg.ssm.head_dim ** 2 * 4 * 2
    if cfg.arch_type == "hybrid" and cfg.ssm is not None:
        di = cfg.ssm.expand * cfg.d_model
        state_bytes = cfg.n_layers * b * di * cfg.ssm.state_dim * 4 * 2
    bytes_ = n_act * wbytes_serve + cache_read + state_bytes
    return FlopBytes(flops, bytes_, 2.0 * n_act * b)
