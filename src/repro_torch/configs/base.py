"""Config system: model/arch configs, input shapes, and reduced smoke variants.

Every assigned architecture gets one file in this package exporting
``CONFIG``.  ``repro_torch.configs.get_config(name)`` resolves them; reduced smoke
variants for CPU tests come from ``ModelConfig.reduced()``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

ARCH_TYPES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01  # load-balance loss coefficient
    router_z_coef: float = 1e-3   # router z-loss coefficient


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """State-space / RWKV recurrence parameters."""
    state_dim: int = 16        # per-channel state (mamba) / ignored by rwkv
    head_dim: int = 64         # rwkv6 head size
    conv_dim: int = 4          # mamba depthwise conv width
    expand: int = 2            # mamba inner expansion
    dt_rank: int = 0           # 0 -> ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class VisionStubConfig:
    """VLM/audio modality frontend stub: precomputed embeddings only."""
    n_tokens: int = 0          # patch/frame tokens provided by input_specs()
    embed_dim: int = 0         # frontend embedding dim (pre-projector)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str
    source: str                # citation bracket from the assignment table
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    # --- block flavour ---
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    mlp: str = "swiglu"              # swiglu | gelu | relu_sq
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0          # stablelm uses partial rotary
    sliding_window: Optional[int] = None  # static SWA (hymba)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: Optional[VisionStubConfig] = None
    # audio (enc-dec) only
    n_encoder_layers: int = 0
    max_source_positions: int = 0
    # hybrid (hymba): number of learnable meta tokens prepended to the prompt
    n_meta_tokens: int = 0
    # numerics
    dtype: str = "bfloat16"
    # serving-side options
    kv_cache_dtype: str = "bfloat16"   # bfloat16 | int8
    long_context_variant: str = "none" # none | sliding | native
    long_context_window: int = 8192
    # notes for DESIGN.md §Arch-applicability
    notes: str = ""

    # ------------------------------------------------------------------
    @property
    def attn_out_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_out_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    def padded_vocab(self, multiple: int = 256) -> int:
        return ((self.vocab_size + multiple - 1) // multiple) * multiple

    @property
    def is_encoder_decoder(self) -> bool:
        return self.arch_type == "audio"

    @property
    def supports_long_context(self) -> bool:
        if self.arch_type in ("ssm", "hybrid"):
            return True
        return self.long_context_variant != "none"

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), ignores tiny biases."""
        d, L = self.d_model, self.n_layers
        emb = self.padded_vocab() * d * (1 if self.tie_embeddings else 2)
        attn = d * self.attn_out_dim + 2 * d * self.kv_out_dim + self.attn_out_dim * d
        if self.mlp == "swiglu":
            ffn = 3 * d * self.d_ff
        else:
            ffn = 2 * d * self.d_ff
        if self.moe is not None:
            ffn = ffn * self.moe.n_experts + d * self.moe.n_experts
        block = attn + ffn
        if self.arch_type == "ssm":       # rwkv6: no attention, wkv mixing
            block = 6 * d * d + ffn       # r,k,v,g,w,out projections
        if self.arch_type == "hybrid" and self.ssm is not None:
            block += 3 * d * d * self.ssm.expand // 2
        total = emb + L * block
        if self.is_encoder_decoder:
            total += self.n_encoder_layers * block
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        full_ffn = (3 if self.mlp == "swiglu" else 2) * d * self.d_ff
        dead = L * full_ffn * (self.moe.n_experts - self.moe.top_k)
        return self.param_count() - dead

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """CPU smoke variant of the same family: 2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        d_head = 32
        n_heads = max(2, d_model // 64)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        # keep the GQA-vs-MHA character of the original
        if self.n_kv_heads == self.n_heads:
            n_kv = n_heads
        else:
            n_kv = max(1, n_heads // 2)
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(self.moe, n_experts=4,
                                      top_k=min(self.moe.top_k, 2))
        ssm = self.ssm
        if ssm is not None:
            ssm = dataclasses.replace(ssm, head_dim=32, state_dim=min(ssm.state_dim, 8))
        if self.arch_type == "ssm" and ssm is not None:
            # rwkv: WKV heads tile d_model exactly
            n_heads = n_kv = d_model // ssm.head_dim
        frontend = None
        if self.frontend is not None:
            frontend = VisionStubConfig(n_tokens=min(self.frontend.n_tokens, 16),
                                        embed_dim=64)
        return dataclasses.replace(
            self, n_layers=2, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
            d_head=d_head, d_ff=min(self.d_ff, 512), vocab_size=min(self.vocab_size, 512),
            moe=moe, ssm=ssm, frontend=frontend,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            max_source_positions=min(self.max_source_positions, 64) if self.max_source_positions else 0,
            n_meta_tokens=min(self.n_meta_tokens, 8),
            sliding_window=(64 if self.sliding_window else None),
            long_context_window=256,
            dtype="float32", kv_cache_dtype="float32")


# ----------------------------------------------------------------------
# Input shapes assigned to this paper (public pool).
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}

ARCH_IDS = (
    "llava_next_34b", "stablelm_3b", "llama32_3b", "rwkv6_1b6", "hymba_1b5",
    "smollm_360m", "whisper_tiny", "phi35_moe", "qwen15_32b", "granite_moe_1b",
)
# CLI aliases matching the assignment table spelling.
ALIASES = {
    "llava-next-34b": "llava_next_34b",
    "stablelm-3b": "stablelm_3b",
    "llama3.2-3b": "llama32_3b",
    "rwkv6-1.6b": "rwkv6_1b6",
    "hymba-1.5b": "hymba_1b5",
    "smollm-360m": "smollm_360m",
    "whisper-tiny": "whisper_tiny",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "qwen1.5-32b": "qwen15_32b",
    "granite-moe-1b-a400m": "granite_moe_1b",
}


# the configs the port carries: all ten.  A config with attention (dense,
# MoE, the VLM, hymba's hybrid layers and whisper's encoder-decoder) is
# ported only with its (d_head, n_heads // n_kv_heads) in the instance sets
# of the attention kernels its family runs (tests/test_torch_d128.py holds
# this)
PORTED = ("smollm_360m", "rwkv6_1b6", "llama32_3b", "qwen15_32b",
          "stablelm_3b", "granite_moe_1b", "phi35_moe", "llava_next_34b",
          "hymba_1b5", "whisper_tiny")


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_")
    if mod_name in ARCH_IDS and mod_name not in PORTED:
        raise NotImplementedError(
            f"{name!r} is not ported to repro_torch: the port carries "
            + ", ".join(PORTED))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG
