"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2. [hf:microsoft/Phi-3.5-MoE-instruct]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=6400,
    vocab_size=32064,
    norm="layernorm",
    mlp="swiglu",
    moe=MoEConfig(n_experts=16, top_k=2),
    long_context_variant="sliding",
    notes="16 experts map 1:1 onto the 16-way model axis (pure expert parallel)",
)
