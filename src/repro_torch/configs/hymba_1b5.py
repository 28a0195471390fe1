"""hymba-1.5b [hybrid] — parallel attention + mamba heads, SWA + meta tokens. [arXiv:2411.13676]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    source="arXiv:2411.13676",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab_size=32001,
    norm="rmsnorm",
    mlp="swiglu",
    sliding_window=1024,      # most layers use SWA in the paper
    n_meta_tokens=128,
    ssm=SSMConfig(state_dim=16, expand=2, conv_dim=4),
    long_context_variant="native",   # SSM state + SWA => sub-quadratic
    notes="parallel attn+mamba heads fused per layer; 128 learnable meta tokens",
)
