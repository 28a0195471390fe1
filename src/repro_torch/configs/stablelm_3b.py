"""stablelm-3b [dense] — MHA, partial rotary, LayerNorm. [hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    arch_type="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_head=80,
    d_ff=6912,
    vocab_size=50304,
    norm="layernorm",
    mlp="swiglu",
    qkv_bias=True,
    rotary_pct=0.25,
    long_context_variant="sliding",
)
