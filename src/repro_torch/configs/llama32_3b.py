"""llama3.2-3b [dense] — small llama3: RMSNorm + SwiGLU + GQA. [hf:meta-llama/Llama-3.2-1B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    arch_type="dense",
    source="hf:meta-llama/Llama-3.2-1B",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab_size=128256,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=500_000.0,
    tie_embeddings=True,
    long_context_variant="sliding",
)
