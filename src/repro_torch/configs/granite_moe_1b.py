"""granite-moe-1b-a400m [moe] — 32 experts top-8, fine-grained. [hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    vocab_size=49155,
    norm="rmsnorm",
    mlp="swiglu",
    tie_embeddings=True,
    moe=MoEConfig(n_experts=32, top_k=8),
    long_context_variant="sliding",
    notes="fine-grained experts (d_ff=512); 2 experts per model shard",
)
