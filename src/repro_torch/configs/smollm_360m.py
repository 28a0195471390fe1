"""smollm-360m [dense] — llama-arch small. [hf:HuggingFaceTB/SmolLM-135M]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    arch_type="dense",
    source="hf:HuggingFaceTB/SmolLM-135M",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_head=64,
    d_ff=2560,
    vocab_size=49152,
    norm="rmsnorm",
    mlp="swiglu",
    tie_embeddings=True,
    long_context_variant="sliding",
)
