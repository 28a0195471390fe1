"""whisper-tiny [audio] — enc-dec, conv frontend (stub). [arXiv:2212.04356]

The mel-spectrogram + conv1d feature extractor is a stub per the carve-out:
``input_specs`` provides 1500 precomputed frame embeddings (d=384).
"""
from repro_torch.configs.base import ModelConfig, VisionStubConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    arch_type="audio",
    source="arXiv:2212.04356",
    n_layers=4,               # decoder layers
    n_encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_head=64,
    d_ff=1536,
    vocab_size=51865,
    norm="layernorm",
    mlp="gelu",
    qkv_bias=True,
    max_source_positions=1500,
    frontend=VisionStubConfig(n_tokens=1500, embed_dim=384),
    tie_embeddings=True,
    long_context_variant="none",
    notes="enc-dec; long_500k skipped (decoder context architecturally bounded)",
)
