"""llava-next-34b [vlm] — anyres tiling, GQA decoder backbone.

[hf:llava-hf/llava-v1.6-mistral-7b-hf] (scaled per assignment table).
Vision tower (ViT) is a stub per the carve-out: ``input_specs`` provides
precomputed anyres patch embeddings; we implement the projector + decoder.
"""
from repro_torch.configs.base import ModelConfig, VisionStubConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    arch_type="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=20480,
    vocab_size=64000,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=5_000_000.0,
    # anyres tiling: base 24x24 grid + up to 4 tiles -> 5 * 576 = 2880 patch
    # tokens after projection (CLIP-ViT-L/14 @ 336px, embed 1024).
    frontend=VisionStubConfig(n_tokens=2880, embed_dim=1024),
    long_context_variant="sliding",   # enables long_500k decode (documented deviation)
    long_context_window=8192,
    notes="anyres tiling; vision encoder stubbed (precomputed patch embeddings)",
)
