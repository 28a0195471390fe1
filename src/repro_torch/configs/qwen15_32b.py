"""qwen1.5-32b [dense] — QKV bias, near-MHA (kv=40). [hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    arch_type="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_head=128,
    d_ff=27392,
    vocab_size=152064,
    norm="rmsnorm",
    mlp="swiglu",
    qkv_bias=True,
    long_context_variant="sliding",
    kv_cache_dtype="int8",   # 40 MHA kv heads @32k x 128 batch does not fit bf16
    notes="int8 KV cache required for decode_32k memory (see EXPERIMENTS.md)",
)
