"""rwkv6-1.6b [ssm] — Finch: attention-free, data-dependent decay. [arXiv:2404.05892]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    arch_type="ssm",
    source="arXiv:2404.05892",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # 2048 / head_dim 64 WKV heads
    n_kv_heads=32,
    d_head=64,
    d_ff=7168,
    vocab_size=65536,
    norm="layernorm",
    mlp="relu_sq",         # rwkv channel-mix uses squared relu
    ssm=SSMConfig(head_dim=64),
    long_context_variant="native",   # recurrent state => O(1) per token
    notes="attention-free WKV recurrence; runs long_500k natively",
)
