"""rwkv6-1.6b — RWKV-6 "Finch", data-dependent decay. [arXiv:2404.05892]

24L d_model=2048 (attention-free) d_ff=7168 vocab=65536. 32 heads of 64.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm_rwkv6",
    n_layers=24,
    d_model=2048,
    n_heads=32,        # d_model / 64 rwkv heads (informational)
    n_kv_heads=32,
    d_ff=7168,
    vocab=65_536,
    mlp_type="relu2",  # rwkv channel-mix uses squared relu
    norm="layer",
)
