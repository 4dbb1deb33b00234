"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; unverified tier]
24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, SWA window 4096.
head_dim = 120 (3840/32).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10_240,
    vocab=32_000,
    swa_window=4096,
    mlp_type="swiglu",
    norm="rms",
)
