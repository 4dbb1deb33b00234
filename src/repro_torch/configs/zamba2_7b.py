"""zamba2-7b — Mamba2 backbone + shared attention blocks. [arXiv:2411.15242]

81L d_model=3584 32H (MHA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
The single shared attention+MLP block is applied every 9 mamba layers
(9 applications over 81 layers), weights shared across applications —
the zamba2 parameter-sharing signature. head_dim=112.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid_mamba2",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14_336,
    vocab=32_000,
    ssm_state=64,
    attn_every=9,
    mlp_type="swiglu",
    norm="rms",
)
