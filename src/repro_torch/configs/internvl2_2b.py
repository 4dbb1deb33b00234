"""internvl2-2b — InternViT + InternLM2 backbone. [arXiv:2404.16821; hf]

LM backbone only per the assignment: 24L d_model=2048 16H (GQA kv=8)
d_ff=8192 vocab=92553. The ViT frontend is a STUB: input_specs() provides
precomputed patch embeddings (n_patches=256 after pixel-shuffle).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92_553,
    n_patches=256,
    mlp_type="swiglu",
    norm="rms",
)
