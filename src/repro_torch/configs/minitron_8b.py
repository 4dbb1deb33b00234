"""minitron-8b — pruned nemotron. [arXiv:2407.14679; hf-verified]

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000. Nemotron family
uses squared-ReLU MLPs (no GLU), kept here for fidelity.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16_384,
    vocab=256_000,
    mlp_type="relu2",
    norm="layer",
)
