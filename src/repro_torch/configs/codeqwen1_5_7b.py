"""codeqwen1.5-7b — qwen1.5 architecture. [hf:Qwen/CodeQwen1.5-7B; hf]

32L d_model=4096 32H (MHA kv=32) d_ff=13440 vocab=92416.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13_440,
    vocab=92_416,
    mlp_type="swiglu",
    norm="rms",
)
