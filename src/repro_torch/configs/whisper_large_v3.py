"""whisper-large-v3 — encoder-decoder ASR. [arXiv:2212.04356; unverified]

32L (encoder) + 32L (decoder) d_model=1280 20H (MHA kv=20) d_ff=5120
vocab=51866. The conv frontend is a STUB: input_specs() provides
precomputed frame embeddings (n_frames=1500). Deviation recorded in
DESIGN.md: RoPE replaces whisper's learned/sinusoidal positions.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio_encdec",
    n_layers=32,       # decoder
    enc_layers=32,     # encoder
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51_866,
    n_frames=1500,
    mlp_type="gelu",
    norm="layer",
)
