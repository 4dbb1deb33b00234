"""Model configuration + assigned input-shape registry.

Every assigned architecture is a ``ModelConfig``; the four assigned input
shapes are ``ShapeSpec``s. ``supports(cfg, shape)`` encodes the long_500k
gate (sub-quadratic attention only) per the assignment rules.
"""
from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "supports", "smoke_config"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm_rwkv6 | hybrid_mamba2 | vlm | audio_encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0
    mlp_type: str = "swiglu"  # swiglu | gelu
    moe_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 0  # dispatch group count (0 = auto)
    swa_window: int = 0
    ssm_state: int = 0
    attn_every: int = 0  # hybrid: one shared attn block per this many layers
    enc_layers: int = 0  # whisper encoder depth
    n_frames: int = 0  # audio stub: precomputed frame embeddings
    n_patches: int = 0  # vlm stub: precomputed patch embeddings
    rope_theta: float = 1e4
    dtype: str = "bfloat16"
    norm: str = "rms"  # rms | layer
    remat: str = "full"  # none | dots | full
    quant_bits: int = 0  # weight-only serving quantization (0 = off)
    kv_bits: int = 0     # KV-cache quantization: 0 = bf16, 8 = int8+scales
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so embed/lm_head shard evenly on any
        production mesh axis (16/32). Tokens/labels always < vocab."""
        return -(-self.vocab // 256) * 256

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm_rwkv6"

    @property
    def sub_quadratic(self) -> bool:
        return (self.family in ("ssm_rwkv6", "hybrid_mamba2")
                or self.swa_window > 0)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def supports(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason-if-skipped). Encodes the assignment's shape gates."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "SKIP(full-attn): 524k dense KV + quadratic decode attention"
    return True, ""


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    hybrid = cfg.family == "hybrid_mamba2"
    return dataclasses.replace(
        cfg,
        n_layers=4 if hybrid else 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab=512,
        moe_experts=4 if cfg.moe_experts else 0,
        moe_top_k=2 if cfg.moe_top_k else 0,
        swa_window=32 if cfg.swa_window else 0,
        ssm_state=8 if cfg.ssm_state else 0,
        attn_every=2 if cfg.attn_every else 0,
        enc_layers=2 if cfg.enc_layers else 0,
        n_frames=8 if cfg.n_frames else 0,
        n_patches=8 if cfg.n_patches else 0,
        remat="none",
    )
