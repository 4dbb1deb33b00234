"""Analytic FLOP / HBM-byte model per (arch, shape), the port's copy of the
reference's ``repro.perf.kernel_cost``: pure Python over ``ModelConfig``,
the same numbers. The reference's dry run uses it where XLA's cost analysis
counts a scanned layer once; the port uses a decode step's HBM bytes
(``analytic_cost(...).hbm_bytes_per_device`` at one device) over the card's
memory rate as the least time a decode step can take.

FLOP model (per token, forward):
  matmul params      2 * N_matmul_active   (embeddings gather excluded,
                                            lm_head included; MoE experts
                                            scaled by top_k/E * capacity)
  attention          4 * ctx * H * dh per attn layer (QK^T + PV), ctx =
                     average visible context (causal: T/2, SWA: min(T,W),
                     decode: cache length, cross: n_frames)
  gla/ssd            4*H*K*V state outer products + 2*L*H*K intra-chunk

Train multiplies forward by (3 + 1 if full remat) [fwd + 2x bwd + re-fwd].

HBM byte model (per device, per step):
  params traffic     train: bf16 read fwd+bwd+remat (3x2B) + fp32 grads
                     write+read (8B) + adam m/v read+write (32B) + param
                     write (2B) = 44 B/param_local
                     serve: one bf16 read = 2 B/param_local
  activations        train: residual saves w+r (2x) + block-internal
                     streams (~6x) of B*T*D*2B per layer
  kv cache (decode)  whole local cache read once per step (+ tiny write)
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ShapeSpec

__all__ = ["analytic_cost", "matmul_param_counts", "scan_trip_counts"]


def _attn_layer_count(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid_mamba2":
        return cfg.n_layers // (cfg.attn_every or cfg.n_layers)
    if cfg.family == "ssm_rwkv6":
        return 0
    return cfg.n_layers


def matmul_param_counts(cfg: ModelConfig) -> dict:
    """Matmul-visible parameter counts (total, active-per-token)."""
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = (d * h * dh) * 2 + (d * hk * dh) * 2  # wq wo wk wv
    mlp = 3 * d * f if cfg.mlp_type == "swiglu" else 2 * d * f
    total = active = 0
    if cfg.family in ("dense", "vlm"):
        total = active = L * (attn + mlp)
        if cfg.family == "vlm":
            total += d * d
            active += d * d
    expert = 0
    if cfg.family == "moe":
        e, k = cfg.moe_experts, cfg.moe_top_k
        expert = L * e * 3 * d * f
        router = L * d * e
        total = L * attn + expert + router
        active = L * attn + router + int(
            expert * min(1.0, k / e * cfg.capacity_factor))
    elif cfg.family == "ssm_rwkv6":
        per = 5 * d * d + d * 64 + 64 * d + 2 * d * f  # r,k,v,g,o + lora + cm
        total = active = L * per
    elif cfg.family == "hybrid_mamba2":
        d_in = 2 * d
        nh = d_in // 64
        n = cfg.ssm_state
        per = d * (2 * d_in + 2 * n + nh) + d_in * d
        shared = attn + mlp  # ONE block, applied n_apps times
        n_apps = _attn_layer_count(cfg)
        total = L * per + shared
        active = L * per + n_apps * shared  # shared weights REUSED: active>total
    elif cfg.family == "audio_encdec":
        dec = cfg.n_layers * (attn * 2 + mlp)  # self + cross
        enc = cfg.enc_layers * (attn + mlp)
        total = dec + enc + d * d
        active = total
    head = d * v  # lm_head (tied or not, the logits matmul runs)
    total += head
    active += head
    return {"total": total, "active": active, "expert": expert}


@dataclasses.dataclass
class AnalyticCost:
    flops_per_device: float
    hbm_bytes_per_device: float
    flops_total: float
    notes: dict

    def as_dict(self):
        return dataclasses.asdict(self)


def analytic_cost(cfg: ModelConfig, shape: ShapeSpec, n_devices: int,
                  params_total: int, params_local_bytes: float | None = None
                  ) -> AnalyticCost:
    d, L = cfg.d_model, cfg.n_layers
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, t = shape.batch, shape.seq
    kind = shape.kind
    n_tok = b * (1 if kind == "decode" else t)

    # ---- forward matmul flops
    counts = matmul_param_counts(cfg)
    mm = 2.0 * counts["active"] * n_tok

    # ---- attention flops
    n_attn = _attn_layer_count(cfg)
    if kind == "decode":
        ctx = min(t, cfg.swa_window) if cfg.swa_window else t
    else:
        ctx = min(t, cfg.swa_window) if cfg.swa_window else t / 2.0
    attn = 4.0 * n_tok * ctx * h * dh * n_attn
    if cfg.family == "audio_encdec":
        fr = cfg.n_frames
        attn += 4.0 * n_tok * fr * h * dh * cfg.n_layers       # cross
        if kind != "decode":  # encoder runs on prefill/train
            attn += 4.0 * (b * fr) * fr * h * dh * cfg.enc_layers
    if cfg.family == "vlm" and kind != "decode":
        # patches extend the context
        attn += 4.0 * (b * cfg.n_patches) * (cfg.n_patches + t) / 2 * h * dh * L

    # ---- linear-recurrence flops
    rec = 0.0
    if cfg.family == "ssm_rwkv6":
        hh, kk = d // 64, 64
        chunk = 32
        rec = n_tok * L * hh * (4.0 * kk * kk + 2.0 * chunk * kk)
    elif cfg.family == "hybrid_mamba2":
        d_in = 2 * d
        nh, p, n = d_in // 64, 64, cfg.ssm_state
        chunk = 128
        rec = n_tok * L * nh * (4.0 * n * p + 2.0 * (chunk if kind != "decode"
                                                     else 1) * n)

    fwd = mm + attn + rec
    mult = 1.0
    if kind == "train":
        mult = 3.0 + (1.0 if cfg.remat == "full" else 0.0)
    flops_total = fwd * mult

    # ---- HBM bytes (per device)
    n_data = max(1, min(16, n_devices // 16)) if n_devices >= 16 else 1
    n_data = 16 if n_devices >= 256 else n_data
    if kind == "train":
        # FSDP: every device READS each layer's gathered full weights
        # (fwd + bwd + remat re-fwd); experts shard over 'data' so only
        # E/n_data of expert weights land on a device.
        expert = counts.get("expert", 0)
        read_params = (params_total - expert) + expert / n_data
        n_reads = 2.0 + (1.0 if cfg.remat == "full" else 0.0)
        params_local = params_total / n_devices
        p_traffic = read_params * 2.0 * n_reads + params_local * 40.0
        act = (n_tok / n_devices) * d * 2.0 * 8.0 * L
        kv = 0.0
    elif kind == "prefill":
        p_traffic = (params_total / max(1, min(16, n_devices))) * 2.0
        act = (n_tok / n_devices) * d * 2.0 * 4.0 * L
        kv = (n_tok / n_devices) * hk * dh * 2 * 2.0 * n_attn  # cache write
    else:  # decode
        p_traffic = (params_total / max(1, min(16, n_devices))) * 2.0
        act = (n_tok / n_devices) * d * 2.0 * 4.0 * L
        cache_ctx = min(t, cfg.swa_window) if cfg.swa_window else t
        kv_bytes = {8: 1.0, 4: 0.5}.get(cfg.kv_bits, 2.0)
        kv = (b / max(1, n_devices / 16)) * cache_ctx * hk * dh * 2 * kv_bytes \
            * n_attn / 16.0
        if cfg.family == "ssm_rwkv6":
            kv += (b * (d // 64) * 64 * 64 * 4.0 * L) / n_devices
        if cfg.family == "hybrid_mamba2":
            d_in = 2 * d
            kv += (b * (d_in // 64) * cfg.ssm_state * 64 * 4.0 * L) / n_devices
    bytes_dev = p_traffic + act + kv

    return AnalyticCost(
        flops_per_device=flops_total / n_devices,
        hbm_bytes_per_device=bytes_dev,
        flops_total=flops_total,
        notes={"matmul_flops": mm * mult, "attn_flops": attn * mult,
               "rec_flops": rec * mult, "param_traffic_bytes": p_traffic,
               "act_traffic_bytes": act, "kv_traffic_bytes": kv,
               "params_matmul_active": counts["active"]},
    )


def scan_trip_counts(cfg: ModelConfig, shape: ShapeSpec,
                     q_chunk: int = 1024, t_chunk: int = 512) -> dict:
    """Named-scope -> trip count, for the HLO collective multiplier."""
    t = shape.seq if shape.kind != "decode" else 1
    trips = {
        "layers_scan": cfg.n_layers,
        "enc_scan": cfg.enc_layers or 1,
        "ce_scan": max(1, -(-t // t_chunk)),
        "qchunk_scan": max(1, -(-t // q_chunk)),
        "gla_scan": max(1, -(-t // 32)),
        "ssd_scan": max(1, -(-t // 128)),
    }
    if cfg.family == "hybrid_mamba2":
        a = cfg.attn_every or cfg.n_layers
        trips["group_scan"] = cfg.n_layers // a
        trips["mamba_scan"] = a
    else:
        trips["group_scan"] = 1
        trips["mamba_scan"] = 1
    return trips
