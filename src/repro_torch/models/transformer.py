"""Attention / FFN / MoE blocks for the LM zoo, as the reference's
``repro.models.transformer``.

Attention: GQA + RoPE; full-causal, sliding-window (SWA), or cross
(whisper decoder); query-chunked softmax for long sequences (memory
O(q_chunk * S) instead of O(T * S)); KV-cache decode with either a full
cache or an O(window) ring buffer for SWA, in bf16 or quantized to int8 or
packed int4 with scales.

A cache is a dict of tensors that ``attention`` updates in place and
returns: the reference returns a new cache instead, and nothing reads the
old one.

MoE: token-choice top-k with per-group capacity, the reference's
single-device path (its ``shard_map`` path waits for the port of
``repro.dist``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Initializer, apply_rope, dense, rope

__all__ = ["init_attention", "attention", "init_mlp", "mlp", "init_moe", "moe",
           "init_attn_cache", "prefill_attn_cache", "cross_kv"]

NEG_INF = -2.0e38


# ----------------------------------------------------------------- attention

def init_attention(ini: Initializer, cfg: ModelConfig, cross: bool = False) -> dict:
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": ini.normal((d, h * dh), ("embed", "qkv")),
        "wk": ini.normal((d, hk * dh), ("embed", "qkv")),
        "wv": ini.normal((d, hk * dh), ("embed", "qkv")),
        "wo": ini.normal((h * dh, d), ("qkv", "embed")),
    }


def init_attn_cache(cfg: ModelConfig, batch: int, max_seq: int,
                    dtype=torch.bfloat16, ring: bool | None = None,
                    device=None, lead: tuple = ()) -> dict:
    """Empty decode cache. ring=True -> O(window) SWA ring buffer.

    cfg.kv_bits == 8: K/V stored int8 with per-(token, head) max-abs
    scales; 4: two nibbles a byte with a scale per group along head_dim.
    ``lead`` prefixes every leaf (the stacked layer axis).
    """
    if ring is None:
        ring = cfg.swa_window > 0
    s = min(max_seq, cfg.swa_window) if ring else max_seq
    hk, dh = cfg.n_kv_heads, cfg.head_dim
    lead = tuple(lead)

    def zeros(shape, dt):
        return torch.zeros(lead + shape, dtype=dt, device=device)

    if cfg.kv_bits == 8:
        c = {"k": zeros((batch, s, hk, dh), torch.int8),
             "v": zeros((batch, s, hk, dh), torch.int8),
             "k_s": zeros((batch, s, hk), torch.bfloat16),
             "v_s": zeros((batch, s, hk), torch.bfloat16)}
    elif cfg.kv_bits == 4:  # two nibbles packed per byte along head_dim
        ng = dh // _kv4_group(dh)
        c = {"k": zeros((batch, s, hk, dh // 2), torch.uint8),
             "v": zeros((batch, s, hk, dh // 2), torch.uint8),
             "k_s": zeros((batch, s, hk, ng), torch.bfloat16),
             "v_s": zeros((batch, s, hk, ng), torch.bfloat16)}
    else:
        c = {"k": zeros((batch, s, hk, dh), dtype),
             "v": zeros((batch, s, hk, dh), dtype)}
    if ring:
        c["kv_pos"] = torch.full(lead + (s,), -1, dtype=torch.int32,
                                 device=device)
    return c


def _kv_quant(x, nbits: int = 8):
    """(B,T,Hk,dh) -> (int8 or nibble-packed uint8, bf16 scales).

    The quotient divides by the float32 scale; the scale is cast to bf16
    only on the way out, as in the reference.
    """
    xf = x.to(torch.float32)
    if nbits == 8:
        s = xf.abs().amax(-1) / 127.0 + 1e-8
        q = torch.round(xf / s[..., None]).to(torch.int8)
        return q, s.to(torch.bfloat16)
    # 4 bits: values in [-7, 7] stored as [1, 15], two a byte, with a scale
    # per group of <= 8 along head_dim (_kv4_group)
    dh = x.shape[-1]
    g = _kv4_group(dh)
    xg = xf.reshape(*xf.shape[:-1], dh // g, g)
    s = xg.abs().amax(-1) / 7.0 + 1e-8                      # (..., dh/g)
    q = torch.clamp(torch.round(xg / s[..., None]), -7, 7).to(torch.int32) + 8
    q = q.reshape(*xf.shape[:-1], dh)
    packed = (q[..., 0::2] | (q[..., 1::2] << 4)).to(torch.uint8)
    return packed, s.to(torch.bfloat16)


def _kv4_group(dh: int) -> int:
    # groups of 8 (at 4 bits the scale error dominates), each holding whole
    # packed byte pairs
    g = min(8, dh)
    while dh % (2 * g):
        g //= 2
    return max(g, 2)


def _kv_dequant(q, s, nbits: int = 8, dtype=torch.bfloat16):
    """The reference's dequantization: bf16 unless ``dtype`` says otherwise,
    whatever the model's dtype (attention passes none)."""
    if nbits == 8:
        return q.to(dtype) * s[..., None].to(dtype)
    dh = q.shape[-1] * 2
    g = _kv4_group(dh)
    qi = q.to(torch.int32)
    lo = (qi & 0xF) - 8
    hi = ((qi >> 4) & 0xF) - 8
    x = torch.stack([lo, hi], dim=-1).reshape(*q.shape[:-1], dh // g, g)
    x = x.to(dtype) * s[..., None].to(dtype)
    return x.reshape(*q.shape[:-1], dh)


def _mask(q_pos, kv_pos, *, causal, window, grouped: bool):
    """Boolean mask, broadcastable over scores.

    grouped=False -> (B,1,T,S) for q-head-major scores (B,H,T,S);
    grouped=True  -> (B,1,1,T,S) for grouped scores (B,Hk,rep,T,S).
    """
    if kv_pos.ndim == 1:
        kv_pos = kv_pos[None]
    if grouped:
        qp = q_pos[:, None, None, :, None]
        kp = kv_pos[:, None, None, None, :]
    else:
        qp = q_pos[:, None, :, None]
        kp = kv_pos[:, None, None, :]
    mask = kp >= 0
    if causal:
        mask = mask & (kp <= qp)
    if window:
        mask = mask & (kp > qp - window)
    return mask


def _sdpa(q, k, v, q_pos, kv_pos, *, causal, window, dtype):
    """q (B,T,H,dh) x k/v (B,S,Hk,dh) -> (B,T,H,dh).

    T > 1 (prefill): K/V repeated to every query head. T == 1 (decode):
    grouped product, K/V stay at Hk heads.
    """
    b, t, h, dh = q.shape
    hk = k.shape[2]
    rep = h // hk
    scale = 1.0 / math.sqrt(float(dh))
    if t > 1 or rep == 1:
        if rep > 1:  # jnp.repeat along the kv-head axis
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        scores = torch.einsum("bthd,bshd->bhts", q, k.to(q.dtype))
        scores = scores.to(torch.float32) * scale
        if q_pos is not None:
            m = _mask(q_pos, kv_pos, causal=causal, window=window,
                      grouped=False)
            scores = torch.where(m, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(dtype)
        return torch.einsum("bhts,bshd->bthd", probs, v.to(dtype))
    qg = q.reshape(b, t, hk, rep, dh)
    scores = torch.einsum("bthrd,bshd->bhrts", qg, k.to(qg.dtype))
    scores = scores.to(torch.float32) * scale
    if q_pos is not None:
        m = _mask(q_pos, kv_pos, causal=causal, window=window, grouped=True)
        scores = torch.where(m, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bhrts,bshd->bthrd", probs, v.to(dtype))
    return out.reshape(b, t, h, dh)


def _sdpa_chunked(q, k, v, q_pos, kv_pos, *, causal, window, dtype, q_chunk):
    """Query-chunked attention: a loop over row blocks of the scores."""
    b, t, h, dh = q.shape
    pad = (-t) % q_chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        # padded queries get the last valid position: rows stay finite
        q_pos = torch.cat([q_pos, q_pos[:, -1:].expand(b, pad)], dim=1)
    outs = [_sdpa(q[:, i:i + q_chunk], k, v, q_pos[:, i:i + q_chunk], kv_pos,
                  causal=causal, window=window, dtype=dtype)
            for i in range(0, q.shape[1], q_chunk)]
    return torch.cat(outs, dim=1)[:, :t]


def attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor | None = None, cache: dict | None = None,
              cache_pos: int | None = None, kv_src: torch.Tensor | None = None,
              causal: bool = True, use_rope: bool = True, q_chunk: int = 1024):
    """Returns (out (B,T,D), cache | None).

    Modes:
      - self, no cache: scoring; q-chunked when T > q_chunk.
      - self, cache: prefill/decode; writes T tokens at ``cache_pos`` (a
        host int) into the cache, in place, then attends over it (ring or
        full).
      - cross (kv_src set, no cache): attends over kv_src, no mask.
      - cross, cache: kv_src may be None; uses precomputed cache['k'/'v'].
    """
    b, t, d = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense(x, p["wq"]).reshape(b, t, h, dh)

    if positions is None:
        positions = torch.arange(t, device=x.device)[None].expand(b, t)

    cross = kv_src is not None or (cache is not None and "kv_pos" not in cache
                                   and cache_pos is None)
    if kv_src is not None or not cross:
        src = kv_src if kv_src is not None else x
        k = dense(src, p["wk"]).reshape(b, -1, hk, dh)
        v = dense(src, p["wv"]).reshape(b, -1, hk, dh)
    else:
        k = v = None  # cross decode: the cache holds the encoder's K/V

    if use_rope and not cross:
        cos, sin = rope(positions, dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    out_cache = None
    if cross:
        if cache is not None:
            k, v = cache["k"], cache["v"]
            out_cache = cache
        kv_pos = torch.arange(k.shape[1], device=x.device)
        q_pos = positions  # with causal=False/window=0 the mask is all-true
        causal = False
        window = 0
    elif cache is not None:
        s = cache["k"].shape[1]
        ring = "kv_pos" in cache
        quant = "k_s" in cache
        nbits = 0
        if quant:
            nbits = 4 if cache["k"].shape[-1] == dh // 2 else 8
            kq, ks = _kv_quant(k, nbits)
            vq, vs = _kv_quant(v, nbits)
        if ring:
            if t >= s:  # prompt longer than the window: keep the tail only
                k, v = k[:, t - s:], v[:, t - s:]
                if quant:
                    kq, ks = kq[:, t - s:], ks[:, t - s:]
                    vq, vs = vq[:, t - s:], vs[:, t - s:]
                woff, t_w = cache_pos + (t - s), s
            else:
                woff, t_w = cache_pos, t
            wpos = woff + torch.arange(t_w, device=x.device)
            idx = wpos % s
            cache["k"][:, idx] = (kq if quant else k).to(cache["k"].dtype)
            cache["v"][:, idx] = (vq if quant else v).to(cache["v"].dtype)
            cache["kv_pos"][idx] = wpos.to(cache["kv_pos"].dtype)
            if quant:
                cache["k_s"][:, idx] = ks
                cache["v_s"][:, idx] = vs
            kv_pos = cache["kv_pos"]
        else:
            sl = slice(cache_pos, cache_pos + t)
            if cache_pos + t > s:
                raise ValueError(f"cache of {s} positions cannot take "
                                 f"{t} more at {cache_pos}")
            cache["k"][:, sl] = (kq if quant else k).to(cache["k"].dtype)
            cache["v"][:, sl] = (vq if quant else v).to(cache["v"].dtype)
            if quant:
                cache["k_s"][:, sl] = ks
                cache["v_s"][:, sl] = vs
            kv_pos = torch.arange(s, device=x.device)
        if quant:
            k = _kv_dequant(cache["k"], cache["k_s"], nbits)
            v = _kv_dequant(cache["v"], cache["v_s"], nbits)
        else:
            k, v = cache["k"], cache["v"]
        out_cache = cache
        q_pos = positions
        window = cfg.swa_window
    else:
        # self-attention without a cache: kv positions == query positions
        q_pos = positions
        kv_pos = positions
        window = cfg.swa_window

    if t > q_chunk:
        out = _sdpa_chunked(q, k, v, q_pos, kv_pos, causal=causal,
                            window=window, dtype=x.dtype, q_chunk=q_chunk)
    else:
        out = _sdpa(q, k, v, q_pos, kv_pos, causal=causal, window=window,
                    dtype=x.dtype)
    out = dense(out.reshape(b, t, h * dh), p["wo"])
    return out, out_cache


def prefill_attn_cache(p, x, cfg: ModelConfig, max_seq: int,
                       positions=None, dtype=torch.bfloat16):
    """Compute K/V for a prompt and place them in a fresh full cache."""
    b = x.shape[0]
    cache = init_attn_cache(cfg, b, max_seq, dtype=dtype, ring=False,
                            device=x.device)
    return attention(p, x, cfg, positions=positions, cache=cache, cache_pos=0)


def cross_kv(p: dict, src: torch.Tensor, cfg: ModelConfig) -> dict:
    """Precompute cross-attention K/V from encoder states (B, S, D)."""
    b = src.shape[0]
    hk, dh = cfg.n_kv_heads, cfg.head_dim
    k = dense(src, p["wk"]).reshape(b, -1, hk, dh)
    v = dense(src, p["wv"]).reshape(b, -1, hk, dh)
    return {"k": k, "v": v}


# ----------------------------------------------------------------------- FFN

def init_mlp(ini: Initializer, cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {"wg": ini.normal((d, f), ("embed", "mlp")),
                "wu": ini.normal((d, f), ("embed", "mlp")),
                "wd": ini.normal((f, d), ("mlp", "embed"))}
    return {"w1": ini.normal((d, f), ("embed", "mlp")),
            "w2": ini.normal((f, d), ("mlp", "embed"))}


def mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if "wg" in p:
        h = F.silu(dense(x, p["wg"])) * dense(x, p["wu"])
        return dense(h, p["wd"])
    h = dense(x, p["w1"])
    if cfg.mlp_type == "relu2":   # nemotron / minitron squared-ReLU
        h = torch.relu(h).square()
    else:  # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h, approximate="tanh")
    return dense(h, p["w2"])


# ----------------------------------------------------------------------- MoE

def init_moe(ini: Initializer, cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    return {
        "router": ini.normal((d, e), ("embed", None), dtype=torch.float32),
        "wg": ini.normal((e, d, f), ("experts", "expert_embed", "expert_mlp")),
        "wu": ini.normal((e, d, f), ("experts", "expert_embed", "expert_mlp")),
        "wd": ini.normal((e, f, d), ("experts", "expert_mlp", "expert_embed")),
    }


def _auto_groups(s: int, cap_groups: int = 32) -> int:
    g = 1
    while g < cap_groups and s % (g * 2) == 0:
        g *= 2
    return g


def _moe_route(p, xs, cfg: ModelConfig, cap: int):
    """Group-local routing. xs (G, Sg, D) -> (sel (G,E,C), weight (G,E,C),
    valid (G,E,C)).

    The slots of an expert that has fewer than C tokens may name other
    tokens than the reference's (``lax.top_k`` and ``torch.topk`` break
    ties apart); they carry weight 0, so the output does not depend on them.
    """
    g, sg, d = xs.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    logits = torch.einsum("gsd,de->gse", xs.to(torch.float32), p["router"])
    gates = torch.softmax(logits, dim=-1)
    top_g, top_i = torch.topk(gates, k, dim=-1)  # (G, Sg, k)
    top_g = top_g / top_g.sum(-1, keepdim=True).clamp(min=1e-9)
    combine = torch.zeros((g, sg, e), dtype=torch.float32, device=xs.device)
    combine.scatter_(-1, top_i, top_g)
    mask = combine > 0
    # per-(group, expert) token selection: the first C tokens in order
    order = -torch.arange(sg, dtype=torch.float32, device=xs.device)
    pri = torch.where(mask, order[None, :, None], NEG_INF)
    _, sel = torch.topk(pri.transpose(1, 2), cap, dim=-1)  # (G, E, C)
    valid = torch.gather(mask.transpose(1, 2), 2, sel)
    gate_ec = torch.gather(combine.transpose(1, 2), 2, sel)
    return sel, (gate_ec * valid).to(xs.dtype), valid


def _moe_gather(xs, sel):
    g, sg, d = xs.shape
    _, e, cap = sel.shape
    rows = torch.arange(g, device=xs.device)[:, None]
    return xs[rows, sel.reshape(g, e * cap)].reshape(g, e, cap, d)


def _moe_scatter(sel, vals, sg):
    g, e, cap, d = vals.shape
    out = torch.zeros((g * sg, d), dtype=vals.dtype, device=vals.device)
    flat = (sel + torch.arange(g, device=sel.device)[:, None, None] * sg)
    out.index_add_(0, flat.reshape(-1), vals.reshape(-1, d))
    return out.reshape(g, sg, d)


def _moe_ffn(wg, wu, wd, gath, weight):
    """Expert FFN over dispatched tokens (G, E, C, D); weight (G, E, C)."""
    gath = gath * (weight[..., None] > 0).to(gath.dtype)
    h = F.silu(torch.einsum("gecd,edf->gecf", gath, wg.to(gath.dtype)))
    h = h * torch.einsum("gecd,edf->gecf", gath, wu.to(gath.dtype))
    out_e = torch.einsum("gecf,efd->gecd", h, wd.to(h.dtype))
    return out_e * weight[..., None]


def moe(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Token-choice top-k with per-group capacity (grouped dispatch).

    Tokens are split into G groups; each expert takes its first C assigned
    tokens a group (C = Sg*k/E * capacity_factor); tokens over capacity
    fall through the residual. G comes from the token count
    (``_auto_groups(b*t)``) unless ``cfg.moe_groups`` fixes it, so a
    prefill and a decode step route alike only when no token is dropped
    (``capacity_factor = E/k``).
    """
    b, t, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    s = b * t
    g = cfg.moe_groups or _auto_groups(s)
    sg = s // g
    cap = max(4, int(sg * k / e * cfg.capacity_factor))
    cap = min(cap, sg)
    xs = x.reshape(g, sg, d)
    sel, weight, _ = _moe_route(p, xs, cfg, cap)
    out_e = _moe_ffn(p["wg"], p["wu"], p["wd"], _moe_gather(xs, sel), weight)
    return _moe_scatter(sel, out_e, sg).reshape(b, t, d)
