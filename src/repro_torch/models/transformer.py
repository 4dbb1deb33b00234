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
single-device path and, on a mesh, its expert-parallel path.

Sharding: the reference's ``constrain`` hints, at its places. On a mesh
(DTensor inputs under ``dist.sharding.shard_ctx``) the attention core, the
expert dispatch and (in ``lm``) the embedding lookup run as per-rank
functions on the local shards; the rest runs as DTensor ops.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.collectives import all_gather, all_reduce, all_to_all
from repro_torch.dist.sharding import (AbstractMesh, axis_size, current_ctx,
                                       flatten, is_sharded, logical_spec,
                                       mesh_shape, pspec, shard_map, spec_of,
                                       unflatten, write_along)
from repro_torch.models.layers import (Initializer, apply_rope, constrain,
                                       dense, rope)

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
        k = constrain(k, "batch", None, "heads", None)
        v = constrain(v, "batch", None, "heads", None)
        scores = torch.einsum("bthd,bshd->bhts", q, k.to(q.dtype))
        scores = scores.to(torch.float32) * scale
        scores = constrain(scores, "batch", "heads", None, None)
        if q_pos is not None:
            m = _mask(q_pos, kv_pos, causal=causal, window=window,
                      grouped=False)
            scores = torch.where(m, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(dtype)
        return torch.einsum("bhts,bshd->bthd", probs, v.to(dtype))
    qg = unflatten(q, 2, (hk, rep))
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


def _sdpa_split(q, k, v, q_pos, kv_pos, *, causal, window, dtype, q_chunk,
                groups):
    """``_sdpa`` over a sequence split across the ranks of ``groups`` (a
    rank's own K/V positions, every rank's queries): each query chunk's
    softmax takes its max and its sum over every rank (all-reduces of one
    value a row), and each rank's share of the output is summed. The
    grouped product keeps K/V at their own heads."""
    b, t, h, dh = q.shape
    hk = k.shape[2]
    scale = 1.0 / math.sqrt(float(dh))
    c = q_chunk or t
    outs = []
    for i in range(0, t, c):
        qg = q[:, i:i + c].unflatten(2, (hk, h // hk))
        scores = torch.einsum("bthrd,bshd->bhrts", qg, k.to(qg.dtype))
        scores = scores.to(torch.float32) * scale
        m = _mask(q_pos[:, i:i + c], kv_pos, causal=causal, window=window,
                  grouped=True)
        scores = torch.where(m, scores, NEG_INF)
        top = scores.amax(-1, keepdim=True)
        for g in groups:
            top = all_reduce(top, g, "max")
        e = torch.exp(scores - top)
        total = e.sum(-1, keepdim=True)
        for g in groups:
            total = all_reduce(total, g)
        out = torch.einsum("bhrts,bshd->bthrd", (e / total).to(dtype),
                           v.to(dtype))
        for g in groups:
            out = all_reduce(out, g)
        outs.append(out.flatten(2, 3))
    return torch.cat(outs, dim=1)


def _attend(q, k, v, q_pos, kv_pos, *, causal, window, dtype, q_chunk):
    """Attention of q (B,T,H,dh) over k/v (B,S,Hk,dh); on a mesh, on each
    rank's shards.

    Off a mesh it is ``_sdpa`` (query-chunked when ``q_chunk`` is set).
    Under a shard context with DTensor inputs it runs as a per-rank
    function (``shard_map``) on the local shards: XLA partitions the
    reference's attention this way, where DTensor would have to plan each
    of its einsums over the mesh (older releases cannot merge two sharded
    batch dims into bmm's one). Two layouts:

    - K/V split along the sequence (a split-KV cache, ``cache_shardings``)
      and no gradient wanted: each rank attends over its own positions and
      the softmax's max and sum, and the output, are reduced over the
      sequence's mesh axes (``_sdpa_split``); the cache is never gathered.
    - otherwise batch rows and heads as the rules' ``batch`` and
      ``heads``; K/V keep their own heads where the kv heads split as the
      query heads do (each rank then holds whole groups), else they are
      first repeated to every query head.
    """
    if q_chunk:
        core = functools.partial(_sdpa_chunked, causal=causal, window=window,
                                 dtype=dtype, q_chunk=q_chunk)
    else:
        core = functools.partial(_sdpa, causal=causal, window=window,
                                 dtype=dtype)
    ctx = current_ctx()
    if ctx is None or isinstance(ctx[0], AbstractMesh) or not is_sharded(q):
        return core(q, k, v, q_pos, kv_pos)
    mesh, rules = ctx
    seq = spec_of(k)[1] if is_sharded(k) else None
    if seq is not None and not (torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v))):
        ks = spec_of(k)
        qs = pspec(ks[0], None, ks[2], None)
        axes = (seq,) if isinstance(seq, str) else seq
        split = functools.partial(
            _sdpa_split, causal=causal, window=window, dtype=dtype,
            q_chunk=q_chunk, groups=[mesh.get_group(a) for a in axes])
        kvs = pspec(ks[0], seq)[2 - kv_pos.ndim:]
        return shard_map(split, mesh, in_specs=(qs, ks, ks, pspec(ks[0], None),
                                                kvs),
                         out_specs=qs)(q, k, v, q_pos, kv_pos)
    names = ("batch", None, "heads", None)
    qs = logical_spec(mesh, rules, names, q.shape)
    rep = q.shape[2] // k.shape[2]
    if rep > 1 and k.shape[2] % axis_size(mesh, qs[2]):
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    ks = pspec(qs[0], None, qs[2], None)
    ps = logical_spec(mesh, rules, ("batch", None), q_pos.shape)
    kvs = logical_spec(mesh, rules, ("batch", None)[2 - kv_pos.ndim:],
                       kv_pos.shape)
    return shard_map(core, mesh, in_specs=(qs, ks, ks, ps, kvs),
                     out_specs=qs)(q, k, v, q_pos, kv_pos)


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
    # the compute layout: weights sharded over "data" (zero3) are gathered
    # here, as in the reference
    wq = constrain(p["wq"], None, "qkv_compute")
    wk = constrain(p["wk"], None, "qkv_compute")
    wv = constrain(p["wv"], None, "qkv_compute")
    wo = constrain(p["wo"], "qkv_compute", None)
    q = unflatten(dense(x, wq), -1, (h, dh))
    q = constrain(q, "batch", None, "heads", None)

    if positions is None:
        positions = torch.arange(t, device=x.device)[None].expand(b, t)

    cross = kv_src is not None or (cache is not None and "kv_pos" not in cache
                                   and cache_pos is None)
    if kv_src is not None or not cross:
        src = kv_src if kv_src is not None else x
        k = unflatten(dense(src, wk), -1, (hk, dh))
        v = unflatten(dense(src, wv), -1, (hk, dh))
        k = constrain(k, "batch", None, "kv_heads", None)
        v = constrain(v, "batch", None, "kv_heads", None)
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
            write_along(cache["k"], 1, idx,
                        (kq if quant else k).to(cache["k"].dtype))
            write_along(cache["v"], 1, idx,
                        (vq if quant else v).to(cache["v"].dtype))
            write_along(cache["kv_pos"], 0, idx,
                        wpos.to(cache["kv_pos"].dtype))
            if quant:
                write_along(cache["k_s"], 1, idx, ks)
                write_along(cache["v_s"], 1, idx, vs)
            kv_pos = cache["kv_pos"]
        else:
            sl = slice(cache_pos, cache_pos + t)
            if cache_pos + t > s:
                raise ValueError(f"cache of {s} positions cannot take "
                                 f"{t} more at {cache_pos}")
            write_along(cache["k"], 1, sl,
                        (kq if quant else k).to(cache["k"].dtype))
            write_along(cache["v"], 1, sl,
                        (vq if quant else v).to(cache["v"].dtype))
            if quant:
                write_along(cache["k_s"], 1, sl, ks)
                write_along(cache["v_s"], 1, sl, vs)
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

    out = _attend(q, k, v, q_pos, kv_pos, causal=causal, window=window,
                  dtype=x.dtype, q_chunk=q_chunk if t > q_chunk else None)
    out = dense(flatten(out, 2), wo)
    return constrain(out, "batch", None, None), out_cache


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
    k = unflatten(dense(src, p["wk"]), -1, (hk, dh))
    v = unflatten(dense(src, p["wv"]), -1, (hk, dh))
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
        h = F.silu(dense(x, constrain(p["wg"], None, "mlp_compute"))) \
            * dense(x, constrain(p["wu"], None, "mlp_compute"))
        h = constrain(h, "batch", None, "mlp_act")
        return dense(h, constrain(p["wd"], "mlp_compute", None))
    h = dense(x, constrain(p["w1"], None, "mlp_compute"))
    if cfg.mlp_type == "relu2":   # nemotron / minitron squared-ReLU
        h = torch.relu(h).square()
    else:  # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h, approximate="tanh")
    h = constrain(h, "batch", None, "mlp_act")
    return dense(h, constrain(p["w2"], "mlp_compute", None))


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

    Tokens are split into G groups aligned with the data-parallel axis; each
    expert takes its first C assigned tokens a group (C = Sg*k/E *
    capacity_factor); tokens over capacity fall through the residual. G
    comes from the token count (``_auto_groups(b*t)``) unless
    ``cfg.moe_groups`` fixes it, so a prefill and a decode step route alike
    only when no token is dropped (``capacity_factor = E/k``).

    Two paths with the same math, as the reference's:
      - expert parallel (``use_sm``: a shard context on a DeviceMesh whose
        data-parallel axes of ``moe_group`` include a sharded "data", with E
        a multiple of the "data" size and G of the data-parallel size): a
        per-rank function (``dist.sharding.shard_map``) routes, gathers and
        scatters its own groups; the group-to-expert transpose and back are
        ``all_to_all_single`` over "data", so each rank runs the FFN of its
        own experts. The capacity is padded to a multiple of "model", whose
        ranks each ship C/n_model slots and run the whole per-expert FFN
        (the weights gathered over "model" where ``expert_mlp`` maps
        there); the partial outputs are summed over "model".
      - otherwise the plain grouped dispatch, with the reference's hints.
    """
    b, t, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    s = b * t
    g = cfg.moe_groups or _auto_groups(s)
    sg = s // g
    cap = max(4, int(sg * k / e * cfg.capacity_factor))
    cap = min(cap, sg)

    ctx = current_ctx()
    dp: tuple = ()
    n_data = n_model = 1
    shape: dict = {}
    if ctx is not None and not isinstance(ctx[0], AbstractMesh):
        mesh, rules = ctx
        shape = mesh_shape(mesh)
        dpr = rules.get("moe_group")
        if dpr:
            dp = (dpr,) if isinstance(dpr, str) else tuple(dpr)
            dp = tuple(a for a in dp if shape.get(a, 1) > 1)
        n_data = shape.get("data", 1)
        n_model = shape.get("model", 1)
    use_sm = bool(dp and "data" in dp and e % n_data == 0
                  and g % axis_size(mesh, dp) == 0)

    if not use_sm:
        xs = constrain(x.reshape(g, sg, d), "moe_group", None, None)
        sel, weight, _ = _moe_route(p, xs, cfg, cap)
        gath = _moe_gather(xs, sel)
        gath = constrain(gath, None, "experts_act", None, None)
        out_e = _moe_ffn(p["wg"], p["wu"], p["wd"], gath, weight)
        out_e = constrain(out_e, None, "experts_act", None, None)
        out = _moe_scatter(sel, out_e, sg)
        out = constrain(out, "moe_group", None, None)
        return out.reshape(b, t, d)
    return _moe_expert_parallel(p, x, cfg, sg, cap, ctx, dp, n_model)


def _moe_expert_parallel(p, x, cfg: ModelConfig, sg: int, cap: int, ctx,
                         dp: tuple, n_model: int):
    """The expert-parallel dispatch (reference ``transformer.py:509-564``).

    Each rank takes its rows of ``x`` (B, T, D) and cuts them into its own
    groups of ``sg`` tokens: the groups of ``x.reshape(G, sg, D)`` that a
    split over the data-parallel ranks gives it.
    """
    mesh, rules = ctx
    d = x.shape[-1]
    dp_spec = dp if len(dp) > 1 else dp[0]
    # pad capacity to a multiple of the model axis: the capacity dim of the
    # dispatch tensors splits over 'model' (each model rank ships C/n_model
    # slots), so the expert FFN runs with WHOLE per-expert weights; only the
    # combined output is summed over 'model'
    cap_pad = -(-cap // n_model) * n_model
    mlp_axis = rules.get("expert_mlp")
    gather_w = mlp_axis == "model" and n_model > 1
    data = mesh.get_group("data")
    model = mesh.get_group("model") if n_model > 1 else None

    def local_fn(x_blk, router, wg, wu, wd):
        # x_blk (B_loc, T, D) -> xs_blk (G_loc, Sg, D); wg/wu/wd E-sharded
        # over 'data'
        xs_blk = x_blk.reshape(-1, sg, d)
        if gather_w:  # reassemble this layer's expert FFN weights
            wg = all_gather(wg, model, axis=2)
            wu = all_gather(wu, model, axis=2)
            wd = all_gather(wd, model, axis=1)
        sel, weight, _ = _moe_route({"router": router}, xs_blk, cfg, cap)
        if cap_pad != cap:  # pad with weight-0 slots pointing at token 0
            sel = F.pad(sel, (0, cap_pad - cap))
            weight = F.pad(weight, (0, cap_pad - cap))
        c_loc = cap_pad // n_model
        ridx = mesh.get_local_rank("model") if n_model > 1 else 0
        sel_l = sel[:, :, ridx * c_loc:(ridx + 1) * c_loc]
        w_l = weight[:, :, ridx * c_loc:(ridx + 1) * c_loc]
        gath = _moe_gather(xs_blk, sel_l)                   # (G_loc, E, Cl, D)
        # group -> expert transpose (all-to-all over 'data')
        gath = all_to_all(gath, data, split_axis=1, concat_axis=0)
        w_a2a = all_to_all(w_l, data, split_axis=1, concat_axis=0)
        out_e = _moe_ffn(wg, wu, wd, gath, w_a2a)        # (G_pod, E_loc, Cl, D)
        # expert -> group transpose back
        out_e = all_to_all(out_e, data, split_axis=0, concat_axis=1)
        return _moe_scatter(sel_l, out_e, sg).reshape(x_blk.shape)

    fn = shard_map(
        local_fn, mesh,
        in_specs=(pspec(dp_spec, None, None), pspec(None, None),
                  pspec("data", None, mlp_axis), pspec("data", None, mlp_axis),
                  pspec("data", mlp_axis, None)),
        out_specs=pspec(dp_spec, None, None),
        sum_over=("model",) if n_model > 1 else ())
    return fn(x, p["router"], p["wg"], p["wu"], p["wd"])
