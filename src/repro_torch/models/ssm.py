"""Attention-free sequence mixers: RWKV6 (Finch) and Mamba2 (SSD), as the
reference's ``repro.models.ssm``.

Both come in two equivalent forms sharing one parameter dict:

  chunked  — prefill: the sequence is cut into fixed chunks; the
             intra-chunk part is a masked matmul with log-domain pairwise
             decay (every exp() argument is <= 0, so it cannot overflow for
             any data-dependent decay), and the inter-chunk part is a state
             recurrence, here a Python loop over the chunks.
  step     — decode: O(1) per-token recurrent update.

The sequential forms (``gla_sequential``/``ssd_sequential``) are the
token-by-token oracles: chunked == sequential to float32 tolerance.

RWKV6 semantics (exclusive + bonus):   o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
                                       S_t = diag(w_t) S_{t-1} + k_t v_t^T
Mamba2/SSD semantics (inclusive):      S_t = a_t S_{t-1} + B_t (dt_t x_t)^T
                                       y_t = C_t . S_t + D x_t
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (AbstractMesh, current_ctx, is_sharded,
                                       join_along, logical_spec, reduce_like,
                                       shard_map, split_along, split_product)
from repro_torch.models.layers import (Initializer, constrain, layer_norm,
                                       rms_norm)

__all__ = [
    "gla_chunked", "gla_chunks_batched", "gla_sequential", "gla_step",
    "ssd_chunked", "ssd_chunks_batched", "ssd_sequential", "ssd_step",
    "init_rwkv6_block", "rwkv6_block", "rwkv6_block_step", "rwkv6_state",
    "init_mamba2_block", "mamba2_block", "mamba2_block_step", "mamba2_state",
]

F32 = torch.float32


# =====================================================================
# GLA-style chunked linear attention with per-channel decay (RWKV6 core)
# =====================================================================

def gla_chunked(r, k, v, lw, u, s0, chunk: int = 32):
    """Per-channel-decay linear attention, chunked parallel form.

    r, k, v, lw: (B, T, H, K) float32; lw = log decay, <= 0. u: (H, K)
    bonus. s0: (B, H, K, V) initial state. Returns (out (B, T, H, V),
    s_final).
    """
    b, t, h, kk = r.shape
    vv = v.shape[-1]
    t0 = t
    pad = (-t) % chunk
    if pad:
        # neutral padding: k=0 (no state contribution), lw=0 (no decay)
        r, k, v, lw = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (r, k, v, lw))
        t = t + pad
    nc = t // chunk

    def to_chunks(x):
        # (B, T, H, X) -> (NC, B, H, L, X)
        return x.reshape(b, nc, chunk, h, -1).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = map(to_chunks, (r, k, v, lw))
    # strict lower triangle: s < t
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    tmask = tri[None, None, :, :, None]
    s = s0
    outs = []
    for i in range(nc):
        r_c, k_c, v_c, lw_c = rc[i], kc[i], vc[i], lwc[i]   # (B, H, L, K/V)
        a = torch.cumsum(lw_c, dim=2)   # inclusive cumsum, <= 0, decreasing
        a_prev = a - lw_c               # exclusive cumsum (a_{t-1})
        # inter-chunk: o_t += (r_t * exp(a_{t-1})) @ S0        [exp arg <= 0]
        o_inter = torch.einsum("bhlk,bhkv->bhlv", r_c * torch.exp(a_prev), s)
        # intra-chunk: score[t,s] = sum_k r_t k_s exp(a_{t-1,k} - a_{s,k}),
        # s < t; masked entries are zeroed before exp
        d = a_prev[:, :, :, None, :] - a[:, :, None, :, :]   # (B,H,L,L,K)
        p = torch.where(tmask, torch.exp(torch.where(tmask, d, 0.0)), 0.0)
        p = p * k_c[:, :, None, :, :]
        scores = torch.einsum("bhlk,bhlmk->bhlm", r_c, p)
        bonus = (r_c * u[None, :, None, :] * k_c).sum(-1)     # diagonal term
        o = o_inter + scores @ v_c + bonus[..., None] * v_c
        # state to chunk end: exp(a_L) . S0 + sum_s exp(a_L - a_s) k_s v_s^T
        rest = torch.exp(a[:, :, -1:, :] - a)                  # (B,H,L,K) <= 1
        s = s * torch.exp(a[:, :, -1, :])[..., None] + torch.einsum(
            "bhlk,bhlv->bhkv", k_c * rest, v_c)
        outs.append(o)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, t, h, vv)
    return out[:, :t0], s


def gla_chunks_batched(r, k, v, lw, u, s0, chunk: int = 32):
    """``gla_chunked`` with every chunk's own work as one batched op.

    The same formulas element for element; the intra-chunk scores, the
    bonus and each chunk's contribution to the state are computed for all
    chunks at once, and only the state recurrence is a loop (two ops a
    chunk), whose states then meet the queries in one batched product. A
    sequence of ``nc`` chunks takes O(1) ops plus 2 * ``nc``, where
    ``gla_chunked`` takes about 25 * ``nc``; it holds every chunk's
    (L, L, K) decay tensor at once. The per-rank scan on a mesh (``_scan``)
    runs this form.
    """
    b, t, h, kk = r.shape
    vv = v.shape[-1]
    t0 = t
    pad = (-t) % chunk
    if pad:
        r, k, v, lw = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (r, k, v, lw))
        t = t + pad
    nc = t // chunk

    def to_chunks(x):
        return x.reshape(b, nc, chunk, h, -1).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = map(to_chunks, (r, k, v, lw))        # (NC,B,H,L,X)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    tmask = tri[:, :, None]
    a = torch.cumsum(lwc, dim=3)
    a_prev = a - lwc
    d = a_prev[..., :, None, :] - a[..., None, :, :]        # (NC,B,H,L,L,K)
    p = torch.where(tmask, torch.exp(torch.where(tmask, d, 0.0)), 0.0)
    p = p * kc[..., None, :, :]
    scores = torch.einsum("cbhlk,cbhlmk->cbhlm", rc, p)
    bonus = (rc * u[None, None, :, None, :] * kc).sum(-1)
    rest = torch.exp(a[..., -1:, :] - a)
    decay = torch.exp(a[..., -1, :])[..., None]              # (NC,B,H,K,1)
    adds = torch.einsum("cbhlk,cbhlv->cbhkv", kc * rest, vc)
    s, starts = s0, []
    for dec_i, add_i in zip(decay.unbind(0), adds.unbind(0)):
        starts.append(s)
        s = s * dec_i + add_i
    o_inter = torch.einsum("cbhlk,cbhkv->cbhlv", rc * torch.exp(a_prev),
                           torch.stack(starts))
    o = o_inter + scores @ vc + bonus[..., None] * vc
    out = o.permute(1, 0, 3, 2, 4).reshape(b, t, h, vv)
    return out[:, :t0], s


def gla_sequential(r, k, v, lw, u, s0):
    """Token-by-token oracle for gla_chunked."""
    s, outs = s0, []
    for i in range(r.shape[1]):
        o, s = gla_step(r[:, i], k[:, i], v[:, i], lw[:, i], u, s)
        outs.append(o)
    return torch.stack(outs, dim=1), s


def gla_step(r_t, k_t, v_t, lw_t, u, s):
    """One decode step. r_t..lw_t: (B, H, K); s: (B, H, K, V)."""
    kv = k_t[..., :, None] * v_t[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", r_t, s) + torch.einsum(
        "bhk,bhkv->bhv", r_t * u[None], kv)
    s = torch.exp(lw_t)[..., None] * s + kv
    return o, s


# =====================================================================
# SSD: chunked scan with per-head scalar decay (Mamba2 core)
# =====================================================================

def ssd_chunked(x, a_log, B, C, s0, chunk: int = 128):
    """Mamba2 SSD, chunked parallel form.

    x: (B, T, H, P) pre-scaled by dt; a_log: (B, T, H) log decay <= 0;
    B, C: (B, T, H, N) (groups already broadcast to heads);
    s0: (B, H, N, P). Returns (y (B,T,H,P), s_final). Inclusive semantics.
    """
    b, t, h, p = x.shape
    n = B.shape[-1]
    t0 = t
    pad = (-t) % chunk
    if pad:
        # neutral padding: B=0 (no state contribution), a_log=0 (no decay)
        x, B, C = (F.pad(z, (0, 0, 0, 0, 0, pad)) for z in (x, B, C))
        a_log = F.pad(a_log, (0, 0, 0, pad))
        t = t + pad
    nc = t // chunk

    xc = x.reshape(b, nc, chunk, h, p).permute(1, 0, 3, 2, 4)
    Bc = B.reshape(b, nc, chunk, h, n).permute(1, 0, 3, 2, 4)
    Cc = C.reshape(b, nc, chunk, h, n).permute(1, 0, 3, 2, 4)
    ac = a_log.reshape(b, nc, chunk, h).permute(1, 0, 3, 2)   # (NC,B,H,L)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))             # s <= t
    tmask = tri[None, None]
    s = s0
    ys = []
    for i in range(nc):
        x_c, b_c, c_c, a_c = xc[i], Bc[i], Cc[i], ac[i]
        ca = torch.cumsum(a_c, dim=2)                 # (B,H,L) inclusive
        # inter: y_t += exp(ca_t) * C_t @ S0
        y_inter = torch.einsum("bhln,bhnp->bhlp", c_c, s) \
            * torch.exp(ca)[..., None]
        # intra: score[t,s] = exp(ca_t - ca_s) * (C_t . B_s), s <= t
        d = ca[:, :, :, None] - ca[:, :, None, :]     # <= 0 on the mask
        w = torch.where(tmask, torch.exp(torch.where(tmask, d, 0.0)), 0.0)
        scores = torch.einsum("bhln,bhmn->bhlm", c_c, b_c) * w
        y = y_inter + scores @ x_c
        rest = torch.exp(ca[:, :, -1:] - ca)           # (B,H,L) <= 1
        s = s * torch.exp(ca[:, :, -1])[..., None, None] + torch.einsum(
            "bhln,bhlp->bhnp", b_c * rest[..., None], x_c)
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, t, h, p)
    return y[:, :t0], s


def ssd_chunks_batched(x, a_log, B, C, s0, chunk: int = 128):
    """``ssd_chunked`` with every chunk's own work as one batched op, for
    the single group's B, C (B, T, N), which every head shares.

    The same formulas element for element, batched over the chunks as in
    ``gla_chunks_batched``: only the state recurrence is a loop. ``C . B``
    is computed once for all heads (each head's is the same dot product)
    and each head applies its own decay.
    """
    b, t, h, p = x.shape
    n = B.shape[-1]
    t0 = t
    pad = (-t) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        B, C = (F.pad(z, (0, 0, 0, pad)) for z in (B, C))
        a_log = F.pad(a_log, (0, 0, 0, pad))
        t = t + pad
    nc = t // chunk

    xc = x.reshape(b, nc, chunk, h, p).permute(1, 0, 3, 2, 4)  # (NC,B,H,L,P)
    Bc = B.reshape(b, nc, chunk, n).transpose(0, 1)            # (NC,B,L,N)
    Cc = C.reshape(b, nc, chunk, n).transpose(0, 1)
    ac = a_log.reshape(b, nc, chunk, h).permute(1, 0, 3, 2)   # (NC,B,H,L)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))             # s <= t
    ca = torch.cumsum(ac, dim=3)
    d = ca[..., :, None] - ca[..., None, :]
    w = torch.where(tri, torch.exp(torch.where(tri, d, 0.0)), 0.0)
    cb = torch.einsum("cbln,cbmn->cblm", Cc, Bc)
    y_intra = (cb[:, :, None] * w) @ xc
    rest = torch.exp(ca[..., -1:] - ca)                        # (NC,B,H,L)
    decay = torch.exp(ca[..., -1])[..., None, None]           # (NC,B,H,1,1)
    adds = torch.einsum("cbhln,cbhlp->cbhnp",
                        Bc[:, :, None] * rest[..., None], xc)
    s, starts = s0, []
    for dec_i, add_i in zip(decay.unbind(0), adds.unbind(0)):
        starts.append(s)
        s = s * dec_i + add_i
    y_inter = torch.einsum("cbln,cbhnp->cbhlp", Cc, torch.stack(starts)) \
        * torch.exp(ca)[..., None]
    y = (y_inter + y_intra).permute(1, 0, 3, 2, 4).reshape(b, t, h, p)
    return y[:, :t0], s


def ssd_sequential(x, a_log, B, C, s0):
    """Token-by-token oracle for ssd_chunked."""
    s, ys = s0, []
    for i in range(x.shape[1]):
        y, s = ssd_step(x[:, i], a_log[:, i], B[:, i], C[:, i], s)
        ys.append(y)
    return torch.stack(ys, dim=1), s


def ssd_step(x_t, a_t, b_t, c_t, s):
    """x_t (B,H,P); a_t (B,H); b_t,c_t (B,H,N); s (B,H,N,P)."""
    s = torch.exp(a_t)[..., None, None] * s + b_t[..., :, None] * x_t[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", c_t, s)
    return y, s


# =====================================================================
# the scans on a mesh
# =====================================================================

def _on_mesh(x) -> bool:
    """Whether ``x`` is a DTensor under a shard context on a DeviceMesh
    (not an ``AbstractMesh``): the blocks then run their per-rank forms."""
    ctx = current_ctx()
    return ctx is not None and not isinstance(ctx[0], AbstractMesh) \
        and is_sharded(x)


def _scan(scan, per_rank, args, names, state_at: int):
    """``scan(*args)`` -> (out (B, T, H, X), final state); on a mesh,
    ``per_rank`` on each rank's shards. A decode step (``gla_step``,
    ``ssd_step``: out (B, H, X)) runs the same way, itself per rank.

    Off a mesh (no shard context, an ``AbstractMesh``, or no DTensor among
    ``args``) it is ``scan(*args)``. Under a shard context with DTensor
    inputs the whole chunked scan runs as one per-rank function
    (``shard_map``): each argument ``args[i]`` takes the spec its logical
    ``names[i]`` resolve to (batch rows over the rules' "batch", heads over
    the mesh axes that hold "heads"; ``None`` names for inputs every head
    shares, which stay replicated), the output the spec of ``args[0]`` and
    the final state the spec of the initial one, ``args[state_at]``. The
    scan is independent per (batch row, head), so no sum is needed, and
    the DTensor ops a layer issues no longer grow with the sequence's
    number of chunks. ``per_rank`` is the chunk-batched form of ``scan``,
    so that its own ops grow by two a chunk, not by some 25.
    """
    if not any(map(_on_mesh, args)):
        return scan(*args)
    mesh, rules = current_ctx()
    specs = tuple(logical_spec(mesh, rules, n, x.shape)
                  for x, n in zip(args, names, strict=True))
    return shard_map(per_rank, mesh, in_specs=specs,
                     out_specs=(specs[0], specs[state_at]))(*args)


# =====================================================================
# RWKV6 block (Finch): data-dependent decay time-mix + relu^2 channel-mix
# =====================================================================

RWKV_HEAD = 64
_DECAY_LORA = 64


def init_rwkv6_block(ini: Initializer, cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    h = d // RWKV_HEAD
    return {
        "ln1_w": ini.ones((d,), ("norm",)), "ln1_b": ini.zeros((d,), ("norm",)),
        "ln2_w": ini.ones((d,), ("norm",)), "ln2_b": ini.zeros((d,), ("norm",)),
        # token-shift lerp weights for r, k, v, w, g
        "mu": ini.zeros((5, d), (None, "embed")),
        # data-dependent decay (the Finch signature): lw = -exp(w0 + tanh(xw A) B)
        "w0": ini.normal((d,), ("embed",), scale=0.5),
        "wa": ini.normal((d, _DECAY_LORA), ("embed", None)),
        "wb": ini.normal((_DECAY_LORA, d), (None, "embed"), scale=0.01),
        "u": ini.normal((h, RWKV_HEAD), ("heads", None), scale=0.5),
        "wr": ini.normal((d, d), ("embed", "qkv")),
        "wk": ini.normal((d, d), ("embed", "qkv")),
        "wv": ini.normal((d, d), ("embed", "qkv")),
        "wg": ini.normal((d, d), ("embed", "qkv")),
        "wo": ini.normal((d, d), ("qkv", "embed")),
        "gn_w": ini.ones((d,), ("norm",)), "gn_b": ini.zeros((d,), ("norm",)),
        # channel mix (relu^2, hidden = d_ff)
        "mu_c": ini.zeros((2, d), (None, "embed")),
        "ck": ini.normal((d, f), ("embed", "mlp")),
        "cv": ini.normal((f, d), ("mlp", "embed")),
        "cr": ini.normal((d, d), ("embed", "embed2")),
    }


def rwkv6_state(cfg: ModelConfig, batch: int, dtype=F32, device=None,
                lead: tuple = ()) -> dict:
    d = cfg.d_model
    h = d // RWKV_HEAD
    lead = tuple(lead)
    return {
        "s": torch.zeros(lead + (batch, h, RWKV_HEAD, RWKV_HEAD), dtype=dtype,
                         device=device),
        "x_t": torch.zeros(lead + (batch, d), dtype=dtype, device=device),
        "x_c": torch.zeros(lead + (batch, d), dtype=dtype, device=device),
    }


def _shift(x, x_last):
    """Token shift: (B,T,D), (B,D) -> previous-token tensor (B,T,D)."""
    return torch.cat([x_last[:, None, :], x[:, :-1]], dim=1)


def _rwkv_time_mix(p, xn, xs, cfg):
    d = cfg.d_model
    h = d // RWKV_HEAD
    mu = p["mu"].to(F32)
    xr, xk, xv, xw, xg = (xn + mu[i] * (xs - xn) for i in range(5))
    shp = xn.shape[:-1]
    wr = constrain(p["wr"], None, "qkv_compute")
    wk = constrain(p["wk"], None, "qkv_compute")
    wv = constrain(p["wv"], None, "qkv_compute")
    wg = constrain(p["wg"], None, "qkv_compute")
    r = (xr @ wr.to(F32)).reshape(*shp, h, RWKV_HEAD)
    k = (xk @ wk.to(F32)).reshape(*shp, h, RWKV_HEAD)
    v = (xv @ wv.to(F32)).reshape(*shp, h, RWKV_HEAD)
    g = xg @ wg.to(F32)
    lw = -torch.exp(p["w0"].to(F32)
                    + torch.tanh(xw @ p["wa"].to(F32)) @ p["wb"].to(F32))
    return r, k, v, g, lw.reshape(*shp, h, RWKV_HEAD)


def _rwkv_out(p, wkv, g, cfg, dtype):
    """Per-head groupnorm -> silu(g) gate -> output proj."""
    b_shape = wkv.shape[:-2]
    mu = wkv.mean(-1, keepdim=True)
    var = wkv.var(-1, keepdim=True, correction=0)   # jnp.var: ddof 0
    o = ((wkv - mu) * torch.rsqrt(var + 1e-5)).reshape(*b_shape, cfg.d_model)
    o = o * p["gn_w"].to(F32) + p["gn_b"].to(F32)
    o = o * F.silu(g)
    wo = constrain(p["wo"], "qkv_compute", None)
    return (o @ wo.to(F32)).to(dtype)


def _rwkv_channel_mix(p, xn, xs):
    mu = p["mu_c"].to(F32)
    xk = xn + mu[0] * (xs - xn)
    xr = xn + mu[1] * (xs - xn)
    ck = constrain(p["ck"], None, "mlp_compute")
    cv = constrain(p["cv"], "mlp_compute", None)
    cr = constrain(p["cr"], None, "embed2_compute")
    kk = torch.relu(xk @ ck.to(F32)).square()
    kk = constrain(kk, "batch", None, "mlp_act") if kk.ndim == 3 else kk
    gate = torch.sigmoid(xr @ cr.to(F32))
    v = kk @ cv.to(F32)
    if v.ndim == 3:
        # the row-parallel product reduced into the gate's layout, its
        # gradient handed back whole over "model": the gate's product,
        # split over d_model, would hand it back split over d_model, and
        # cv's gradient kk^T @ g would gather kk at the whole FFN width
        v = reduce_like(v, gate)
    return gate * v


def _rwkv_block(p, x, cfg, chunk):
    """The chunked block and its decode state."""
    b, t, d = x.shape
    h = d // RWKV_HEAD
    dtype = x.dtype
    zero = torch.zeros((b, d), dtype=F32, device=x.device)
    xn = layer_norm(x, p["ln1_w"], p["ln1_b"]).to(F32)
    r, k, v, g, lw = _rwkv_time_mix(p, xn, _shift(xn, zero), cfg)
    s0 = torch.zeros((b, h, RWKV_HEAD, RWKV_HEAD), dtype=F32, device=x.device)
    seq = ("batch", None, "heads", None)
    c = min(chunk, t)
    wkv, s_fin = _scan(
        functools.partial(gla_chunked, chunk=c),
        functools.partial(gla_chunks_batched, chunk=c),
        (r, k, v, lw, p["u"].to(F32), s0),
        (seq, seq, seq, seq, ("heads", None), ("batch", "heads", None, None)),
        state_at=5)
    # the residual stream replicated over the tensor-parallel axis, as a
    # transformer block's output: the row-parallel products leave partial
    # sums, which DTensor would otherwise reduce-scatter along the sequence
    x = constrain(x + _rwkv_out(p, wkv, g, cfg, dtype), "batch", None, None)
    xn2 = layer_norm(x, p["ln2_w"], p["ln2_b"]).to(F32)
    x = x + _rwkv_channel_mix(p, xn2, _shift(xn2, zero)).to(dtype)
    x = constrain(x, "batch", None, None)
    return x, {"s": s_fin, "x_t": xn[:, -1], "x_c": xn2[:, -1]}


def rwkv6_block(p, x, cfg: ModelConfig, chunk: int = 32):
    """Prefill form. x: (B, T, D). Returns x'."""
    return _rwkv_block(p, x, cfg, chunk)[0]


def rwkv6_block_step(p, x, state, cfg: ModelConfig):
    """Decode step. x: (B, D). state: rwkv6_state. Returns (x', state')."""
    dtype = x.dtype
    xn = layer_norm(x[:, None], p["ln1_w"], p["ln1_b"])[:, 0].to(F32)
    r, k, v, g, lw = _rwkv_time_mix(p, xn, state["x_t"], cfg)
    tok = ("batch", "heads", None)
    wkv, s = _scan(gla_step, gla_step,
                   (r, k, v, lw, p["u"].to(F32), state["s"]),
                   (tok, tok, tok, tok, ("heads", None),
                    ("batch", "heads", None, None)), state_at=5)
    x = x + _rwkv_out(p, wkv, g, cfg, dtype)
    xn2 = layer_norm(x[:, None], p["ln2_w"], p["ln2_b"])[:, 0].to(F32)
    x = x + _rwkv_channel_mix(p, xn2, state["x_c"]).to(dtype)
    return x, {"s": s, "x_t": xn, "x_c": xn2}


# =====================================================================
# Mamba2 block (zamba2 backbone)
# =====================================================================

MAMBA_HEAD = 64  # P (head dim)
CONV_K = 4


def _mamba_dims(cfg: ModelConfig):
    d = cfg.d_model
    d_in = 2 * d
    nh = d_in // MAMBA_HEAD
    n = cfg.ssm_state
    conv_w = d_in + 2 * n  # conv over (x, B, C), single group
    return d, d_in, nh, n, conv_w


def init_mamba2_block(ini: Initializer, cfg: ModelConfig) -> dict:
    d, d_in, nh, n, conv_w = _mamba_dims(cfg)
    return {
        "ln_w": ini.ones((d,), ("norm",)),
        "in_proj": ini.normal((d, 2 * d_in + 2 * n + nh), ("embed", "mlp")),
        "conv_w": ini.normal((CONV_K, conv_w), (None, "mlp"), scale=0.5),
        "conv_b": ini.zeros((conv_w,), ("mlp",)),
        "a_log": ini.normal((nh,), ("heads",), scale=0.1),  # A = -exp(a_log)
        "d_skip": ini.ones((nh,), ("heads",)),
        "dt_bias": ini.zeros((nh,), ("heads",)),
        "norm_w": ini.ones((d_in,), ("norm",)),
        "out_proj": ini.normal((d_in, d), ("mlp", "embed")),
    }


def mamba2_state(cfg: ModelConfig, batch: int, dtype=F32, device=None,
                 lead: tuple = ()) -> dict:
    d, d_in, nh, n, conv_w = _mamba_dims(cfg)
    lead = tuple(lead)
    return {
        "s": torch.zeros(lead + (batch, nh, n, MAMBA_HEAD), dtype=dtype,
                         device=device),
        "conv": torch.zeros(lead + (batch, CONV_K - 1, conv_w), dtype=dtype,
                            device=device),
    }


def _segments(cfg) -> tuple:
    """The widths of in_proj's segments z, x, B, C and dt, in order; x, B
    and C (``[1:4]``) are the conv's."""
    d, d_in, nh, n, conv_w = _mamba_dims(cfg)
    return (d_in, d_in, n, n, nh)


def _mamba_ssm(p, x, dt, cfg):
    """The SSD's inputs from x (..., d_in), after the conv's silu, and dt
    (..., nh)."""
    d, d_in, nh, n, conv_w = _mamba_dims(cfg)
    dt = F.softplus(dt + p["dt_bias"].to(F32))                 # (..., nh)
    a = -torch.exp(p["a_log"].to(F32))
    a_log_t = dt * a                                            # log decay <= 0
    shp = x.shape[:-1]
    xh = x.reshape(*shp, nh, MAMBA_HEAD) * dt[..., None]        # dt-scaled input
    return xh, a_log_t


def _causal_conv(xbc_pre, w, b):
    """The causal depthwise conv over time, kernel CONV_K, summed in the
    reference's order: (B, T, W) -> (output, the input padded with
    CONV_K - 1 zero steps in front)."""
    bsz, t, width = xbc_pre.shape
    pad = torch.zeros((bsz, CONV_K - 1, width), dtype=F32,
                      device=xbc_pre.device)
    xpad = torch.cat([pad, xbc_pre], dim=1)
    w = w.to(F32)
    return sum(xpad[:, i:i + t] * w[i] for i in range(CONV_K)) \
        + b.to(F32), xpad


def _to_heads(z, nh: int):
    """(..., N) -> (..., nh, N): the single group's B or C, every head's."""
    return z[..., None, :].expand(*z.shape[:-1], nh, z.shape[-1])


def _ssd_grouped(x, a_log, B, C, s0, chunk: int):
    """``ssd_chunked`` with B and C (B, T, N) of the single group,
    broadcast here to x's heads."""
    h = x.shape[2]
    return ssd_chunked(x, a_log, _to_heads(B, h), _to_heads(C, h), s0, chunk)


def _ssd_step_grouped(x_t, a_t, B, C, s):
    """``ssd_step`` with B and C (B, N) of the single group, broadcast here
    to x_t's heads."""
    h = x_t.shape[1]
    return ssd_step(x_t, a_t, _to_heads(B, h), _to_heads(C, h), s)


def _gated_rmsnorm(y, z, w):
    y = y * F.silu(z)
    # over heads split over the tensor-parallel axis the sum of squares is
    # a partial sum: reduced whole here (left to DTensor, it is scattered
    # along the sequence, and a mean's partial average cannot be
    # redistributed in backward); on the CPU sum / n is what mean computes
    ss = y.square().sum(-1, keepdim=True)
    if ss.ndim == 3:  # (B, T, 1); a decode step's (B, 1) is left as it was
        ss = constrain(ss, "batch", None, None)
    return y * torch.rsqrt(ss / y.shape[-1] + 1e-6) * w.to(F32)


def _mamba_block(p, x, cfg, chunk, state: bool = True):
    """The chunked block and (``state``) its decode state.

    On a mesh, in_proj's columns are split over "model" (``mlp_compute``)
    in shards that do not fall on the segments' boundaries. The weight's
    shard is put in grouped order by one all-to-all
    (``dist.sharding.split_product``), so that the product gives each rank
    its own columns of z, x, B, C and dt, taken locally; the conv runs per
    segment on the conv weights' pieces (one all-to-all each), B and C
    (every head's) are gathered by the scan, and the conv state is joined
    back into the cache's order by one all-to-all. Off a mesh: one
    product, its slices and one conv, as the reference (cutting the conv
    in three there would only add launches).
    """
    b, t, _ = x.shape
    d, d_in, nh, n, conv_w = _mamba_dims(cfg)
    dtype = x.dtype
    xn = rms_norm(x, p["ln_w"]).to(F32)
    w = constrain(p["in_proj"], None, "mlp_compute")
    if _on_mesh(w):
        seg = _segments(cfg)
        z, *pre, dt = split_product(xn, w, seg)
        convs = [_causal_conv(v, cw, cb) for v, cw, cb in zip(
            pre, split_along(p["conv_w"], 1, seg[1:4]),
            split_along(p["conv_b"], 0, seg[1:4]))]
        xs, B, C = (F.silu(c) for c, _ in convs)

        def conv_state():
            return join_along([xp[:, -(CONV_K - 1):] for _, xp in convs], -1)
    else:
        z, xbc_pre, dt = (xn @ w.to(F32)).split((d_in, conv_w, nh), -1)
        xbc, xpad = _causal_conv(xbc_pre, p["conv_w"], p["conv_b"])
        xs, B, C = F.silu(xbc).split((d_in, n, n), -1)

        def conv_state():
            # the last CONV_K - 1 pre-conv inputs
            return xpad[:, -(CONV_K - 1):]
    xh, a_log_t = _mamba_ssm(p, xs, dt, cfg)
    s0 = torch.zeros((b, nh, n, MAMBA_HEAD), dtype=F32, device=x.device)
    shared = ("batch", None, None)
    c = min(chunk, t)
    y, s_fin = _scan(
        functools.partial(_ssd_grouped, chunk=c),
        functools.partial(ssd_chunks_batched, chunk=c),
        (xh, a_log_t, B, C, s0),
        (("batch", None, "heads", None), ("batch", None, "heads"), shared,
         shared, ("batch", "heads", None, None)),
        state_at=4)
    y = y + p["d_skip"].to(F32)[:, None] * xh
    y = _gated_rmsnorm(y.reshape(b, t, d_in), z, p["norm_w"])
    wo = constrain(p["out_proj"], "mlp_compute", None)
    # the residual stream replicated over the tensor-parallel axis, as in
    # the rwkv6 block
    x = constrain(x + (y @ wo.to(F32)).to(dtype), "batch", None, None)
    return x, ({"s": s_fin, "conv": conv_state()} if state else None)


def mamba2_block(p, x, cfg: ModelConfig, chunk: int = 128):
    """Prefill form. x: (B, T, D)."""
    return _mamba_block(p, x, cfg, chunk, state=False)[0]


def mamba2_block_step(p, x, state, cfg: ModelConfig):
    """Decode step. x: (B, D). Returns (x', state').

    On a mesh the product's few rows are split per rank by two all-to-alls
    (``dist.sharding.split_along``): z, the conv's input and dt, the conv's
    input then in the natural order of the conv weights' and the cache's
    shards, so that the conv moves nothing; then x, B and C of its output.
    """
    b = x.shape[0]
    d, d_in, nh, n, conv_w = _mamba_dims(cfg)
    dtype = x.dtype
    xn = rms_norm(x[:, None], p["ln_w"])[:, 0].to(F32)
    z, xbc, dt = split_along(xn @ p["in_proj"].to(F32), -1,
                             (d_in, conv_w, nh))
    window = torch.cat([state["conv"], xbc[:, None]], dim=1)  # (B,K,W)
    xbc = torch.einsum("bkw,kw->bw", window, p["conv_w"].to(F32)) \
        + p["conv_b"].to(F32)
    xs, B, C = split_along(F.silu(xbc), -1, (d_in, n, n))
    xh, a_log_t = _mamba_ssm(p, xs, dt, cfg)
    y, s = _scan(_ssd_step_grouped, _ssd_step_grouped,
                 (xh, a_log_t, B, C, state["s"]),
                 (("batch", "heads", None), ("batch", "heads"),
                  ("batch", None), ("batch", None),
                  ("batch", "heads", None, None)), state_at=4)
    y = y + p["d_skip"].to(F32)[:, None] * xh
    y = _gated_rmsnorm(y.reshape(b, d_in), z, p["norm_w"])
    x = x + (y @ p["out_proj"].to(F32)).to(dtype)
    return x, {"s": s, "conv": window[:, 1:]}
