"""Functional quantized layers (the reference's ``repro.api.nn``).

  as_quantized       — normalize a layer input to (int values, QuantParams)
  qlinear            — s-bit activations x t-bit weights -> float x @ w
  qgraph_conv        — Â h aggregation: 1-bit adjacency x s-bit features
                       integer GEMM + dequant epilogue (Algorithm 1)
  qlinear_train      — qlinear as an autograd.Function: STE backward, its
                       two GEMMs integer too when grad_bits > 0
  qgraph_conv_train  — Â u over a batch's IntBatchArtifacts (blocked
                       diagonal GEMMs + edge remainder), differentiable
  blocked_agg_full   — the exact integer A @ v of those artifacts
  wq_linear          — float x @ weight-only-quantized W (+ bias)
  quantize_lm_params — weight-only quantize an LM's large projections

Every GEMM dispatches through ``repro_torch.api``, so
``with repro_torch.api.use("popcount"): ...`` switches the whole model.
"""
from __future__ import annotations

import torch

from repro_torch import api
from repro_torch.core.quantize import (QuantParams, affine_matmul_correction,
                                       calibrate, dequantize, quantize,
                                       quantize_stochastic)
from repro_torch.core.quantize import in_range as _in_range
from repro_torch.kernels import ops as kops

__all__ = ["as_quantized", "qlinear", "qgraph_conv", "qlinear_train",
           "qgraph_conv_train", "blocked_agg_full", "wq_linear",
           "quantize_lm_params"]


def as_quantized(x, nbits: int) -> tuple[torch.Tensor, QuantParams]:
    """A float tensor (calibrated and quantized here) or an already
    quantized ``(xq, QuantParams)`` pair -> the pair at ``nbits``.

    A pair of another bitwidth is rescaled through float, so the layer
    always computes at its configured precision.
    """
    if isinstance(x, tuple):
        xq, qp = x
        if not isinstance(qp, QuantParams):
            raise TypeError(
                f"pre-quantized input must be (xq, QuantParams), got "
                f"(..., {type(qp).__name__})")
        if qp.nbits == nbits:
            return xq, qp
        x = dequantize(xq, qp)
    qp = calibrate(x, nbits)
    return quantize(x, qp), qp


def qlinear(xq, qpx: QuantParams, wq, qpw: QuantParams, *, bias=None,
            relu: bool = False, backend=None, policy=None):
    """Integer GEMM of quantized activations x weights -> float x @ w.

    xq (M, K) unsigned qpx.nbits ints; wq (K, N) unsigned qpw.nbits ints.
    The exact int32 product is corrected by the rank-1 affine epilogue,
    then bias and relu are applied.
    """
    prod = api.bitserial_mm(xq, wq, qpx.nbits, qpw.nbits,
                            backend=backend, policy=policy)
    out = affine_matmul_correction(xq, wq, qpx, qpw, prod)
    if bias is not None:
        out = out + bias
    if relu:
        out = torch.relu(out)
    return out


def qgraph_conv(adj_bin, hq, qph: QuantParams, inv_deg, *, backend=None,
                policy=None, tiles=None):
    """Â h with Â = (D+I)^-1 (A+I) over quantized features (Algorithm 1).

    adj_bin (N, N) 0/1 int32 (no self loops); hq (N, D) unsigned
    qph.nbits ints; inv_deg (N, 1). ``tiles`` are precomputed zero-tile
    artifacts of the packed adjacency (compact triple or tagged sgt
    4-tuple) on the policy's grid.
    """
    cnt = api.bitserial_mm(adj_bin, hq, 1, qph.nbits,
                           backend=backend, policy=policy, tiles=tiles)
    deg = torch.sum(adj_bin, dim=1, keepdim=True).to(torch.float32)
    # dequant: sum_j h_j = scale * sum_j hq_j + deg * zero
    hf = hq.to(torch.float32) * qph.scale + qph.zero
    agg = cnt.to(torch.float32) * qph.scale + deg * qph.zero
    return (agg + hf) * inv_deg


def _backward_scope(ctx):
    """Re-enter, in a backward, the engine and policy the forward ran under.

    Autograd runs the backward of CUDA tensors on a thread of its own,
    where the caller's ``api.use`` context is not set; without this the
    backward GEMMs would run on the default engine and policy.
    """
    be, pol = ctx.scope
    return api.use(be.name, policy=pol)


def _quantize(x, qp, generator):
    """Stochastic rounding when the layer holds a generator, else floor."""
    if generator is None:
        return quantize(x, qp)
    return quantize_stochastic(x, qp, generator=generator)


class _QLinearTrain(torch.autograd.Function):
    """out = h @ w + b through the integer GEMM; ``opts`` is (x_bits,
    w_bits, grad_bits, generator or None, backend, policy)."""

    @staticmethod
    def forward(ctx, h, w, b, hq, qph, opts):
        x_bits, w_bits, _, gen, backend, policy = opts
        if hq is None:
            qph = calibrate(h, x_bits)
            hq = _quantize(h, qph, gen)
        qpw = calibrate(w, w_bits)
        # weights stay deterministically rounded: stochastic rounding
        # de-biases the per-step activation and gradient noise, not the
        # (stable) weight grid
        wq = quantize(w, qpw)
        prod = api.bitserial_mm(hq, wq, x_bits, w_bits, backend=backend,
                                policy=policy)
        ctx.save_for_backward(hq, wq, _in_range(h, qph), _in_range(w, qpw))
        ctx.qph, ctx.qpw, ctx.opts, ctx.scope = qph, qpw, opts, api.current()
        return affine_matmul_correction(hq, wq, qph, qpw, prod) + b

    @staticmethod
    def backward(ctx, g):
        with _backward_scope(ctx):
            return _QLinearTrain._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
        hq, wq, h_mask, w_mask = ctx.saved_tensors
        qph, qpw = ctx.qph, ctx.qpw
        x_bits, w_bits, grad_bits, gen, backend, policy = ctx.opts
        mm = dict(backend=backend, policy=policy)
        gh = None
        if grad_bits:
            # quantized backward (Tango): the cotangent is quantized too
            # (stochastically under SR) and both GEMMs run as integer
            # products with the forward's affine epilogue
            qpg = calibrate(g, grad_bits)
            gq = _quantize(g, qpg, gen)
            if ctx.needs_input_grad[0]:
                gh = affine_matmul_correction(
                    gq, wq.T, qpg, qpw,
                    api.bitserial_mm(gq, wq.T, grad_bits, w_bits, **mm))
            gw = affine_matmul_correction(
                hq.T, gq, qph, qpg,
                api.bitserial_mm(hq.T, gq, x_bits, grad_bits, **mm))
        else:
            # a float backward over the QUANTIZED operands: the fake-quant
            # path's gradients
            if ctx.needs_input_grad[0]:
                gh = g @ dequantize(wq, qpw).T
            gw = dequantize(hq, qph).T @ g
        if gh is not None:
            gh = torch.where(h_mask, gh, 0.0)
        gw = torch.where(w_mask, gw, 0.0)
        return gh, gw, torch.sum(g, dim=0), None, None, None


def qlinear_train(h, w, bias=None, *, x_bits=8, w_bits=8, grad_bits=0,
                  stochastic=False, generator=None, backend=None, policy=None):
    """Trainable integer linear: quantize -> bit-serial GEMM -> STE backward.

    The forward is :func:`qlinear`'s integer pipeline, calibrated per call
    (activations stochastically rounded when ``stochastic``). The backward
    gates the gradients on the forward's clip ranges; with ``grad_bits >
    0`` both of its GEMMs are integer bit-serial products over the
    quantized cotangent, else float GEMMs over the quantized operands,
    which are the fake-quant path's gradients. No gradient of ``h`` is
    computed where autograd needs none (a model's first layer).

    ``h`` is a float tensor or a pre-quantized ``(hq, QuantParams)`` pair
    (a batch's features, quantized once). ``stochastic=True`` draws from
    ``generator``, which it requires.
    """
    if stochastic and generator is None:
        raise ValueError("stochastic=True requires a generator")
    opts = (x_bits, w_bits, grad_bits, generator if stochastic else None,
            backend, policy)
    b = (torch.zeros(w.shape[-1], dtype=torch.float32, device=w.device)
         if bias is None else bias)
    if isinstance(h, tuple):
        hq, qph = as_quantized(h, x_bits)
        return _QLinearTrain.apply(dequantize(hq, qph), w, b, hq, qph, opts)
    return _QLinearTrain.apply(h, w, b, None, None, opts)


def _blocked_agg(adjb, row_idx, v, s, backend, policy, tiles, s_maxes):
    """Exact A @ v over the stacked diagonal blocks of a batch adjacency.

    ``adjb`` (B, P, P) holds the per-partition 0/1 diagonal blocks, each
    zero-padded to the shared block size P; ``row_idx`` (B, P) maps block
    rows to batch node ids (-1 padding). Cross-block edges are not here:
    callers add the ``edge_scatter_sum`` remainder. ``s == 0`` is the float
    path (a backward over an unquantized cotangent); otherwise each block
    is one 1-bit x s-bit ``api.bitserial_mm``, with the block's zero-tile
    compact artifacts ``tiles[b] = (idx, counts)`` and host-int
    ``s_maxes[b]`` when given.
    """
    n, d = v.shape
    valid = row_idx >= 0
    safe = row_idx.clamp(min=0).to(torch.int64)
    vb = torch.where(valid[..., None], v[safe], 0)  # (B, P, D) gather
    out = torch.zeros((n, d), dtype=v.dtype, device=v.device)
    for b in range(adjb.shape[0]):
        if s == 0:
            cnt = adjb[b].to(v.dtype) @ vb[b]
        else:
            t = ((tiles[b][0], tiles[b][1], s_maxes[b])
                 if tiles is not None else None)
            cnt = api.bitserial_mm(adjb[b], vb[b], 1, s, backend=backend,
                                   policy=policy, tiles=t)
        # block node sets are disjoint; the clamped -1 rows add zeros
        out.index_add_(0, safe[b], torch.where(valid[b][:, None], cnt, 0))
    return out


def blocked_agg_full(adjb, row_idx, rsrc, rdst, v, s, *, backend=None,
                     policy=None, tiles=None, s_maxes=None):
    """Exact ``A @ v`` for a decomposed batch adjacency: the diagonal blocks
    through :func:`_blocked_agg` (integer bit-serial when ``s > 0``) plus
    the -1-padded cross-block edge list through ``edge_scatter_sum``."""
    cnt = _blocked_agg(adjb, row_idx, v, s, backend, policy, tiles, s_maxes)
    return cnt + kops.edge_scatter_sum(v, rsrc, rdst, v.shape[0])


class _QGraphConvTrain(torch.autograd.Function):
    """(A + I) @ dequantize(quantize(u)) * inv_deg over ``art``'s blocks and
    remainder; ``opts`` is (x_bits, grad_bits, generator or None, backend,
    policy)."""

    @staticmethod
    def forward(ctx, u, art, opts):
        x_bits, _, gen, backend, policy = opts
        qpu = calibrate(u, x_bits)
        uq = _quantize(u, qpu, gen)
        cnt = blocked_agg_full(art.adjb, art.row_idx, art.rem_src, art.rem_dst,
                               uq, x_bits, backend=backend, policy=policy,
                               tiles=art.tiles, s_maxes=art.s_maxes)
        # dequant epilogue: sum_j u_dq[j] = scale*cnt + deg*zero; + self; scale
        out = (cnt.to(torch.float32) * qpu.scale + art.deg * qpu.zero
               + dequantize(uq, qpu)) * art.inv_deg
        ctx.save_for_backward(_in_range(u, qpu))
        ctx.art, ctx.opts, ctx.scope = art, opts, api.current()
        return out

    @staticmethod
    def backward(ctx, g):
        with _backward_scope(ctx):
            return _QGraphConvTrain._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
        (u_mask,) = ctx.saved_tensors
        art = ctx.art
        _, grad_bits, gen, backend, policy = ctx.opts
        gp = g * art.inv_deg
        # du = (A^T + I) @ (g * inv_deg), STE-masked. The transposed diagonal
        # blocks are the diagonal blocks of A^T, and the remainder's
        # transpose swaps src and dst, so the forward's artifacts serve.
        adjt = art.adjb.transpose(1, 2)
        if grad_bits:
            qpg = calibrate(gp, grad_bits)
            gq = _quantize(gp, qpg, gen)
            cnt = blocked_agg_full(adjt, art.row_idx, art.rem_dst, art.rem_src,
                                   gq, grad_bits, backend=backend,
                                   policy=policy)
            # the self term stays the float gp: free and exact
            gu = (cnt.to(torch.float32) * qpg.scale + art.deg_in * qpg.zero) + gp
        else:
            gu = blocked_agg_full(adjt, art.row_idx, art.rem_dst, art.rem_src,
                                  gp, 0, backend=backend, policy=policy) + gp
        return torch.where(u_mask, gu, 0.0), None, None


def qgraph_conv_train(u, art, *, x_bits=8, grad_bits=0, stochastic=False,
                      generator=None, backend=None, policy=None):
    """Trainable Â u aggregation over a batch's cached integer artifacts.

    ``art`` is a ``repro_torch.train.intpath.IntBatchArtifacts``: the batch
    adjacency decomposed once into per-partition diagonal blocks (1-bit
    GEMMs through ``api.bitserial_mm``, with optional zero-tile artifacts
    per block) and the cross-partition remainder as an edge list (integer
    gather/scatter). Their sum is bit for bit the dense ``adj @ uq``.

    The forward quantizes ``u`` per call (stochastically when
    ``stochastic``, which requires ``generator``); the backward is ``(A^T +
    I) @ (g * inv_deg)`` with the forward's STE mask, an integer
    aggregation of the quantized cotangent when ``grad_bits > 0``.
    """
    if stochastic and generator is None:
        raise ValueError("stochastic=True requires a generator")
    return _QGraphConvTrain.apply(
        u, art, (x_bits, grad_bits, generator if stochastic else None,
                 backend, policy))


def wq_linear(x, wq, *, bias=None, out_dtype=torch.bfloat16, backend=None,
              policy=None):
    """x (..., K) float @ weight-only-quantized W (K, N) + optional bias."""
    out = api.wq_mm(x, wq, out_dtype=out_dtype, backend=backend,
                    policy=policy)
    if bias is not None:
        out = (out + bias).to(out_dtype)
    return out


def quantize_lm_params(params, nbits: int = 4, min_size: int = 4096,
                       skip: tuple = ("embed",)):
    """Weight-only-quantize every large 2-D projection in a nested dict of
    tensors.

    Returns ``(params_q, stats)``: params_q has each eligible leaf replaced
    by its quantize->dequantize round trip (the W-nbits serving effect on a
    stock forward pass), and stats reports the packed footprint:
    {"n_quantized", "bytes_fp16", "bytes_packed", "ratio"}. A leaf's key is
    its path spelled as ``jax.tree_util.keystr`` spells it (``['layer0']['wq']``),
    so ``skip`` substrings pick the leaves they pick in the reference.
    """
    from repro_torch.core.qgemm import weight_dequantize, weight_quantize

    stats = {"n_quantized": 0, "bytes_fp16": 0, "bytes_packed": 0}

    def visit(key, leaf):
        if isinstance(leaf, dict):
            return {k: visit(f"{key}[{k!r}]", v) for k, v in leaf.items()}
        if (leaf.ndim != 2 or leaf.numel() <= min_size
                or any(s in key for s in skip)):
            return leaf
        wq = weight_quantize(leaf.to(torch.float32), nbits)
        stats["n_quantized"] += 1
        stats["bytes_fp16"] += leaf.numel() * 2
        stats["bytes_packed"] += leaf.numel() * nbits // 8 + wq.scale.numel() * 4
        return weight_dequantize(wq).to(leaf.dtype)

    params_q = visit("", params)
    stats["ratio"] = stats["bytes_fp16"] / max(stats["bytes_packed"], 1)
    return params_q, stats
