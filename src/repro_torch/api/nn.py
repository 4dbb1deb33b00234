"""Functional quantized layers (the reference's ``repro.api.nn``, inference part).

  as_quantized       — normalize a layer input to (int values, QuantParams)
  qlinear            — s-bit activations x t-bit weights -> float x @ w
  qgraph_conv        — Â h aggregation: 1-bit adjacency x s-bit features
                       integer GEMM + dequant epilogue (Algorithm 1)
  wq_linear          — float x @ weight-only-quantized W (+ bias)
  quantize_lm_params — weight-only quantize an LM's large projections

Every GEMM dispatches through ``repro_torch.api``, so
``with repro_torch.api.use("popcount"): ...`` switches the whole model.
"""
from __future__ import annotations

import torch

from repro_torch import api
from repro_torch.core.quantize import (QuantParams, affine_matmul_correction,
                                       calibrate, dequantize, quantize)

__all__ = ["as_quantized", "qlinear", "qgraph_conv", "wq_linear",
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
