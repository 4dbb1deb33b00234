"""GNN models: Cluster-GCN and Batched GIN (paper §6.1 benchmarks).

Three inference paths share one parameter dict:

  fp32_dense — dense-adjacency fp32 matmuls (the "DGL dense" baseline)
  fp32_csr   — gather / ``index_add_`` aggregation over the edge list (the
               DGL/PyG scatter-kernel analogue)
  qgtc       — the paper's path: binary adjacency, any-bit quantized
               activations and weights, integer bit-serial GEMMs with float
               rescale epilogues (Algorithm 1 + §4.5). Hidden layers
               requantize; only the final layer emits full precision.

The qgtc path is built from ``repro_torch.api.nn`` (``qlinear`` /
``qgraph_conv``), which dispatch through the backend registry: pick the
engine with ``with repro_torch.api.use("popcount"): ...`` or pass
``backend=``/``policy=`` to ``forward_qgtc``.

Model settings follow the paper: Cluster-GCN updates-then-aggregates
(X' = Â (X W), 3 layers, 16 hidden); GIN aggregates-then-updates with a
2-layer MLP (3 layers, 64 hidden). Parameters are a plain dict
``{"layer{l}": {"w": ..., "b": ...}}`` (GIN: w1, b1, w2, b2, eps), the
reference's pytree layout.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.api import nn as qnn
from repro_torch.core.quantize import calibrate, quantize
from repro_torch.device import resolve_device

__all__ = ["GNNConfig", "init_params", "forward", "forward_qgtc",
           "quantize_params"]


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    model: str = "gcn"  # gcn | gin
    in_dim: int = 128
    hidden: int = 16
    n_classes: int = 40
    layers: int = 3
    x_bits: int = 8  # activation bits (paper's s)
    w_bits: int = 8  # weight bits (paper's t)
    gin_eps: float = 0.0

    @staticmethod
    def paper_gcn(in_dim: int, n_classes: int, x_bits=8, w_bits=8) -> "GNNConfig":
        return GNNConfig("gcn", in_dim, 16, n_classes, 3, x_bits, w_bits)

    @staticmethod
    def paper_gin(in_dim: int, n_classes: int, x_bits=8, w_bits=8) -> "GNNConfig":
        return GNNConfig("gin", in_dim, 64, n_classes, 3, x_bits, w_bits)


def _glorot(shape, generator, device):
    s = (2.0 / (shape[0] + shape[-1])) ** 0.5
    return torch.randn(shape, generator=generator, dtype=torch.float32) \
        .mul_(s).to(device)


def init_params(cfg: GNNConfig, *, generator: torch.Generator | None = None,
                device=None) -> dict:
    """Random Glorot-normal weights and zero biases.

    The numbers come from ``generator`` on the CPU (a seeded
    ``torch.Generator`` gives the same weights on every device) and are
    then moved to ``device`` (None means the card).
    """
    dev = resolve_device(device)
    dims = [cfg.in_dim] + [cfg.hidden] * (cfg.layers - 1) + [cfg.n_classes]
    params = {}
    for l in range(cfg.layers):
        d_in, d_out = dims[l], dims[l + 1]
        if cfg.model == "gin":
            width = max(d_out, cfg.hidden)
            params[f"layer{l}"] = {
                "w1": _glorot((d_in, width), generator, dev),
                "b1": torch.zeros(width, device=dev),
                "w2": _glorot((width, d_out), generator, dev),
                "b2": torch.zeros(d_out, device=dev),
                "eps": torch.tensor(cfg.gin_eps, dtype=torch.float32, device=dev),
            }
        else:
            params[f"layer{l}"] = {
                "w": _glorot((d_in, d_out), generator, dev),
                "b": torch.zeros(d_out, device=dev),
            }
    return params


# ---------------------------------------------------------------- fp32 paths

def _aggregate_dense(adj_bin, h, inv_deg):
    """Â h with Â = (D+I)^-1 (A+I); adj_bin excludes self loops."""
    return (adj_bin.to(h.dtype) @ h + h) * inv_deg


def _aggregate_csr(edges, h, inv_deg):
    src, dst = edges[0].to(torch.int64), edges[1].to(torch.int64)
    valid = (src >= 0)[:, None]
    msgs = torch.where(valid, h[src.clamp(min=0)], 0.0)
    agg = torch.zeros_like(h).index_add_(0, dst.clamp(min=0), msgs)
    return (agg + h) * inv_deg


def forward(params: dict, adj_or_edges, x, inv_deg, cfg: GNNConfig,
            path: str = "fp32_dense"):
    """fp32 forward. ``adj_or_edges`` is the dense 0/1 adjacency for
    ``fp32_dense`` and the (2, E) -1-padded edge list for ``fp32_csr``;
    inv_deg is (N, 1)."""
    if path not in ("fp32_dense", "fp32_csr"):
        raise ValueError(f"path must be fp32_dense or fp32_csr, got {path!r}")
    agg = _aggregate_dense if path == "fp32_dense" else _aggregate_csr
    h = x
    for l in range(cfg.layers):
        p = params[f"layer{l}"]
        if cfg.model == "gin":
            a = agg(adj_or_edges, h, inv_deg) + p["eps"] * h
            h = torch.relu(a @ p["w1"] + p["b1"])
            h = h @ p["w2"] + p["b2"]
        else:  # cluster-GCN: update THEN aggregate (paper §6.2)
            h = agg(adj_or_edges, h @ p["w"] + p["b"], inv_deg)
        if l != cfg.layers - 1:
            h = torch.relu(h)
    return h


# ---------------------------------------------------------------- QGTC path

def quantize_params(params: dict, cfg: GNNConfig) -> dict:
    """Post-training weight quantization: int values + QuantParams per matrix."""
    out = {}
    for name, p in params.items():
        q = {}
        for k, v in p.items():
            if k.startswith("w"):
                qp = calibrate(v, cfg.w_bits)
                q[k] = (quantize(v, qp), qp)
            else:
                q[k] = v
        out[name] = q
    return out


def _requant(h, bits: int):
    qp = calibrate(h, bits)
    return quantize(h, qp), qp


def forward_qgtc(qparams: dict, adj_bin, x, inv_deg, cfg: GNNConfig, *,
                 backend=None, policy=None, tiles=None):
    """Integer-domain forward (serving path). adj_bin: (N,N) 0/1 int32.

    ``x`` is a float feature matrix (quantized here) or a pre-quantized
    ``(xq, QuantParams)`` pair. ``backend``/``policy`` override the active
    ``repro_torch.api`` context for every integer GEMM. ``tiles`` are
    precomputed zero-tile artifacts of the packed ``adj_bin``; they reach
    only the aggregation GEMMs, whose A operand is the adjacency.
    """
    mm = dict(backend=backend, policy=policy)
    hq, qph = qnn.as_quantized(x, cfg.x_bits)
    h = None
    for l in range(cfg.layers):
        p = qparams[f"layer{l}"]
        if cfg.model == "gin":
            a = qnn.qgraph_conv(adj_bin, hq, qph, inv_deg, tiles=tiles, **mm)
            hf = hq.to(torch.float32) * qph.scale + qph.zero
            a = a + p["eps"] * hf
            aq, qpa = _requant(a, cfg.x_bits)
            w1, qpw1 = p["w1"]
            u = qnn.qlinear(aq, qpa, w1, qpw1, bias=p["b1"], relu=True, **mm)
            uq, qpu = _requant(u, cfg.x_bits)
            w2, qpw2 = p["w2"]
            h = qnn.qlinear(uq, qpu, w2, qpw2, bias=p["b2"], **mm)
        else:
            w, qpw = p["w"]
            u = qnn.qlinear(hq, qph, w, qpw, bias=p["b"], **mm)
            uq, qpu = _requant(u, cfg.x_bits)
            h = qnn.qgraph_conv(adj_bin, uq, qpu, inv_deg, tiles=tiles, **mm)
        if l != cfg.layers - 1:
            h = torch.relu(h)
            hq, qph = _requant(h, cfg.x_bits)  # §4.5: requantize between layers
    return h
