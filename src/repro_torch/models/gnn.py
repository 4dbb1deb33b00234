"""GNN models: Cluster-GCN and Batched GIN (paper §6.1 benchmarks).

Four paths share one parameter dict:

  fp32_dense — dense-adjacency fp32 matmuls (the "DGL dense" baseline),
               fake-quantized for QAT with ``fake_bits=True``
  fp32_csr   — gather / ``index_add_`` aggregation over the edge list (the
               DGL/PyG scatter-kernel analogue)
  qgtc       — the paper's path: binary adjacency, any-bit quantized
               activations and weights, integer bit-serial GEMMs with float
               rescale epilogues (Algorithm 1 + §4.5). Hidden layers
               requantize; only the final layer emits full precision.
  int_bitserial — the training twin of qgtc (``forward_int``): the same
               integer forward, differentiable (``api.nn.qlinear_train`` /
               ``qgraph_conv_train``, STE backward, optional quantized
               gradients and stochastic rounding), over a batch's cached
               ``train.intpath.IntBatchArtifacts``.

The qgtc path is built from ``repro_torch.api.nn`` (``qlinear`` /
``qgraph_conv``), which dispatch through the backend registry: pick the
engine with ``with repro_torch.api.use("popcount"): ...`` or pass
``backend=``/``policy=`` to ``forward_qgtc``.

``forward_int`` carries the reference's sharding hint
``constrain(u, "gnn_nodes", None)``: the identity on the plain tensors of a
batch, so under a ``shard_ctx`` the bit-serial kernels run on whole local
tensors and give the forward's logits bit for bit.

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
from repro_torch.core.quantize import calibrate, fake_quant, quantize
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import constrain

__all__ = ["GNNConfig", "init_params", "forward", "forward_int",
           "forward_qgtc", "quantize_params"]


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
            path: str = "fp32_dense", fake_bits: bool = False, **int_kw):
    """fp32 forward, fake-quantized for QAT when ``fake_bits``.

    ``adj_or_edges`` is the dense 0/1 adjacency for ``fp32_dense`` and the
    (2, E) -1-padded edge list for ``fp32_csr``; inv_deg is (N, 1).
    ``path="int_bitserial"`` is :func:`forward_int`: ``adj_or_edges`` is
    then an ``IntBatchArtifacts`` (``x`` and ``inv_deg`` are unused) and
    ``int_kw`` carries grad_bits/stochastic/generator/backend/policy. The
    fake-quant path quantizes where the integer paths do, the requant of
    ``u`` before the aggregation included, so both compute the same
    function up to GEMM rounding.
    """
    if path == "int_bitserial":
        return forward_int(params, adj_or_edges, cfg, **int_kw)
    if path not in ("fp32_dense", "fp32_csr"):
        raise ValueError(f"path must be fp32_dense, fp32_csr or "
                         f"int_bitserial, got {path!r}")
    agg = _aggregate_dense if path == "fp32_dense" else _aggregate_csr
    h = x
    for l in range(cfg.layers):
        p = params[f"layer{l}"]
        if fake_bits:
            h = fake_quant(h, cfg.x_bits)
        if cfg.model == "gin":
            w1 = fake_quant(p["w1"], cfg.w_bits) if fake_bits else p["w1"]
            w2 = fake_quant(p["w2"], cfg.w_bits) if fake_bits else p["w2"]
            a = agg(adj_or_edges, h, inv_deg) + p["eps"] * h
            if fake_bits:
                a = fake_quant(a, cfg.x_bits)
            h = torch.relu(a @ w1 + p["b1"])
            if fake_bits:
                h = fake_quant(h, cfg.x_bits)
            h = h @ w2 + p["b2"]
        else:  # cluster-GCN: update THEN aggregate (paper §6.2)
            w = fake_quant(p["w"], cfg.w_bits) if fake_bits else p["w"]
            u = h @ w + p["b"]
            if fake_bits:
                # the integer paths aggregate QUANTIZED u: fake-quant here
                # too, so QAT trains the function they run
                u = fake_quant(u, cfg.x_bits)
            h = agg(adj_or_edges, u, inv_deg)
        if l != cfg.layers - 1:
            h = torch.relu(h)
    return h


# ----------------------------------------------------------- training int path

def forward_int(params: dict, art, cfg: GNNConfig, *, grad_bits: int = 0,
                stochastic: bool = False, generator=None, backend=None,
                policy=None):
    """Differentiable integer forward over a batch's cached artifacts.

    The float-parameter twin of :func:`forward_qgtc`: the layers quantize
    the weights per call (autograd reaches them through the STE), the
    activations flow quantized through the bit-serial GEMMs, and the
    aggregation runs over ``art``'s diagonal blocks plus the cross-block
    remainder. Layer 0 takes the features ``art`` quantized once.
    ``grad_bits > 0`` quantizes the backward GEMMs too; ``stochastic``
    rounds stochastically, drawing every layer's noise from ``generator``.
    """
    if cfg.model != "gcn":
        raise NotImplementedError(
            "int_bitserial training path covers cluster-GCN; GIN still "
            "trains via the fake-quant path (its eps-weighted self term "
            "needs a float epilogue the train kernels do not fuse yet)")
    kw = dict(x_bits=cfg.x_bits, grad_bits=grad_bits, stochastic=stochastic,
              generator=generator, backend=backend, policy=policy)
    h = (art.xq, art.qpx)
    for l in range(cfg.layers):
        p = params[f"layer{l}"]
        u = qnn.qlinear_train(h, p["w"], p["b"], w_bits=cfg.w_bits, **kw)
        u = constrain(u, "gnn_nodes", None)
        h = qnn.qgraph_conv_train(u, art, **kw)
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
