"""Integer-path batch artifacts for QAT training (the ``int_bitserial`` path).

A Cluster-GCN batch concatenates ``batch_size`` partitions, so its
adjacency is almost block-diagonal: most edges lie inside the
per-partition diagonal blocks, and a sparse remainder crosses them. The
integer path decomposes the adjacency ONCE per batch into

  * stacked diagonal blocks ``adjb`` (B, P, P) with a row-id map
    ``row_idx`` (B, P): dense 1-bit integer GEMMs, about batch_size times
    fewer operations than the dense batch adjacency;
  * the cross-block remainder as a -1-padded edge list (integer
    gather/scatter, ``kernels.ops.edge_scatter_sum``);
  * row and column degrees (the backward runs the transpose), inv_deg, and
    the batch features quantized once (``xq, qpx``: layer 0's input carries
    no gradient);
  * optional per-block zero-tile compact artifacts (``(idx, counts)`` and a
    host-int ``s_max`` per block).

``blocked_aggregate(art, vq) == adj @ vq`` bit for bit: the decomposition
is exact. The host arrays are built with numpy exactly as the reference's
``repro.train.intpath`` builds them, then moved to ``device``. Shapes are
uniform across the batches of one (n_nodes, B, P, E_rem) bucket.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.quantize import QuantParams, calibrate, quantize
from repro_torch.device import resolve_device
from repro_torch.graph.batching import SubgraphBatch

__all__ = ["IntBatchArtifacts", "build_artifacts", "batch_caps",
           "blocked_aggregate", "ArtifactCache"]


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class IntBatchArtifacts:
    """Device-resident per-batch artifacts consumed by qgraph_conv_train."""

    adjb: torch.Tensor       # (B, P, P) int32 0/1 diagonal blocks
    row_idx: torch.Tensor    # (B, P) int32 node ids, -1 padded
    rem_src: torch.Tensor    # (E_rem,) int32 cross-block edges, -1 padded
    rem_dst: torch.Tensor    # (E_rem,) int32
    deg: torch.Tensor        # (N, 1) f32 row degrees of the FULL adjacency
    deg_in: torch.Tensor     # (N, 1) f32 column degrees (== deg if symmetric)
    inv_deg: torch.Tensor    # (N, 1) f32 1/(deg+1)
    xq: torch.Tensor         # (N, D) int32 pre-quantized features
    qpx: QuantParams
    tiles: tuple | None      # per-block ((idx, counts), ...) or None
    s_maxes: tuple | None    # per-block host-int tile-count bounds


def _block_sizes(batch: SubgraphBatch) -> np.ndarray:
    return (np.asarray(batch.part_sizes, np.int64)
            if batch.part_sizes is not None else np.array([batch.n_valid]))


def build_artifacts(batch: SubgraphBatch, x_bits: int, *,
                    block_pad: int | None = None,
                    rem_pad: int | None = None,
                    with_tiles: bool = False,
                    tile_shape: tuple[int, int] | None = None,
                    device=None) -> IntBatchArtifacts:
    """Decompose one host batch into integer-path artifacts on ``device``
    (None means the card).

    ``block_pad`` / ``rem_pad`` fix the padded block size P and the
    remainder's edge capacity: pass :func:`batch_caps` over all batches so
    that every batch has the same shapes. ``with_tiles`` also builds each
    block's zero-tile compact artifacts on the ``tile_shape`` grid
    (default: DEFAULT_POLICY's block_m/block_w).
    """
    dev = resolve_device(device)
    n = batch.n_nodes
    edges = np.asarray(batch.edges)
    src, dst = edges[0], edges[1]
    live = src >= 0
    adj = np.zeros((n, n), np.int32)
    adj[src[live], dst[live]] = 1

    sizes = _block_sizes(batch)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    p = int(block_pad) if block_pad is not None else _pad_to(
        max(int(sizes.max()), 1), 8)
    if p < int(sizes.max()):
        raise ValueError(f"block_pad={p} < largest partition {sizes.max()}")
    bcount = len(sizes)

    adjb = np.zeros((bcount, p, p), np.int32)
    row_idx = -np.ones((bcount, p), np.int32)
    in_block = np.zeros((n, n), bool)
    for b in range(bcount):
        lo, hi = int(offs[b]), int(offs[b + 1])
        adjb[b, :hi - lo, :hi - lo] = adj[lo:hi, lo:hi]
        row_idx[b, :hi - lo] = np.arange(lo, hi)
        in_block[lo:hi, lo:hi] = True

    rs, rd = np.nonzero(adj & ~in_block)
    cap = int(rem_pad) if rem_pad is not None else max(
        _pad_to(max(len(rs), 1), 64), 64)
    if cap < len(rs):
        raise ValueError(f"rem_pad={cap} < {len(rs)} cross-block edges")
    rem_src = -np.ones(cap, np.int32)
    rem_dst = -np.ones(cap, np.int32)
    # edge_scatter_sum gathers values[src] into out[dst]: out = A @ v needs
    # out[i] += v[j] for each edge (i, j), i.e. src = column, dst = row
    rem_src[:len(rs)] = rd
    rem_dst[:len(rs)] = rs

    deg = adj.sum(axis=1, keepdims=True).astype(np.float32)
    deg_in = adj.sum(axis=0).reshape(-1, 1).astype(np.float32)

    x = torch.as_tensor(batch.features, device=dev)
    qpx = calibrate(x, x_bits)
    xq = quantize(x, qpx)

    adjb_t = torch.as_tensor(adjb, device=dev)
    tiles = s_maxes = None
    if with_tiles:
        from repro_torch.core import bitops, zerotile

        if tile_shape is None:
            from repro_torch.api import DEFAULT_POLICY

            tile_shape = (DEFAULT_POLICY.block_m, DEFAULT_POLICY.block_w)
        built = [zerotile.compact_artifacts(bitops.pack_a(adjb_t[b], 1),
                                            *tile_shape)
                 for b in range(bcount)]
        tiles = tuple((idx, cnt) for idx, cnt, _ in built)
        s_maxes = tuple(s for _, _, s in built)

    def put(a):
        return torch.as_tensor(a, device=dev)

    return IntBatchArtifacts(
        adjb=adjb_t, row_idx=put(row_idx), rem_src=put(rem_src),
        rem_dst=put(rem_dst), deg=put(deg), deg_in=put(deg_in),
        inv_deg=put(1.0 / (deg + 1.0)), xq=xq, qpx=qpx, tiles=tiles,
        s_maxes=s_maxes)


def batch_caps(batches) -> tuple[int, int]:
    """Shared (block_pad, rem_pad) over a batch list: one shape bucket.

    The largest partition (padded to 8) and the largest cross-block edge
    count (padded to 64) across all batches; fed to :func:`build_artifacts`
    they give every batch identical artifact shapes.
    """
    bp = re = 0
    for b in batches:
        sizes = _block_sizes(b)
        offs = np.concatenate([[0], np.cumsum(sizes)])
        e = np.asarray(b.edges)
        live = e[0] >= 0
        blk_s = np.searchsorted(offs, e[0][live], side="right")
        blk_d = np.searchsorted(offs, e[1][live], side="right")
        bp = max(bp, int(sizes.max()))
        re = max(re, int(np.sum(blk_s != blk_d)))
    return _pad_to(max(bp, 1), 8), max(_pad_to(max(re, 1), 64), 64)


def blocked_aggregate(art: IntBatchArtifacts, vq, *, backend=None,
                      policy=None):
    """Exact integer ``adj @ vq`` from the decomposition."""
    from repro_torch.api.nn import blocked_agg_full

    return blocked_agg_full(art.adjb, art.row_idx, art.rem_src, art.rem_dst,
                            vq, art.qpx.nbits, backend=backend, policy=policy,
                            tiles=art.tiles, s_maxes=art.s_maxes)


class ArtifactCache:
    """Artifacts keyed by batch identity, built on a batch's first visit.

    The batch list is built once per training run and iterated by
    reference, so ``id()`` is a stable key; every later epoch reuses the
    artifacts.
    """

    def __init__(self, x_bits: int, **build_kw):
        self._x_bits = x_bits
        self._kw = build_kw
        self._store: dict[int, IntBatchArtifacts] = {}
        self.builds = 0

    def get(self, batch: SubgraphBatch) -> IntBatchArtifacts:
        key = id(batch)
        art = self._store.get(key)
        if art is None:
            art = build_artifacts(batch, self._x_bits, **self._kw)
            self._store[key] = art
            self.builds += 1
        return art
