"""Subgraph batching for GNN computation (paper §4.1).

A batch gathers ``batch_size`` partitions into one block-diagonal graph
(no edges cross subgraphs — the dominant source of all-zero TC tiles the
paper measures in §6.4). Nodes are padded to a tile multiple so the packed
adjacency aligns with the kernels' tile grid. A numpy copy of the
reference's ``repro.graph.batching``: for the same seed it makes the same
batches.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator

import numpy as np

from repro_torch.graph.datasets import GraphData

__all__ = ["SubgraphBatch", "make_batches", "batch_iterator"]


@dataclasses.dataclass
class SubgraphBatch:
    """Host-side batch; fields are numpy, converted on transfer."""

    edges: np.ndarray        # (2, E_pad) int32 block-diagonal, -1 padded
    n_nodes: int             # padded node count (tile multiple)
    n_valid: int             # true node count
    features: np.ndarray     # (n_nodes, D) float32, zero-padded
    labels: np.ndarray       # (n_nodes,) int32, -1 padded
    train_mask: np.ndarray   # (n_nodes,) bool
    node_ids: np.ndarray     # (n_nodes,) original ids, -1 padded
    n_edges: int
    # per-member-partition node counts, in concatenation order. Nodes are
    # laid out partition-by-partition, so cumsum(part_sizes) gives the
    # diagonal-block boundaries of the batch adjacency — the structure the
    # integer training path's blocked aggregation consumes. None for
    # batches built by older callers; consumers must fall back to treating
    # the whole batch as one block (always correct, just no block skipping).
    part_sizes: np.ndarray | None = None


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def make_batches(
    data: GraphData,
    parts: np.ndarray,
    batch_size: int,
    tile: int = 128,
    pad_edges_to: int | None = None,
    seed: int = 0,
    shuffle: bool = True,
) -> list[SubgraphBatch]:
    k = int(parts.max()) + 1
    order = np.arange(k)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    batches = []
    for b0 in range(0, k, batch_size):
        group = order[b0:b0 + batch_size]
        members = [np.where(parts == p)[0] for p in group]
        nodes = np.concatenate(members)
        sizes = np.array([len(m) for m in members], np.int32)
        sub = data.csr.subgraph(nodes)
        el = sub.edge_list().astype(np.int32)
        n_pad = _pad_to(max(sub.n, 1), tile)
        e_cap = pad_edges_to or el.shape[1]
        if el.shape[1] < e_cap:
            pad = -np.ones((2, e_cap - el.shape[1]), np.int32)
            el = np.concatenate([el, pad], axis=1)
        feats = np.zeros((n_pad, data.features.shape[1]), np.float32)
        feats[:sub.n] = data.features[nodes]
        labels = -np.ones(n_pad, np.int32)
        labels[:sub.n] = data.labels[nodes]
        mask = np.zeros(n_pad, bool)
        mask[:sub.n] = data.train_mask[nodes]
        ids = -np.ones(n_pad, np.int32)
        ids[:sub.n] = nodes
        batches.append(SubgraphBatch(el, n_pad, sub.n, feats, labels, mask,
                                     ids, sub.e, part_sizes=sizes))
    return batches


def batch_iterator(batches: list[SubgraphBatch], epochs: int | None = None,
                   seed: int = 0) -> Iterator[tuple[int, SubgraphBatch]]:
    """Deterministic, step-resumable iterator: step -> batch is a pure map.

    Each epoch visits the batches in ``np.random.default_rng(seed +
    epoch).permutation``'s order. ``epochs=None`` iterates forever (the
    training loop stops on its step budget); a finite ``epochs`` yields
    ``epochs * len(batches)`` steps, a prefix of the infinite sequence.
    """
    n = len(batches)
    step = 0
    epoch_range = itertools.count() if epochs is None else range(epochs)
    for epoch in epoch_range:
        order = np.random.default_rng(seed + epoch).permutation(n)
        for i in range(n):
            yield step, batches[int(order[i])]
            step += 1
