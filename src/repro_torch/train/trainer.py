"""Batch transfer for the GNN paths (the reference's ``repro.train.trainer``;
the training loop itself waits for the training slice)."""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.graph.batching import SubgraphBatch
from repro_torch.graph.sparse import sparse_to_dense

__all__ = ["make_device_batch"]


def make_device_batch(batch: SubgraphBatch, device=None) -> dict:
    """Host batch -> device tensors (dense adjacency path).

    ``device=None`` means the card (``device.resolve_device``).
    """
    dev = resolve_device(device)
    edges = torch.as_tensor(batch.edges, device=dev)
    adj = sparse_to_dense(edges, batch.n_nodes)
    deg = torch.sum(adj, dim=1, keepdim=True).to(torch.float32)
    inv_deg = 1.0 / (deg + 1.0)  # +1: self loop
    return {
        "adj": adj,
        "inv_deg": inv_deg,
        "x": torch.as_tensor(batch.features, device=dev),
        "y": torch.as_tensor(batch.labels, device=dev),
        "mask": torch.as_tensor(batch.train_mask, device=dev),
    }
