"""CSR / edge-list / dense adjacency utilities (host numpy + device torch).

The host half is a numpy copy of the reference's ``repro.graph.sparse``.
The device-side ``sparse_to_dense`` is the §4.6 on-device densification:
ship the sparse edge list over the host link, scatter into the dense
binary adjacency on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["CSR", "edges_to_csr", "csr_to_dense", "sparse_to_dense", "degrees",
           "add_self_loops"]


@dataclasses.dataclass(frozen=True)
class CSR:
    indptr: np.ndarray  # (N+1,) int32
    indices: np.ndarray  # (E,) int32
    n: int

    @property
    def e(self) -> int:
        return int(self.indices.shape[0])

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    def edge_list(self) -> np.ndarray:
        """(2, E) int32 [src; dst]."""
        src = np.repeat(np.arange(self.n, dtype=np.int32), np.diff(self.indptr))
        return np.stack([src, self.indices.astype(np.int32)])

    def subgraph(self, nodes: np.ndarray) -> "CSR":
        """Induced subgraph with nodes relabeled 0..len-1 (order preserved)."""
        nodes = np.asarray(nodes, dtype=np.int64)
        remap = -np.ones(self.n, dtype=np.int64)
        remap[nodes] = np.arange(len(nodes))
        indptr = [0]
        out_idx = []
        for v in nodes:
            nb = remap[self.neighbors(v)]
            nb = nb[nb >= 0]
            out_idx.append(np.sort(nb))
            indptr.append(indptr[-1] + len(nb))
        idx = (np.concatenate(out_idx) if out_idx else np.zeros(0)).astype(np.int32)
        return CSR(np.asarray(indptr, np.int32), idx, len(nodes))


def edges_to_csr(edges: np.ndarray, n: int, symmetrize: bool = True) -> CSR:
    """(2, E) -> CSR; dedups; optionally adds reverse edges."""
    src, dst = edges[0].astype(np.int64), edges[1].astype(np.int64)
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    keep = src != dst  # no self loops in storage; added explicitly later
    src, dst = src[keep], dst[keep]
    key = src * n + dst
    key = np.unique(key)
    src, dst = (key // n).astype(np.int32), (key % n).astype(np.int32)
    indptr = np.zeros(n + 1, dtype=np.int32)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr, dtype=np.int32)
    return CSR(indptr, dst, n)


def csr_to_dense(csr: CSR) -> np.ndarray:
    a = np.zeros((csr.n, csr.n), dtype=np.int32)
    el = csr.edge_list()
    a[el[0], el[1]] = 1
    return a


def sparse_to_dense(edges: torch.Tensor, n: int) -> torch.Tensor:
    """Device-side scatter: (2, E) int edge list -> (n, n) int32 0/1.

    Padded edges are encoded as src == -1; they land in a scratch row n
    that is sliced away.
    """
    src, dst = edges[0].to(torch.int64), edges[1].to(torch.int64)
    valid = src >= 0
    src = torch.where(valid, src, torch.full_like(src, n))  # scratch row n
    dst = torch.where(valid, dst, torch.zeros_like(dst))
    a = torch.zeros((n + 1, n), dtype=torch.int32, device=edges.device)
    a.index_put_((src, dst), torch.ones_like(src, dtype=torch.int32))
    return a[:n]


def degrees(adj_dense: torch.Tensor) -> torch.Tensor:
    return torch.sum(adj_dense, dim=1)


def add_self_loops(adj_dense: torch.Tensor) -> torch.Tensor:
    n = adj_dense.shape[0]
    eye = torch.eye(n, dtype=adj_dense.dtype, device=adj_dense.device)
    return torch.maximum(adj_dense, eye)
