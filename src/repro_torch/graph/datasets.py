"""Synthetic graph datasets mirroring the paper's Table 1.

The real graphs are not shipped with the repository, so each Table-1
dataset gets a generator that reproduces its *structural statistics* (|V|, |E|, feature
dim, #classes) with a planted-partition (SBM) community structure — the
property METIS exploits and the paper's zero-tile analysis depends on.
Features are class-conditional Gaussians so node classification is
learnable end-to-end (Table 2 reproduction).

``load(name, scale=...)`` shrinks |V|/|E| proportionally; callers state the
scale they used. A numpy copy of the reference's ``repro.graph.datasets``:
for the same seed it makes the same graph.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.sparse import CSR, edges_to_csr

__all__ = ["TABLE1", "GraphData", "load", "make_sbm_graph"]

# name: (|V|, |E|, dim, classes)  — paper Table 1
TABLE1 = {
    "proteins": (43_471, 162_088, 29, 2),
    "artist": (50_515, 1_638_396, 100, 12),
    "blogcatalog": (88_784, 2_093_195, 128, 39),
    "ppi": (56_944, 818_716, 50, 121),
    "ogbn-arxiv": (169_343, 1_166_243, 128, 40),
    "ogbn-products": (2_449_029, 61_859_140, 100, 47),
}


@dataclasses.dataclass
class GraphData:
    name: str
    csr: CSR
    features: np.ndarray  # (N, D) float32
    labels: np.ndarray  # (N,) int32
    n_classes: int
    train_mask: np.ndarray
    test_mask: np.ndarray


def make_sbm_graph(
    n: int,
    e_target: int,
    dim: int,
    n_classes: int,
    n_communities: int | None = None,
    intra_frac: float = 0.85,
    seed: int = 0,
    name: str = "sbm",
) -> GraphData:
    """Planted-partition graph with learnable class-conditional features."""
    rng = np.random.default_rng(seed)
    if n_communities is None:
        # real Table-1 graphs carry thousands of natural clusters (the paper
        # partitions into 1500 subgraphs); keep communities ~250 nodes so any
        # reasonable part count can align with them
        n_communities = max(32, n // 250)
    comm = rng.integers(0, n_communities, n)
    comm.sort()  # contiguous communities: realistic locality for BFS seeds
    # sample edges: intra_frac within community, rest uniform
    e_intra = int(e_target * intra_frac)
    e_inter = e_target - e_intra
    # intra edges: pick a community by size, then two members
    nodes_by_comm = np.argsort(comm, kind="stable")
    counts = np.bincount(comm, minlength=n_communities)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    cprob = counts / counts.sum()
    cidx = rng.choice(n_communities, size=e_intra, p=cprob)
    offs_a = (rng.random(e_intra) * counts[cidx]).astype(np.int64)
    offs_b = (rng.random(e_intra) * counts[cidx]).astype(np.int64)
    src_i = nodes_by_comm[starts[cidx] + offs_a]
    dst_i = nodes_by_comm[starts[cidx] + offs_b]
    src_x = rng.integers(0, n, e_inter)
    dst_x = rng.integers(0, n, e_inter)
    edges = np.stack([np.concatenate([src_i, src_x]),
                      np.concatenate([dst_i, dst_x])]).astype(np.int64)
    csr = edges_to_csr(edges, n)
    # labels correlated with communities (several communities per class)
    labels = (comm % n_classes).astype(np.int32)
    means = rng.normal(scale=1.0, size=(n_classes, dim)).astype(np.float32)
    feats = means[labels] + rng.normal(scale=1.0, size=(n, dim)).astype(np.float32)
    mask = rng.random(n) < 0.7
    return GraphData(name, csr, feats, labels, n_classes, mask, ~mask)


def load(name: str, scale: float = 1.0, seed: int = 0) -> GraphData:
    if name not in TABLE1:
        raise KeyError(f"unknown dataset {name!r}; choices: {list(TABLE1)}")
    n, e, dim, classes = TABLE1[name]
    n = max(256, int(n * scale))
    e = max(4 * n, int(e * scale))
    return make_sbm_graph(n, e, dim, classes, seed=seed, name=name)
