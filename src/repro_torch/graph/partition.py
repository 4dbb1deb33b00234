"""Graph partitioning: a METIS-substitute for subgraph batching (paper §4.1).

METIS itself is a C library we cannot assume; the paper uses it purely as a
preprocessing step whose *contract* is: k roughly-balanced parts with high
intra-part edge density. We implement a deterministic two-phase scheme with
the same contract:

  1. **BFS-grow ordering** from a pseudo-peripheral low-degree seed
     (Cuthill–McKee flavored — the paper's §4.1 cites BFS methods as the
     alternative family), chunked into k equal slices.
  2. **Greedy boundary refinement** (Fiduccia–Mattheyses-lite): repeated
     passes move boundary nodes to their majority-neighbor part when that
     strictly reduces edge cut and keeps parts within a balance tolerance.

Quality metrics (`edge_cut`, `balance`) are exported. A numpy copy of the
reference's ``repro.graph.partition``: for the same graph it makes the same
parts.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.sparse import CSR

__all__ = ["partition", "random_partition", "edge_cut", "balance"]


def _bfs_order(csr: CSR, seed: int) -> np.ndarray:
    n = csr.n
    deg = csr.degrees()
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    # deterministic start: global min-degree node; restart per component
    candidates = np.argsort(deg, kind="stable")
    cand_ptr = 0
    frontier: list[int] = []
    while pos < n:
        if not frontier:
            while visited[candidates[cand_ptr]]:
                cand_ptr += 1
            start = int(candidates[cand_ptr])
            frontier = [start]
            visited[start] = True
        next_frontier: list[int] = []
        for v in frontier:
            order[pos] = v
            pos += 1
            nb = csr.neighbors(v)
            nb = nb[~visited[nb]]
            if len(nb):
                # visit low-degree neighbors first (CM heuristic)
                nb = nb[np.argsort(deg[nb], kind="stable")]
                visited[nb] = True
                next_frontier.extend(int(x) for x in nb)
        frontier = next_frontier
    return order


def _majority_neighbor_part(csr: CSR, parts: np.ndarray, k: int):
    """Per node: (best other part, #edges to it, #edges to own part)."""
    el = csr.edge_list()  # (2, E)
    u, pv = el[0].astype(np.int64), parts[el[1]].astype(np.int64)
    own = pv == parts[u]
    own_cnt = np.zeros(csr.n, dtype=np.int64)
    np.add.at(own_cnt, u[own], 1)
    uo, po = u[~own], pv[~own]
    if len(uo) == 0:
        return np.full(csr.n, -1), np.zeros(csr.n, np.int64), own_cnt
    key = uo * k + po
    uk, counts = np.unique(key, return_counts=True)
    nodes, cand_parts = uk // k, uk % k
    # pick per-node argmax: sort by (node, count) and take last per node
    order = np.lexsort((counts, nodes))
    nodes_s, parts_s, cnt_s = nodes[order], cand_parts[order], counts[order]
    last = np.r_[nodes_s[1:] != nodes_s[:-1], True]
    best_part = np.full(csr.n, -1, dtype=np.int64)
    best_cnt = np.zeros(csr.n, dtype=np.int64)
    best_part[nodes_s[last]] = parts_s[last]
    best_cnt[nodes_s[last]] = cnt_s[last]
    return best_part, best_cnt, own_cnt


def partition(
    csr: CSR,
    k: int,
    refine_passes: int = 4,
    balance_tol: float = 0.1,
    seed: int = 0,
) -> np.ndarray:
    """Return parts (N,) int32 in [0, k)."""
    n = csr.n
    if k <= 1:
        return np.zeros(n, dtype=np.int32)
    order = _bfs_order(csr, seed)
    parts = np.empty(n, dtype=np.int32)
    # equal chunks over the BFS order
    bounds = np.linspace(0, n, k + 1).astype(np.int64)
    for p in range(k):
        parts[order[bounds[p]:bounds[p + 1]]] = p
    cap = int(np.ceil(n / k * (1.0 + balance_tol)))
    floor_ = max(1, int(np.floor(n / k * (1.0 - balance_tol))))
    sizes = np.bincount(parts, minlength=k).astype(np.int64)
    for _ in range(refine_passes):
        best_part, best_cnt, own_cnt = _majority_neighbor_part(csr, parts, k)
        gain = best_cnt - own_cnt
        cand = np.where((gain > 0) & (best_part >= 0))[0]
        if len(cand) == 0:
            break
        cand = cand[np.argsort(-gain[cand], kind="stable")]
        moved = 0
        for v in cand:
            src, dst = parts[v], best_part[v]
            if src == dst:
                continue
            if sizes[dst] >= cap or sizes[src] <= floor_:
                continue
            parts[v] = dst
            sizes[src] -= 1
            sizes[dst] += 1
            moved += 1
        if moved == 0:
            break
    return parts


def random_partition(n: int, k: int, seed: int = 0) -> np.ndarray:
    """Balanced random parts: node i to part i % k, then shuffled."""
    rng = np.random.default_rng(seed)
    parts = np.arange(n, dtype=np.int64) % k
    rng.shuffle(parts)
    return parts.astype(np.int32)


def edge_cut(csr: CSR, parts: np.ndarray) -> int:
    el = csr.edge_list()
    return int(np.sum(parts[el[0]] != parts[el[1]]) // 2)


def balance(parts: np.ndarray, k: int) -> float:
    sizes = np.bincount(parts, minlength=k)
    return float(sizes.max() / max(1.0, np.mean(sizes)))
