"""Fig. 8b: zero-tile jumping efficiency — the fraction of 8x128 adjacency
tiles actually processed, across the Table-1 datasets (batched
block-diagonal subgraphs).

As in the reference, the same occupancy artifacts drive the multi-bit
aggregation GEMM (1-bit adjacency x ``feat_bits`` features): for each
dataset's first batch ``api.bitserial_mm_packed`` on the ``cuda`` engine is
timed dense and compact-jumping, and the two results must be equal.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import api
from repro_torch.api.policy import DEFAULT_POLICY
from repro_torch.benchmarks.common import emit, timeit
from repro_torch.core import bitops
from repro_torch.core.zerotile import (compact_artifacts, occupancy_stats,
                                       tile_occupancy)
from repro_torch.device import resolve_device
from repro_torch.graph import batching, datasets, partition
from repro_torch.train.trainer import make_device_batch

DATASETS = ("proteins", "artist", "blogcatalog", "ppi", "ogbn-arxiv")


def main(scale: float = 0.01, feat_bits: int = 4, dsets=DATASETS, device=None):
    dev = resolve_device(device)
    # the paper's 8x128 tile = DEFAULT_POLICY's (block_m=8, block_w=4 words)
    tm, tw = DEFAULT_POLICY.block_m, DEFAULT_POLICY.block_w
    for name in dsets:
        data = datasets.load(name, scale=scale)
        parts = partition.partition(data.csr, 8)
        bs = batching.make_batches(data, parts, 4, shuffle=False)
        tot = nz = 0
        timed = None
        for bi, b in enumerate(bs[:4]):
            db = make_device_batch(b, device=dev)
            ap = bitops.pack_a(db["adj"], 1)[0]
            ap = bitops.pad_to(bitops.pad_to(ap, 0, tm), 1, tw)
            st = occupancy_stats(tile_occupancy(ap, tm, tw))
            tot += st["tiles_total"]
            nz += st["tiles_nonzero"]
            if bi == 0:
                n_nodes = db["adj"].shape[0]
                rng = np.random.default_rng(1)
                hq = rng.integers(0, 1 << feat_bits,
                                  (n_nodes, db["x"].shape[1])).astype(np.int32)
                a3 = bitops.pack_a(db["adj"], 1)
                hp = bitops.pack_b(torch.as_tensor(hq, device=dev), feat_bits)
                tiles = compact_artifacts(a3, tm, tw)

                def run(tl=None, _a=a3, _h=hp):
                    return api.bitserial_mm_packed(
                        _a, _h, backend="cuda", policy=DEFAULT_POLICY, tiles=tl)

                if not torch.equal(run(tiles), run()):
                    raise AssertionError(f"fig8b {name}: compact != dense")
                t_dense = timeit(run, iters=3)
                t_jump = timeit(run, tiles, iters=3)
                timed = (t_dense, t_jump, st["skip_ratio"])
        emit(f"fig8b_{name}_nonzero_tile_frac", round(nz / tot, 4), "frac",
             skipped=round(1 - nz / tot, 4))
        if timed is not None:
            t_dense, t_jump, skip = timed
            emit(f"fig8b_{name}_bitserial{feat_bits}b_dense", t_dense * 1e3, "ms")
            emit(f"fig8b_{name}_bitserial{feat_bits}b_compact", t_jump * 1e3,
                 "ms", skip_ratio=round(skip, 4),
                 speedup=t_dense / max(t_jump, 1e-9))


if __name__ == "__main__":
    main()
