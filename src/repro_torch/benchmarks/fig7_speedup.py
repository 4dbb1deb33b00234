"""Fig. 7 (a/b): QGTC vs the full-precision baselines on Cluster-GCN and
Batched-GIN across the Table-1 datasets.

  fp32_dense — dense-adjacency fp32 matmuls (DGL dense analogue)
  fp32_csr   — edge-list gather / index_add_ (DGL/PyG scatter analogue)
  qgtc       — the integer bit-serial path on the ``cuda`` engine: the
               hand-written kernels on the card, their plain versions on
               the CPU

Datasets are SBM re-creations of Table 1 at ``scale``; one batch of 4 of 8
parts each, as in the reference. Bits above 8 run at 8, as there.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.benchmarks.common import emit, timeit
from repro_torch.device import resolve_device
from repro_torch.graph import batching, datasets, partition
from repro_torch.models import gnn
from repro_torch.train.trainer import make_device_batch

DATASETS = ("proteins", "artist", "blogcatalog", "ppi", "ogbn-arxiv",
            "ogbn-products")


def run(scale: float = 0.01, bits_list=(2, 4, 8, 16), model: str = "gcn",
        dsets=DATASETS, device=None):
    dev = resolve_device(device)
    for name in dsets:
        ds_scale = scale * (0.1 if name == "ogbn-products" else 1.0)
        data = datasets.load(name, scale=ds_scale)
        parts = partition.partition(data.csr, 8)
        mk = (gnn.GNNConfig.paper_gcn if model == "gcn"
              else gnn.GNNConfig.paper_gin)
        cfg = mk(data.features.shape[1], data.n_classes)
        b = batching.make_batches(data, parts, 4, shuffle=False)[0]
        db = make_device_batch(b, device=dev)
        edges = torch.as_tensor(b.edges, device=dev)
        params = gnn.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=dev)

        t_fp32 = timeit(gnn.forward, params, db["adj"], db["x"], db["inv_deg"],
                        cfg)
        emit(f"fig7_{model}_{name}_fp32", t_fp32 * 1e6, "us")
        t_csr = timeit(gnn.forward, params, edges, db["x"], db["inv_deg"], cfg,
                       path="fp32_csr")
        emit(f"fig7_{model}_{name}_csr", t_csr * 1e6, "us")

        for bits in bits_list:
            cfg_b = dataclasses.replace(cfg, x_bits=min(bits, 8),
                                        w_bits=min(bits, 8))
            qp = gnn.quantize_params(params, cfg_b)
            t_q = timeit(gnn.forward_qgtc, qp, db["adj"], db["x"],
                         db["inv_deg"], cfg_b, backend="cuda")
            emit(f"fig7_{model}_{name}_qgtc{bits}", t_q * 1e6, "us",
                 speedup_vs_fp32=t_fp32 / t_q)


def main(scale: float = 0.01, bits_list=(2, 4, 8, 16), gcn_dsets=DATASETS,
         gin_dsets=("proteins", "ppi"), device=None):
    run(scale, bits_list, model="gcn", dsets=gcn_dsets, device=device)
    run(scale, bits_list, model="gin", dsets=gin_dsets, device=device)


if __name__ == "__main__":
    main()
