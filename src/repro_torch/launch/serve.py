"""Serving launcher, GNN mode: continuous batching on the card.

Streams repeat subgraph traffic through the ``repro_torch.serve.GNNServer``
continuous-batching engine (queue + shape buckets + tile cache) and
prints the ServeStats summary (p50/p95 after a synchronize of the
device). The reference's ``repro.launch.serve --gnn`` for the port:

  python -m repro_torch.launch.serve --gnn ogbn-arxiv --scale 0.008 \\
      --rounds 3                          # on the card
  python -m repro_torch.launch.serve --gnn ogbn-arxiv --device cpu

The reference's LM mode (``--arch``: batched prefill and decode) is not
ported yet; passing ``--arch`` is an error that says so.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.device import resolve_device


def serve_gnn(args) -> dict:
    """Stream repeat subgraph traffic through the continuous GNN engine."""
    from repro_torch.graph import datasets, partition
    from repro_torch.models import gnn
    from repro_torch.serve import (AdmissionPolicy, FaultInjector, GNNServer,
                                   requests_from_partitions)
    from repro_torch.serve.queue import buckets_for

    dev = resolve_device(args.device)
    data = datasets.load(args.gnn, scale=args.scale, seed=args.seed)
    parts = partition.partition(data.csr, args.parts)
    cfg = gnn.GNNConfig.paper_gcn(data.features.shape[1], data.n_classes,
                                  x_bits=args.feat_bits,
                                  w_bits=args.feat_bits)
    params = gnn.init_params(
        cfg, generator=torch.Generator().manual_seed(args.seed), device=dev)
    qparams = gnn.quantize_params(params, cfg)
    reqs = requests_from_partitions(data, parts)
    buckets = buckets_for(reqs, levels=3)
    admission = None
    if (args.max_queue_depth or args.max_queued_nodes
            or args.max_queued_edges):
        admission = AdmissionPolicy(max_depth=args.max_queue_depth,
                                    max_nodes=args.max_queued_nodes,
                                    max_edges=args.max_queued_edges,
                                    on_full=args.admission)
    # policy source: "auto" = the active repro_torch.tune table (none is
    # packaged: the ambient policy), "off" = hand-picked defaults, PATH =
    # a table file
    table = (None if args.tuning_table == "off" else args.tuning_table)
    # deterministic chaos: --inject-failure specs go through the ONE
    # sanctioned fault source (serve/chaos.py)
    chaos = (FaultInjector(*args.inject_failure, seed=args.seed)
             if args.inject_failure else None)
    # the engine routes INDIVIDUAL subgraphs to replicas by rendezvous
    # fingerprint affinity (repeats hit the replica holding their cached
    # tiles); --replicas decouples the logical fleet from the one device
    server = GNNServer(qparams, cfg, feat_bits=args.feat_bits,
                       buckets=buckets, devices=[dev], admission=admission,
                       cache_bytes=args.cache_bytes, tuning_table=table,
                       replicas=args.replicas, chaos=chaos,
                       straggler_tolerance=args.straggler_tolerance)
    for rnd in range(args.rounds):
        for r in reqs:
            server.submit(type(r)(edges=r.edges, features=r.features,
                                  n_nodes=r.n_nodes))
        server.drain()
        st = server.stats
        print(f"[serve-gnn] round {rnd}: compiles={server.n_compiles} "
              f"cache_hit_rate={server.cache.hit_rate:.2f} "
              f"shed={st.requests_shed} live={st.replicas_live} "
              f"retried={st.requests_retried} "
              f"retry_after={st.retry_after_s:.4f}s", flush=True)
    summary = server.stats.summary()
    summary["n_compiles"] = server.n_compiles
    summary["tuned_policies"] = server.tuned_policies()
    summary["replicas"] = server.stats.replicas_live
    summary["device"] = (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu")
    if chaos is not None:
        summary["chaos_fired"] = chaos.fired
        print(f"[serve-gnn] chaos fired: {json.dumps(chaos.fired)}",
              flush=True)
    plan = server.mesh_plan()
    if plan is not None:
        print(f"[serve-gnn] mesh plan for {server.stats.replicas_live} "
              f"live: {plan}", flush=True)
    print(f"[serve-gnn] {json.dumps(summary)}", flush=True)
    return summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="LM architecture to serve (not ported "
                                   "yet: an error)")
    ap.add_argument("--gnn", metavar="DATASET",
                    help="serve GNN subgraph traffic from this Table-1 "
                         "dataset")
    ap.add_argument("--device", default=None,
                    help="cuda (the default: the card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=0.008,
                    help="GNN dataset scale factor")
    ap.add_argument("--parts", type=int, default=8,
                    help="GNN partition count (= request granularity)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="GNN traffic rounds (repeats exercise the cache)")
    ap.add_argument("--feat-bits", type=int, default=8)
    ap.add_argument("--cache-bytes", type=int, default=None,
                    help="strict resident-bytes bound on the tile cache "
                         "(LRU; entry count stays the fallback bound)")
    # admission-control knobs (unset = unbounded queue)
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="bound the GNN request queue at N requests")
    ap.add_argument("--max-queued-nodes", type=int, default=None,
                    help="bound the queue at N total queued nodes")
    ap.add_argument("--max-queued-edges", type=int, default=None,
                    help="bound the queue at N total queued edges")
    ap.add_argument("--admission", choices=("reject", "block"),
                    default="reject",
                    help="at the queue bound: shed with a reason (reject) "
                         "or backpressure the producer (block)")
    # elastic-replica knobs
    ap.add_argument("--replicas", type=int, default=None,
                    help="logical replica count for per-subgraph routing "
                         "(default: one per device; more = virtual "
                         "replicas sharing the device)")
    ap.add_argument("--inject-failure", action="append", default=[],
                    metavar="KIND@BATCH[:k=v,...]",
                    help="deterministic fault injection (repeatable): "
                         "kill@2, stall@1:replica=0,stall_s=0.2, "
                         "slow@3:repeat=4")
    ap.add_argument("--straggler-tolerance", type=float, default=None,
                    help="evict a replica whose batch wall time exceeds "
                         "TOL x its rolling p50 for consecutive batches "
                         "(default: detection off)")
    ap.add_argument("--tuning-table", default="auto", metavar="PATH",
                    help="execution-policy source: 'auto' (the active "
                         "repro_torch.tune table, the default), 'off' "
                         "(hand-picked defaults), or a table file")
    args = ap.parse_args(argv)
    if args.arch is not None:
        ap.error("--arch (LM serving) is not ported yet: the port serves "
                 "GNN traffic only (--gnn DATASET)")
    if args.gnn is None:
        ap.error("pass --gnn DATASET")
    if not 1 <= args.feat_bits <= 8:
        ap.error(f"--feat-bits must be in 1..8, got {args.feat_bits}")
    return serve_gnn(args)


if __name__ == "__main__":
    main()
