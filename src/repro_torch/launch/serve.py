"""Serving launcher: LM batched prefill + decode, and GNN continuous
batching, on the card.

LM mode (``--arch``): requests fill a fixed array of batch slots; each
engine step decodes one token for every slot (greedy), and a batch of
slots is prefilled and decoded to ``--max-new`` tokens before the next
batch of requests takes the slots. ``--smoke`` serves the arch's reduced
same-family config; without it the full config (on the card: codeqwen1.5-7b
is 16.4 GB of bf16 weights). ``--wq-bits N`` weight-only quantizes every
large 2-D projection through ``repro_torch.api.nn.quantize_lm_params``,
which hands the stock forward the dequantized weights.

GNN mode (``--gnn DATASET``): streams repeat subgraph traffic through the
``repro_torch.serve.GNNServer`` continuous-batching engine (queue + shape
buckets + tile cache) and prints the ServeStats summary (p50/p95 after a
synchronize of the device).

  python -m repro_torch.launch.serve --arch rwkv6-1.6b --smoke \\
      --requests 12 --max-new 16 --wq-bits 4         # on the card
  python -m repro_torch.launch.serve --arch rwkv6-1.6b --smoke --device cpu
  python -m repro_torch.launch.serve --gnn ogbn-arxiv --scale 0.008 \\
      --rounds 3
  python -m repro_torch.launch.serve --gnn ogbn-arxiv --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.perf import report


class DecodeEngine:
    """Fixed-batch greedy decode engine over ``models.lm`` prefill and
    decode_step. ``generate`` times its prefill up to a synchronize of the
    device, and each token from the call of the decode step that makes it
    to the host copy of its argmax: the host's issue of the step's ops is
    part of a token's latency (the first token's is the prefill's argmax
    alone). ``last_walls`` keeps the last call's walls unrounded."""

    def __init__(self, cfg, params, batch_slots: int, max_seq: int):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.batch = batch_slots
        self.device = params["embed"].device
        self.last_walls: dict = {}

    def _inputs(self, prompts) -> dict:
        cfg, b = self.cfg, self.batch
        batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int32,
                                           device=self.device)}
        if cfg.family == "vlm":
            batch["patches"] = torch.zeros((b, cfg.n_patches, cfg.d_model),
                                           dtype=torch.bfloat16,
                                           device=self.device)
        if cfg.family == "audio_encdec":
            batch["frames"] = torch.zeros((b, cfg.n_frames, cfg.d_model),
                                          dtype=torch.bfloat16,
                                          device=self.device)
        return batch

    @torch.no_grad()
    def generate(self, prompts, max_new: int,
                 eos_id: int | None = None) -> tuple[np.ndarray, dict]:
        """prompts (B, T0) int -> generated (B, max_new) int32 and stats."""
        b, _ = prompts.shape
        if b != self.batch:
            raise ValueError(f"{b} prompts for {self.batch} batch slots")
        batch = self._inputs(prompts)
        t_start = time.perf_counter()
        logits, cache = lm.prefill(self.params, batch, self.cfg,
                                         max_seq=self.max_seq)
        if self.device.type == "cuda":  # the first step must not absorb it
            torch.cuda.synchronize(self.device)
        prefill_s = time.perf_counter() - t_start
        out = np.zeros((b, max_new), np.int32)
        done = np.zeros(b, bool)
        step_lat = []
        t_dec = time.perf_counter()
        for i in range(max_new):
            t_step = time.perf_counter()
            if i:  # the step that makes token i; token 0 is the prefill's
                logits, cache = lm.decode_step(
                    self.params, cache, nxt[:, None], self.cfg)
            nxt = logits.argmax(-1).to(torch.int32)
            nxt = nxt.clamp(max=self.cfg.vocab - 1)  # padded vocab
            out[:, i] = nxt.cpu().numpy()  # the host copy waits for the step
            step_lat.append(time.perf_counter() - t_step)
            if eos_id is not None:
                done |= out[:, i] == eos_id
                if done.all():
                    out = out[:, : i + 1]
                    break
        decode_s = time.perf_counter() - t_dec
        self.last_walls = {"prefill_s": prefill_s, "decode_s": decode_s,
                           "token_s": step_lat}
        stats = {
            "prefill_s": round(prefill_s, 3),
            "decode_s": round(decode_s, 3),
            "tokens_generated": int(out.size),
            "tok_per_s": round(out.size / max(decode_s, 1e-9), 1),
            "decode_p50_s": round(report.percentile(step_lat, 50), 5),
            "decode_p95_s": round(report.percentile(step_lat, 95), 5),
        }
        return out, stats


def serve_lm(args) -> dict:
    """Serve ``--requests`` synthetic prompts through the decode engine."""
    from repro_torch import configs
    from repro_torch.api import nn as qnn
    from repro_torch.train import data as data_lib

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = configs.smoke_config(cfg)
    params, _ = lm.init_lm(
        cfg, generator=torch.Generator(device=dev).manual_seed(args.seed),
        device=dev)
    if args.wq_bits:
        params, qstats = qnn.quantize_lm_params(params, args.wq_bits)
        # the packed bytes are a footprint: the forward reads the
        # dequantized weights at the model's dtype
        print(f"[serve] wq{args.wq_bits}: {qstats['n_quantized']} "
              f"projections, {qstats['bytes_fp16'] / 1e6:.1f} MB bf16 -> "
              f"{qstats['bytes_packed'] / 1e6:.1f} MB packed "
              f"({qstats['ratio']:.1f}x smaller)", flush=True)
    engine = DecodeEngine(cfg, params, args.batch_slots,
                          max_seq=args.prompt_len + args.max_new + 8)
    served = 0
    all_stats = []
    while served < args.requests:
        n = min(args.batch_slots, args.requests - served)
        toks, _ = data_lib.synthetic_batch(
            args.seed, served, batch=args.batch_slots, seq=args.prompt_len,
            vocab=cfg.vocab, device="cpu")
        _, stats = engine.generate(toks.numpy(), args.max_new)
        stats["live_slots"] = n
        all_stats.append(stats)
        served += n
        print(f"[serve] {json.dumps(stats)}", flush=True)
    total_tok = sum(s["tokens_generated"] for s in all_stats)
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[serve] served {served} requests, {total_tok} tokens on {device}",
          flush=True)
    return {"requests": served, "stats": all_stats, "device": device}


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
    ap.add_argument("--arch", help="LM architecture to serve")
    ap.add_argument("--gnn", metavar="DATASET",
                    help="serve GNN subgraph traffic from this Table-1 "
                         "dataset")
    ap.add_argument("--device", default=None,
                    help="cuda (the default: the card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    # LM-mode knobs
    ap.add_argument("--smoke", action="store_true",
                    help="serve the arch's reduced same-family config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--wq-bits", type=int, default=0,
                    help="weight-only quantize projections to N bits "
                         "(0 = serve full precision)")
    # GNN-mode knobs
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
    if (args.arch is None) == (args.gnn is None):
        ap.error("pass exactly one of --arch (LM) or --gnn (GNN)")
    if not 1 <= args.feat_bits <= 8:
        ap.error(f"--feat-bits must be in 1..8, got {args.feat_bits}")
    if args.wq_bits and not 1 <= args.wq_bits <= 8:
        ap.error(f"--wq-bits must be in 1..8 (or 0 to disable), "
                 f"got {args.wq_bits}")
    if args.gnn:
        return serve_gnn(args)
    return serve_lm(args)


if __name__ == "__main__":
    main()
