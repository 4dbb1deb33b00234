"""Serving throughput: continuous batching + tile reuse vs naive loop.

The reference's ``benchmarks/serve_throughput.py`` on the port: every arm
keeps its traffic, its emitted names and its checks of what is served
(the speed checks are reported, see below), runs on the
``cuda`` engine wherever the reference names ``pallas``, and takes
``device=`` (None: the card). ``run_arms`` runs them all; it is the
``serve`` suite of ``repro_torch.benchmarks.run``, whose ``--out`` writes
the records to a file of its own.

Repeat-subgraph traffic (R rounds over the same partition set — the hot
path of a production GNN server) through two engines:

  baseline — no shape buckets (exact padding: every distinct coalesced
             size is a new forward shape) and no tile cache (every batch
             re-ships edges and re-runs pack+occupancy)
  qgtc     — bucketed batches (one forward shape per bucket) +
             cross-request tile cache (repeat subgraphs ship features only)

A second comparison isolates zero-tile jumping on the serving path: two
cuda-engine servers, ``jump="none"`` vs ``jump="compact"`` (the forward
consumes the cached ``TileEntry.compact_idx``/``compact_counts`` — no
per-request occupancy work), warmed up so first shapes and tile-cache
misses sit outside the timed window. Logits must be bit-identical; the
compact arm's nodes/s against the dense arm's is reported.

Two load-safety arms:

  overload_arm — sustained arrival > service rate through an unbounded
             queue vs an AdmissionPolicy-bounded one (reject mode). The
             bounded queue sheds load and keeps p95 queue->result latency
             bounded; the unbounded queue serves everything, seconds
             late.
  shuffled_arm — repeat traffic whose coalescing ORDER is reshuffled
             every round. Per-subgraph cache keying + offset-shifted
             composition must keep hitting (≥90% per-key hit rate) with
             logits bit-identical to a cache-disabled scratch build on
             the identical traffic.

Reported: nodes/sec, p50/p95 batch latency (timer stopped after device
sync), forward-signature counts (``n_compiles``), cache hit rate,
transfer bytes. A time is the device's the suite ran on
(benchmarks/common.py).

The checks of what is served stay asserted: bit-identical logits across
arms, the per-key hit rate, zero lost, a finite retry hint, bounded tail
latency under admission control, forward signatures within the ladder.
The reference's speed checks (the bucketed + cached engine faster than
the baseline, compact jumping and the autotuned arm within 10 % of the
best) are measured and emitted with ``claim_holds``, not asserted: the
port claims no speed, and the first rested on recompiles the port does
not have (it did not hold on an H100 at the reference's sizes: PERF.md).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.benchmarks.common import emit
from repro_torch.device import resolve_device
from repro_torch.graph import batching, datasets, partition
from repro_torch.models import gnn
from repro_torch.perf import report
from repro_torch.serve import AdmissionPolicy, GNNServer, SubgraphRequest
from repro_torch.serve.queue import buckets_for, requests_from_partitions


def _model(cfg, dev):
    """The quantized weights of ``init_params`` seeded with 0, on ``dev``."""
    params = gnn.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device=dev)
    return gnn.quantize_params(params, cfg)


def _stream(server: GNNServer, reqs, rounds: int) -> float:
    t0 = time.perf_counter()
    for _ in range(rounds):
        for r in reqs:
            # fresh request objects: same subgraph structure, reused
            # features buffer (the engine re-packs them every time)
            server.submit(SubgraphRequest(edges=r.edges, features=r.features,
                                          n_nodes=r.n_nodes))
        server.drain()
    return time.perf_counter() - t0


def main(scale: float = 0.01, parts_k: int = 12, rounds: int = 4,
         device=None):
    dev = resolve_device(device)
    for name in ("ogbn-arxiv", "blogcatalog"):
        data = datasets.load(name, scale=scale)
        parts = partition.partition(data.csr, parts_k)
        cfg = gnn.GNNConfig.paper_gcn(data.features.shape[1], data.n_classes)
        qparams = _model(cfg, dev)
        reqs = requests_from_partitions(data, parts)
        buckets = buckets_for(reqs, levels=3)

        base = GNNServer(qparams, cfg, buckets=None,
                         node_budget=buckets[-1].n_pad,
                         edge_budget=buckets[-1].e_cap, cache_entries=0,
                         devices=[dev])
        t_base = _stream(base, reqs, rounds)

        fast = GNNServer(qparams, cfg, buckets=buckets, devices=[dev])
        t_fast = _stream(fast, reqs, rounds)

        for tag, srv, t in (("baseline", base, t_base), ("qgtc", fast, t_fast)):
            st = srv.stats
            emit(f"serve_{name}_{tag}", round(st.nodes / t, 1), "nodes_per_s",
                 wall_s=round(t, 3), batches=st.batches,
                 p50_ms=round(st.p50_s * 1e3, 2),
                 p95_ms=round(st.p95_s * 1e3, 2),
                 compiles=srv.n_compiles,
                 cache_hit_rate=round(srv.cache.hit_rate, 3)
                 if srv.cache else 0.0,
                 transfer_mb=round(st.transfer_bytes / 1e6, 3))
        emit(f"serve_{name}_speedup", round(t_base / t_fast, 2), "x",
             derived=True, claim_holds=t_fast < t_base)
        assert 0 < fast.n_compiles <= len(buckets), (
            f"forward-signature leak: {fast.n_compiles} signatures for "
            f"{len(buckets)} buckets")


def jump_arm(scale: float = 0.006, parts_k: int = 8,
             rounds: int = 3, device=None) -> list[dict]:
    """Zero-tile jumping on the serving path: dense vs compact vs
    autotuned.

    All arms run the cuda engine; the two hand-picked arms pin
    ``jump="none"`` / ``jump="compact"`` and the ``autotuned`` arm passes
    NO policy, so the engine resolves each shape bucket from the active
    tuning table (``repro_torch.tune``; none is packaged, so the ambient
    policy).
    Logits are asserted bit-identical across all arms; whether the
    compact arm holds the dense arm's nodes/s, and the autotuned arm the
    BEST hand-picked arm's (both at a 10% wall-clock noise margin — the
    windows are timed on a shared host), is reported (``claim_holds``).
    The warm-up wave (first shapes + tile-cache misses) is excluded from
    BOTH the throughput window and the recorded latency percentiles.
    """
    dev = resolve_device(device)
    name = "ogbn-arxiv"
    data = datasets.load(name, scale=scale)
    parts = partition.partition(data.csr, parts_k)
    cfg = gnn.GNNConfig.paper_gcn(data.features.shape[1], data.n_classes)
    qparams = _model(cfg, dev)
    reqs = requests_from_partitions(data, parts)
    buckets = buckets_for(reqs, levels=2)
    parity_batch = batching.make_batches(data, parts, 2, shuffle=False)[0]

    arms = {
        "none": dict(policy=api.ExecutionPolicy(jump="none"),
                     tuning_table=None),
        "compact": dict(policy=api.ExecutionPolicy(jump="compact"),
                        tuning_table=None),
        "autotuned": dict(policy=None),  # tuning_table="auto"
    }
    records, results = [], {}
    has_table = False  # whether the autotuned arm had a table to consult
    for arm, kw in arms.items():
        srv = GNNServer(qparams, cfg, backend="cuda", buckets=buckets,
                        devices=[dev], **kw)
        if arm == "autotuned":
            has_table = srv._table is not None
        _, logits = srv.infer_batch(parity_batch, return_logits=True)
        for r in reqs:  # warm-up wave: first shapes + tile-cache misses
            srv.submit(SubgraphRequest(edges=r.edges, features=r.features,
                                       n_nodes=r.n_nodes))
        srv.drain()
        srv.stats.batch_latencies_s.clear()  # percentiles: timed window only
        n0, t0 = srv.stats.nodes, time.perf_counter()
        for _ in range(rounds):
            for r in reqs:
                srv.submit(SubgraphRequest(edges=r.edges,
                                           features=r.features,
                                           n_nodes=r.n_nodes))
            srv.drain()
        dt = time.perf_counter() - t0
        nps = (srv.stats.nodes - n0) / dt
        results[arm] = (nps, logits)
        # the jump mode an autotuned server actually ran: its largest
        # bucket's table policy (None = no table entry -> default dense)
        pol = kw.get("policy")
        if pol is None:
            tuned = [p for p in srv.tuned_policies().values()
                     if p is not None]
            jump = tuned[-1]["jump"] if tuned else "none"
        else:
            jump = pol.jump
        records.append({
            "op": "serve_forward", "bits": srv.feat_bits,
            "sparsity": round(srv.stats.zero_tile_skip_ratio, 4),
            "jump": jump, "median_ms": round(srv.stats.p50_s * 1e3, 3),
            "nodes_per_s": round(nps, 1), "arm": arm,
        })
        emit(f"serve_{name}_pallas_jump_{arm}", round(nps, 1), "nodes_per_s",
             wall_s=round(dt, 3), p50_ms=records[-1]["median_ms"],
             skip_ratio=round(srv.stats.zero_tile_skip_ratio, 4),
             cache_hit_rate=round(srv.cache.hit_rate, 3), jump=jump)
    nps_dense, lg_dense = results["none"]
    nps_jump, lg_jump = results["compact"]
    nps_auto, lg_auto = results["autotuned"]
    emit(f"serve_{name}_jump_speedup", round(nps_jump / nps_dense, 2), "x",
         derived=True, claim_holds=nps_jump >= 0.9 * nps_dense)
    np.testing.assert_array_equal(
        np.asarray(lg_jump), np.asarray(lg_dense),
        err_msg="compact-jump serving logits diverged from dense")
    np.testing.assert_array_equal(
        np.asarray(lg_auto), np.asarray(lg_dense),
        err_msg="autotuned serving logits diverged from dense")
    best_hand = max(nps_dense, nps_jump)
    # with no table active (none is packaged until a sweep on the card
    # writes one) the autotuned arm is the ambient-policy arm
    emit(f"serve_{name}_autotuned_vs_best", round(nps_auto / best_hand, 2),
         "x", derived=True, table=has_table,
         claim_holds=nps_auto >= 0.9 * best_hand)
    return records


def sgt_arm(scale: float = 0.006, parts_k: int = 8,
            rounds: int = 3, device=None) -> list[dict]:
    """Sparse-graph translation on the serving path.

    One engine serves repeat traffic under ``jump="sgt"`` with the tile
    cache on — repeat subgraphs consume CACHED translation artifacts and
    coalesced batches compose them by word-offset shifting
    (``compose_entries``). Its logits must be bit-identical to (a) a
    scratch build (same SGT policy, cache disabled: every batch rebuilds
    the remap from the raw adjacency — proves composition exact) and (b)
    a dense ``jump="none"`` engine (proves the kernel path exact), with
    no forward-signature leak (signatures ≤ bucket count).
    """
    name = "ogbn-arxiv"
    dev = resolve_device(device)
    cfg, qparams, reqs, buckets = _setup(name, scale, parts_k, dev)
    pol = api.ExecutionPolicy(jump="sgt")
    srv = GNNServer(qparams, cfg, backend="cuda", buckets=buckets,
                    policy=pol, tuning_table=None, devices=[dev])
    for r in reqs:  # warm-up wave: first shapes + tile-cache misses
        srv.submit(_fresh(r))
    srv.drain()
    srv.stats.batch_latencies_s.clear()
    n0, t0 = srv.stats.nodes, time.perf_counter()
    logits = []
    for _ in range(rounds):
        ids = [srv.submit(_fresh(r)) for r in reqs]
        out = srv.drain(return_logits=True)
        logits = [out[i][1] for i in ids]
    dt = time.perf_counter() - t0
    nps = (srv.stats.nodes - n0) / dt
    for tag, kw in (("scratch", dict(policy=pol, cache_entries=0)),
                    ("dense", dict(policy=api.ExecutionPolicy(jump="none")))):
        ref = GNNServer(qparams, cfg, backend="cuda", buckets=buckets,
                        tuning_table=None, devices=[dev], **kw)
        rids = [ref.submit(_fresh(r)) for r in reqs]
        rout = ref.drain(return_logits=True)
        for got, rid in zip(logits, rids):
            np.testing.assert_array_equal(
                np.asarray(got), np.asarray(rout[rid][1]),
                err_msg=f"sgt serving logits diverged from the {tag} build")
    assert 0 < srv.n_compiles <= len(buckets), (
        f"forward-signature leak under jump='sgt': {srv.n_compiles} "
        f"signatures for {len(buckets)} buckets")
    rec = {
        "op": "serve_forward", "bits": srv.feat_bits,
        "sparsity": round(srv.stats.zero_tile_skip_ratio, 4),
        "jump": "sgt", "median_ms": round(srv.stats.p50_s * 1e3, 3),
        "nodes_per_s": round(nps, 1), "arm": "sgt",
    }
    emit(f"serve_{name}_pallas_jump_sgt", round(nps, 1), "nodes_per_s",
         wall_s=round(dt, 3), p50_ms=rec["median_ms"],
         skip_ratio=rec["sparsity"],
         cache_hit_rate=round(srv.cache.hit_rate, 3), jump="sgt")
    return [rec]


def _setup(name: str, scale: float, parts_k: int, dev, levels: int = 2):
    data = datasets.load(name, scale=scale)
    parts = partition.partition(data.csr, parts_k)
    cfg = gnn.GNNConfig.paper_gcn(data.features.shape[1], data.n_classes)
    qparams = _model(cfg, dev)
    reqs = requests_from_partitions(data, parts)
    return cfg, qparams, reqs, buckets_for(reqs, levels=levels)


def _fresh(r) -> SubgraphRequest:
    return SubgraphRequest(edges=r.edges, features=r.features,
                           n_nodes=r.n_nodes)


def overload_arm(scale: float = 0.006, parts_k: int = 8,
                 bursts: int = 5, device=None) -> list[dict]:
    """Overload (arrival > service): unbounded queue vs bounded+shed.

    Each burst submits the partition set TWICE but only ONE engine step
    runs between bursts, so arrival outpaces service and the queue grows
    without bound unless admission control sheds. The bounded arm (depth
    capped at one round) must shed load AND hold a lower p95
    queue->result latency than the unbounded arm (whose tail requests
    wait out the whole backlog); the unbounded arm serves everything,
    late.
    """
    name = "ogbn-arxiv"
    dev = resolve_device(device)
    cfg, qparams, reqs, buckets = _setup(name, scale, parts_k, dev)
    arms = {
        "unbounded": None,
        "bounded": AdmissionPolicy(max_depth=parts_k, on_full="reject"),
    }
    records, results = [], {}
    for tag, admission in arms.items():
        srv = GNNServer(qparams, cfg, buckets=buckets, admission=admission,
                        devices=[dev])
        for r in reqs:  # warm-up wave: first shapes + tile-cache misses
            srv.submit(_fresh(r))
        srv.drain()
        srv.stats.batch_latencies_s.clear()
        srv.stats.request_latencies_s.clear()
        n0, t0 = srv.stats.nodes, time.perf_counter()
        for _ in range(bursts):
            for _ in range(2):  # arrival: two rounds per burst
                for r in reqs:
                    srv.submit(_fresh(r))
            srv.step()  # service: one batch per burst — overload
        srv.drain()
        dt = time.perf_counter() - t0
        st = srv.stats
        nps = (st.nodes - n0) / dt
        rec = {
            "op": "serve_overload", "bits": srv.feat_bits,
            "sparsity": round(st.zero_tile_skip_ratio, 4), "jump": "none",
            "median_ms": round(st.p50_s * 1e3, 3),
            "nodes_per_s": round(nps, 1), "arm": tag,
            "admitted": st.requests_admitted, "shed": st.requests_shed,
            "req_p95_ms": round(
                1e3 * report.percentile(st.request_latencies_s, 95), 3),
        }
        records.append(rec)
        results[tag] = rec
        emit(f"serve_{name}_overload_{tag}", rec["req_p95_ms"], "req_p95_ms",
             shed=rec["shed"], admitted=rec["admitted"],
             nodes_per_s=rec["nodes_per_s"])
    bounded, unbounded = results["bounded"], results["unbounded"]
    assert bounded["shed"] > 0, "bounded queue under overload did not shed"
    assert unbounded["shed"] == 0
    assert bounded["req_p95_ms"] < unbounded["req_p95_ms"], (
        f"admission control did not bound tail latency: bounded p95 "
        f"{bounded['req_p95_ms']}ms >= unbounded {unbounded['req_p95_ms']}ms")
    emit(f"serve_{name}_overload_p95_ratio",
         round(unbounded["req_p95_ms"] / max(bounded["req_p95_ms"], 1e-9), 2),
         "x", derived=True)
    return records


def shuffled_arm(scale: float = 0.006, parts_k: int = 8, rounds: int = 3,
                 seed: int = 1, device=None) -> list[dict]:
    """Shuffled coalescing order: per-subgraph composition must keep
    hitting.

    After a cold wave, every round re-submits the same subgraphs in a
    fresh random order — so the coalesced GROUPS never repeat, only the
    member subgraphs do. Per-key hit rate over the shuffled window must
    be ≥90% (it is 100% here: every member is cached) and the logits must
    be bit-identical to a cache-disabled server building everything from
    scratch on the identical traffic. Under the old per-group keying this
    arm's hit rate was 0%.
    """
    name = "ogbn-arxiv"
    dev = resolve_device(device)
    cfg, qparams, reqs, buckets = _setup(name, scale, parts_k, dev)
    rng = np.random.default_rng(seed)
    warm = GNNServer(qparams, cfg, buckets=buckets, devices=[dev])
    for r in reqs:  # cold wave: builds the per-subgraph entries
        warm.submit(_fresh(r))
    warm.drain()
    hits0 = warm.cache.hits
    total0 = warm.cache.hits + warm.cache.misses
    warm.stats.batch_latencies_s.clear()
    n0, t_warm = warm.stats.nodes, 0.0
    mismatches = 0
    for _ in range(rounds):
        order = rng.permutation(len(reqs))
        ref = GNNServer(qparams, cfg, buckets=buckets, cache_entries=0,
                        devices=[dev])
        wids, rids = [], []
        # warm-server window timed alone: the scratch server's
        # construction and scratch builds must not deflate the reported
        # serving throughput
        t0 = time.perf_counter()
        for i in order:
            wids.append(warm.submit(_fresh(reqs[i])))
        got_w = warm.drain(return_logits=True)
        t_warm += time.perf_counter() - t0
        for i in order:
            rids.append(ref.submit(_fresh(reqs[i])))
        got_r = ref.drain(return_logits=True)
        for wid, rid in zip(wids, rids):
            if not np.array_equal(got_w[wid][1], got_r[rid][1]):
                mismatches += 1
    nps = (warm.stats.nodes - n0) / t_warm
    hit_rate = (warm.cache.hits - hits0) / max(
        warm.cache.hits + warm.cache.misses - total0, 1)
    rec = {
        "op": "serve_shuffled", "bits": warm.feat_bits,
        "sparsity": round(warm.stats.zero_tile_skip_ratio, 4),
        "jump": "none", "median_ms": round(warm.stats.p50_s * 1e3, 3),
        "nodes_per_s": round(nps, 1),
        "cache_hit_rate": round(hit_rate, 4),
        "full_hit_batches": warm.cache.full_hits,
        "partial_hit_batches": warm.cache.partial_hits,
    }
    emit(f"serve_{name}_shuffled", rec["cache_hit_rate"], "hit_rate",
         p50_ms=rec["median_ms"], full_hits=rec["full_hit_batches"],
         partial_hits=rec["partial_hit_batches"])
    assert mismatches == 0, (
        f"{mismatches} requests diverged from the scratch build under "
        f"shuffled coalescing")
    assert hit_rate >= 0.9, (
        f"shuffled-coalescing hit rate {hit_rate:.2%} < 90%: per-subgraph "
        f"composition is not order-insensitive")
    return [rec]


def failover_arm(scale: float = 0.008, parts_k: int = 16,
                 rounds: int = 4, device=None) -> list[dict]:
    """Chaos-tested replica failover: kill one replica mid-serve.

    Three arms on identical repeat traffic over a 3-replica (virtual)
    fleet, with the node budget pinned to one tile so every coalesced
    plan is exactly one request — plan membership (which sets the §4.6
    batch quantization scale) is then identical across arms, making
    per-request logits comparable bit-for-bit:

      clean    — no faults; the per-request reference logits.
      failover — ``kill@2`` via the chaos harness: one replica dies
                 mid-serve. Every submitted request must still complete
                 (ZERO lost), logits bit-identical to the clean arm, the
                 in-flight plan retried on a survivor, the dead replica's
                 fingerprints re-homed, and the per-key hit rate in the
                 final round recovered above 90% (the re-homed keys miss
                 once while the survivor's cache re-warms, then hit).
      shed     — a depth-bounded queue under burst arrival: rejected
                 submits must carry a FINITE, positive ``retry_after_s``
                 backoff hint (the queue-wait/latency p95 window).
    """
    import math

    from repro_torch.serve import FaultInjector

    name = "ogbn-arxiv"
    dev = resolve_device(device)
    cfg, qparams, reqs, buckets = _setup(name, scale, parts_k, dev)
    tile = GNNServer(qparams, cfg, buckets=buckets, devices=[dev]).align
    bad = [r.n_nodes for r in reqs if r.n_nodes > tile]
    assert not bad, (
        f"failover arm needs single-request plans (one per {tile}-node "
        f"tile) for bit-identical comparison; partition finer: {bad}")

    def run(tag, chaos=None):
        srv = GNNServer(qparams, cfg, buckets=buckets, node_budget=tile,
                        replicas=3, chaos=chaos, devices=[dev])
        outs, round_hits = [], []
        t0 = time.perf_counter()
        for _ in range(rounds):
            h0, m0 = srv.cache.hits, srv.cache.misses
            ids = [srv.submit(_fresh(r)) for r in reqs]
            got = srv.drain(return_logits=True)
            assert set(ids) <= set(got), f"{tag}: lost requests"
            outs.append([np.asarray(got[i][1]) for i in ids])
            dh = srv.cache.hits - h0
            dm = srv.cache.misses - m0
            round_hits.append(dh / max(dh + dm, 1))
        return srv, outs, round_hits, time.perf_counter() - t0

    clean_srv, clean_out, _, t_clean = run("clean")
    chaos = FaultInjector("kill@2")
    fo_srv, fo_out, fo_hits, t_fo = run("failover", chaos=chaos)

    lost = sum(len(a) - len(b) for a, b in zip(clean_out, fo_out))
    mismatch = sum(
        not np.array_equal(a, b)
        for ca, fa in zip(clean_out, fo_out) for a, b in zip(ca, fa))
    st = fo_srv.stats
    assert chaos.fired and chaos.fired[0]["kind"] == "kill"
    assert lost == 0, f"failover lost {lost} requests"
    assert mismatch == 0, (
        f"{mismatch} requests' logits diverged from the no-fault run "
        f"after failover")
    assert st.requests_retried > 0 and st.replica_faults == 1
    assert st.replicas_live == 2
    hit_floor = 0.9
    assert fo_hits[-1] >= hit_floor, (
        f"post-failover hit rate {fo_hits[-1]:.2%} never recovered above "
        f"{hit_floor:.0%}: re-homed fingerprints are not re-warming")

    # shed arm: burst arrival into a depth-bounded queue -> finite hints
    shed_srv = GNNServer(qparams, cfg, buckets=buckets, node_budget=tile,
                         replicas=3, devices=[dev],
                         admission=AdmissionPolicy(max_depth=4,
                                                   on_full="reject"))
    for _ in range(2):
        for r in reqs:
            shed_srv.submit(_fresh(r))
    shed_srv.drain()
    sst = shed_srv.stats
    assert sst.requests_shed > 0, "depth-4 queue under burst did not shed"
    assert math.isfinite(sst.retry_after_s) and sst.retry_after_s > 0, (
        f"shed submits must carry a finite retry-after hint, got "
        f"{sst.retry_after_s}")

    records = []
    for tag, srv, dt, extra in (
            ("clean", clean_srv, t_clean, {}),
            ("failover", fo_srv, t_fo,
             {"lost": lost, "logits_match": mismatch == 0,
              "retried": st.requests_retried,
              "replicas_live": st.replicas_live,
              "rehomed_entries": st.cache_rehomed_entries,
              "hit_rate_final": round(fo_hits[-1], 4)}),
            ("shed", shed_srv, None,
             {"shed": sst.requests_shed,
              "retry_after_s": round(sst.retry_after_s, 6)})):
        s = srv.stats
        nps = (s.nodes / dt) if dt else s.nodes_per_s
        rec = {"op": "serve_failover", "bits": srv.feat_bits,
               "sparsity": round(s.zero_tile_skip_ratio, 4), "jump": "none",
               "median_ms": round(s.p50_s * 1e3, 3),
               "nodes_per_s": round(nps, 1), "arm": tag, **extra}
        records.append(rec)
        emit(f"serve_{name}_failover_{tag}", rec["nodes_per_s"],
             "nodes_per_s", **extra)
    return records


ARMS = {
    "main": main,
    "jump_arm": jump_arm,
    "sgt_arm": sgt_arm,
    "overload_arm": overload_arm,
    "shuffled_arm": shuffled_arm,
    "failover_arm": failover_arm,
}

# smoke-scale overrides per arm (small graphs, few rounds)
SMOKE_KW = {
    "main": dict(scale=0.004, parts_k=4, rounds=2),
    "jump_arm": dict(scale=0.004, parts_k=4, rounds=2),
    "sgt_arm": dict(scale=0.004, parts_k=4, rounds=2),
    "overload_arm": dict(scale=0.004, parts_k=4, bursts=3),
    "shuffled_arm": dict(scale=0.004, parts_k=4, rounds=2),
    "failover_arm": dict(scale=0.004, parts_k=16, rounds=3),
}


def run_arms(device=None, sizes=None) -> list[dict]:
    """Run every arm, each at its default sizes or at ``sizes[arm]``;
    returns the arms' records."""
    sizes = sizes or {}
    out: list[dict] = []
    for name, arm in ARMS.items():
        out.extend(arm(device=device, **sizes.get(name, {})) or [])
    return out
