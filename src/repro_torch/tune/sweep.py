"""Declarative ExecutionPolicy sweep: measure a grid, persist the winners.

The reference's ``repro.tune.sweep`` for the port. A sweep CONFIG is a
plain dict (usually a JSON file, e.g. ``tune/sweeps/h100.json``)
describing a measurement grid:

  name           — stamped into the emitted table's provenance metadata
  ops            — subset of ("bgemm", "bitserial_mm", "bitserial_fused")
  bits           — operand bitwidths (bgemm cells run only at 1 bit)
  sparsity_bands — zeroed fractions of A's reduction dim (a leading,
                   tile-aligned band, kernel_bench's generator)
  shapes         — [m, k, n] shape buckets
  backend        — engine the candidates run on (default "cuda")
  candidates     — list of ExecutionPolicy field-override dicts applied
                   over DEFAULT_POLICY ({} = the hand-picked default arm)
  iters/warmup   — timing repeats (median) / warm-up runs per arm
  seed           — numpy seed of the operands (default 0)
  serve          — optional serving section (dataset/scale/parts/rounds/
                   feat_bits/levels/candidates, and node_budget and
                   cache_entries): streams repeat subgraph traffic through
                   GNNServer per candidate and emits one "serve_forward"
                   table entry per shape bucket

The reference's engines map to the port's: "pallas" is "cuda" (the
hand-written kernels) and the parity engine "xla_dot" is "torch_dot".
Operands go on ``resolve_device(device)``, so the default is the card.
Every candidate is asserted equal (``torch.equal``) to the dense
``torch_dot`` product AS it is timed (``perf.report.bench_median``, each
call with its dispatch), so a sweep doubles as an exactness gate.
Invalid candidates (a tile ExecutionPolicy rejects) are not errors: they
are recorded in ``SweepResult.rejected`` with the construction-time
ValueError text prefixed by the offending location
(``<config source>:candidates[i]``).

Timed arms also become BENCH-style trajectory records (``phase:
"sweep"``, the op spelled ``bitserial_gemm``, one ``best`` a cell) that
``repro_torch.launch.sweep --bench-out`` merges into a file of its own.
"""
from __future__ import annotations

import dataclasses
import inspect
import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.api.policy import DEFAULT_POLICY
from repro_torch.core import bitops, zerotile
from repro_torch.device import resolve_device
from repro_torch.kernels import sgt as sgt_lib
from repro_torch.perf.report import bench_median, percentile
from repro_torch.tune.table import (TableEntry, TuningTable, policy_to_dict,
                                    provenance)

__all__ = ["KERNEL_OPS", "DEFAULT_CANDIDATES", "SMOKE_CONFIG",
           "SweepResult", "run_sweep"]

KERNEL_OPS = ("bgemm", "bitserial_mm", "bitserial_fused")

# dispatch-layer op name -> the historical BENCH_kernels.json spelling
_BENCH_OP = {"bitserial_mm": "bitserial_gemm"}

PARITY_BACKEND = "torch_dot"

DEFAULT_CANDIDATES = (
    {},                              # the hand-picked DEFAULT_POLICY arm
    {"jump": "mask"},
    {"jump": "compact"},
    {"jump": "sgt"},                 # sparse-graph translation (kernels/sgt)
    {"mode": "mxu"},
    {"block_m": 16, "block_w": 8},
)

# Tiny grid for `repro_torch.launch.sweep --smoke`: one shape, two bands,
# four candidates, one of them deliberately invalid to exercise the
# legible rejection end to end: 8 x 150 = 1200 threads, neither whole
# warps nor within the port's 1024 (the reference's invalid block_m=12
# and block_n=100 are whole warps here, so valid).
SMOKE_CONFIG = {
    "name": "smoke",
    "ops": ["bgemm", "bitserial_mm"],
    "bits": [1, 2],
    "sparsity_bands": [0.0, 0.9],
    "shapes": [[16, 256, 16]],
    "backend": "cuda",
    "candidates": [{}, {"jump": "compact"}, {"jump": "sgt"},
                   {"block_n": 150}],
    "iters": 2,
    "warmup": 1,
    "serve": {
        "dataset": "ogbn-arxiv", "scale": 0.004, "parts": 4,
        "rounds": 1, "levels": 2,
        "candidates": [{}, {"jump": "compact"}, {"jump": "sgt"}],
    },
}


@dataclasses.dataclass
class SweepResult:
    table: TuningTable
    records: list        # BENCH-style trajectory records (phase: "sweep")
    rejected: list       # [{candidate, source, error}]: invalid overrides,
                         # error prefixed with the offending source:candidates[i]


def _banded(rng, m, k, bits, sparsity):
    """s-bit operand with a leading zero band covering ``sparsity`` of K
    (tile-aligned under any block split: kernel_bench's generator)."""
    a = rng.integers(1, 1 << bits, (m, k)).astype(np.int32)
    z = int(k * sparsity)
    if z:
        a[:, :z] = 0
    return a


def _cells(config):
    for op in config.get("ops", KERNEL_OPS):
        if op not in KERNEL_OPS:
            raise ValueError(f"unknown sweep op {op!r} "
                             f"(expected one of {KERNEL_OPS})")
        for bits in config.get("bits", (1, 2, 4)):
            if op == "bgemm" and bits != 1:
                continue  # bgemm is the 1-bit kernel by definition
            for band in config.get("sparsity_bands", (0.0, 0.5, 0.9)):
                for shape in config.get("shapes", ((64, 2048, 64),)):
                    m, k, n = (int(x) for x in shape)
                    yield op, int(bits), float(band), (m, k, n)


def _candidates(raw, rejected, source="config"):
    """Validate policy-override dicts; invalid ones -> rejected, legibly.

    Each candidate is tagged ``{source}:candidates[i]`` so a rejection in
    a generated grid points back at the grid, not just at the ValueError
    text. Returns ``(override, policy, source_tag)`` triples for the
    valid candidates."""
    out = []
    for i, ov in enumerate(raw):
        src = f"{source}:candidates[{i}]"
        try:
            pol = DEFAULT_POLICY.replace(**dict(ov))
        except (TypeError, ValueError) as e:
            rejected.append({"candidate": dict(ov), "source": src,
                             "error": f"{src}: {e}"})
            continue
        out.append((dict(ov), pol, src))
    return out


def _cell_runner(op, backend, ap, bp, alpha, beta):
    """One callable per cell: dispatch with an EXPLICIT backend and policy.

    An explicit policy means `resolve` never consults the active tuning
    table here: the sweep measures candidates, it must not recurse into
    its own output.
    """
    def run(pol, tiles=None):
        if op == "bgemm":
            return api.bgemm(ap[0], bp[0], backend=backend, policy=pol,
                             tiles=tiles)
        if op == "bitserial_mm":
            return api.bitserial_mm_packed(ap, bp, backend=backend,
                                           policy=pol, tiles=tiles)
        return api.bitserial_fused(ap, bp, alpha, beta, out_bits=4,
                                   relu=True, backend=backend, policy=pol,
                                   tiles=tiles)
    return run


def _sweep_cell(op, bits, band, shape, backend, cands, iters, warmup,
                rng, log, dev):
    m, k, n = shape
    a = _banded(rng, m, k, bits, band)
    b = rng.integers(0, 1 << bits, (k, n)).astype(np.int32)
    ap = bitops.pack_a(torch.as_tensor(a, device=dev), bits)
    bp = bitops.pack_b(torch.as_tensor(b, device=dev), bits)
    alpha = torch.full((m, 1), 0.01, dtype=torch.float32, device=dev)
    beta = torch.zeros((1, n), dtype=torch.float32, device=dev)
    run = _cell_runner(op, backend, ap, bp, alpha, beta)
    # the dense plain engine: the parity target
    ref = _cell_runner(op, PARITY_BACKEND, ap, bp, alpha, beta)(DEFAULT_POLICY)
    tiles_by_grid = {}
    sgt_by_bm = {}
    records, arms = [], []
    for ov, pol, _src in cands:
        tiles = None
        if pol.jump == "compact":
            grid = (pol.block_m, pol.block_w)
            if grid not in tiles_by_grid:
                # precomputed artifacts with the true max count: the
                # contract the compact path is honest under when serving
                tiles_by_grid[grid] = zerotile.compact_artifacts(ap, *grid)
            tiles = tiles_by_grid[grid]
        elif pol.jump == "sgt":
            # translation artifacts depend only on block_m (word-granular
            # remap), so they survive block_w-varying candidates
            if pol.block_m not in sgt_by_bm:
                sgt_by_bm[pol.block_m] = sgt_lib.sgt_artifacts(ap,
                                                               pol.block_m)
            tiles = sgt_by_bm[pol.block_m]
        out = run(pol, tiles)
        if not torch.equal(out, ref):
            raise AssertionError(
                f"sweep parity: {op} {bits}b z{band} {shape} {backend} "
                f"candidate {ov} differs from {PARITY_BACKEND}")
        ms = bench_median(run, pol, tiles, warmup=warmup, iters=iters) * 1e3
        rec = {
            "op": _BENCH_OP.get(op, op), "bits": bits, "sparsity": band,
            "jump": pol.jump, "median_ms": ms,
            "m": m, "k": k, "n": n, "backend": backend,
            "phase": "sweep", "candidate": dict(ov),
            "policy": policy_to_dict(pol),
        }
        records.append(rec)
        arms.append((ms, ov, pol, rec))
    best_ms, best_ov, best_pol, best_rec = min(arms, key=lambda x: x[0])
    best_rec["best"] = True
    baseline = next((ms for ms, ov, _, _ in arms if not ov), None)
    entry = TableEntry(op=op, bits=bits, sparsity_band=band,
                       shape_bucket=shape, policy=best_pol, backend=backend,
                       median_ms=best_ms, baseline_ms=baseline)
    log(f"[sweep] {op} {bits}b z{band} {shape}: best={best_ov or 'default'} "
        f"{best_ms:.5f}ms" + (f" (default {baseline:.5f}ms)"
                              if baseline is not None else ""))
    return entry, records


# ---------------------------------------------------------------- serve arm

def _sweep_serve(scfg, rejected, log, source="config", device=None):
    """Stream repeat traffic through GNNServer per candidate; the winner
    (by nodes/s, logits asserted equal across candidates) becomes one
    serve_forward entry per shape bucket.

    Candidates must keep DEFAULT_POLICY's tile grid: the bucket ladder,
    offset alignment and cache composition are all built on it, so a
    grid-changing candidate is rejected legibly, not silently mistuned.
    ``node_budget`` sets the top bucket (else ``buckets_for`` sizes it from
    the traffic), each request taking at least one tile-sized slot;
    ``cache_entries`` the tile cache (else the server's default).
    """
    from repro_torch.graph import datasets, partition
    from repro_torch.models import gnn
    from repro_torch.serve import GNNServer, SubgraphRequest
    from repro_torch.serve.queue import (buckets_for, make_buckets,
                                         requests_from_partitions)

    dev = resolve_device(device)
    backend = scfg.get("backend", "cuda")
    feat_bits = int(scfg.get("feat_bits", 8))
    rounds = int(scfg.get("rounds", 1))
    levels = int(scfg.get("levels", 2))
    data = datasets.load(scfg.get("dataset", "ogbn-arxiv"),
                         scale=float(scfg.get("scale", 0.004)))
    parts = partition.partition(data.csr, int(scfg.get("parts", 4)))
    cfg = gnn.GNNConfig.paper_gcn(data.features.shape[1], data.n_classes,
                                  x_bits=feat_bits, w_bits=feat_bits)
    qparams = gnn.quantize_params(gnn.init_params(
        cfg, generator=torch.Generator().manual_seed(0), device=dev), cfg)
    reqs = requests_from_partitions(data, parts)
    if scfg.get("node_budget"):
        tile = 128
        budget = int(scfg["node_budget"])
        buckets = make_buckets(
            node_budget=budget,
            edge_budget=(budget // tile) * max(r.n_edges for r in reqs),
            tile=tile, levels=levels)
    else:
        buckets = buckets_for(reqs, levels=levels)
    server_kw = {}
    if scfg.get("cache_entries") is not None:
        server_kw["cache_entries"] = int(scfg["cache_entries"])

    def fresh(r):
        return SubgraphRequest(edges=r.edges, features=r.features,
                               n_nodes=r.n_nodes)

    default_grid = (DEFAULT_POLICY.block_m, DEFAULT_POLICY.block_n,
                    DEFAULT_POLICY.block_w)
    arms, records = [], []
    ref_logits = None
    for ov, pol, src in _candidates(scfg.get("candidates",
                                             ({}, {"jump": "compact"})),
                                    rejected, source=f"{source}:serve"):
        if (pol.block_m, pol.block_n, pol.block_w) != default_grid:
            rejected.append({
                "candidate": dict(ov), "source": src,
                "error": f"{src}: serve sweep candidates must keep the "
                         f"default tile grid (the bucket ladder and cache "
                         f"composition are built on it)"})
            continue
        srv = GNNServer(qparams, cfg, feat_bits=feat_bits, backend=backend,
                        policy=pol, buckets=buckets, tuning_table=None,
                        devices=[dev], **server_kw)
        for r in reqs:  # warm-up wave: first shapes + tile-cache misses
            srv.submit(fresh(r))
        srv.drain()
        srv.stats.batch_latencies_s.clear()
        n0, t0 = srv.stats.nodes, time.perf_counter()
        logits = []
        for _ in range(rounds):
            ids = [srv.submit(fresh(r)) for r in reqs]
            out = srv.drain(return_logits=True)
            logits = [out[i][1] for i in ids]
        dt = time.perf_counter() - t0
        nps = (srv.stats.nodes - n0) / dt
        if ref_logits is None:
            ref_logits = logits
        else:  # tuning must never change answers: assert as we measure
            for got, want in zip(logits, ref_logits):
                np.testing.assert_array_equal(
                    np.asarray(got), np.asarray(want),
                    err_msg=f"serve sweep parity: candidate {ov}")
        p50_ms = 1e3 * percentile(list(srv.stats.batch_latencies_s), 50)
        skip = round(srv.stats.zero_tile_skip_ratio, 4)
        rec = {
            "op": "serve_forward", "bits": feat_bits, "sparsity": skip,
            "jump": pol.jump, "median_ms": p50_ms,
            "nodes_per_s": nps, "backend": backend,
            "phase": "sweep", "candidate": dict(ov),
            "policy": policy_to_dict(pol),
        }
        records.append(rec)
        arms.append((nps, ov, pol, skip, p50_ms, rec))
        log(f"[sweep] serve candidate {ov or 'default'}: "
            f"{nps:.1f} nodes/s, p50 {p50_ms:.3f}ms, skip {skip}")
    if not arms:
        return [], records
    nps, ov, pol, skip, p50_ms, rec = max(arms, key=lambda x: x[0])
    rec["best"] = True
    base_p50 = next((a[4] for a in arms if not a[1]), None)
    entries = [TableEntry(op="serve_forward", bits=feat_bits,
                          sparsity_band=skip,
                          shape_bucket=(b.n_pad, b.n_pad, cfg.in_dim),
                          policy=pol, backend=backend, median_ms=p50_ms,
                          baseline_ms=base_p50)
               for b in buckets]
    log(f"[sweep] serve best={ov or 'default'} -> "
        f"{len(entries)} bucket entries")
    return entries, records


# --------------------------------------------------------------- entry point

def run_sweep(config: dict, *, log=print, source: str | None = None,
              device=None) -> SweepResult:
    """Measure the config's grid on ``device`` (None: the card); returns
    the table and the trajectory records.

    ``source`` names where the config came from (its JSON path, or e.g.
    ``".../sweep.py:SMOKE_CONFIG"``) so candidate rejections carry the
    offending location; when omitted it falls back to ``config["source"]``
    and then to the caller's ``file:line``."""
    if source is None:
        source = config.get("source")
    if source is None:
        caller = inspect.stack()[1]
        source = f"{caller.filename}:{caller.lineno}"
    dev = resolve_device(device)
    rejected: list = []
    cands = _candidates(config.get("candidates", DEFAULT_CANDIDATES),
                        rejected, source=source)
    if not cands:
        raise ValueError(
            f"no valid policy candidates in config "
            f"{config.get('name', '?')!r}: {rejected}")
    backend = config.get("backend", "cuda")
    iters = int(config.get("iters", 3))
    warmup = int(config.get("warmup", 1))
    rng = np.random.default_rng(int(config.get("seed", 0)))
    entries, records = [], []
    for op, bits, band, shape in _cells(config):
        entry, recs = _sweep_cell(op, bits, band, shape, backend, cands,
                                  iters, warmup, rng, log, dev)
        entries.append(entry)
        records.extend(recs)
    if config.get("serve"):
        scfg = dict(config["serve"])
        scfg.setdefault("backend", backend)
        serve_entries, serve_recs = _sweep_serve(scfg, rejected, log,
                                                 source=source, device=dev)
        entries.extend(serve_entries)
        records.extend(serve_recs)
    meta = provenance({
        "config": config.get("name", "unnamed"),
        "generated_by": "repro_torch.launch.sweep",
        "candidates": [dict(ov) for ov, _, _ in cands],
        "swept_on": dev.type,
    })
    table = TuningTable(entries, meta=meta)
    for rej in rejected:
        log(f"[sweep] rejected candidate {rej['candidate']}: "
            f"{rej['error']}")
    return SweepResult(table=table, records=records, rejected=rejected)
