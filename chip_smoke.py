#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases run in order; any failure raises and the script exits non-zero
without printing a result:

  1. device and build — the card's name and power limit (nvidia-smi), and
     the bit-serial kernel built from src/repro_torch/csrc with nvcc.
  2. kernel against plain — the kernel and its plain PyTorch version on
     the same CUDA tensors, in the dense, mask, compact and sgt schedules,
     at ragged shapes and at the main path's own shapes; the int32 results
     must be equal (torch.equal), and equal to the exact product.
  3. main path — ogbn-arxiv at full scale, partitioned into 1500 parts
     (Cluster-GCN's setting), batches of 20 parts; the first 8 batches
     are served through forward_qgtc for qgtc-gcn and qgtc-gin at 8, 4
     and 2 bits, with no jumping, compact tiles and sgt tiles. The kernel
     engine's logits must equal the plain engine's bit for bit, and the
     kernel must launch 6 times per GCN forward and 9 per GIN forward.
  4. timing, fig7-style — per batch, CUDA events, median over repeats:
     fp32_dense, fp32_csr, qgtc at 8/4/2 bits; the kernel alone at the
     adjacency GEMM's shape beside its plain version, its bound, and one
     float32 torch.matmul on the unpacked values (exact: every sum stays
     below 2**24) as the library yardstick, which the port never calls.
  5. profile — one qgtc forward per model under torch.profiler: host wall
     time, device time of its kernels, and the device's idle share.

The line before the last lists each kernel as JSON; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
DATASET, SCALE, PARTS, BATCH_PARTS, N_BATCHES = "ogbn-arxiv", 1.0, 1500, 20, 8
DEVICE = "cuda"
BITS = (8, 4, 2)
ST_PAIRS = ((1, 1), (1, 8), (2, 4), (3, 5), (8, 8))
RAGGED = ((37, 333, 5), (61, 1000, 70))
# H100 SXM published peaks: HBM bytes/s, and the 32-bit rate outside the
# tensor cores, which is where the kernel's AND and popcount run.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


def emit(**kw):
    print(json.dumps(kw), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, *, warmup=3, reps=10, repeats=5) -> float:
    """Median over ``repeats`` of CUDA-event time per call over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def graph_ms(torch, fn, *, reps=50, repeats=5) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph, so
    the host's launch cost is not in the number."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def bound(a_packed, t, n) -> tuple[float, str]:
    """Least time (ms) for the bit-serial GEMM on these inputs, and what
    bounds it.

    Bytes: every input word read once, every output written once. Operations:
    one AND and one popcount per non-zero word of A, per plane of B, per
    output column; a zero word adds nothing, whatever the schedule, so the
    work this data needs counts only the non-zero ones."""
    s, m, w = a_packed.shape
    nonzero_words = int((a_packed != 0).sum())
    nbytes = 4 * (s * m * w + t * w * n + m * n)
    ops = 2 * t * n * nonzero_words
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_vs_plain(torch, card):
    from repro_torch.api import DEFAULT_POLICY as pol
    from repro_torch.core import bitops, zerotile
    from repro_torch.kernels import bitserial, ops, sgt

    gen = torch.Generator().manual_seed(1)

    def operand(m, k, bits, pattern):
        a = torch.randint(0, 1 << bits, (m, k), generator=gen, dtype=torch.int32)
        if pattern == "zero":
            a.zero_()
        elif pattern == "block_diag":
            out = torch.zeros_like(a)
            sm, sk = max(m // 4, 1), max(k // 4, 1)
            for i in range(4):
                out[i * sm:(i + 1) * sm, i * sk:(i + 1) * sk] = \
                    a[i * sm:(i + 1) * sm, i * sk:(i + 1) * sk]
            a = out
        return a

    cases = [(shape, st) for shape in RAGGED for st in ST_PAIRS]
    cases += [((2048, 2048, 16), (1, 8)), ((2048, 128, 64), (8, 8))]
    max_err, n_checks = 0, 0
    for (m, k, n), (s, t) in cases:
        for pattern in ("random", "zero", "block_diag"):
            a = operand(m, k, s, pattern)
            b = torch.randint(0, 1 << t, (k, n), generator=gen, dtype=torch.int32)
            exact = (a.double() @ b.double()).to(torch.int32).to(DEVICE)
            ap, bp = bitops.pack_a(a, s).to(DEVICE), bitops.pack_b(b, t).to(DEVICE)
            a_pad = bitops.pad_to(bitops.pad_to(ap, 1, pol.block_m), 2, pol.block_w)
            b_pad = bitops.pad_to(bp, 1, pol.block_w)
            occ = zerotile.tile_occupancy_planes(a_pad, pol.block_m, pol.block_w)
            ctiles = zerotile.compact_artifacts(ap, pol.block_m, pol.block_w)
            stiles = sgt.sgt_artifacts(ap, pol.block_m)
            schedules = {
                "dense": ({}, {}),
                "mask": ({"occupancy": occ}, {"occupancy": occ}),
                "compact": ({"tiles": ctiles},
                            {"compact": (ctiles[0], ctiles[1], ctiles[2])}),
                "sgt": ({"tiles": stiles},
                        {"sgt": (stiles[0], stiles[1], stiles[2])}),
            }
            for name, (wrap_kw, plain_kw) in schedules.items():
                got = ops.bitserial_gemm(ap, bp, **wrap_kw)
                plain = bitserial.bitserial_gemm_plain(
                    a_pad, b_pad, block_m=pol.block_m, block_w=pol.block_w,
                    **plain_kw)[:m]
                torch.cuda.synchronize()
                if not (torch.equal(got, plain) and torch.equal(got, exact)):
                    raise AssertionError(
                        f"kernel != plain at {(m, k, n)} s={s} t={t} "
                        f"{pattern} {name}")
                err = (got.long() - plain.long()).abs().max().item()
                max_err, n_checks = max(max_err, err), n_checks + 1
    emit(phase="kernel_vs_plain", kernel="bitserial_gemm", checks=n_checks,
         schedules=["dense", "mask", "compact", "sgt"],
         st_pairs=[list(p) for p in ST_PAIRS], ragged=[list(r) for r in RAGGED],
         path_shapes=[[2048, 2048, 16, 1, 8], [2048, 128, 64, 8, 8]],
         patterns=["random", "zero", "block_diag"], equal=True,
         max_abs_err=max_err, card=card)
    return max_err


def phase_main_path(torch, card):
    from repro_torch.api import DEFAULT_POLICY as pol
    from repro_torch.configs.qgtc_gnn import GNN_CONFIGS
    from repro_torch.core import bitops, zerotile
    from repro_torch.graph import batching, datasets, partition
    from repro_torch.kernels import bitserial, sgt
    from repro_torch.models import gnn
    from repro_torch.train.trainer import make_device_batch

    t0 = time.perf_counter()
    data = datasets.load(DATASET, scale=SCALE, seed=0)
    t1 = time.perf_counter()
    parts = partition.partition(data.csr, PARTS)
    t2 = time.perf_counter()
    batches = batching.make_batches(data, parts, BATCH_PARTS)[:N_BATCHES]
    t3 = time.perf_counter()
    emit(phase="data", dataset=DATASET, scale=SCALE, nodes=data.csr.n,
         directed_edges=data.csr.e, parts=PARTS, batch_parts=BATCH_PARTS,
         batch_nodes=[b.n_nodes for b in batches],
         batch_edges=[b.n_edges for b in batches], load_s=t1 - t0,
         partition_s=t2 - t1, batching_s=t3 - t2)

    dbs, tiles = [], []
    for b in batches:
        db = make_device_batch(b, device=DEVICE)
        db["edges"] = torch.as_tensor(b.edges, device=DEVICE)
        ap = bitops.pack_a(db["adj"], 1)
        dbs.append(db)
        tiles.append({"none": None,
                      "compact": zerotile.compact_artifacts(
                          ap, pol.block_m, pol.block_w),
                      "sgt": sgt.sgt_artifacts(ap, pol.block_m)})
    occ = [zerotile.occupancy_stats(zerotile.tile_occupancy(
        bitops.pack_a(db["adj"], 1)[0], pol.block_m, pol.block_w))["nonzero_ratio"]
        for db in dbs]
    emit(phase="artifacts", tile_nonzero_ratio=occ,
         compact_s_max=[t["compact"][2] for t in tiles],
         sgt_s_w=[t["sgt"][2] for t in tiles])

    models = {}
    for name, cfg in GNN_CONFIGS.items():
        params = gnn.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device=DEVICE)
        per_bits = {}
        for bits in BITS:
            cfg_b = dataclasses.replace(cfg, x_bits=bits, w_bits=bits)
            per_bits[bits] = (cfg_b, gnn.quantize_params(params, cfg_b))
        models[name] = (cfg, params, per_bits)

    per_forward = {"gcn": 6, "gin": 9}
    bitserial.reset_launches()
    expected = 0
    for name, (cfg, _, per_bits) in models.items():
        for bits, (cfg_b, qp) in per_bits.items():
            for jump in ("none", "compact", "sgt"):
                for db, tl in zip(dbs, tiles):
                    before = bitserial.LAUNCHES["bitserial_gemm"]
                    got = gnn.forward_qgtc(qp, db["adj"], db["x"], db["inv_deg"],
                                           cfg_b, backend="cuda", tiles=tl[jump])
                    launched = bitserial.LAUNCHES["bitserial_gemm"] - before
                    want = gnn.forward_qgtc(qp, db["adj"], db["x"], db["inv_deg"],
                                            cfg_b, backend="popcount",
                                            tiles=tl[jump])
                    if launched != per_forward[cfg.model]:
                        raise AssertionError(
                            f"{name} launched the kernel {launched} times, "
                            f"expected {per_forward[cfg.model]}")
                    if got.shape != (db["adj"].shape[0], cfg.n_classes) or \
                            not bool(torch.isfinite(got).all()):
                        raise AssertionError(f"{name} logits: bad shape or values")
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"{name} {bits}b jump={jump}: kernel engine logits "
                            f"differ from the plain engine's")
                    expected += launched
                emit(phase="main_path", model=name, bits=bits, jump=jump,
                     batches=len(dbs), logits_equal_plain=True,
                     launches_per_forward=per_forward[cfg.model])
    launches = bitserial.LAUNCHES["bitserial_gemm"]
    if launches == 0 or launches != expected:
        raise AssertionError(f"kernel launches on the main path: {launches}, "
                             f"expected {expected}")
    emit(phase="launches", kernel="bitserial_gemm", launches=launches,
         forwards=len(dbs) * len(BITS) * 3 * len(models))

    # the whole port on the CPU, on the first batch, as the reference the card
    # is held to: integer products are exact on both, and each float step is
    # one IEEE operation on both, so the logits agree to within 1e-5
    cpu_db = make_device_batch(batches[0], device="cpu")
    for name, (cfg, params, per_bits) in models.items():
        cfg_b, qp = per_bits[8]
        params_cpu = {layer: {k: v.cpu() for k, v in p.items()}
                      for layer, p in params.items()}
        qp_cpu = gnn.quantize_params(params_cpu, cfg_b)
        on_card = gnn.forward_qgtc(qp, dbs[0]["adj"], dbs[0]["x"],
                                   dbs[0]["inv_deg"], cfg_b).cpu()
        on_cpu = gnn.forward_qgtc(qp_cpu, cpu_db["adj"], cpu_db["x"],
                                  cpu_db["inv_deg"], cfg_b)
        diff = (on_card - on_cpu).abs().max().item()
        if not torch.allclose(on_card, on_cpu, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"{name}: card and CPU logits differ by {diff}")
        dense = gnn.forward(params, dbs[0]["adj"], dbs[0]["x"],
                            dbs[0]["inv_deg"], cfg)
        csr = gnn.forward(params, dbs[0]["edges"], dbs[0]["x"],
                          dbs[0]["inv_deg"], cfg, path="fp32_csr")
        fp_diff = (dense - csr).abs().max().item()
        if not torch.allclose(dense, csr, rtol=1e-4, atol=1e-5):
            raise AssertionError(f"{name}: fp32_dense and fp32_csr differ by "
                                 f"{fp_diff}")
        emit(phase="reference", model=name, qgtc8_card_vs_cpu_max_abs=diff,
             fp32_dense_vs_csr_max_abs=fp_diff, card=card)
    return models, dbs, tiles, launches


def phase_timing(torch, card, models, dbs, tiles):
    from repro_torch.api import DEFAULT_POLICY as pol
    from repro_torch.core import bitops
    from repro_torch.kernels import bitserial, ops
    from repro_torch.models import gnn

    for name, (cfg, params, per_bits) in models.items():
        runs = {
            "fp32_dense": lambda db: gnn.forward(params, db["adj"], db["x"],
                                                 db["inv_deg"], cfg),
            "fp32_csr": lambda db: gnn.forward(params, db["edges"], db["x"],
                                               db["inv_deg"], cfg,
                                               path="fp32_csr"),
        }
        for bits, (cfg_b, qp) in per_bits.items():
            runs[f"qgtc{bits}"] = (
                lambda db, cfg_b=cfg_b, qp=qp: gnn.forward_qgtc(
                    qp, db["adj"], db["x"], db["inv_deg"], cfg_b))
        for path, fn in runs.items():
            per_batch = [time_ms(torch, lambda db=db: fn(db)) for db in dbs]
            emit(phase="fig7", model=name, path=path, unit="ms",
                 median_ms=statistics.median(per_batch), per_batch_ms=per_batch,
                 card=card)

    # the kernel alone at the adjacency GEMM of the first batch: 1-bit
    # adjacency x 8-bit GCN hidden features (N = 16)
    db, tl = dbs[0], tiles[0]
    m = db["adj"].shape[0]
    n = models["qgtc-gcn"][0].hidden
    values = torch.randint(0, 256, (m, n), generator=torch.Generator().manual_seed(2),
                           dtype=torch.int32).to(DEVICE)
    ap, bp = bitops.pack_a(db["adj"], 1), bitops.pack_b(values, 8)
    s, w, t = 1, ap.shape[2], 8
    a_f, v_f = db["adj"].float(), values.float()
    kernel_ms = graph_ms(torch, lambda: ops.bitserial_gemm(ap, bp))
    plain_ms = time_ms(torch, lambda: bitserial.bitserial_gemm_plain(
        ap, bp, block_m=pol.block_m, block_w=pol.block_w), reps=3)
    library_ms = graph_ms(torch, lambda: torch.matmul(a_f, v_f))
    if not torch.equal(torch.matmul(a_f, v_f).to(torch.int32),
                       ops.bitserial_gemm(ap, bp)):
        raise AssertionError("float32 matmul yardstick is not exact here")
    bound_ms, bound_by = bound(ap, t, n)
    emit(phase="kernel_timing", kernel="bitserial_gemm", schedule="dense",
         shape=[s, m, w, t, n], ms=kernel_ms, plain_ms=plain_ms,
         library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, card=card)
    for sched in ("compact", "sgt"):
        ms = graph_ms(torch, lambda sched=sched: ops.bitserial_gemm(
            ap, bp, tiles=tl[sched]))
        emit(phase="kernel_timing", kernel="bitserial_gemm", schedule=sched,
             shape=[s, m, w, t, n], ms=ms, bound_ms=bound_ms, bound_by=bound_by,
             card=card)
    # and at GIN's widest feature GEMM: 8-bit (M, 128) x 8-bit (128, 64)
    gen = torch.Generator().manual_seed(3)
    xq = torch.randint(0, 256, (m, 128), generator=gen, dtype=torch.int32)
    wq = torch.randint(0, 256, (128, 64), generator=gen, dtype=torch.int32)
    xp, wp = bitops.pack_a(xq, 8).to(DEVICE), bitops.pack_b(wq, 8).to(DEVICE)
    ms = graph_ms(torch, lambda: ops.bitserial_gemm(xp, wp))
    ms_plain = time_ms(torch, lambda: bitserial.bitserial_gemm_plain(
        xp, wp, block_m=pol.block_m, block_w=pol.block_w), reps=3)
    x_f, w_f = xq.double().to(DEVICE), wq.double().to(DEVICE)
    ms_lib = graph_ms(torch, lambda: torch.matmul(x_f, w_f))
    b_ms, b_by = bound(xp, 8, 64)
    emit(phase="kernel_timing", kernel="bitserial_gemm", schedule="dense",
         shape=list(xp.shape) + [8, 64], ms=ms, plain_ms=ms_plain,
         library_ms_float64=ms_lib, bound_ms=b_ms, bound_by=b_by, card=card)
    return kernel_ms, plain_ms, library_ms, bound_ms, bound_by


def phase_profile(torch, card, models, dbs, reps=5):
    """Where one qgtc forward's time goes: host wall time per forward, the
    device time of the kernels it launches (torch.profiler), and the device's
    idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import gnn

    db = dbs[0]
    for name, (_, _, per_bits) in models.items():
        cfg_b, qp = per_bits[8]

        def fn():
            return gnn.forward_qgtc(qp, db["adj"], db["x"], db["inv_deg"], cfg_b)

        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        emit(phase="profile", model=name, bits=8, host_wall_ms=wall_ms,
             device_ms=device_ms if kernels else "not measured",
             device_idle_share=(1 - device_ms / wall_ms) if kernels else "not measured",
             device_ops_per_forward=sum(e.count for e in kernels) / reps,
             top_device_ms=[[e.key[:60], e.self_device_time_total / 1e3 / reps,
                             e.count // reps] for e in top],
             card=card)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout holding src/repro_torch",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    from repro_torch.kernels import bitserial

    t0 = time.perf_counter()
    bitserial.build()
    bitserial._library()
    emit(phase="build", kernel="bitserial_gemm", seconds=time.perf_counter() - t0,
         torch=torch.__version__, cuda=torch.version.cuda, card=card)

    max_err = phase_kernel_vs_plain(torch, card)
    models, dbs, tiles, launches = phase_main_path(torch, card)
    kernel_ms, plain_ms, library_ms, bound_ms, bound_by = phase_timing(
        torch, card, models, dbs, tiles)
    phase_profile(torch, card, models, dbs)

    print(card, flush=True)
    emit(kernels=[{
        "name": "bitserial_gemm", "route": "cuda",
        "source": "src/repro_torch/csrc/bitserial.cu",
        "replaces": "src/repro/kernels/bitserial.py:245",
        "launches": launches, "max_abs_err": max_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}])
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
