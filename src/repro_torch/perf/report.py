"""The port's one timing method, and the latency summaries the serving
engines report through (the reference's ``repro.perf.report``).

On the card a call is timed with CUDA events around it and a synchronize
(``time_ms``), or as many calls captured in one CUDA graph when the host's
launch cost must stay out of the number (``graph_ms``); on the CPU with
``time.perf_counter``. ``bench_median`` picks between the two by where the
function's output lies.

The dry-run renderers (``load``, ``roofline_table``, ``dryrun_table``)
turn ``launch/dryrun.py``'s JSON records into the reference's tables, the
same strings for the same records; ``compare_table`` sets two runs' records
side by side, cell by cell.

Usage:  PYTHONPATH=src python -m repro_torch.perf.report results/dryrun
        PYTHONPATH=src python -m repro_torch.perf.report --compare A B
"""
from __future__ import annotations

import json
import pathlib
import statistics
import sys
import time

import torch

__all__ = ["percentile", "latency_summary", "bench_median", "time_ms",
           "graph_ms", "load", "roofline_table", "dryrun_table",
           "compare_table"]


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


def _on_card(out) -> bool:
    """Whether any tensor in ``out`` (nested tuples, lists, dicts) is on a
    CUDA device."""
    if isinstance(out, torch.Tensor):
        return out.device.type == "cuda"
    if isinstance(out, dict):
        return any(_on_card(x) for x in out.values())
    if isinstance(out, (tuple, list)):
        return any(_on_card(x) for x in out)
    return False


def bench_median(fn, *args, warmup: int = 1, iters: int = 5, **kw) -> float:
    """Median seconds of ``fn(*args, **kw)``, each run waited for.

    The one timing primitive of the figure suites. The first warm-up run's
    output says where ``fn`` runs: if it holds a CUDA tensor, each timed
    run sits between two CUDA events and ends in a synchronize
    (``time_ms`` with one call a repeat), so work the host does inside
    ``fn`` counts as well; else the host clock times it.
    """
    def call():
        return fn(*args, **kw)

    out = call()
    if _on_card(out):
        torch.cuda.synchronize()
        return time_ms(torch, call, warmup=max(warmup - 1, 0), reps=1,
                       repeats=iters) / 1e3
    for _ in range(warmup - 1):
        call()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def percentile(xs, q: float) -> float:
    """Nearest-rank percentile of a sequence (q in [0, 100]); 0.0 if empty.

    Dependency-free and exact on small samples — serving latency lists are
    a few hundred entries, not a distribution to interpolate over.
    """
    if not xs:
        return 0.0
    s = sorted(xs)
    if q <= 0:
        return float(s[0])
    rank = int(-(-q / 100.0 * len(s) // 1))  # ceil without math import
    return float(s[min(max(rank, 1), len(s)) - 1])


def latency_summary(xs, prefix: str = "") -> dict:
    """{n, mean_s, p50_s, p95_s, max_s} for a latency sample list."""
    p = prefix
    if not xs:
        return {f"{p}n": 0, f"{p}mean_s": 0.0, f"{p}p50_s": 0.0,
                f"{p}p95_s": 0.0, f"{p}max_s": 0.0}
    return {
        f"{p}n": len(xs),
        f"{p}mean_s": float(sum(xs) / len(xs)),
        f"{p}p50_s": percentile(xs, 50),
        f"{p}p95_s": percentile(xs, 95),
        f"{p}max_s": float(max(xs)),
    }


def _fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-4:
        return f"{x * 1e6:.1f}us"
    if x < 0.1:
        return f"{x * 1e3:.2f}ms"
    return f"{x:.3f}s"


def load(dirpath) -> list[dict]:
    recs = []
    for p in sorted(pathlib.Path(dirpath).glob("*.json")):
        recs.append(json.loads(p.read_text()))
    return recs


def roofline_table(recs: list[dict], mesh: str = "16x16") -> str:
    rows = ["| arch | shape | status | compute | memory | collective | "
            "bottleneck | useful-FLOPs | peak HBM/chip | fits |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        if r["status"] == "SKIP":
            rows.append(f"| {r['arch']} | {r['shape']} | SKIP | - | - | - | "
                        f"{r['reason'][:40]} | - | - | - |")
            continue
        if r["status"] != "OK":
            rows.append(f"| {r['arch']} | {r['shape']} | FAIL | - | - | - | "
                        f"- | - | - | - |")
            continue
        rl = r["roofline"]
        mem = r["memory"].get("peak_bytes_est", 0) / 2**30
        rows.append(
            f"| {r['arch']} | {r['shape']} | OK | {_fmt_s(rl['compute_s'])} | "
            f"{_fmt_s(rl['memory_s'])} | {_fmt_s(rl['collective_s'])} | "
            f"**{rl['bottleneck']}** | {rl['useful_flops_ratio']:.2f} | "
            f"{mem:.1f} GiB | {'Y' if r['fits_hbm'] else 'N'} |")
    return "\n".join(rows)


def dryrun_table(recs: list[dict]) -> str:
    rows = ["| arch | shape | mesh | compile | HLO flops/dev (raw) | "
            "analytic flops/dev | coll GB/dev | collectives |",
            "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["status"] != "OK":
            status = r["status"]
            reason = r.get("reason", r.get("error", ""))[:40]
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"{status}: {reason} | - | - | - | - |")
            continue
        c = r.get("collectives", {})
        byop = r.get("collectives_by_op", {})
        ops = " ".join(f"{k.split('-')[-1]}:{v['count']}"
                       for k, v in sorted(byop.items()))
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r.get('compile_s', '-')}s | "
            f"{r['cost_hlo_raw'].get('flops', 0):.2e} | "
            f"{r['analytic']['flops_per_device']:.2e} | "
            f"{c.get('total_effective_bytes', 0) / 2**30:.1f} | {ops} |")
    return "\n".join(rows)


def _by_op(r: dict) -> str:
    return " ".join(f"{k.split('-')[-1]} {v['count']}/"
                    f"{v['result_bytes'] / 1e9:.3f}"
                    for k, v in sorted(r["collectives_by_op"].items()))


def compare_table(before: list[dict], after: list[dict]) -> str:
    """Two dry runs' records cell by cell (``before`` -> ``after``): the
    collectives by op (count / result GB a device), the collective term,
    the bottleneck, the peak and ``fits_hbm``, whether FLOPs and parameter
    bytes are equal, and whether each run's records equal its
    ``CommDebugMode`` counts (``--comm-debug``; "-" where not counted)."""
    rows = ["| arch | shape | mesh | status | collectives (count/GB) | "
            "collective s | bottleneck | peak GB | fits | flops, params "
            "equal | records = CommDebugMode |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    old = {(r["arch"], r["shape"], r["mesh"]): r for r in before}
    for r in after:
        b = old.get((r["arch"], r["shape"], r["mesh"]))
        cell = f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
        if b is None or (b["status"], r["status"]) != ("OK", "OK"):
            rows.append(cell + f"{b and b['status']} -> {r['status']} |"
                        + " - |" * 7)
            continue

        def pair(f):
            return f"{f(b)} -> {f(r)}"

        rows.append(cell + "OK | " + " | ".join([
            pair(_by_op),
            pair(lambda x: f"{x['roofline']['collective_s']:.3f}"),
            pair(lambda x: x["roofline"]["bottleneck"]),
            pair(lambda x: f"{x['memory']['peak_bytes_est'] / 1e9:.2f}"),
            pair(lambda x: "Y" if x["fits_hbm"] else "N"),
            "Y" if (b["cost_hlo_raw"]["flops"], b["memory"]["param_bytes"])
            == (r["cost_hlo_raw"]["flops"], r["memory"]["param_bytes"])
            else "N",
            pair(lambda x: "Y" if x.get("comm_debug", {}).get("equal")
                 else "-" if "comm_debug" not in x else "N")]) + " |")
    return "\n".join(rows)


def main():
    if len(sys.argv) > 3 and sys.argv[1] == "--compare":
        print(compare_table(load(sys.argv[2]), load(sys.argv[3])))
        return
    d = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun"
    recs = load(d)
    print("## Roofline (single-pod 16x16, per-device seconds/step)\n")
    print(roofline_table(recs, "16x16"))
    print("\n## Roofline (multi-pod 2x16x16)\n")
    print(roofline_table(recs, "2x16x16"))
    print("\n## Dry-run detail\n")
    print(dryrun_table(recs))


if __name__ == "__main__":
    main()
