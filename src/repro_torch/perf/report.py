"""The port's one timing method, and the latency summaries the serving
engines report through (the reference's ``repro.perf.report``).

On the card a call is timed with CUDA events around it and a synchronize
(``time_ms``), or as many calls captured in one CUDA graph when the host's
launch cost must stay out of the number (``graph_ms``); on the CPU with
``time.perf_counter``. ``bench_median`` picks between the two by where the
function's output lies.

The reference's dry-run renderers (``load``, ``roofline_table``,
``dryrun_table``) read XLA compile records and have no counterpart yet.
"""
from __future__ import annotations

import statistics
import time

import torch

__all__ = ["percentile", "latency_summary", "bench_median", "time_ms",
           "graph_ms"]


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
