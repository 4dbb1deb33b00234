"""Shared benchmark utilities: one timing primitive and the CSV records.

Columns tagged ``derived`` are computed from byte or operation accounting,
not measured. A time is measured on the device the suite ran on: CUDA
events on the card, the host clock on the CPU (``perf.report.bench_median``);
a CPU time is never a time of the card.
"""
from __future__ import annotations

from repro_torch.perf.report import bench_median

__all__ = ["timeit", "emit", "RECORDS"]

# every emitted line, as a dict, in order (run.py writes them as JSON)
RECORDS: list[dict] = []


def timeit(fn, *args, warmup: int = 1, iters: int = 5, **kw) -> float:
    """Median seconds of ``fn(*args, **kw)``, each run waited for: an alias
    of ``repro_torch.perf.report.bench_median``."""
    return bench_median(fn, *args, warmup=warmup, iters=iters, **kw)


def emit(name: str, value, unit: str, derived: bool = False, **extra):
    """Print one CSV line ``name,value,unit,tag,k=v,...`` and keep it."""
    tag = "derived" if derived else "measured"
    kv = ",".join(f"{k}={v}" for k, v in extra.items())
    print(f"{name},{value},{unit},{tag},{kv}", flush=True)
    RECORDS.append({"name": name, "value": value, "unit": unit, "tag": tag,
                    **extra})
