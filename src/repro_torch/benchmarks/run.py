"""Run the paper-figure suites on the port. CSV on stdout:
name,value,unit,tag,extras.

  python -m repro_torch.benchmarks.run                  # on the card
  python -m repro_torch.benchmarks.run --device cpu --smoke   # tiny, CPU
  python -m repro_torch.benchmarks.run --out BENCH_torch_figures.json
  python -m repro_torch.benchmarks.run --suite table2     # one suite
  python -m repro_torch.benchmarks.run --suite kernels    # kernel_bench

Runs fig7, fig8a, fig8b, fig8c, fig9a, fig9b, table2 (QAT accuracy
against bits, the int arm through the integer training path) and serve
(``serve_throughput``'s arms: continuous batching, jumping, overload,
shuffled coalescing, failover) and kernels (``kernel_bench``: the
bit-GEMMs over jump modes, SGT against compact, the serving arms, a
training step of each arm) at the reference's default sizes
(``--smoke``: the tiny sizes of ``SMOKE``). A
suite whose check fails fails the run. ``--out`` writes every record as JSON, with the device it
ran on, to a file of its own; the reference's ``BENCH_kernels.json`` holds
the reference's records and is never written here.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

import torch

from repro_torch.benchmarks import (common, fig7_speedup, fig8a_lowbit_gemm,
                                    fig8b_zerotile, fig8c_adjsize, fig9a_reuse,
                                    fig9b_transfer, kernel_bench,
                                    serve_throughput, table2_accuracy)
from repro_torch.device import resolve_device

SUITES = [
    ("fig7", fig7_speedup.main),
    ("fig8a", fig8a_lowbit_gemm.main),
    ("fig8b", fig8b_zerotile.main),
    ("fig8c", fig8c_adjsize.main),
    ("fig9a", fig9a_reuse.main),
    ("fig9b", fig9b_transfer.main),
    ("table2", table2_accuracy.main),
    ("serve", serve_throughput.run_arms),
    ("kernels", kernel_bench.main),
]

# the smallest sizes each suite runs at: a check of the code paths, on the CPU
SMOKE = {
    "fig7": dict(scale=0.002, bits_list=(2, 8), gcn_dsets=("proteins", "ppi"),
                 gin_dsets=("proteins",)),
    "fig8a": dict(ns=(32,), d=64, bits_list=(2, 7)),
    "fig8b": dict(scale=0.002, dsets=("proteins", "ogbn-arxiv")),
    "fig8c": dict(ds=(16, 32), ns=(128, 256)),
    "fig9a": dict(n=64, d=32, bits_list=(4, 16)),
    "fig9b": dict(scale=0.005),
    "table2": dict(scale=0.005, steps=3, dsets=("ogbn-arxiv",),
                   bits_list=("fp32", 8)),
    "serve": dict(sizes=serve_throughput.SMOKE_KW),
    "kernels": dict(smoke=True),
}

RESERVED = "BENCH_kernels.json"


def main(device=None, smoke: bool = False, out=None,
         suites=None) -> list[dict]:
    """Run every suite, or those named in ``suites``; returns the records,
    each with its suite's name."""
    dev = resolve_device(device)
    if out is not None and pathlib.Path(out).name == RESERVED:
        raise ValueError(f"{RESERVED} holds the reference's records")
    unknown = set(suites or ()) - {name for name, _ in SUITES}
    if unknown:
        raise ValueError(f"unknown suites {sorted(unknown)}")
    print("name,value,unit,tag,extras")
    records = []
    for name, fn in SUITES:
        if suites is not None and name not in suites:
            continue
        t0 = time.time()
        print(f"# --- {name} ---", flush=True)
        start = len(common.RECORDS)
        fn(device=dev, **(SMOKE[name] if smoke else {}))
        records += [{"suite": name, **r} for r in common.RECORDS[start:]]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # the suite's own launches included
        print(f"# {name} took {time.time() - t0:.1f}s", flush=True)
    if out is not None:
        pathlib.Path(out).write_text(json.dumps(
            {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu"), "torch": torch.__version__,
             "smoke": smoke, "records": records}, indent=1) + "\n")
        print(f"# wrote {out} ({len(records)} records)", flush=True)
    return records


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="the tiny sizes of SMOKE, for a check on the CPU")
    ap.add_argument("--out", default=None, help="write the records as JSON here")
    ap.add_argument("--suite", action="append", default=None,
                    help="run only this suite (repeatable)")
    args = ap.parse_args()
    main(device=args.device, smoke=args.smoke, out=args.out, suites=args.suite)
