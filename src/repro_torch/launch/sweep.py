"""Sweep launcher: measure a policy grid, persist the tuning table.

  python -m repro_torch.launch.sweep --smoke --device cpu --out /tmp/t.json
  python -m repro_torch.launch.sweep \\
      --config src/repro_torch/tune/sweeps/h100.json \\
      --out src/repro_torch/tune/tables/h100_kernels.json   # on the card

``--smoke`` runs the built-in tiny grid (``tune.sweep.SMOKE_CONFIG``);
otherwise ``--config`` names a JSON sweep config (format: the docstring
of ``repro_torch.tune.sweep``). ``--device`` is where the operands live:
the card unless it says ``cpu``, where the cuda engine runs each kernel's
plain version. ``--backend``, the engine the candidates run on, comes
from the config. The emitted table is what ``repro_torch.api`` dispatch
and ``GNNServer`` consult when no policy is given: written to the packaged
path (src/repro_torch/tune/tables/h100_kernels.json) it becomes the
default, or consumers take it explicitly (``repro_torch.tune.install``,
``repro_torch.launch.serve --tuning-table PATH``). Its provenance names
the card, its power limit and ``--commit``.

``--bench-out`` merges the sweep's trajectory records into a BENCH-style
file of the port's own: earlier ``phase == "sweep"`` records are
replaced, every other record is kept. It refuses ``BENCH_kernels.json``,
which holds the reference's records.
"""
from __future__ import annotations

import argparse
import inspect
import json
import pathlib
import subprocess

from repro_torch.benchmarks.run import RESERVED
from repro_torch.tune.sweep import SMOKE_CONFIG, run_sweep
from repro_torch.tune.table import provenance


def merge_bench(path, records) -> None:
    """Merge sweep records into a BENCH file, keeping non-sweep records."""
    path = pathlib.Path(path)
    if path.name == RESERVED:
        raise ValueError(f"{RESERVED} holds the reference's records")
    payload = {"schema": 2, "smoke": False, "meta": provenance(),
               "records": []}
    if path.exists():
        try:
            old = json.loads(path.read_text())
            payload["smoke"] = bool(old.get("smoke", False))
            payload["records"] = [r for r in old.get("records", ())
                                  if r.get("phase") != "sweep"]
        except (json.JSONDecodeError, AttributeError, TypeError) as e:
            print(f"[sweep] {path} unreadable ({e}); rewriting", flush=True)
    payload["records"].extend(records)
    path.write_text(json.dumps(payload, indent=1) + "\n")
    print(f"[sweep] merged {len(records)} sweep records into {path} "
          f"({len(payload['records'])} total)", flush=True)


def _head_commit() -> str | None:
    """The checkout's HEAD, or None outside a git checkout."""
    root = pathlib.Path(__file__).resolve().parents[3]
    try:
        return subprocess.run(["git", "-C", str(root), "rev-parse", "HEAD"],
                              capture_output=True, text=True, timeout=30,
                              check=True).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="config-driven ExecutionPolicy sweep -> tuning table")
    ap.add_argument("--config", help="JSON sweep config")
    ap.add_argument("--smoke", action="store_true",
                    help="run the built-in tiny grid")
    ap.add_argument("--out", default="tuning_table.json",
                    help="where to write the tuning table")
    ap.add_argument("--bench-out", default=None, metavar="PATH",
                    help="merge trajectory records into this BENCH-style "
                         f"file (never {RESERVED})")
    ap.add_argument("--kernels-only", action="store_true",
                    help="skip the config's serve section")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--commit", default=None,
                    help="the commit measured, stamped into the table "
                         "(default: the checkout's HEAD, if any)")
    args = ap.parse_args(argv)
    if args.smoke == bool(args.config):
        ap.error("pass exactly one of --smoke or --config")
    if args.bench_out and pathlib.Path(args.bench_out).name == RESERVED:
        ap.error(f"--bench-out may not be {RESERVED}: it holds the "
                 f"reference's records")
    if args.smoke:
        config = dict(SMOKE_CONFIG)
        # candidate rejections point at the literal grid, file:name
        source = f"{inspect.getsourcefile(run_sweep)}:SMOKE_CONFIG"
    else:
        config = json.loads(pathlib.Path(args.config).read_text())
        source = str(args.config)
    if args.kernels_only:
        config = {k: v for k, v in config.items() if k != "serve"}

    result = run_sweep(config, source=source, device=args.device)
    result.table.meta["commit"] = args.commit or _head_commit()
    out = result.table.save(args.out)
    if args.bench_out:
        merge_bench(args.bench_out, result.records)
    summary = {
        "config": config.get("name", "unnamed"),
        "entries": len(result.table),
        "records": len(result.records),
        "rejected": result.rejected,
        "table": str(out),
    }
    print(f"[sweep] {json.dumps(summary)}", flush=True)
    return summary


if __name__ == "__main__":
    main()
