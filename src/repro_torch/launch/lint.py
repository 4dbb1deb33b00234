"""The port's contract lint: AST rules, and the dispatch-level checker.

  PYTHONPATH=src python -m repro_torch.launch.lint --strict
  PYTHONPATH=src python -m repro_torch.launch.lint --strict --trace --device cpu
  PYTHONPATH=src python -m repro_torch.launch.lint --baseline lint_baseline.json
  PYTHONPATH=src python -m repro_torch.launch.lint --list-rules
  PYTHONPATH=src python -m repro_torch.launch.lint --json path/to/tree

The exit code is 0 only when every finding is fixed or pinned in the
``--baseline`` file; ``--strict`` also fails on STALE baseline entries (a
pinned violation that no longer fires must be deleted, so a baseline only
shrinks). ``--write-baseline F`` pins the current findings. ``--trace``
adds ``repro_torch.analysis.trace`` (integer purity per engine and bit
width, the ``tiles=`` contract, kernel launches, the int training step,
policy sites) on ``--device`` (the card unless it says ``cpu``) and fails
on any of its failures. ``--rel-root`` re-bases the rules' path scoping
for trees that mirror the repository's layout.
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.analysis import engine
from repro_torch.analysis.rules import ALL_RULES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="the port's contract lint (--list-rules for the catalog)")
    ap.add_argument("paths", nargs="*",
                    help=f"files/dirs to lint (default: "
                         f"{', '.join(engine.DEFAULT_SCAN_ROOTS)})")
    ap.add_argument("--baseline", metavar="PATH",
                    help="JSON suppression file of pinned findings")
    ap.add_argument("--write-baseline", metavar="PATH",
                    help="pin the current findings and exit 0")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on stale baseline entries")
    ap.add_argument("--trace", action="store_true",
                    help="run the dispatch-level trace checker too")
    ap.add_argument("--device", default=None,
                    help="where --trace runs: the card unless 'cpu'")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--rel-root", metavar="DIR",
                    help="base dir for rule path scoping (mirrored trees)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.name:24s} {rule.description}")
        return 0

    result = engine.run_lint(paths=args.paths or None,
                             rel_root=args.rel_root)
    baseline = engine.load_baseline(args.baseline) if args.baseline else []
    new, suppressed, stale = engine.split_by_baseline(result.findings,
                                                      baseline)
    if args.write_baseline:
        payload = engine.baseline_payload(result.findings)
        pathlib.Path(args.write_baseline).write_text(
            json.dumps(payload, indent=1) + "\n")
        if not args.json:
            print(f"[lint] pinned {len(payload['findings'])} findings "
                  f"to {args.write_baseline}")
        return 0

    trace_report = None
    if args.trace:
        from repro_torch.analysis import trace
        trace_report = trace.run_trace_checks(
            device=args.device, log=(lambda *_: None) if args.json else print)

    payload = {
        "files": result.files,
        "findings": [f.to_dict() for f in new],
        "suppressed": len(suppressed),
        "stale_baseline": [{"rule": r, "path": p, "message": m}
                           for r, p, m in stale],
    }
    if trace_report is not None:
        payload["trace"] = trace_report

    fail = bool(new) or (args.strict and stale) \
        or (trace_report is not None and trace_report["failures"])

    if args.json:
        print(json.dumps(payload, indent=1))
        return 1 if fail else 0

    for f in new:
        print(f"[lint] {f}")
    for r, p, m in stale:
        print(f"[lint] stale baseline entry (fixed? delete it): "
              f"[{r}] {p}: {m}")
    if trace_report is not None:
        for t in trace_report["failures"]:
            print(f"[lint] trace FAIL {t}")
        print(f"[lint] trace: {trace_report['checks']} checks over "
              f"{', '.join(trace_report['backends'])} on "
              f"{trace_report['device']}, "
              f"{len(trace_report['failures'])} failures")
    print(f"[lint] {result.files} files, {len(new)} findings"
          + (f", {len(suppressed)} baselined" if suppressed else "")
          + (f", {len(stale)} stale baseline entries" if stale else ""))
    return 1 if fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
