"""repro_torch.analysis: the port's contract lint and trace checker.

  engine.py — the AST lint core: file walking, inline waivers
              (``# lint: allow[rule-id]``), baseline suppression
  rules/    — one module per contract: integer purity of the kernel
              modules, timers synchronised with the card, dispatch only
              through ``repro_torch.api``, faults only through the chaos
              harness, valid policy grids
  trace.py  — runs each engine's ops on small concrete inputs under a
              recording dispatch mode and checks every aten op it saw:
              integer purity per engine and bit width, the ``tiles=``
              contract, the int training step, policy sites

Front door: ``python -m repro_torch.launch.lint [--strict] [--baseline F]
[--trace [--device cpu]] [--json]``.
"""
from repro_torch.analysis.engine import (DEFAULT_SCAN_ROOTS, REPO_ROOT,
                                         Finding, LintResult, Rule,
                                         baseline_payload, load_baseline,
                                         run_lint, split_by_baseline)

__all__ = ["Finding", "LintResult", "Rule", "run_lint", "load_baseline",
           "baseline_payload", "split_by_baseline", "REPO_ROOT",
           "DEFAULT_SCAN_ROOTS"]
