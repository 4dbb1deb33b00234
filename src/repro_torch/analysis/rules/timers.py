"""bench-timer-sync: a timer stop needs a device sync in its scope.

CUDA launches are asynchronous: ``time.perf_counter() - t0`` after an
unsynchronised launch times the enqueue, not the work, and a benchmark
reports numbers off by orders of magnitude. The serving engine's batch
walls feed straggler eviction and retry-after hints, and the training
launcher's and the 100M example's step walls feed the straggler watchdog,
so an enqueue-time sample there flags the wrong step or replica. Every
timing scope in ``repro_torch/benchmarks/``, ``serve/``, ``perf/``,
``tune/sweep.py``, ``train/trainer.py``, ``launch/train.py`` and
``examples/train_lm_100m.py`` must therefore hold a sync between start and
stop:

  * ``torch.cuda.synchronize`` or an event's ``synchronize`` /
    ``elapsed_time``,
  * the serving engine's ``_wait`` (a synchronize of the logits' device),
    or an engine call that ends in it: ``drain``, ``step``,
    ``infer_batch``,
  * a read back to the host: ``.cpu()``, ``.item()``, ``.numpy()``.

A stop is ``perf_counter()``/``time.time()`` on the left of a
subtraction, or any such call after the scope's first one (``t1 =
perf_counter()``). The check is per scope: one function is one scope,
nested defs are their own. Helpers that leave the timing to
``perf.report.bench_median`` hold no stop and pass.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.engine import Rule, callee_name

_SCOPE = re.compile(r"(^|/)repro_torch/((benchmarks|serve|perf)/[^/]*|"
                    r"tune/sweep|train/trainer|launch/train|"
                    r"examples/train_lm_100m)\.py$")

SYNC_NAMES = {"synchronize", "elapsed_time", "_wait", "cpu", "item", "numpy",
              "drain", "step", "infer_batch"}


def _is_timer(node) -> bool:
    """``perf_counter()`` in any spelling, or ``time.time()``."""
    if not isinstance(node, ast.Call) or node.args:
        return False
    fn = node.func
    if callee_name(node) == "perf_counter":
        return True
    return (isinstance(fn, ast.Attribute) and fn.attr == "time"
            and isinstance(fn.value, ast.Name) and fn.value.id == "time")


def _walk_scope(body):
    """Nodes of one scope, not descending into nested defs."""
    stack = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


class TimerSync(Rule):
    name = "bench-timer-sync"
    description = ("in repro_torch/{benchmarks,serve,perf}/, tune/sweep.py, "
                   "train/trainer.py, launch/train.py and "
                   "examples/train_lm_100m.py, a perf_counter()/time.time() "
                   "stop must share its scope with a device sync (synchronize, "
                   "elapsed_time, _wait, .cpu/.item/.numpy, or an engine "
                   "drain/step/infer_batch)")

    def applies_to(self, path: str) -> bool:
        return bool(_SCOPE.search(path))

    def check(self, path, tree, lines):
        scopes = [("<module>", tree.body)]
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scopes.append((node.name, node.body))
        out = []
        for name, body in scopes:
            nodes = list(_walk_scope(body))
            if any(isinstance(n, ast.Call) and callee_name(n) in SYNC_NAMES
                   for n in nodes):
                continue
            timers = sorted((n for n in nodes if _is_timer(n)),
                            key=lambda n: (n.lineno, n.col_offset))
            stops = {id(n): n for n in timers[1:]}
            for n in nodes:
                if (isinstance(n, ast.BinOp) and isinstance(n.op, ast.Sub)
                        and _is_timer(n.left)):
                    stops[id(n.left)] = n.left
            for stop in sorted(stops.values(),
                               key=lambda n: (n.lineno, n.col_offset)):
                out.append(self.finding(
                    path, stop,
                    f"timer stop in {name!r} with no device sync in scope: "
                    f"launches are asynchronous, so this times the enqueue, "
                    f"not the work (synchronize first, or time through "
                    f"perf.report.bench_median)"))
        return out
