"""serve-chaos-harness: failure injection only through serve/chaos.py.

The failover tests and the failover benchmark arm rely on faults being
deterministic and replayable: every fault fires from a seeded
``FaultSpec`` at a batch ordinal, and the injector's ``fired`` log is
checked. An ad-hoc fault point in engine code (a ``time.sleep`` to fake a
stall, a ``raise ReplicaFault`` outside the harness) is invisible to that
replay: the no-fault run and the chaos run would no longer differ by
exactly the injected specs, and the bit-identical-logits check stops
meaning anything. Sleeping in the engine also breaks its liveness
(block-mode ``submit`` spins on ``_step_once``; backoff is accounted in
``ServeStats``, never slept).

So under ``repro_torch/serve/`` only ``chaos.py`` may call ``sleep`` or
construct ``ReplicaFault``. The engine CATCHES ReplicaFault (that is the
failover path); it must not originate one.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.engine import Rule, callee_name

_SCOPE = re.compile(r"(^|/)repro_torch/serve/[^/]*\.py$")
_HARNESS = re.compile(r"(^|/)repro_torch/serve/chaos\.py$")


class ChaosHarnessOnly(Rule):
    name = "serve-chaos-harness"
    description = ("in repro_torch/serve/, only chaos.py may sleep or "
                   "construct ReplicaFault: ad-hoc fault points break "
                   "deterministic failover replay and engine liveness")

    def applies_to(self, path: str) -> bool:
        return bool(_SCOPE.search(path)) and not _HARNESS.search(path)

    def check(self, path, tree, lines):
        out = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            callee = callee_name(node)
            if callee == "sleep":
                out.append(self.finding(
                    path, node,
                    "time.sleep outside the chaos harness: a stall here "
                    "is invisible to deterministic failover replay and "
                    "breaks block-mode submit liveness (account the delay "
                    "in ServeStats, or inject it via serve/chaos.py)"))
            elif callee == "ReplicaFault":
                out.append(self.finding(
                    path, node,
                    "ReplicaFault constructed outside the chaos harness: "
                    "engine code catches replica faults, it must not "
                    "originate them (add a FaultSpec via serve/chaos.py "
                    "so the firing is seeded and auditable)"))
        return out
