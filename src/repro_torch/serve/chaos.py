"""Deterministic, seedable fault injection for the serving tier.

The reference's ``repro.serve.chaos`` for the port, with the same specs
and the same seeded jitter stream.

Failover code that is only exercised by real outages is failover code
that does not work. This module is the ONE sanctioned fault source for
``repro_torch.serve``: the engine calls :meth:`FaultInjector.at_execute` once
per batch execution, and a matching :class:`FaultSpec` either raises
:class:`ReplicaFault` (replica death — the engine marks the replica
failed and retries the in-flight work on survivors) or sleeps inside the
harness (stall / slow-step — the per-replica straggler watchdog sees the
inflated wall time and evicts a persistent offender).

Everything is deterministic: specs fire by GLOBAL BATCH ORDINAL (the
engine's ``stats.batches``, which only advances on success — so a killed
batch's retry re-executes at the same ordinal and is NOT re-killed once
the spec's ``repeat`` budget is spent), and the slow-step jitter stream
is seeded. Tests and ``benchmarks/serve_throughput.failover_arm`` drive
the same specs the CLI does (``launch/serve.py --inject-failure``).

The flip side: no ``time.sleep`` and no ``ReplicaFault`` construction
anywhere else under ``serve/``; an ad-hoc fault point is invisible to
the deterministic replay the failover checks depend on.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

__all__ = ["ReplicaFault", "FaultSpec", "FaultInjector", "parse_fault",
           "FAULT_KINDS"]

FAULT_KINDS = ("kill", "stall", "slow")


class ReplicaFault(RuntimeError):
    """A replica died mid-batch (injected here; a real integration would
    translate device/RPC errors into this). The engine catches it, marks
    the replica failed and retries the in-flight plan on survivors — it
    must never surface to a client as a lost request."""

    def __init__(self, replica: int, kind: str = "kill", batch: int = -1):
        super().__init__(f"replica {replica} {kind} at batch {batch}")
        self.replica = replica
        self.kind = kind
        self.batch = batch


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injection point.

    ``kind``      — "kill" (raise ReplicaFault), "stall" (one long sleep),
                    "slow" (sleep + seeded jitter; pair with ``repeat`` for
                    a persistently slow replica).
    ``at_batch``  — global batch ordinal at/after which the spec arms.
    ``replica``   — only fire on this replica (None = whichever replica
                    executes the armed batch first).
    ``stall_s``   — sleep duration for stall/slow.
    ``repeat``    — total firings before the spec burns out (1 = one-shot,
                    so a kill's retry on a survivor proceeds cleanly).
    """

    kind: str
    at_batch: int
    replica: int | None = None
    stall_s: float = 0.05
    repeat: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault kind must be one of {FAULT_KINDS}, got {self.kind!r}")
        if self.at_batch < 0:
            raise ValueError(f"at_batch must be >= 0, got {self.at_batch}")
        if self.stall_s < 0:
            raise ValueError(f"stall_s must be >= 0, got {self.stall_s}")
        if self.repeat < 1:
            raise ValueError(f"repeat must be >= 1, got {self.repeat}")


def parse_fault(spec: str) -> FaultSpec:
    """Parse a CLI spec ``KIND@BATCH[:key=value,...]``.

    Examples::

        kill@3
        stall@2:replica=1,stall_s=0.2
        slow@4:repeat=3,stall_s=0.05
    """
    head, _, tail = spec.partition(":")
    kind, sep, at = head.partition("@")
    if not sep or not at:
        raise ValueError(
            f"bad fault spec {spec!r}: want KIND@BATCH[:key=value,...]")
    kw: dict = {}
    casts = {"replica": int, "stall_s": float, "repeat": int}
    if tail:
        for item in tail.split(","):
            k, sep, v = item.partition("=")
            if not sep or k not in casts:
                raise ValueError(
                    f"bad fault spec option {item!r} in {spec!r}; "
                    f"known keys: {sorted(casts)}")
            kw[k] = casts[k](v)
    return FaultSpec(kind=kind, at_batch=int(at), **kw)


class FaultInjector:
    """Fires :class:`FaultSpec` s at engine batch boundaries.

    Construct with specs (or raw spec strings) and a seed; pass as
    ``GNNServer(chaos=...)``. ``fired`` is the audit log — one dict per
    firing with the kind, replica, batch ordinal and spec index — which
    tests and the failover benchmark assert against.
    """

    def __init__(self, *specs, seed: int = 0):
        parsed = tuple(parse_fault(s) if isinstance(s, str) else s
                       for s in specs)
        for s in parsed:
            if not isinstance(s, FaultSpec):
                raise TypeError(f"want FaultSpec or spec string, got {s!r}")
        self.specs = parsed
        self._remaining = [s.repeat for s in parsed]
        self._rng = np.random.default_rng(seed)
        self.fired: list[dict] = []

    def at_execute(self, replica: int, batch: int) -> None:
        """Engine hook: about to execute ``batch`` on ``replica``."""
        for i, s in enumerate(self.specs):
            if self._remaining[i] <= 0 or batch < s.at_batch:
                continue
            if s.replica is not None and s.replica != replica:
                continue
            self._remaining[i] -= 1
            self.fired.append({"kind": s.kind, "replica": int(replica),
                               "batch": int(batch), "spec": i})
            if s.kind == "kill":
                raise ReplicaFault(replica, "kill", batch)
            jitter = (float(self._rng.uniform(0.0, 0.1 * s.stall_s))
                      if s.kind == "slow" else 0.0)
            time.sleep(s.stall_s + jitter)
