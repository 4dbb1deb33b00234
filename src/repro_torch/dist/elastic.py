"""Elastic support: straggler detection and mesh replanning.

A numpy copy of the reference's ``repro.dist.elastic``. When a device
or replica is lost the device count changes: ``replan_mesh`` gives the
(data, model) shape for the devices left, and the serving engine reports
it for its live replicas (``serve.GNNServer.mesh_plan``). The watchdog
is the detection side: per-step wall times feed a rolling p50/p95, and
steps slower than ``tolerance * p50`` are flagged (a persistent flagger
is the eviction signal).
"""
from __future__ import annotations

import numpy as np

__all__ = ["StragglerWatchdog", "replan_mesh"]


def replan_mesh(n_devices: int, model_par: int) -> tuple[int, int]:
    """(data, model) mesh shape for `n_devices` with fixed model parallelism.

    Model parallelism is pinned (it matches the checkpointed layout's TP
    degree); the data axis absorbs device loss, shrinking to the largest
    power of two that fits so batch math stays divisible.

    Degenerate cases are well-defined: one device with ``model_par=1``
    plans ``(1, 1)``; a non-dividing count floors first and then rounds
    down to a power of two (``replan_mesh(6, 4) == (1, 4)`` — two devices
    idle, ``replan_mesh(7, 1) == (4, 1)``); fewer devices than the pinned
    TP degree is unrecoverable and raises.
    """
    if model_par < 1:
        raise ValueError(f"model_par must be >= 1, got {model_par}")
    if n_devices < model_par:
        raise ValueError(
            f"cannot fit model_par={model_par} on {n_devices} devices")
    data = n_devices // model_par
    data = 1 << (data.bit_length() - 1)  # largest power of two <= data
    return (data, model_par)


class StragglerWatchdog:
    """Rolling per-step wall-time tracker that flags outlier steps.

    observe(step, wall) -> True iff `wall` exceeds ``tolerance * p50`` of
    the history seen so far; flagged steps are kept in ``.flagged``
    (bounded to the same rolling ``window`` as the wall-time history, so
    a long-lived watchdog on a chronically slow host does not grow
    without bound).

    Edge cases are pinned down because the serving tier evicts replicas
    on this signal: before the window has ANY samples nothing can be an
    outlier (there is no p50 yet), so the first observation is never
    flagged; the tolerance boundary is EXCLUSIVE (``wall == tolerance *
    p50`` is not a straggler — only strictly slower is); ``tolerance``
    below 1 would flag typical steps and is rejected up front, as are
    non-finite or negative wall times (a poisoned sample would skew every
    later p50).
    """

    def __init__(self, tolerance: float = 2.0, window: int = 512):
        tolerance, window = float(tolerance), int(window)
        if not np.isfinite(tolerance) or tolerance < 1.0:
            raise ValueError(
                f"tolerance is a multiple of the rolling p50 and must be "
                f"finite and >= 1, got {tolerance}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.tolerance = tolerance
        self.window = window
        self.times: list[float] = []
        self.flagged: list[dict] = []

    @property
    def p50(self) -> float:
        return float(np.percentile(self.times, 50)) if self.times else 0.0

    @property
    def p95(self) -> float:
        return float(np.percentile(self.times, 95)) if self.times else 0.0

    def observe(self, step: int, wall: float) -> bool:
        wall = float(wall)
        if not np.isfinite(wall) or wall < 0.0:
            raise ValueError(
                f"wall must be a finite non-negative duration, got {wall}")
        is_straggler = bool(self.times) and wall > self.tolerance * self.p50
        if is_straggler:
            self.flagged.append(
                {"step": int(step), "wall_s": wall, "p50": self.p50})
            if len(self.flagged) > self.window:
                del self.flagged[: len(self.flagged) - self.window]
        self.times.append(wall)
        if len(self.times) > self.window:
            del self.times[: len(self.times) - self.window]
        return is_straggler
