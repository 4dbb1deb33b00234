"""repro_torch.dist — elastic replica support (the reference's ``repro.dist``).

Only the numpy half of ``dist.elastic`` is ported: ``replan_mesh`` (the
(data, model) shape for a live device count) and ``StragglerWatchdog``
(rolling per-step wall times, outliers flagged), which the serving
engine's failover uses. Sharding rules, checkpoints and collectives come
with the multi-card work.
"""
from repro_torch.dist.elastic import StragglerWatchdog, replan_mesh

__all__ = ["StragglerWatchdog", "replan_mesh"]
