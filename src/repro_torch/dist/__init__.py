"""repro_torch.dist — checkpoints and elastic replica support (the
reference's ``repro.dist``).

Ported: ``dist.checkpoint`` (atomic save / restore in the reference's
layout, readable by either package) and the numpy half of
``dist.elastic``: ``replan_mesh`` (the (data, model) shape for a live
device count) and ``StragglerWatchdog`` (rolling per-step wall times,
outliers flagged), which the serving engine's failover and the training
launcher use. Sharding rules and collectives come with the multi-card
work.
"""
from repro_torch.dist.elastic import StragglerWatchdog, replan_mesh

__all__ = ["StragglerWatchdog", "replan_mesh"]
