"""repro_torch.dist — sharding rules and context, atomic checkpoints,
elastic replanning and quantized collectives (the reference's
``repro.dist``).

One convention runs through it: *logical* axis names (what a tensor
dimension means: "batch", "qkv_compute", "experts", ...) map to *mesh* axis
names ("pod", "data", "model") by a rule table from
:func:`repro_torch.dist.sharding.make_rules`. Models talk only in logical
names through :func:`repro_torch.dist.sharding.constrain`: the identity
outside a :func:`repro_torch.dist.sharding.shard_ctx` and on a plain
tensor, a DTensor redistribution inside one.

  sharding     the rule tables, the context, specs and their DTensor
               placements, ``shard_map`` (a function on each rank's shards)
  checkpoint   atomic save / restore in the reference's layout; sharded
               trees are gathered to host numpy and restored onto any mesh
  collectives  ``compressed_psum_mean`` (an int-nbits all-reduce with error
               feedback) and the differentiable ``all_to_all`` /
               ``all_gather`` the expert-parallel MoE uses
  elastic      ``replan_mesh`` and ``StragglerWatchdog``

The reference's ``dist/compat.py`` (a jax 0.4 ``shard_map`` shim) has no
counterpart: the port has no jax.
"""
from repro_torch.dist import checkpoint, collectives, elastic, sharding
from repro_torch.dist.elastic import StragglerWatchdog, replan_mesh
from repro_torch.dist.sharding import (constrain, current_ctx, make_rules,
                                       named_sharding, shard_ctx)

__all__ = ["checkpoint", "collectives", "elastic", "sharding",
           "StragglerWatchdog", "replan_mesh", "constrain", "current_ctx",
           "make_rules", "named_sharding", "shard_ctx"]
