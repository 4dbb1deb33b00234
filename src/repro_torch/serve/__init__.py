"""Serving substrate: the continuous-batching GNN engine (the reference's
``repro.serve``).

  engine.GNNServer   — queue + micro-batcher + tile cache + quantized
                       fast path + admission control + elastic replica
                       failover, on the card through the hand-written
                       bit-serial kernel
  queue              — SubgraphRequest, shape buckets, MicroBatcher,
                       AdmissionPolicy (bounded queue / backpressure)
  cache              — cross-request non-zero tile reuse (§4.4 extended),
                       per-subgraph entries + compose_entries
  router             — per-subgraph rendezvous routing + cache-aware
                       cold placement over the elastic replica set
  chaos              — deterministic fault injection (the ONE sanctioned
                       fault source)
"""
from repro_torch.serve.cache import TileCache, TileEntry, compose_entries
from repro_torch.serve.chaos import (FaultInjector, FaultSpec, ReplicaFault,
                                     parse_fault)
from repro_torch.serve.engine import GNNServer, ServeStats, STATS_WINDOW
from repro_torch.serve.queue import (AdmissionError, AdmissionPolicy, Bucket,
                                     MicroBatcher, SubgraphRequest,
                                     make_buckets, requests_from_partitions)
from repro_torch.serve.router import ReplicaRouter

__all__ = ["GNNServer", "ServeStats", "STATS_WINDOW", "TileCache",
           "TileEntry", "compose_entries", "Bucket", "MicroBatcher",
           "SubgraphRequest", "AdmissionPolicy", "AdmissionError",
           "make_buckets", "requests_from_partitions", "ReplicaRouter",
           "FaultInjector", "FaultSpec", "ReplicaFault", "parse_fault"]
