"""Per-subgraph replica routing: rendezvous hashing + cache-aware placement.

The reference's ``repro.serve.router`` for the port, unchanged: the
scores hash the same bytes, so both route a fingerprint alike.

The serving engine routes INDIVIDUAL subgraphs (not whole coalesced
groups) to replicas. Two mechanisms, both deterministic:

  rendezvous (HRW) hash — every (fingerprint, replica) pair gets a score
      ``blake2b(seed|fp|replica)``; the owner is the highest-scoring LIVE
      replica. The defining property is minimal disruption: removing a
      replica re-homes ONLY the keys it owned (each falls to its
      second-highest score), and adding one claims ONLY the keys whose
      top score it now holds — everything else keeps its warm cache.

  cache-aware cold placement — a fingerprint the router has never seen
      has no warm cache anywhere, so hashing it blindly wastes the one
      free placement decision. ``place()`` scores each replica as
      ``(1 + queued load) * (1 + cache pressure)`` (pressure = that
      replica's resident tile-cache bytes over its byte budget, fed from
      the engine's ``ServeStats.cache_resident_bytes`` accounting) and
      pins the cheapest; ties break by HRW score so equal-cost placement
      degenerates to plain rendezvous hashing. Pins are an LRU-bounded
      map: an evicted pin falls back to the HRW owner — deterministic
      degradation, never an error.

When the replica set changes, pinned fingerprints of a REMOVED replica
re-pin to their post-removal HRW owner (deterministic re-homing; the new
owner re-warms on its first miss); pins to surviving replicas stay put
(their cache is warm there), and unpinned keys re-route by pure HRW.
"""
from __future__ import annotations

import bisect
import collections
import hashlib

__all__ = ["ReplicaRouter"]


class ReplicaRouter:
    """Deterministic subgraph-fingerprint -> replica-id routing.

    ``replicas`` is the initial live set (integer ids); ``seed`` salts
    the hash so two routers over the same fleet can shard independent
    keyspaces; ``pin_capacity`` bounds the cold-placement pin map (LRU).
    Routing never depends on wall clock, arrival order of OTHER keys, or
    process identity — two routers fed the same calls agree exactly.
    """

    def __init__(self, replicas, *, seed: int = 0, pin_capacity: int = 65536):
        ids = sorted({int(r) for r in replicas})
        if not ids:
            raise ValueError("ReplicaRouter needs at least one replica")
        if pin_capacity < 1:
            raise ValueError(f"pin_capacity must be >= 1, got {pin_capacity}")
        self.seed = int(seed)
        self.pin_capacity = int(pin_capacity)
        self._live: list[int] = ids
        self._pins: collections.OrderedDict = collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._live)

    @property
    def replicas(self) -> tuple[int, ...]:
        return tuple(self._live)

    def known(self, fp: str) -> bool:
        """True when ``fp`` holds a placement pin (it has routed before)."""
        return fp in self._pins

    def _score(self, fp: str, replica: int) -> int:
        h = hashlib.blake2b(f"{self.seed}|{fp}|{replica}".encode(),
                            digest_size=8)
        return int.from_bytes(h.digest(), "big")

    def owner(self, fp: str) -> int:
        """The HRW owner among the live replicas (ignores pins)."""
        return max(self._live, key=lambda r: (self._score(fp, r), r))

    def route(self, fp: str) -> int:
        """Affinity route: the pin if one exists, else the HRW owner."""
        r = self._pins.get(fp)
        if r is not None:
            self._pins.move_to_end(fp)
            return r
        return self.owner(fp)

    def place(self, fp: str, load=None, pressure=None) -> int:
        """Cold-fingerprint placement; pins and returns the chosen replica.

        ``load`` maps replica -> queued-request count, ``pressure`` maps
        replica -> cache-byte fraction in [0, ...); absent replicas score
        as idle/empty. Cost is ``(1 + load) * (1 + pressure)`` with HRW
        score as the deterministic tie-break, so with no signal at all
        the placement IS the rendezvous owner. A repeat call for an
        already-pinned fingerprint returns the pin unchanged (placement
        happens once; after that the cache is warm where it landed).
        """
        r = self._pins.get(fp)
        if r is not None:
            self._pins.move_to_end(fp)
            return r
        load = load or {}
        pressure = pressure or {}

        def cost(rep):
            return ((1.0 + float(load.get(rep, 0)))
                    * (1.0 + float(pressure.get(rep, 0.0))),
                    -self._score(fp, rep))

        r = min(self._live, key=cost)
        self._pin(fp, r)
        return r

    def _pin(self, fp: str, replica: int) -> None:
        self._pins[fp] = replica
        self._pins.move_to_end(fp)
        while len(self._pins) > self.pin_capacity:
            self._pins.popitem(last=False)

    def add_replica(self, replica: int) -> None:
        """Grow the live set. Pins keep their affinity (cache is warm
        there); unpinned keys re-route by HRW, so the new replica claims
        exactly the keys whose top score it holds."""
        replica = int(replica)
        if replica in self._live:
            raise ValueError(f"replica {replica} is already live")
        bisect.insort(self._live, replica)

    def remove_replica(self, replica: int) -> None:
        """Shrink the live set; the removed replica's pins re-home.

        Each pin it held re-pins to the post-removal HRW owner — the
        deterministic re-home target whose cache the engine re-warms.
        Removing the last replica raises: a router with no live replicas
        cannot honor any route.
        """
        replica = int(replica)
        if replica not in self._live:
            raise KeyError(f"replica {replica} is not live: {self._live}")
        if len(self._live) == 1:
            raise RuntimeError(
                f"cannot remove replica {replica}: it is the last live "
                f"replica")
        self._live.remove(replica)
        for fp, r in self._pins.items():
            if r == replica:
                self._pins[fp] = self.owner(fp)
