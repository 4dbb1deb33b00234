"""Cross-request non-zero tile reuse cache (paper §4.4, extended).

The reference's ``repro.serve.cache`` for the port. The artifacts are
torch tensors on the replica's device, with the reference's dtypes (the
packed plane's uint32 words as int32 bit patterns, same width), so the
byte accounting, and with it eviction under ``cache_bytes``, is the
reference's. Composition places each member by slice assignment into
zeros on the members' device.

§4.4 reuses non-zero adjacency tiles across bit planes *within* one kernel
launch; a serving system sees the same subgraphs again and again (hot
partitions, repeat queries), so the same idea extends across requests: the
adjacency-derived artifacts — dense 0/1 form, packed bit-plane, per-tile
occupancy map, ``compact_tiles`` indices — depend only on the subgraph
structure, never on the features. Cache them by subgraph fingerprint and a
repeat request skips edge transfer, densify, bit-pack and occupancy
analysis entirely; only its (fresh) quantized features move (the
features-only §4.6 compound buffer, ``packing.transfer_packed_feats``).

Entries are PER SUBGRAPH, not per coalesced group: the micro-batcher
aligns each request's node offset to the kernel tile footprint
(``MicroBatcher(align=...)``), so :func:`compose_entries` assembles the
block-diagonal batch's artifacts from the members' cached entries by pure
offset shifting — dense blocks and packed bit-planes placed at
``(off, off)`` / ``(off, off // 32)``, occupancy placed at the tile-grid
offset, compact k-tile indices shifted by the member's column-tile offset,
and the sparse-graph-translation word-column remap (kernels/sgt.py) shifted
by the member's word offset ``off // 32``.
A repeat subgraph therefore hits the cache in ANY coalescing order; under
per-group keying a novel ordering was a guaranteed miss.

TC-GNN (PAPERS.md) motivates the same tile-occupancy-centric view of
sparse adjacencies; here the occupancy map IS the cached object.
"""
from __future__ import annotations

import collections
import dataclasses

import torch

__all__ = ["TileEntry", "TileCache", "compose_entries"]


@dataclasses.dataclass
class TileEntry:
    """Device-resident adjacency artifacts for one subgraph (or batch)."""

    adj: torch.Tensor         # (n_pad, n_pad) 0/1 int32, dense
    inv_deg: torch.Tensor     # (n_pad, 1) f32, (deg+1)^-1
    a_packed: torch.Tensor    # (Mt, Wt) packed 1-bit plane (int32 bit
    #                           patterns of uint32 words), tile-padded
    occupancy: torch.Tensor   # (Mt/tm, Wt/tw) int32 0/1 tile-occupancy map
    compact_idx: torch.Tensor  # (Mt/tm, max_nnz) int32 non-zero k-tile ids
    compact_counts: torch.Tensor  # (Mt/tm,) int32
    occ_stats: dict        # occupancy_stats() snapshot (host ints)
    s_max: int = 0         # host int: max(compact_counts) — sizes the
    #                        compact kernel's K grid without a device sync
    # sparse-graph translation artifacts (kernels/sgt.py): the per-row-
    # window non-zero WORD-column remap. Depend only on block_m, so they
    # survive block_w retuning; None on entries built without them.
    sgt_idx: torch.Tensor | None = None     # (Mt/tm, Wt) int32 word ids
    sgt_counts: torch.Tensor | None = None  # (Mt/tm,) int32
    sgt_w: int = 0         # host int: max(sgt_counts) — sizes the SGT
    #                        kernel's K grid without a device sync

    def nbytes(self) -> int:
        n = 0
        for f in (self.adj, self.inv_deg, self.a_packed, self.occupancy,
                  self.compact_idx, self.compact_counts, self.sgt_idx,
                  self.sgt_counts):
            if f is not None:
                n += f.numel() * f.element_size()
        return n


def compose_entries(entries: list[TileEntry], offsets: list[int],
                    n_pad: int, block_m: int, block_w: int) -> TileEntry:
    """Assemble a block-diagonal batch entry from per-subgraph entries.

    ``entries[i]`` holds subgraph i's artifacts at its ALIGNED size
    ``entries[i].adj.shape[0]``; ``offsets[i]`` is its node offset in the
    batch (a multiple of lcm(block_m, 32 * block_w), so every placement
    lands on whole tile-grid coordinates). The result is bit-identical to
    building the artifacts from the full batch adjacency: off-diagonal
    tiles of a block-diagonal batch are zero, each diagonal block's
    occupancy/compact rows are exactly the member's own (k-tile ids
    shifted by the member's column-tile offset), and ``s_max`` is the max
    of the members' host-side counts — no device sync at coalesce time.
    """
    if not entries:
        raise ValueError("compose_entries needs at least one entry")
    tm, tw = block_m, block_w
    step = 32 * tw  # node columns per k-tile
    if n_pad % tm or n_pad % step:
        raise ValueError(
            f"batch n_pad={n_pad} not a multiple of the tile grid "
            f"(block_m={tm}, {step} node columns per k-tile); pad the "
            f"bucket to lcm({tm}, {step})")
    mt, kt = n_pad // tm, n_pad // step
    wt = n_pad // 32
    dev = entries[0].adj.device
    i32 = dict(dtype=torch.int32, device=dev)
    adj = torch.zeros((n_pad, n_pad), dtype=entries[0].adj.dtype, device=dev)
    inv_deg = torch.ones((n_pad, 1), dtype=torch.float32,
                         device=dev)  # padding rows: deg 0
    a_packed = torch.zeros((n_pad, n_pad // 32), **i32)
    occ = torch.zeros((mt, kt), **i32)
    idx = torch.zeros((mt, kt), **i32)
    counts = torch.zeros((mt,), **i32)
    # SGT word-column remap composes by the same shifting, at word
    # granularity (off // 32); only when every member carries it
    have_sgt = all(e.sgt_idx is not None for e in entries)
    sgt_idx = torch.zeros((mt, wt), **i32) if have_sgt else None
    sgt_counts = torch.zeros((mt,), **i32) if have_sgt else None
    tiles_nonzero, s_max, sgt_w = 0, 0, 0
    for e, off in zip(entries, offsets):
        n_sub = e.adj.shape[0]
        if off % tm or off % step or off + n_sub > n_pad:
            raise ValueError(
                f"member offset {off} (size {n_sub}) not tile-aligned "
                f"inside n_pad={n_pad}; use MicroBatcher(align=...)")
        adj[off:off + n_sub, off:off + n_sub] = e.adj
        inv_deg[off:off + n_sub] = e.inv_deg
        w0 = off // 32
        a_packed[off:off + n_sub, w0:w0 + e.a_packed.shape[1]] = e.a_packed
        r0, k0 = off // tm, off // step
        mt_sub, kt_sub = e.occupancy.shape
        occ[r0:r0 + mt_sub, k0:k0 + kt_sub] = e.occupancy
        mask = (torch.arange(e.compact_idx.shape[1], device=dev)[None, :]
                < e.compact_counts[:, None])
        idx[r0:r0 + mt_sub, :e.compact_idx.shape[1]] = torch.where(
            mask, e.compact_idx + k0, 0)
        counts[r0:r0 + mt_sub] = e.compact_counts
        if have_sgt:
            smask = (torch.arange(e.sgt_idx.shape[1], device=dev)[None, :]
                     < e.sgt_counts[:, None])
            sgt_idx[r0:r0 + mt_sub, :e.sgt_idx.shape[1]] = torch.where(
                smask, e.sgt_idx + w0, 0)
            sgt_counts[r0:r0 + mt_sub] = e.sgt_counts
            sgt_w = max(sgt_w, e.sgt_w)
        tiles_nonzero += e.occ_stats["tiles_nonzero"]
        s_max = max(s_max, e.s_max)
    total = mt * kt
    occ_stats = {
        "tiles_total": total,
        "tiles_nonzero": tiles_nonzero,
        "tiles_zero": total - tiles_nonzero,
        "nonzero_ratio": tiles_nonzero / max(total, 1),
        "skip_ratio": 1.0 - tiles_nonzero / max(total, 1),
    }
    return TileEntry(adj=adj, inv_deg=inv_deg, a_packed=a_packed,
                     occupancy=occ, compact_idx=idx, compact_counts=counts,
                     occ_stats=occ_stats, s_max=s_max, sgt_idx=sgt_idx,
                     sgt_counts=sgt_counts, sgt_w=sgt_w)


class TileCache:
    """LRU fingerprint -> :class:`TileEntry` map with hit/miss accounting.

    Two accounting levels, kept separate so benchmark hit rates stay
    honest:

      per-key (``hits``/``misses``/``hit_rate``) — individual ``get``
      lookups, i.e. per-subgraph under composition keying.

      per-batch (``note_batch``: ``full_hits``/``partial_hits``/
      ``full_misses``) — a *full* hit means every member of a coalesced
      batch was cached (the batch ships features only); a *partial* hit
      means some members were cached (their pack+occupancy work was
      skipped, but the batch still ships its compound buffer for the
      missing members). Reporting partial composition as "hit" would
      overstate the transfer savings.

    Eviction is bounded two ways: ``capacity`` counts entries (the
    fallback bound), ``cache_bytes`` bounds RESIDENT BYTES — entries vary
    widely in size per fingerprint (a big subgraph's adjacency + SGT
    remap can outweigh dozens of small ones), so an entry count alone can
    blow the device-memory envelope. The bytes bound is strict: eviction
    pops LRU-first until resident bytes fit, and a single entry larger
    than the bound is itself evicted (the caller still holds the entry it
    just built; repeats rebuild rather than pinning an over-budget
    resident). ``resident_bytes`` is maintained incrementally and
    reported through ``ServeStats``.

    Replica awareness: the engine keys entries with the owning replica id
    as the LAST tuple element (``("sub", fp, replica)``), so the cache
    also maintains per-replica resident bytes (``bytes_by_replica`` — the
    cache-pressure signal for cold-fingerprint placement in
    serve/router.py) and can drop a failed replica's entries in one call
    (``drop_replica`` — the re-home accounting: those fingerprints
    re-warm on their new owner's first miss).
    """

    def __init__(self, capacity: int = 64, cache_bytes: int | None = None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if cache_bytes is not None and cache_bytes <= 0:
            raise ValueError(f"cache_bytes must be positive, got {cache_bytes}")
        self.capacity = capacity
        self.cache_bytes = cache_bytes
        self.resident_bytes = 0
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._replica_bytes: collections.Counter = collections.Counter()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.full_hits = 0
        self.partial_hits = 0
        self.full_misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key) -> TileEntry | None:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return entry

    @staticmethod
    def _key_replica(key) -> int | None:
        """The owning replica id when the key carries one (last element)."""
        if (isinstance(key, tuple) and len(key) >= 2
                and isinstance(key[-1], int)):
            return key[-1]
        return None

    def _forget(self, key, entry: TileEntry) -> int:
        nb = entry.nbytes()
        self.resident_bytes -= nb
        rep = self._key_replica(key)
        if rep is not None:
            self._replica_bytes[rep] -= nb
            if self._replica_bytes[rep] <= 0:
                del self._replica_bytes[rep]
        return nb

    def put(self, key, entry: TileEntry) -> None:
        old = self._entries.pop(key, None)
        if old is not None:
            self._forget(key, old)
        self._entries[key] = entry
        nb = entry.nbytes()
        self.resident_bytes += nb
        rep = self._key_replica(key)
        if rep is not None:
            self._replica_bytes[rep] += nb
        while len(self._entries) > self.capacity or (
                self.cache_bytes is not None
                and self.resident_bytes > self.cache_bytes):
            k, evicted = self._entries.popitem(last=False)
            self._forget(k, evicted)
            self.evictions += 1

    def bytes_by_replica(self) -> dict:
        """replica id -> resident bytes (the cold-placement pressure)."""
        return dict(self._replica_bytes)

    def drop_replica(self, replica: int) -> tuple[int, int]:
        """Drop every entry owned by ``replica``; (entries, bytes) dropped.

        The failed replica's device-resident artifacts are unreachable;
        their fingerprints re-home (serve/router.py) and the new owner
        rebuilds on its first miss — the engine accounts the drop as
        ``cache_rehomed_entries``/``cache_rehomed_bytes``.
        """
        doomed = [k for k in self._entries
                  if self._key_replica(k) == replica]
        n_bytes = 0
        for k in doomed:
            n_bytes += self._forget(k, self._entries.pop(k))
        return len(doomed), n_bytes

    def note_batch(self, n_cached: int, n_members: int) -> None:
        """Record one coalesced batch's composition outcome."""
        if n_members <= 0:
            return
        if n_cached >= n_members:
            self.full_hits += 1
        elif n_cached > 0:
            self.partial_hits += 1
        else:
            self.full_misses += 1

    def clear(self) -> None:
        self._entries.clear()
        self._replica_bytes.clear()
        self.resident_bytes = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    @property
    def full_hit_rate(self) -> float:
        total = self.full_hits + self.partial_hits + self.full_misses
        return self.full_hits / total if total else 0.0

    def nbytes(self) -> int:
        return sum(e.nbytes() for e in self._entries.values())
