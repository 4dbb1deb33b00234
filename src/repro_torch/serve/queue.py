"""Request queue + continuous micro-batcher for GNN serving (paper §4.1).

The reference's ``repro.serve.queue`` for the port: host-side numpy,
the same fingerprints (blake2b over the same bytes), buckets and plans.

Incoming subgraph requests are coalesced FIFO into one block-diagonal
batch — the paper's batched-subgraph shape, where no edge crosses request
boundaries (the dominant source of the all-zero TC tiles §6.4 measures) —
under a node/edge budget.

Shape bucketing: the coalesced batch is padded to one of a SMALL FIXED set
of ``(n_pad, e_cap)`` buckets rather than its exact size, so the
forward sees a bounded set of shapes (``GNNServer.n_compiles`` counts
them) and a stream of mixed-size subgraphs brings no new one. Without
bucketing every distinct coalesced size is a new shape.

Admission control: an unbounded FIFO under overload trades shed requests
for unbounded queue-wait — every request is eventually served, seconds
late. ``AdmissionPolicy`` bounds the queue (depth / queued nodes / queued
edges, optional per-client fair share) and picks what happens at the
bound: ``reject`` sheds the request with a reason (the engine accounts
it), ``block`` makes ``submit`` run the engine until space frees — true
backpressure on the producer.

Block alignment: ``align=`` rounds each request's node offset up to a
multiple of the kernel tile footprint (lcm of tile rows and packed-word
tile columns), so a subgraph's cached packed bit-plane / occupancy /
compact-tile artifacts can be placed into ANY coalesced batch by pure
offset shifting (serve/cache.py ``compose_entries``) — the batch
composition never forces a re-pack.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import itertools

import numpy as np

from repro_torch.graph.batching import SubgraphBatch

__all__ = ["subgraph_fingerprint", "SubgraphRequest", "Bucket",
           "make_buckets", "buckets_for", "pick_bucket", "CoalescedBatch",
           "AdmissionPolicy", "AdmissionError", "MicroBatcher",
           "requests_from_partitions"]

_req_ids = itertools.count()


def subgraph_fingerprint(n_nodes: int, edges: np.ndarray) -> str:
    """The cache key of one adjacency structure (features excluded)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64(n_nodes).tobytes())
    h.update(np.ascontiguousarray(edges, np.int32).tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class SubgraphRequest:
    """One inference request: a subgraph with local node ids in [0, n_nodes).

    ``fingerprint`` identifies the adjacency structure (not the features) —
    the tile cache reuses packed bit-planes/occupancy across requests that
    share it, even when their features differ.
    """

    edges: np.ndarray     # (2, e) int32, no padding
    features: np.ndarray  # (n_nodes, d) float32
    n_nodes: int
    req_id: int = dataclasses.field(default_factory=lambda: next(_req_ids))
    t_enqueue: float | None = None  # stamped by the engine at submit()
    client_id: str | None = None    # admission fair-share bucket (None =
    #                                 anonymous, exempt from fair-share)
    replica: int | None = None      # routed replica (serve/router.py);
    #                                 None = unrouted (raw batcher use)
    retries: int = 0                # replica-fault retry count; bounded by
    #                                 the engine's max_retries (never silent)

    @property
    def n_edges(self) -> int:
        return self.edges.shape[1]

    @property
    def fingerprint(self) -> str:
        fp = getattr(self, "_fp", None)
        if fp is None:
            fp = self._fp = subgraph_fingerprint(self.n_nodes, self.edges)
        return fp


@dataclasses.dataclass(frozen=True)
class Bucket:
    n_pad: int  # padded node count (tile multiple)
    e_cap: int  # edge capacity (-1-padded)


def _ceil_to(x: int, m: int) -> int:
    return ((max(x, 1) + m - 1) // m) * m


def make_buckets(node_budget: int, edge_budget: int, tile: int = 128,
                 levels: int = 3) -> tuple[Bucket, ...]:
    """A geometric ladder of ``levels`` buckets topping out at the budget.

    Each bucket halves the node capacity of the one above (floored at one
    tile) with edge capacity scaled proportionally, so small requests do
    not pay the full-budget padding while the number of batch shapes
    stays at ``levels``.
    """
    if node_budget < tile:
        raise ValueError(f"node_budget {node_budget} < tile {tile}")
    buckets = []
    n, e = _ceil_to(node_budget, tile), max(edge_budget, 1)
    for _ in range(levels):
        buckets.append(Bucket(n_pad=n, e_cap=e))
        if n <= tile:
            break
        n = _ceil_to(n // 2, tile)
        e = max(e // 2, 1)
    return tuple(sorted(set(buckets), key=lambda b: (b.n_pad, b.e_cap)))


def buckets_for(requests, tile: int = 128, levels: int = 3,
                node_headroom: int = 4,
                edge_headroom: int = 8) -> tuple[Bucket, ...]:
    """Bucket ladder sized from a sample of the expected traffic.

    The top bucket holds ``node_headroom`` of the largest observed request
    (so several requests coalesce per batch) with edge capacity scaled by
    ``edge_headroom``; lower rungs come from :func:`make_buckets`.
    """
    n_top = node_headroom * _ceil_to(max(r.n_nodes for r in requests), tile)
    e_top = edge_headroom * max(r.n_edges for r in requests)
    return make_buckets(node_budget=n_top, edge_budget=e_top, tile=tile,
                        levels=levels)


def pick_bucket(buckets: tuple[Bucket, ...], n: int, e: int) -> Bucket:
    """Smallest bucket that fits (n nodes, e edges); the top bucket must."""
    for b in buckets:
        if b.n_pad >= n and b.e_cap >= e:
            return b
    raise ValueError(
        f"no bucket fits n={n}, e={e} (top: {buckets[-1]}); the batcher "
        f"must admit under the top bucket's capacity")


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Bounds on the request queue and the behavior at the bound.

    ``None`` caps are unlimited. ``on_full``:

      reject — the over-limit submit is shed with a reason string; the
               engine counts it (``ServeStats.requests_shed``) and returns
               ``None`` instead of a request id.
      block  — ``GNNServer.submit`` runs engine steps until the request
               fits (backpressure: the producer waits, nothing sheds).

    ``per_client_share`` (0 < share <= 1, requires ``max_depth``) caps any
    single ``client_id`` at ``ceil(share * max_depth)`` queued requests so
    one flooding client cannot starve the rest; requests with
    ``client_id=None`` are exempt.
    """

    max_depth: int | None = None   # queued requests
    max_nodes: int | None = None   # sum of queued raw node counts
    max_edges: int | None = None   # sum of queued edge counts
    on_full: str = "reject"
    per_client_share: float | None = None

    def __post_init__(self):
        if self.on_full not in ("reject", "block"):
            raise ValueError(
                f"on_full must be 'reject' or 'block', got {self.on_full!r}")
        for f in ("max_depth", "max_nodes", "max_edges"):
            v = getattr(self, f)
            if v is not None and v <= 0:
                raise ValueError(f"{f} must be positive or None, got {v}")
        if self.per_client_share is not None:
            if not 0 < self.per_client_share <= 1:
                raise ValueError(f"per_client_share must be in (0, 1], got "
                                 f"{self.per_client_share}")
            if self.max_depth is None:
                raise ValueError(
                    "per_client_share needs max_depth (the share is a "
                    "fraction of the queue depth)")

    @property
    def client_cap(self) -> int | None:
        """Max queued requests per client_id, or None when unset."""
        if self.per_client_share is None:
            return None
        return max(1, int(np.ceil(self.max_depth * self.per_client_share)))


class AdmissionError(ValueError):
    """Raised by MicroBatcher.add when the admission policy rejects.

    ``retry_after_s`` is the engine's client backoff hint (derived from
    the rolling queue-wait p95 — see ``GNNServer._retry_hint``): how long
    the caller should wait before resubmitting instead of hammering a
    shedding server. None when the batcher has no hint source (raw
    batcher use outside an engine). ``reason`` stays the STABLE policy
    string (it keys the bounded ``shed_reasons`` histogram); the hint is
    appended to the exception MESSAGE only.
    """

    def __init__(self, reason: str, retry_after_s: float | None = None):
        msg = reason
        if retry_after_s is not None:
            msg = f"{reason} (retry after {retry_after_s:.3f}s)"
        super().__init__(msg)
        self.reason = reason
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class CoalescedBatch:
    """A block-diagonal batch of coalesced requests, padded to a bucket."""

    batch: SubgraphBatch
    requests: list  # the member SubgraphRequests, in block order
    spans: list     # [(req_id, node_offset, n_nodes)] for result splitting
    bucket: Bucket | None

    @property
    def replica(self) -> int | None:
        """The replica every member routed to (None: unrouted traffic).

        ``next_plan`` only coalesces requests sharing one route, so the
        head member's replica is the whole plan's execution target.
        """
        return self.requests[0].replica if self.requests else None

    @property
    def fingerprint(self) -> str:
        """Order-insensitive routing key: the sorted member fingerprints.

        Used for replica affinity, NOT as a cache key — the tile cache
        keys per-subgraph (serve/cache.py), so only the member SET must
        be stable across coalescing orders. Features are excluded on
        purpose: a repeat group with fresh features routes identically.
        """
        h = hashlib.blake2b(digest_size=16)
        for fp in sorted(r.fingerprint for r in self.requests):
            h.update(fp.encode())
        return h.hexdigest()


class MicroBatcher:
    """FIFO coalescing under a node/edge budget with shape bucketing.

    ``buckets=None`` disables bucketing (exact tile-multiple padding per
    batch) — the no-bucket baseline the throughput benchmark compares
    against; the budget then comes from ``node_budget``/``edge_budget``.

    ``align=`` rounds each request's node offset (and its budget
    footprint) up to a multiple of ``align`` so cached per-subgraph tile
    artifacts compose into the batch by offset shifting alone — the serve
    engine sets it to lcm(block_m, 32 * block_w) of its execution policy.

    ``admission=`` bounds the queue: :meth:`admit_reason` reports why a
    request would be refused (None = admitted) and :meth:`add` raises
    :class:`AdmissionError` at the bound. Blocking behavior lives in the
    engine (the batcher cannot drain itself).
    """

    def __init__(self, buckets: tuple[Bucket, ...] | None = None,
                 node_budget: int | None = None,
                 edge_budget: int | None = None, tile: int = 128,
                 align: int | None = None,
                 admission: AdmissionPolicy | None = None,
                 retry_hint=None):
        if buckets is not None and not buckets:
            raise ValueError("buckets must be a non-empty tuple or None")
        if align is not None and align <= 0:
            raise ValueError(f"align must be positive or None, got {align}")
        self.buckets = buckets
        top = buckets[-1] if buckets else None
        self.node_budget = node_budget or (top.n_pad if top else 4 * tile)
        self.edge_budget = edge_budget or (top.e_cap if top else 1 << 16)
        if top is not None and (self.node_budget > top.n_pad
                                or self.edge_budget > top.e_cap):
            raise ValueError(
                f"budget ({self.node_budget} nodes, {self.edge_budget} "
                f"edges) exceeds the top bucket {top}; every admitted "
                f"batch must fit a bucket")
        self.tile = tile
        self.align = align
        self.admission = admission
        # zero-arg callable returning the current backoff hint in seconds
        # (the engine wires its queue-wait-p95 probe in); None = no hint
        self.retry_hint = retry_hint
        self._queue: collections.deque = collections.deque()
        self._queued_nodes = 0
        self._queued_edges = 0
        self._per_client: collections.Counter = collections.Counter()

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def queued_nodes(self) -> int:
        return self._queued_nodes

    @property
    def queued_edges(self) -> int:
        return self._queued_edges

    def _footprint(self, n: int) -> int:
        """Padded node extent a request occupies in a coalesced batch."""
        return _ceil_to(n, self.align) if self.align else n

    def admit_reason(self, req: SubgraphRequest) -> str | None:
        """Why the admission policy would refuse ``req`` now, or None.

        Reason strings are STABLE per policy (no live counters or client
        ids) — they key the engine's ``shed_reasons`` histogram, which
        must stay bounded on a long-running server.
        """
        pol = self.admission
        if pol is None:
            return None
        if pol.max_depth is not None and len(self._queue) >= pol.max_depth:
            return f"queue depth at max_depth={pol.max_depth}"
        if (pol.max_nodes is not None
                and self._queued_nodes + req.n_nodes > pol.max_nodes):
            return f"queued nodes would exceed max_nodes={pol.max_nodes}"
        if (pol.max_edges is not None
                and self._queued_edges + req.n_edges > pol.max_edges):
            return f"queued edges would exceed max_edges={pol.max_edges}"
        cap = pol.client_cap
        if (cap is not None and req.client_id is not None
                and self._per_client[req.client_id] >= cap):
            return (f"client at fair-share cap {cap} "
                    f"(share={pol.per_client_share} of "
                    f"max_depth={pol.max_depth})")
        return None

    def add(self, req: SubgraphRequest) -> None:
        if (self._footprint(req.n_nodes) > self.node_budget
                or req.n_edges > self.edge_budget):
            raise ValueError(
                f"request {req.req_id} ({req.n_nodes} nodes, {req.n_edges} "
                f"edges) exceeds the batch budget ({self.node_budget} nodes, "
                f"{self.edge_budget} edges); pre-partition it smaller")
        reason = self.admit_reason(req)
        if reason is not None:
            hint = self.retry_hint() if self.retry_hint is not None else None
            raise AdmissionError(reason, retry_after_s=hint)
        self._queue.append(req)
        self._queued_nodes += req.n_nodes
        self._queued_edges += req.n_edges
        if req.client_id is not None:
            self._per_client[req.client_id] += 1

    def _uncount(self, r: SubgraphRequest) -> None:
        self._queued_nodes -= r.n_nodes
        self._queued_edges -= r.n_edges
        if r.client_id is not None:
            self._per_client[r.client_id] -= 1
            if self._per_client[r.client_id] <= 0:
                del self._per_client[r.client_id]

    def requeue(self, reqs, *, front: bool = True) -> None:
        """Re-admit already-admitted requests after a replica fault.

        Deliberately NO admission check: these requests were admitted
        once, and shedding a retry would be silent loss — exactly what
        the failover contract forbids (the queue may transiently exceed
        its caps by the in-flight plan's size; it drains first). The
        accounting (queued nodes/edges, per-client counts) is restored.
        ``front=True`` keeps the retried work at the head of the FIFO —
        it is the oldest traffic.
        """
        for r in (reversed(list(reqs)) if front else reqs):
            if front:
                self._queue.appendleft(r)
            else:
                self._queue.append(r)
            self._queued_nodes += r.n_nodes
            self._queued_edges += r.n_edges
            if r.client_id is not None:
                self._per_client[r.client_id] += 1

    def pending(self) -> tuple:
        """Snapshot of the queued requests in FIFO order (the engine
        re-routes these in place when the replica set changes)."""
        return tuple(self._queue)

    def next_plan(self) -> CoalescedBatch | None:
        """Coalesce the longest FIFO run that fits the budget — one route.

        Requests carry the replica the engine routed them to
        (``req.replica``; None for unrouted traffic, which all matches).
        A plan only coalesces requests sharing the HEAD request's route,
        so one batch executes on one replica while other replicas'
        traffic keeps its FIFO order in the queue. Budget semantics are
        unchanged from the single-route batcher: the first same-route
        request that does not fit ends the run (no skip-ahead within a
        route — FIFO fairness), and the budget is checked against the
        ALIGNED node footprint (what the batch actually occupies), so an
        aligned batch always fits its bucket.
        """
        if not self._queue:
            return None
        route = self._queue[0].replica
        taken, keep = [], []
        n_aln = e_tot = 0
        full = False
        for r in self._queue:
            if r.replica != route or full:
                keep.append(r)
                continue
            if taken and (n_aln + self._footprint(r.n_nodes) > self.node_budget
                          or e_tot + r.n_edges > self.edge_budget):
                full = True
                keep.append(r)
                continue
            taken.append(r)
            n_aln += self._footprint(r.n_nodes)
            e_tot += r.n_edges
        self._queue = collections.deque(keep)
        for r in taken:
            self._uncount(r)
        return self._coalesce(taken, n_aln, e_tot)

    def _coalesce(self, reqs, n_aln: int, e_tot: int) -> CoalescedBatch:
        bucket = (pick_bucket(self.buckets, n_aln, e_tot)
                  if self.buckets else None)
        n_pad = bucket.n_pad if bucket else _ceil_to(n_aln, self.tile)
        e_cap = bucket.e_cap if bucket else max(e_tot, 1)
        d = reqs[0].features.shape[1]
        edges = -np.ones((2, e_cap), np.int32)
        feats = np.zeros((n_pad, d), np.float32)
        spans, off, e_off, n_tot = [], 0, 0, 0
        for r in reqs:
            e = r.edges
            edges[:, e_off:e_off + e.shape[1]] = e + off  # block-diagonal
            feats[off:off + r.n_nodes] = r.features
            spans.append((r.req_id, off, r.n_nodes))
            off += self._footprint(r.n_nodes)
            e_off += e.shape[1]
            n_tot += r.n_nodes
        batch = SubgraphBatch(
            edges=edges, n_nodes=n_pad, n_valid=n_tot, features=feats,
            labels=-np.ones(n_pad, np.int32),
            train_mask=np.zeros(n_pad, bool),
            node_ids=-np.ones(n_pad, np.int32), n_edges=e_tot)
        return CoalescedBatch(batch=batch, requests=list(reqs), spans=spans,
                              bucket=bucket)


def requests_from_partitions(data, parts: np.ndarray) -> list[SubgraphRequest]:
    """One SubgraphRequest per graph partition (the serving traffic unit)."""
    reqs = []
    for p in range(int(parts.max()) + 1):
        nodes = np.where(parts == p)[0]
        if len(nodes) == 0:
            continue
        sub = data.csr.subgraph(nodes)
        reqs.append(SubgraphRequest(
            edges=sub.edge_list().astype(np.int32),
            features=np.ascontiguousarray(data.features[nodes], np.float32),
            n_nodes=sub.n))
    return reqs
