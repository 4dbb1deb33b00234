"""Continuous-batching GNN serving engine.

The reference's ``repro.serve.engine`` for the port. The forward is a
plain method (no jit): the §4.6 packed features are unpacked and fed to
``models.gnn.forward_qgtc`` pre-quantized, with the cached tile
artifacts, on the replica's device. Timers stop after a synchronize of
that device, so latencies are the device's work, not its dispatch.

``GNNServer`` is the paper's deployment shape grown into a serving
subsystem:

  queue + micro-batcher — incoming subgraph requests coalesce FIFO into
      block-diagonal batches (§4.1) under a node/edge budget, padded to a
      small fixed set of shape buckets, so the forward sees a bounded
      set of shapes (serve/queue.py).
  admission control — the queue is bounded by an ``AdmissionPolicy``
      (depth / queued nodes / queued edges, optional per-client fair
      share). At the bound, ``reject`` sheds the submit with a reason
      (``submit`` returns None; ``ServeStats`` counts sheds by reason)
      and ``block`` applies backpressure: ``submit`` runs engine steps
      until the request fits, stashing the produced results for the next
      ``step``/``drain`` to return.
  tile reuse cache — adjacency artifacts (dense form, packed bit-planes,
      occupancy maps, compact_tiles indices) are cached PER SUBGRAPH
      fingerprint (§4.4 extended across requests, serve/cache.py); the
      micro-batcher aligns block offsets to the kernel tile footprint so
      a coalesced batch's artifacts compose from its members' cached
      entries by offset shifting (``compose_entries``) — a hot subgraph
      hits in any coalescing order, skips pack+occupancy work, and ships
      only its features when the whole batch is cached.
  quantized fast path — the §4.6 compound transfer delivers packed integer
      features that feed ``forward_qgtc`` pre-quantized, no
      dequantize -> requantize roundtrip.
  multi-replica + failover — INDIVIDUAL subgraphs (not coalesced
      groups) route to replicas by rendezvous-hash fingerprint affinity,
      with cache-aware placement for cold fingerprints (serve/router.py);
      the batcher coalesces per route, so repeats hit their replica's
      tile cache while distinct traffic balances over the fleet. The
      replica set is ELASTIC: a replica that dies mid-batch
      (serve/chaos.py ``ReplicaFault``) is removed, its queued/in-flight
      requests retry on survivors (bounded by ``max_retries``, never
      silently lost), its fingerprints re-home and the tile cache
      re-warms on the new owner; a replica that persistently straggles
      (per-replica ``dist.elastic.StragglerWatchdog``) is evicted the
      same way. Shedding submits carry a ``retry_after_s`` backoff hint
      from the queue-wait p95 window. With ``devices=`` replicas map onto
      those devices; ``replicas=`` decouples the logical replica count
      from the device count (virtual replicas — the routing and failover
      paths are fully exercisable on one device).

The execution engine and its tuning remain a constructor choice
(``backend=``/``policy=`` routed through the repro_torch.api registry).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.core import bitops
from repro_torch.core.quantize import QuantParams
from repro_torch.core.zerotile import (compact_tiles, occupancy_stats,
                                       tile_occupancy)
from repro_torch.device import resolve_device
from repro_torch.dist.elastic import StragglerWatchdog, replan_mesh
from repro_torch.graph.batching import SubgraphBatch
from repro_torch.graph.packing import (compound_nbytes, transfer_packed,
                                       transfer_packed_feats)
from repro_torch.kernels import sgt
from repro_torch.models import gnn
from repro_torch.perf import report
from repro_torch.serve.cache import TileCache, TileEntry, compose_entries
from repro_torch.serve.chaos import ReplicaFault
from repro_torch.serve.queue import (AdmissionPolicy, CoalescedBatch,
                                     MicroBatcher, SubgraphRequest, _ceil_to,
                                     subgraph_fingerprint)
from repro_torch.serve.router import ReplicaRouter
from repro_torch.tune import table as tune_table

__all__ = ["GNNServer", "ServeStats", "STATS_WINDOW"]

# one rolling window for every per-request/per-batch sample series in
# ServeStats (latencies AND queue waits): a long-running server reports
# recent percentiles without growing memory per request
STATS_WINDOW = 4096


@dataclasses.dataclass
class ServeStats:
    batches: int = 0
    requests: int = 0
    nodes: int = 0
    wall_s: float = 0.0
    transfer_bytes: int = 0
    tiles_total: int = 0
    tiles_nonzero: int = 0
    # batch-level cache outcomes: cache_hits = full hits (the batch
    # shipped features only), cache_misses = compound-buffer batches, of
    # which cache_partial_hits had SOME members cached (their
    # pack+occupancy was skipped via composition)
    cache_hits: int = 0
    cache_misses: int = 0
    cache_partial_hits: int = 0
    # bytes resident in the tile cache after the latest batch (snapshot,
    # not a counter): tracks the cache_bytes= LRU bound
    cache_resident_bytes: int = 0
    # admission accounting: every submit is admitted or shed (monotone:
    # requests_admitted + requests_shed == submit calls); shed_reasons
    # histograms the policy reason strings; submit_blocked counts
    # backpressure events (block-mode submits that had to run the engine)
    requests_admitted: int = 0
    requests_shed: int = 0
    submit_blocked: int = 0
    shed_reasons: dict = dataclasses.field(default_factory=dict)
    # elastic replica set: live-count snapshot plus fault/retry
    # accounting. A faulted batch's requests are retried on survivors —
    # requests_retried counts them; they are never dropped.
    replicas_live: int = 1
    replica_faults: int = 0
    replicas_evicted: int = 0
    requests_retried: int = 0
    # accumulated exponential-backoff hint for retried work (accounted,
    # not slept — the single-process engine must not stall survivors)
    retry_backoff_s: float = 0.0
    # the current client backoff hint (rolling queue-wait p95, see
    # GNNServer._retry_hint); re-stamped on every shed so rejected
    # submits always carry a finite retry_after_s
    retry_after_s: float = 0.0
    # tile-cache entries/bytes dropped when a replica left the set (the
    # fingerprints re-homed; the new owner re-warms on its first miss)
    cache_rehomed_entries: int = 0
    cache_rehomed_bytes: int = 0
    # per-batch compute latency (timer stopped AFTER device sync),
    # per-request queue->result latency, and per-request queue-wait
    # (submit -> coalesce); all three share the same bounded rolling
    # window (STATS_WINDOW) so a long-running server reports recent
    # percentiles without growing per request
    batch_latencies_s: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=STATS_WINDOW))
    request_latencies_s: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=STATS_WINDOW))
    queue_wait_s: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=STATS_WINDOW))

    @property
    def zero_tile_skip_ratio(self) -> float:
        if self.tiles_total == 0:
            return 0.0
        return 1.0 - self.tiles_nonzero / self.tiles_total

    @property
    def p50_s(self) -> float:
        return report.percentile(self.batch_latencies_s, 50)

    @property
    def p95_s(self) -> float:
        return report.percentile(self.batch_latencies_s, 95)

    @property
    def nodes_per_s(self) -> float:
        return self.nodes / self.wall_s if self.wall_s > 0 else 0.0

    def summary(self) -> dict:
        out = {
            "batches": self.batches,
            "requests": self.requests,
            "nodes": self.nodes,
            "wall_s": round(self.wall_s, 4),
            "nodes_per_s": round(self.nodes_per_s, 1),
            "transfer_bytes": self.transfer_bytes,
            "zero_tile_skip_ratio": round(self.zero_tile_skip_ratio, 4),
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "cache_partial_hits": self.cache_partial_hits,
            "cache_resident_bytes": self.cache_resident_bytes,
            "requests_admitted": self.requests_admitted,
            "requests_shed": self.requests_shed,
            "submit_blocked": self.submit_blocked,
            "shed_reasons": dict(self.shed_reasons),
            "replicas_live": self.replicas_live,
            "replica_faults": self.replica_faults,
            "replicas_evicted": self.replicas_evicted,
            "requests_retried": self.requests_retried,
            "retry_backoff_s": round(self.retry_backoff_s, 6),
            "retry_after_s": round(self.retry_after_s, 6),
            "cache_rehomed_entries": self.cache_rehomed_entries,
            "cache_rehomed_bytes": self.cache_rehomed_bytes,
        }
        out.update(report.latency_summary(self.batch_latencies_s, "batch_"))
        out.update(report.latency_summary(self.request_latencies_s, "req_"))
        out.update(report.latency_summary(self.queue_wait_s, "queue_"))
        return out


class GNNServer:
    """Quantized batched-subgraph serving (queue, cache, bucketed forward).

    Two entry points share one execution path:

      ``infer_batch(batch)``    — run one pre-built :class:`SubgraphBatch`
                                  (the classic loop; examples/tests use it)
      ``submit(req)`` + ``step()``/``drain()``
                                — continuous batching: requests coalesce
                                  into block-diagonal bucketed batches

    ``backend``/``policy`` select the execution engine through the
    repro_torch.api registry (None = the active ``api.use`` context /
    registered default). The policy's tile shape also drives the zero-tile
    accounting so reported skip ratios match what the kernel would skip.
    ``cache_entries=0`` disables the tile cache; ``cache_bytes=`` adds a
    strict resident-bytes LRU bound on top of the entry bound (entries
    vary widely in size per subgraph — see serve/cache.py); ``buckets=
    None`` disables shape bucketing (exact padding, the
    recompile-per-shape baseline).
    ``admission=`` bounds the queue (see serve/queue.py AdmissionPolicy);
    None = unbounded (every submit admitted).

    ``devices=`` lists the ``torch.device`` s the replicas run on; None
    means the card alone (``device.resolve_device(None)``, which raises
    without one). ``replicas=`` sets the logical replica count (default:
    one per device); replicas beyond the device count share devices
    round-robin (virtual replicas — per-subgraph routing and failover
    behave identically, so they are testable on one device).
    ``chaos=`` installs a serve/chaos.py ``FaultInjector`` at the batch
    execution point; ``max_retries`` bounds per-request fault retries (a
    request faulting more raises loudly — work is never shed silently).
    ``straggler_tolerance=`` enables per-replica straggler eviction via
    ``dist.elastic.StragglerWatchdog``: a replica whose batch wall time
    exceeds tolerance x its own rolling p50 for ``straggler_strikes``
    consecutive batches is removed from the routing set (its traffic
    re-homes; None = detection off).

    ``tuning_table`` feeds the policy fallback chain when ``policy=None``:
    each shape bucket resolves its own tuned ``serve_forward`` policy
    (one nearest-bucket lookup per ``n_pad``, memoized, so each bucket
    keeps one policy). ``"auto"`` (the default) snapshots the active table
    from ``repro_torch.tune`` at construction (``use_table`` context >
    ``install()`` > the packaged artifact, of which none is committed);
    pass a path or TuningTable to pin one, or None to disable tuning. An explicit ``policy=`` always wins, and an unusable table
    file warns and degrades to the ambient policy — it never fails
    construction.
    """

    def __init__(self, qparams: dict, cfg: gnn.GNNConfig, feat_bits: int = 8,
                 backend=None, policy: api.ExecutionPolicy | None = None,
                 buckets=None, node_budget: int | None = None,
                 edge_budget: int | None = None, tile: int = 128,
                 cache_entries: int = 64, cache_bytes: int | None = None,
                 devices=None, admission: AdmissionPolicy | None = None,
                 tuning_table="auto", replicas: int | None = None,
                 chaos=None, max_retries: int = 3,
                 straggler_tolerance: float | None = None,
                 straggler_strikes: int = 2):
        self.qparams = qparams
        self.cfg = cfg
        self.feat_bits = feat_bits
        self.backend = backend
        self.policy = policy  # None = table entry, else the active context
        if tuning_table == "auto":
            self._table = tune_table.active_table()
        elif tuning_table is None or isinstance(tuning_table,
                                                tune_table.TuningTable):
            self._table = tuning_table
        else:  # a path: corrupt/stale/missing warns and disables tuning
            self._table = tune_table.TuningTable.load(tuning_table)
        self._bucket_pols: dict = {}  # n_pad -> tuned policy | None
        self.stats = ServeStats()
        self.cache = (TileCache(cache_entries, cache_bytes=cache_bytes)
                      if cache_entries > 0 else None)
        # block offsets aligned to the kernel tile footprint so cached
        # per-subgraph artifacts compose into any batch by offset shifting.
        # With no explicit policy the table's largest-bucket entry sets the
        # footprint — but only when its grid divides the batcher tile and
        # every bucket (a tuned grid must not invalidate the ladder the
        # caller already built); otherwise the ambient policy's grid holds.
        pol0 = policy
        if pol0 is None and self._table is not None:
            probe = max((b.n_pad for b in (buckets or ())), default=tile)
            cand = self._table.policy_for(
                "serve_forward", bits=feat_bits,
                shape=(probe, probe, cfg.in_dim))
            if cand is not None:
                align = math.lcm(cand.block_m, 32 * cand.block_w)
                if (tile % align == 0
                        and not any(b.n_pad % align
                                    for b in (buckets or ()))):
                    pol0 = cand
        if pol0 is None:
            pol0 = api.current()[1]
        self._align = math.lcm(pol0.block_m, 32 * pol0.block_w)
        self._tile_shape = (pol0.block_m, pol0.block_w)
        # fail fast: every batch shape the batcher can produce must land
        # on the composition grid, or compose_entries would raise deep in
        # serving after requests were already admitted
        if tile % self._align:
            raise ValueError(
                f"tile={tile} is not a multiple of the policy's tile "
                f"footprint {self._align} (lcm of block_m={pol0.block_m} "
                f"rows and {32 * pol0.block_w} packed columns); pass "
                f"tile={self._align}")
        bad = [b for b in (buckets or ()) if b.n_pad % self._align]
        if bad:
            raise ValueError(
                f"bucket n_pad not a multiple of the policy's tile "
                f"footprint {self._align}: {bad}; build the ladder with "
                f"tile={self._align}")
        self.batcher = MicroBatcher(buckets, node_budget=node_budget,
                                    edge_budget=edge_budget, tile=tile,
                                    align=self._align, admission=admission)
        self._spill: dict = {}  # results produced by block-mode submits
        # L2: composed batch entries memoized by (ordered member
        # fingerprints, n_pad, replica). Pure memoization — a composed
        # entry is a deterministic function of its key, so it never needs
        # invalidation, only LRU bounding. A REPEATED coalescing order
        # skips the per-batch composition entirely; a novel order
        # composes once from the per-subgraph L1 entries and is memoized
        # for next time.
        self._composed: collections.OrderedDict = collections.OrderedDict()
        self._composed_cap = cache_entries  # the tile cache's entry bound
        self._devices = ([resolve_device(None)] if devices is None
                         else [torch.device(d) for d in devices])
        if not self._devices:
            raise ValueError("devices must name at least one device")
        self._explicit_devices = devices is not None
        if replicas is not None and replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if max_retries < 1:
            raise ValueError(f"max_retries must be >= 1, got {max_retries}")
        n_rep = replicas if replicas is not None else len(self._devices)
        # logical replica -> backing device; virtual replicas share devices
        # round-robin, so routing/failover are exercisable on one device
        self._replica_dev = {r: self._devices[r % len(self._devices)]
                             for r in range(n_rep)}
        self._router = ReplicaRouter(range(n_rep))
        self._routed_load: collections.Counter = collections.Counter()
        self._chaos = chaos
        self.max_retries = max_retries
        self._straggler_tolerance = straggler_tolerance
        self._straggler_strikes = int(straggler_strikes)
        self._watchdogs: dict = {}   # replica -> StragglerWatchdog
        self._strikes: collections.Counter = collections.Counter()
        self.stats.replicas_live = n_rep
        # shed rejections carry a data-driven retry-after hint (queue-wait /
        # batch-latency p95); wired post-construction so the hint closes
        # over live stats
        self.batcher.retry_hint = self._retry_hint
        self._dev_params: dict = {}
        # the distinct forward signatures run so far: what the reference's
        # jit cached an executable on (see n_compiles)
        self._signatures: set = set()

    def _fwd(self, qp, adj, packed, scale, zero, inv_deg, t_idx, t_cnt,
             s_max, t_kind, pol):
        """Unpack the compound features and run the pre-quantized integer
        path. ``pol`` is the per-bucket policy resolved by _policy_for_n;
        None means "the ambient context's" (the pre-table behavior)."""
        xq = bitops.bit_compose(
            bitops.unpack_along_axis(packed, dim=2, size=self.cfg.in_dim))
        qpx = QuantParams(nbits=self.feat_bits, scale=scale, zero=zero)
        tiles = None
        if t_idx is not None:
            # t_kind tags which remap the arrays are: compact k-tile ids
            # or the SGT word-column translation
            tiles = ((t_idx, t_cnt, s_max, "sgt") if t_kind == "sgt"
                     else (t_idx, t_cnt, s_max))
        fwd_pol = pol
        if tiles is not None:
            # The cached tiles describe only the adjacency, so the
            # forward-wide policy drops its jump mode: the aggregation
            # GEMMs jump through the tiles (which take precedence) while
            # the dense feature/weight GEMMs skip the pointless occupancy
            # analysis.
            fwd_pol = pol if pol is not None else api.current()[1]
            if fwd_pol.jump != "none":
                fwd_pol = fwd_pol.replace(jump="none")
        return gnn.forward_qgtc(qp, adj, (xq, qpx), inv_deg, self.cfg,
                                backend=self.backend, policy=fwd_pol,
                                tiles=tiles)

    # ------------------------------------------------------------- probes

    @property
    def n_compiles(self) -> int:
        """Distinct forward signatures run so far.

        Nothing is compiled here: a signature is ``(n_pad, device,
        s_max, t_kind, policy)``, the key the reference's jitted forward
        cached one executable on. The bucket ladder bounds it (one
        ``n_pad`` per bucket, ``s_max`` rounded to a power of two), so
        it counts the shapes a CUDA graph or allocator would have to
        hold, and a repeated wave adds none.
        """
        return len(self._signatures)

    @property
    def align(self) -> int:
        """Node alignment of the composition grid (the policy's tile
        footprint). A ``node_budget`` equal to this forces single-request
        plans — the failover benchmark uses that to make per-request
        logits coalescing-invariant."""
        return self._align

    # ------------------------------------------------- continuous batching

    def submit(self, req: SubgraphRequest) -> int | None:
        """Enqueue one subgraph request; returns its id for result lookup.

        Under an AdmissionPolicy the submit may not be admitted: in
        ``reject`` mode an over-limit request is shed (returns None;
        ``stats.requests_shed``/``shed_reasons`` account it), in ``block``
        mode the call runs engine steps until the request fits — the
        produced results are stashed and returned by the next ``step``/
        ``drain`` (backpressure: the producer pays the wait, not the
        queue).
        """
        req.t_enqueue = time.perf_counter()
        pol = self.batcher.admission
        reason = self.batcher.admit_reason(req)
        if reason is not None:
            if pol.on_full == "reject":
                self.stats.retry_after_s = self._retry_hint()
                self.stats.requests_shed += 1
                self.stats.shed_reasons[reason] = \
                    self.stats.shed_reasons.get(reason, 0) + 1
                return None
            # block: make forward progress until the request is admissible
            self.stats.submit_blocked += 1
            while reason is not None:
                if not self.batcher:
                    raise ValueError(
                        f"request {req.req_id} can never be admitted (empty "
                        f"queue, still refused): {reason}")
                self._spill.update(self._step_once())
                reason = self.batcher.admit_reason(req)
        # per-subgraph routing: pin the request to a replica by fingerprint
        # affinity (known keys stick; cold keys get cache-aware placement)
        req.replica = self._route_fp(req.fingerprint)
        self.batcher.add(req)
        self._routed_load[req.replica] += 1
        self.stats.requests_admitted += 1
        return req.req_id

    def step(self, return_logits: bool = False) -> dict:
        """Coalesce + run ONE batch off the queue; {req_id: predictions}.

        Results stashed by block-mode submits are returned first (merged
        into the dict). With ``return_logits=True`` each value is a
        ``(predictions, logits)`` tuple for the request's valid nodes.
        """
        out = self._spill
        self._spill = {}
        out.update(self._step_once())
        if not return_logits:
            return {rid: preds for rid, (preds, _) in out.items()}
        return out

    def _step_once(self) -> dict:
        """Run one batch; {req_id: (predictions, logits)} (empty if idle).

        The plan runs on its route's replica. A ``ReplicaFault`` (from the
        chaos harness, or a real integration's device/RPC error
        translation) marks the replica failed and requeues the in-flight
        requests at the FRONT of the queue re-routed to survivors — a
        retried batch returns {} this call and completes on a later step;
        it is never silently dropped.
        """
        plan = self.batcher.next_plan()
        if plan is None:
            return {}
        rep = plan.replica if plan.replica is not None else 0
        self._routed_load[rep] -= len(plan.requests)
        if self._routed_load[rep] <= 0:
            self._routed_load.pop(rep, None)
        t0 = time.perf_counter()
        try:
            if self._chaos is not None:
                self._chaos.at_execute(rep, self.stats.batches)
            logits, entry = self._execute_plan(plan, rep)
            _wait(logits)  # latency = compute, not dispatch
        except ReplicaFault as fault:
            self._retry_after_fault(plan, fault)
            return {}
        t1 = time.perf_counter()
        self._observe_replica(rep, t1 - t0)
        # queue-wait accounts on SUCCESS only: a faulted batch's requests
        # stay queued and would double-count their wait on the retry
        for r in plan.requests:
            if r.t_enqueue is not None:
                self.stats.queue_wait_s.append(t0 - r.t_enqueue)
        self._account(plan.batch, entry, t1 - t0)
        out = {}
        lg = logits.cpu().numpy()
        for req_id, off, n in plan.spans:
            span = lg[off:off + n]
            out[req_id] = (np.argmax(span, axis=-1), span)
            self.stats.requests += 1
        for r in plan.requests:
            if r.t_enqueue is not None:
                self.stats.request_latencies_s.append(t1 - r.t_enqueue)
        return out

    def drain(self, return_logits: bool = False) -> dict:
        """Run until the queue is empty; results by req_id.

        Results are handed to the caller, never retained by the engine —
        a long-running serve loop must not grow memory per request.
        """
        out: dict = {}
        while self.batcher or self._spill:
            out.update(self.step(return_logits=return_logits))
        return out

    # ------------------------------------------- routing + elastic failover

    def _route_fp(self, fp: str) -> int:
        """Replica for a fingerprint: sticky if routed before, else
        cache-aware cold placement (least loaded x least cache pressure,
        HRW-ranked tiebreak — see serve/router.py)."""
        if self._router.known(fp):
            return self._router.route(fp)
        return self._router.place(fp, load=self._routed_load,
                                  pressure=self._cache_pressure())

    def _cache_pressure(self) -> dict:
        """{replica: fractional cache occupancy} for cold placement."""
        if self.cache is None:
            return {}
        by_rep = self.cache.bytes_by_replica()
        denom = (float(self.cache.cache_bytes)
                 if self.cache.cache_bytes is not None
                 else float(self.cache.resident_bytes) + 1.0)
        return {r: b / denom for r, b in by_rep.items()}

    def _retry_hint(self) -> float:
        """Data-driven retry-after: p95 of recent queue waits and batch
        latencies (floored to 1 ms so the hint is always finite > 0)."""
        return max(report.percentile(list(self.stats.queue_wait_s), 95),
                   report.percentile(list(self.stats.batch_latencies_s), 95),
                   1e-3)

    def _retry_after_fault(self, plan: CoalescedBatch,
                           fault: ReplicaFault) -> None:
        """Requeue a faulted plan's requests on survivors (bounded)."""
        self.stats.replica_faults += 1
        over = [r.req_id for r in plan.requests
                if r.retries + 1 > self.max_retries]
        if over:
            raise RuntimeError(
                f"requests {over} exceeded max_retries={self.max_retries} "
                f"after replica faults; refusing to shed admitted work "
                f"silently") from fault
        self.mark_failed(fault.replica)
        backoff = 0.0
        for r in plan.requests:
            r.retries += 1
            backoff = max(backoff, min(0.001 * 2 ** (r.retries - 1), 1.0))
            r.replica = self._route_fp(r.fingerprint)
            self._routed_load[r.replica] += 1
        self.stats.requests_retried += len(plan.requests)
        # backoff is ACCOUNTED, not slept: the engine must keep making
        # progress (block-mode submits spin on _step_once), so the delay
        # surfaces as a hint for callers instead of stalling the loop
        self.stats.retry_backoff_s += backoff
        self.stats.retry_after_s = max(self._retry_hint(), backoff)
        self.batcher.requeue(plan.requests, front=True)

    def mark_failed(self, replica: int) -> None:
        """Remove a replica from the routing set and re-home its state.

        Idempotent for already-removed replicas. Pinned fingerprints
        re-home deterministically (HRW over survivors), the replica's
        cache entries are dropped (re-warmed on the next miss) and queued
        requests re-route. Failing the LAST replica raises — there are no
        survivors to retry on.
        """
        if replica not in self._router.replicas:
            return
        if len(self._router) == 1:
            raise RuntimeError(
                f"replica {replica} failed with no survivors; cannot "
                f"re-home in-flight work")
        self._router.remove_replica(replica)
        self.stats.replicas_live = len(self._router)
        if self.cache is not None:
            n, nbytes = self.cache.drop_replica(replica)
            self.stats.cache_rehomed_entries += n
            self.stats.cache_rehomed_bytes += nbytes
            self.stats.cache_resident_bytes = self.cache.resident_bytes
        for k in [k for k in self._composed
                  if isinstance(k, tuple) and k[-1] == replica]:
            del self._composed[k]
        self._watchdogs.pop(replica, None)
        self._strikes.pop(replica, None)
        self._replica_dev.pop(replica, None)
        self._reroute_queued()

    def add_replica(self, replica: int | None = None) -> int:
        """Join a (new or recovered) replica; queued traffic re-routes so
        fingerprints whose HRW owner is the newcomer move to it (minimal
        disruption: only those move). Returns the replica id."""
        if replica is None:
            replica = max(self._router.replicas) + 1
        self._router.add_replica(replica)
        self._replica_dev[replica] = \
            self._devices[replica % len(self._devices)]
        self.stats.replicas_live = len(self._router)
        self._reroute_queued()
        return replica

    def _reroute_queued(self) -> None:
        """Re-route every queued request after a membership change."""
        self._routed_load.clear()
        for r in self.batcher.pending():
            r.replica = self._route_fp(r.fingerprint)
            self._routed_load[r.replica] += 1

    def _observe_replica(self, replica: int, wall: float) -> None:
        """Feed the per-replica straggler watchdog; evict on a strike run.

        Detection is off unless ``straggler_tolerance`` was passed. A
        replica is evicted only after ``straggler_strikes`` CONSECUTIVE
        flagged batches (one slow batch — a compile, a cold cache — is
        normal), and never when it is the last one standing.
        """
        if self._straggler_tolerance is None:
            return
        wd = self._watchdogs.get(replica)
        if wd is None:
            wd = self._watchdogs[replica] = StragglerWatchdog(
                tolerance=self._straggler_tolerance)
        if wd.observe(self.stats.batches, wall):
            self._strikes[replica] += 1
        else:
            self._strikes.pop(replica, None)
        if (self._strikes[replica] >= self._straggler_strikes
                and len(self._router) > 1):
            self.stats.replicas_evicted += 1
            self.mark_failed(replica)

    def mesh_plan(self) -> tuple[int, int] | None:
        """(data, model) mesh shape for the live replica count (None
        unless ``devices=`` was passed) — what a multi-host restore would
        replan to."""
        if not self._explicit_devices:
            return None
        return replan_mesh(len(self._router), 1)

    # ------------------------------------------------------ one-batch path

    def infer_batch(self, batch: SubgraphBatch, *, return_logits: bool = False):
        """Run one pre-built batch; predictions for its valid nodes."""
        t0 = time.perf_counter()
        logits, entry = self._execute(batch, self._batch_key(batch))
        _wait(logits)  # the forward is async-dispatched: stop the timer
        # only after the device finishes, not after dispatch
        self._account(batch, entry, time.perf_counter() - t0)
        self.stats.requests += 1
        lg = logits.cpu().numpy()
        preds = np.argmax(lg[:batch.n_valid], axis=-1)
        return (preds, lg) if return_logits else preds

    # ------------------------------------------------------------ internals

    @staticmethod
    def _batch_key(batch: SubgraphBatch) -> str:
        return subgraph_fingerprint(batch.n_nodes, batch.edges)

    def _params_for(self, device):
        """The weights on ``device``, every tensor moved once per device
        (those inside ``QuantParams`` included)."""
        if device not in self._dev_params:
            self._dev_params[device] = _to_device(self.qparams, device)
        return self._dev_params[device]

    def _build_entry(self, adj) -> TileEntry:
        deg = torch.sum(adj, dim=1, keepdim=True).to(torch.float32)
        inv_deg = 1.0 / (deg + 1.0)
        tm, tw = self._tile_shape
        ap = bitops.pack_a(adj, 1)[0]
        ap = bitops.pad_to(bitops.pad_to(ap, 0, tm), 1, tw)
        occ = tile_occupancy(ap, tm, tw)
        idx, counts = compact_tiles(occ)
        # the SGT word-column remap rides along: same OR-reduction source,
        # word granularity (sgt.word_occupancy reuses the packed plane)
        wocc = sgt.word_occupancy(ap, tm)
        s_idx, s_counts = compact_tiles(wocc)
        return TileEntry(adj=adj, inv_deg=inv_deg, a_packed=ap,
                         occupancy=occ, compact_idx=idx,
                         compact_counts=counts,
                         occ_stats=occupancy_stats(occ),
                         s_max=int(torch.max(counts)),
                         sgt_idx=s_idx, sgt_counts=s_counts,
                         sgt_w=int(torch.max(s_counts)))

    def _policy_for_n(self, n_pad: int) -> api.ExecutionPolicy | None:
        """Per-bucket policy: constructor ``policy=`` > tuning table >
        None (= resolve the ambient context per call, pre-table behavior).

        Table lookups are memoized per ``n_pad`` — deterministic per
        bucket, so each bucket keeps one policy and tuning adds no
        forward signature.
        """
        if self.policy is not None:
            return self.policy
        if self._table is None:
            return None
        if n_pad not in self._bucket_pols:
            self._bucket_pols[n_pad] = self._table.policy_for(
                "serve_forward", bits=self.feat_bits,
                shape=(n_pad, n_pad, self.cfg.in_dim))
        return self._bucket_pols[n_pad]

    def tuned_policies(self) -> dict:
        """{n_pad: policy-field dict | None} resolved so far (probes/CLI)."""
        from repro_torch.tune.table import policy_to_dict
        return {n: (policy_to_dict(p) if p is not None else None)
                for n, p in sorted(self._bucket_pols.items())}

    def _jump_tiles(self, entry: TileEntry, pol=None):
        """Cached jump artifacts for the forward: (idx, counts, s_max,
        kind) with kind "compact" | "sgt" | None (no artifacts).

        Active when the engine's (backend, policy) pair asks for compact
        jumping or sparse-graph translation and the backend can exploit
        it. ``pol=None`` resolves the constructor policy or the ambient
        context (the per-bucket tuned policy is passed in by
        ``_forward``). ``s_max`` is rounded up to the next power of two
        (clamped to the grid bound) so the forward signatures stay few:
        one per (bucket, rounded count), not one per distinct subgraph
        sparsity. The kernel visits ``idx[i, :min(counts[i], s_max)]``,
        so a rounded ``s_max`` above every row's count is exact.
        """
        be = (api.get_backend(self.backend) if self.backend is not None
              else api.current()[0])
        if pol is None:
            pol = self.policy if self.policy is not None else api.current()[1]
        if (pol.jump == "sgt" and be.supports("bitserial_sgt")
                and entry.sgt_idx is not None
                and pol.block_m == self._tile_shape[0]):
            # the word-column remap depends only on block_m (not block_w),
            # so it survives an ambient policy with a retuned word tile
            wt = entry.sgt_idx.shape[1]
            s_pad = 1 << max(0, entry.sgt_w - 1).bit_length()
            return (entry.sgt_idx, entry.sgt_counts,
                    min(s_pad, max(wt, 1)), "sgt")
        if pol.jump != "compact" or not be.supports("bitserial_jump"):
            return None, None, 0, None
        if (pol.block_m, pol.block_w) != self._tile_shape:
            # the cached artifacts live on the construction-time tile
            # grid; an ambient policy with a different grid must not
            # consume them (the kernel would jump on the wrong tiles).
            # Jumping is an optimization, never a semantic change — the
            # forward recomputes occupancy in-call on its own grid.
            return None, None, 0, None
        kt = entry.compact_idx.shape[1]
        s_pad = 1 << max(0, entry.s_max - 1).bit_length()
        return (entry.compact_idx, entry.compact_counts,
                min(s_pad, max(kt, 1)), "compact")

    def _execute(self, batch: SubgraphBatch, key: str, rep: int | None = None):
        """Transfer + forward one batch; returns (logits, tile entry)."""
        # fingerprint-affinity placement: repeats of the same subgraph
        # group always land on the same replica (its cache has the tiles);
        # distinct traffic spreads over the fleet by HRW rank
        if rep is None:
            rep = self._router.route(key)
        device = self._replica_dev.get(rep)
        cache_key = (key, rep)
        self._check_feat_dim(batch)
        nb = compound_nbytes(batch, nbits=self.feat_bits)
        entry = self.cache.get(cache_key) if self.cache is not None else None
        if entry is None:
            # miss: full §4.6 compound transfer (header|edges|features),
            # then build + cache the adjacency artifacts
            adj, packed, meta = transfer_packed(batch, nbits=self.feat_bits,
                                                device=device)
            entry = self._build_entry(adj)
            if self.cache is not None:
                self.cache.put(cache_key, entry)
                self.stats.cache_misses += 1  # no cache => no miss to count
            self.stats.transfer_bytes += nb["III_packed"]
        else:
            # hit: adjacency artifacts are device-resident; ship features
            # only (the smaller feats-only compound buffer)
            packed, meta = transfer_packed_feats(batch, nbits=self.feat_bits,
                                                 device=device)
            self.stats.transfer_bytes += nb["III_feats"]
            self.stats.cache_hits += 1
        return self._forward(device, entry, packed, meta), entry

    def _execute_plan(self, plan: CoalescedBatch, rep: int = 0):
        """Transfer + forward one coalesced plan via per-subgraph entries.

        Each member subgraph's tile artifacts are cached under its OWN
        fingerprint and composed into the batch entry at its aligned
        offset, so a repeat subgraph hits regardless of the coalescing
        order. With every member cached the batch ships features only; a
        partial or full miss ships the compound buffer, and the missing
        members' artifacts are built from aligned slices of the (already
        device-resident) batch adjacency — one transfer either way.
        """
        batch = plan.batch
        if self.cache is None:
            # no cache: the whole-batch scratch build (also the reference
            # path the composition is asserted bit-identical against)
            return self._execute(batch, plan.fingerprint, rep)
        self._check_feat_dim(batch)
        device = self._replica_dev.get(rep)
        nb = compound_nbytes(batch, nbits=self.feat_bits)
        keys = [("sub", r.fingerprint, rep) for r in plan.requests]
        entries = [self.cache.get(k) for k in keys]
        n_cached = sum(e is not None for e in entries)
        self.cache.note_batch(n_cached, len(entries))
        offsets = [off for _, off, _ in plan.spans]
        l2_key = (tuple(r.fingerprint for r in plan.requests),
                  batch.n_nodes, rep)
        if n_cached == len(entries):
            packed, meta = transfer_packed_feats(batch, nbits=self.feat_bits,
                                                 device=device)
            self.stats.transfer_bytes += nb["III_feats"]
            self.stats.cache_hits += 1
        else:
            adj, packed, meta = transfer_packed(batch, nbits=self.feat_bits,
                                                device=device)
            self.stats.transfer_bytes += nb["III_packed"]
            self.stats.cache_misses += 1
            if n_cached:
                self.stats.cache_partial_hits += 1
            for i, (e, key) in enumerate(zip(entries, keys)):
                if e is not None:
                    continue
                off = offsets[i]
                n_sub = _ceil_to(plan.spans[i][2], self._align)
                # aligned and inside the batch by construction (the
                # batcher's footprint); compose_entries checks it again
                sub_adj = adj[off:off + n_sub, off:off + n_sub].contiguous()
                entries[i] = self._build_entry(sub_adj)
                self.cache.put(key, entries[i])
        entry = self._composed.get(l2_key)
        if entry is None:
            tm, tw = self._tile_shape
            entry = compose_entries(entries, offsets, batch.n_nodes, tm, tw)
            self._composed[l2_key] = entry
            while len(self._composed) > self._composed_cap:
                self._composed.popitem(last=False)
        else:
            self._composed.move_to_end(l2_key)
        return self._forward(device, entry, packed, meta), entry

    def _forward(self, device, entry: TileEntry, packed, meta):
        n_pad = entry.adj.shape[0]
        pol = self._policy_for_n(n_pad)
        t_idx, t_cnt, s_max, t_kind = self._jump_tiles(entry, pol)
        self._signatures.add((n_pad, device, s_max, t_kind, pol))
        # scale and zero as 0-d float32 tensors on the device: a host
        # scalar divisor would make torch's CUDA div multiply by its
        # reciprocal and move quantization levels
        f32 = dict(dtype=torch.float32, device=device)
        return self._fwd(self._params_for(device), entry.adj, packed,
                         torch.tensor(meta["scale"], **f32),
                         torch.tensor(meta["zero"], **f32), entry.inv_deg,
                         t_idx, t_cnt, s_max, t_kind, pol)

    def _check_feat_dim(self, batch: SubgraphBatch) -> None:
        if batch.features.shape[1] != self.cfg.in_dim:
            raise ValueError(
                f"batch feature dim {batch.features.shape[1]} != model "
                f"in_dim {self.cfg.in_dim}; the unpack would silently "
                f"truncate")

    def _account(self, batch: SubgraphBatch, entry: TileEntry,
                 elapsed_s: float) -> None:
        st = entry.occ_stats
        self.stats.tiles_total += st["tiles_total"]
        self.stats.tiles_nonzero += st["tiles_nonzero"]
        self.stats.batches += 1
        self.stats.nodes += batch.n_valid
        self.stats.wall_s += elapsed_s
        self.stats.batch_latencies_s.append(elapsed_s)
        if self.cache is not None:
            self.stats.cache_resident_bytes = self.cache.resident_bytes


def _wait(logits: torch.Tensor) -> None:
    """Block until the device that holds ``logits`` has computed them."""
    if logits.is_cuda:
        torch.cuda.synchronize(logits.device)


def _to_device(tree, device):
    """Every tensor of a parameter tree (dicts, tuples, QuantParams) on
    ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, QuantParams):
        return QuantParams(tree.nbits, tree.scale.to(device),
                           tree.zero.to(device))
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_device(v, device) for v in tree)
    return tree
