"""Port parity for the elastic serving tier: ``repro_torch.serve``'s router,
chaos harness, replica-aware cache and failover against the reference's,
the cases of tests/test_serve_failover.py (ogbn-arxiv at scale 0.008,
seed 0, 16 parts, so every request fits one tile and every plan is one
request).

Routes, placements, re-homes, fault firings and seeded jitter equal the
reference's; under the same faults both servers count the same batches,
retries, re-homed entries and bytes, and give logits within rtol = atol =
1e-5 (the reference run op by op, see tests/test_torch_serve.py). Within
the port, a run with a replica killed gives the no-fault run's logits bit
for bit and loses nothing. The port runs on the CPU.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.graph import datasets as jdatasets  # noqa: E402
from repro.graph import partition as jpartition  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.serve import chaos as jchaos  # noqa: E402
from repro.serve import (FaultInjector as JInjector,  # noqa: E402
                         GNNServer as JServer, ReplicaRouter as JRouter,
                         SubgraphRequest as JRequest, TileCache as JCache,
                         TileEntry as JEntry)
from repro.serve import queue as jqueue  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.graph import datasets, partition  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.serve import (AdmissionError, AdmissionPolicy,  # noqa: E402
                               FaultInjector, FaultSpec, GNNServer,
                               ReplicaFault, ReplicaRouter, STATS_WINDOW,
                               ServeStats, SubgraphRequest, TileCache,
                               TileEntry, parse_fault,
                               requests_from_partitions)
from repro_torch.serve import chaos  # noqa: E402
from repro_torch.serve.queue import buckets_for  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
COUNTERS = ("batches", "requests", "nodes", "transfer_bytes", "tiles_total",
            "tiles_nonzero", "cache_hits", "cache_misses",
            "cache_partial_hits", "cache_resident_bytes",
            "requests_admitted", "requests_shed", "submit_blocked",
            "shed_reasons", "replicas_live", "replica_faults",
            "replicas_evicted", "requests_retried", "retry_backoff_s",
            "cache_rehomed_entries", "cache_rehomed_bytes")
FPS = [f"fp{i:03d}" for i in range(120)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch thread
    each keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------- router

@pytest.mark.parametrize("seed", [0, 7])
def test_router_routes_match_reference(seed):
    """Owners, removals, additions and re-homes equal the reference's."""
    r, j = ReplicaRouter(range(5), seed=seed), JRouter(range(5), seed=seed)
    assert [r.owner(fp) for fp in FPS] == [j.owner(fp) for fp in FPS]
    before = {fp: r.owner(fp) for fp in FPS}
    for rt in (r, j):
        rt.remove_replica(2)
    after = {fp: r.owner(fp) for fp in FPS}
    assert after == {fp: j.owner(fp) for fp in FPS}
    # ONLY the dead replica's keys move
    assert {fp for fp in FPS if before[fp] != after[fp]} == \
        {fp for fp in FPS if before[fp] == 2}
    for rt in (r, j):
        rt.add_replica(9)
    assert [r.route(fp) for fp in FPS] == [j.route(fp) for fp in FPS]
    assert r.replicas == j.replicas and len(r) == len(j)


def test_router_placement_and_pins_match_reference():
    """Cold placement under load and pressure, the pin LRU and re-homing
    of a removed replica's pins, call for call as the reference."""
    r = ReplicaRouter(range(4), pin_capacity=8)
    j = JRouter(range(4), pin_capacity=8)
    rng = np.random.default_rng(0)
    for i, fp in enumerate(FPS[:40]):
        load = {k: int(rng.integers(0, 4)) for k in range(4)}
        pressure = {k: float(rng.random()) for k in range(4) if i % 3}
        assert r.place(fp, load=load, pressure=pressure) == \
            j.place(fp, load=load, pressure=pressure)
    assert [r.known(fp) for fp in FPS[:40]] == [j.known(fp) for fp in FPS[:40]]
    assert sum(r.known(fp) for fp in FPS[:40]) == 8
    for rt in (r, j):
        rt.remove_replica(rt.route(FPS[39]))
    assert [r.route(fp) for fp in FPS[:40]] == [j.route(fp) for fp in FPS[:40]]
    # with no signal the placement is the rendezvous owner
    fresh = ReplicaRouter(range(4))
    assert all(fresh.place(fp) == fresh.owner(fp) for fp in FPS[40:60])
    cold = ReplicaRouter(range(3))
    assert cold.place("cold-fp", load={0: 100, 1: 0, 2: 0},
                      pressure={1: 10.0, 2: 0.0}) == 2
    assert cold.route("cold-fp") == 2 and cold.place("cold-fp",
                                                     load={2: 999}) == 2


def test_router_validation_errors():
    with pytest.raises(ValueError, match="at least one replica"):
        ReplicaRouter([])
    with pytest.raises(ValueError, match="pin_capacity"):
        ReplicaRouter([0], pin_capacity=0)
    r = ReplicaRouter([0, 1])
    with pytest.raises(ValueError, match="already live"):
        r.add_replica(1)
    with pytest.raises(KeyError):
        r.remove_replica(9)
    r.remove_replica(1)
    with pytest.raises(RuntimeError, match="last live"):
        r.remove_replica(0)


# -------------------------------------------------------------------- chaos

def test_parse_fault_matches_reference():
    for spec in ("kill@3", "stall@2:replica=1,stall_s=0.2", "slow@4:repeat=3",
                 "slow@0:replica=2,stall_s=0.01,repeat=5"):
        assert dataclasses.asdict(parse_fault(spec)) == \
            dataclasses.asdict(jchaos.parse_fault(spec))
    for bad in ("kill", "kill@", "@3", "kill@3:bogus=1", "kill@3:replica",
                "explode@1", "kill@-1", "kill@0:repeat=0"):
        with pytest.raises(ValueError) as got:
            parse_fault(bad)
        with pytest.raises(ValueError) as want:
            jchaos.parse_fault(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(TypeError):
        FaultInjector(42)


def test_injector_firings_and_jitter_match_reference(monkeypatch):
    """The same specs fire at the same (replica, batch) points, raise the
    same faults and sleep the same seeded durations as the reference's."""
    specs = ("kill@2", "slow@1:repeat=4,stall_s=0.05",
             "stall@3:replica=3,stall_s=0.2,repeat=2")

    def drive(injector, fault):
        """Every (batch, replica) point: what it raised and what it slept."""
        slept, raised = [], []
        monkeypatch.setattr(chaos.time, "sleep", slept.append)
        for batch in range(8):
            for rep in range(4):
                try:
                    injector.at_execute(rep, batch)
                    raised.append(None)
                except fault as e:
                    raised.append((e.replica, e.kind, e.batch, str(e)))
        return raised, slept

    inj, jinj = FaultInjector(*specs, seed=5), JInjector(*specs, seed=5)
    got = drive(inj, ReplicaFault)
    assert got == drive(jinj, jchaos.ReplicaFault)
    assert inj.fired == jinj.fired and len(inj.fired) == 7
    assert len(got[1]) == 6 and sum(r is not None for r in got[0]) == 1
    # a kill's budget is spent: the retry at the same ordinal proceeds
    one = FaultInjector("kill@2")
    with pytest.raises(ReplicaFault):
        one.at_execute(1, 2)
    one.at_execute(0, 2)


# ----------------------------------------------------- cache replica bytes

def _entry(n=4):
    z = torch.zeros
    return TileEntry(adj=z((n, n), dtype=torch.int32),
                     inv_deg=z((n, 1), dtype=torch.float32),
                     a_packed=z((n, 1), dtype=torch.int32),
                     occupancy=z((1, 1), dtype=torch.int32),
                     compact_idx=z((1, 1), dtype=torch.int32),
                     compact_counts=z((1,), dtype=torch.int32),
                     occ_stats={"tiles_total": 1, "tiles_nonzero": 0})


def _jentry(n=4):
    z = jnp.zeros
    return JEntry(adj=z((n, n), jnp.int32), inv_deg=z((n, 1), jnp.float32),
                  a_packed=z((n, 1), jnp.uint32),
                  occupancy=z((1, 1), jnp.int32),
                  compact_idx=z((1, 1), jnp.int32),
                  compact_counts=z((1,), jnp.int32),
                  occ_stats={"tiles_total": 1, "tiles_nonzero": 0})


def test_cache_tracks_bytes_by_replica_and_drop():
    """Per-replica bytes, drops and evictions equal the reference's."""
    c, j = TileCache(capacity=3), JCache(capacity=3)
    assert _entry().nbytes() == _jentry().nbytes()
    keys = [("sub", "fp00", 0), ("sub", "fp01", 0), ("sub", "fp10", 1),
            ("sub", "fp10", 1), "plainkey", ("sub", "fp20", 2)]
    for k in keys:
        c.put(k, _entry())
        j.put(k, _jentry())
        assert c.bytes_by_replica() == j.bytes_by_replica()
        assert (c.resident_bytes, c.evictions) == (j.resident_bytes,
                                                   j.evictions)
    assert c.drop_replica(1) == j.drop_replica(1)
    assert c.drop_replica(7) == j.drop_replica(7) == (0, 0)
    assert c.bytes_by_replica() == j.bytes_by_replica()
    assert c.get(("sub", "fp10", 1)) is None


def test_stats_windows_share_one_bound():
    st = ServeStats()
    for dq in (st.batch_latencies_s, st.request_latencies_s,
               st.queue_wait_s):
        assert dq.maxlen == STATS_WINDOW == 4096
        for i in range(STATS_WINDOW + 500):
            dq.append(float(i))
        assert len(dq) == STATS_WINDOW and dq[0] == 500.0
    assert math.isfinite(st.p95_s)


# -------------------------------------------------------- engine integration

@pytest.fixture(scope="module")
def setup():
    jdata = jdatasets.load("ogbn-arxiv", scale=0.008, seed=0)
    tdata = datasets.load("ogbn-arxiv", scale=0.008, seed=0)
    jcfg = jgnn.GNNConfig.paper_gcn(jdata.features.shape[1], jdata.n_classes)
    tcfg = gnn.GNNConfig(**dataclasses.asdict(jcfg))
    jparams = jgnn.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    jreqs = jqueue.requests_from_partitions(
        jdata, jpartition.partition(jdata.csr, 16))
    treqs = requests_from_partitions(tdata, partition.partition(tdata.csr, 16))
    s = dict(jcfg=jcfg, tcfg=tcfg, jq=jgnn.quantize_params(jparams, jcfg),
             tq=gnn.quantize_params(tparams, tcfg), jreqs=jreqs, treqs=treqs,
             jbuckets=jqueue.buckets_for(jreqs, levels=2),
             tbuckets=buckets_for(treqs, levels=2))
    s["align"] = _server(s).align
    assert all(r.n_nodes <= s["align"] for r in treqs), \
        "fixture needs one-tile subgraphs for single-request plans"
    return s


def _server(s, **kw):
    """The port's server on one-request plans, jump none, no table."""
    kw.setdefault("node_budget", s.get("align", 128))
    return GNNServer(s["tq"], s["tcfg"], buckets=s["tbuckets"],
                     tuning_table=None, devices=["cpu"], **kw)


def _jserver(s, **kw):
    """The reference's, run op by op, with the same knobs."""
    kw.setdefault("node_budget", s["align"])
    srv = JServer(s["jq"], s["jcfg"], buckets=s["jbuckets"],
                  tuning_table=None, **kw)
    srv._fwd = srv._fwd.__wrapped__
    return srv


def _rounds(srv, cls, reqs, n):
    """n rounds of the traffic; logits by round, in submit order."""
    outs = []
    for _ in range(n):
        ids = [srv.submit(cls(edges=r.edges, features=r.features,
                              n_nodes=r.n_nodes)) for r in reqs]
        got = srv.drain(return_logits=True)
        missing = [i for i in ids if i not in got]
        assert not missing, f"lost requests {missing}"
        outs.append([np.asarray(got[i][1]) for i in ids])
    return outs


def _counters(stats):
    return {k: getattr(stats, k) for k in COUNTERS}


def test_routing_spreads_sticks_and_matches_reference(setup):
    srv, jsrv = _server(setup, replicas=3), _jserver(setup, replicas=3)
    for _ in range(2):
        sub = [SubgraphRequest(edges=r.edges, features=r.features,
                               n_nodes=r.n_nodes) for r in setup["treqs"]]
        jsub = [JRequest(edges=r.edges, features=r.features,
                         n_nodes=r.n_nodes) for r in setup["jreqs"]]
        for q, jq in zip(sub, jsub):
            srv.submit(q)
            jsrv.submit(jq)
        srv.drain()
        jsrv.drain()
        assert [q.replica for q in sub] == [q.replica for q in jsub]
    assert len({q.replica for q in sub}) > 1, "all traffic on one replica"
    assert _counters(srv.stats) == _counters(jsrv.stats)
    assert srv.cache.bytes_by_replica() == jsrv.cache.bytes_by_replica()


def test_failover_zero_loss_bit_identical(setup):
    """A replica killed in round 2: nothing lost, the no-fault logits bit
    for bit, and every counter as the reference's under the same kill."""
    treqs, jreqs = setup["treqs"], setup["jreqs"]
    clean = _rounds(_server(setup, replicas=3), SubgraphRequest, treqs, 3)
    spec = f"kill@{len(treqs) + 2}"
    inj, jinj = FaultInjector(spec), JInjector(spec)
    srv = _server(setup, replicas=3, chaos=inj)
    jsrv = _jserver(setup, replicas=3, chaos=jinj)
    fault = _rounds(srv, SubgraphRequest, treqs, 3)
    jfault = _rounds(jsrv, JRequest, jreqs, 3)
    for rd, (a, b, c) in enumerate(zip(clean, fault, jfault)):
        assert len(a) == len(b) == len(c)
        for i, (la, lb, lc) in enumerate(zip(a, b, c)):
            np.testing.assert_array_equal(
                la, lb, err_msg=f"round {rd} request {i} diverged from the "
                                f"no-fault run")
            np.testing.assert_allclose(lb, lc, **TOL)
    st = srv.stats
    assert inj.fired == jinj.fired and inj.fired[0]["kind"] == "kill"
    assert st.replica_faults == 1 and st.requests_retried >= 1
    assert st.replicas_live == 2
    assert st.cache_rehomed_entries > 0 and st.cache_rehomed_bytes > 0
    assert st.retry_backoff_s > 0
    assert _counters(st) == _counters(jsrv.stats)
    assert srv.mesh_plan() == (2, 1)


def test_failover_last_replica_raises(setup):
    srv = _server(setup, replicas=1, chaos=FaultInjector("kill@0"))
    srv.submit(SubgraphRequest(edges=setup["treqs"][0].edges,
                               features=setup["treqs"][0].features,
                               n_nodes=setup["treqs"][0].n_nodes))
    with pytest.raises(RuntimeError, match="no survivors"):
        srv.drain()


def test_max_retries_bounds_refires(setup):
    chaos_ = FaultInjector(FaultSpec(kind="kill", at_batch=0, repeat=10))
    srv = _server(setup, replicas=5, chaos=chaos_, max_retries=2)
    r = setup["treqs"][0]
    srv.submit(SubgraphRequest(edges=r.edges, features=r.features,
                               n_nodes=r.n_nodes))
    with pytest.raises(RuntimeError, match="max_retries=2"):
        srv.drain()
    assert srv.stats.requests_retried == 2


def test_straggler_eviction(setup):
    """Replica 0 stalls on every batch after round 1: two consecutive
    flags evict it.

    Host load moves a batch's wall by 2x and more (under the full suite's
    six workers about one healthy batch in five exceeded 2 x its replica's
    p50), so the test leaves the watchdog nothing to misread. Round 1
    serves six requests, two a replica; a replica's first wall is never
    flagged, so none can collect two strikes there. Round 2 serves only
    replica 0's requests, one at a time, stalled through serve/chaos.py,
    until the watchdog evicts it. The stall is sized from round 1's walls
    so that load cannot hide it: at 2 x tolerance x the slowest, a stalled
    wall clears tolerance x the p50 of round 1's two walls, and of those
    two and one stalled wall."""
    tolerance = 2.0
    srv = _server(setup, replicas=3, straggler_tolerance=tolerance,
                  straggler_strikes=2)
    first = [SubgraphRequest(edges=r.edges, features=r.features,
                             n_nodes=r.n_nodes) for r in setup["treqs"][:6]]
    ids = [srv.submit(r) for r in first]
    assert set(ids) <= set(srv.drain())
    served = {rep: len(wd.times) for rep, wd in srv._watchdogs.items()}
    assert served == {0: 2, 1: 2, 2: 2}, served
    stall = max(0.5, 2 * tolerance * max(srv._watchdogs[0].times))
    srv._chaos = FaultInjector(FaultSpec(kind="stall",
                                         at_batch=srv.stats.batches,
                                         replica=0, stall_s=stall,
                                         repeat=16))
    for r in (r for r in first if r.replica == 0):
        rid = srv.submit(SubgraphRequest(edges=r.edges, features=r.features,
                                         n_nodes=r.n_nodes))
        assert rid in srv.drain()
        if 0 not in srv._router.replicas:
            break
    assert srv._chaos.fired and all(f["replica"] == 0
                                    for f in srv._chaos.fired)
    assert srv.stats.replicas_evicted >= 1
    assert srv.stats.replicas_live == 2
    assert 0 not in srv._router.replicas


def test_add_replica_rejoins(setup):
    srv = _server(setup, replicas=3)
    _rounds(srv, SubgraphRequest, setup["treqs"], 1)
    srv.mark_failed(1)
    assert srv.stats.replicas_live == 2
    assert srv.add_replica(1) == 1
    assert srv.stats.replicas_live == 3
    assert srv.add_replica() == 3
    _rounds(srv, SubgraphRequest, setup["treqs"], 1)


def test_shed_carries_retry_after_hint(setup):
    reqs = setup["treqs"]
    srv = _server(setup, replicas=3,
                  admission=AdmissionPolicy(max_depth=2, on_full="reject"))

    def fresh(r):
        return SubgraphRequest(edges=r.edges, features=r.features,
                               n_nodes=r.n_nodes)

    assert srv.submit(fresh(reqs[0])) is not None
    assert srv.submit(fresh(reqs[1])) is not None
    assert srv.submit(fresh(reqs[2])) is None
    st = srv.stats
    assert st.requests_shed == 1
    assert math.isfinite(st.retry_after_s) and st.retry_after_s > 0
    with pytest.raises(AdmissionError, match="max_depth=2") as e:
        srv.batcher.add(fresh(reqs[2]))
    assert math.isfinite(e.value.retry_after_s) and e.value.retry_after_s > 0
    assert "retry after" in str(e.value) and "retry" not in e.value.reason


def test_shed_and_block_under_faults_match_reference(setup):
    """A bounded queue over three rounds sheds the reference's requests
    with one stable reason; backpressured submits through a replica's
    death serve everything, as the reference's do."""
    from repro.serve import AdmissionPolicy as JPolicy

    treqs, jreqs = setup["treqs"], setup["jreqs"]
    srv = _server(setup, replicas=3,
                  admission=AdmissionPolicy(max_depth=2, on_full="reject"))
    jsrv = _jserver(setup, replicas=3,
                    admission=JPolicy(max_depth=2, on_full="reject"))
    for _ in range(3):
        for tr, jr in zip(treqs, jreqs):
            srv.submit(SubgraphRequest(edges=tr.edges, features=tr.features,
                                       n_nodes=tr.n_nodes))
            jsrv.submit(JRequest(edges=jr.edges, features=jr.features,
                                 n_nodes=jr.n_nodes))
        srv.drain()
        jsrv.drain()
    assert set(srv.stats.shed_reasons) == {"queue depth at max_depth=2"}
    assert _counters(srv.stats) == _counters(jsrv.stats)

    srv = _server(setup, replicas=3, chaos=FaultInjector("kill@1"),
                  admission=AdmissionPolicy(max_depth=2, on_full="block"))
    jsrv = _jserver(setup, replicas=3, chaos=JInjector("kill@1"),
                    admission=JPolicy(max_depth=2, on_full="block"))
    ids = [srv.submit(SubgraphRequest(edges=r.edges, features=r.features,
                                      n_nodes=r.n_nodes)) for r in treqs]
    for r in jreqs:
        jsrv.submit(JRequest(edges=r.edges, features=r.features,
                             n_nodes=r.n_nodes))
    got = srv.drain()
    jsrv.drain()
    assert set(ids) <= set(got) and len(got) == len(treqs)
    assert srv.stats.replica_faults == 1 and srv.stats.requests_shed == 0
    assert srv.stats.submit_blocked > 0
    assert _counters(srv.stats) == _counters(jsrv.stats)
