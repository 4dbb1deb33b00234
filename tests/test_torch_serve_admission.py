"""Port parity for admission control, backpressure and per-subgraph tile
composition: ``repro_torch.serve`` against the reference's on the cases of
tests/test_serve_admission.py (ogbn-arxiv at scale 0.008, seed 0, 8
parts).

Admission reasons, errors, plans and every ServeStats counter must equal
the reference's; composed artifacts equal the whole batch's built from
scratch and the reference's, word for word; logits agree within rtol =
atol = 1e-5 with the reference server run op by op (see
tests/test_torch_serve.py), and bit for bit with the port's own scratch
build. The port runs on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.graph import datasets as jdatasets  # noqa: E402
from repro.graph import packing as jpacking  # noqa: E402
from repro.graph import partition as jpartition  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.serve import AdmissionError as JAdmissionError  # noqa: E402
from repro.serve import AdmissionPolicy as JPolicy  # noqa: E402
from repro.serve import GNNServer as JServer  # noqa: E402
from repro.serve import MicroBatcher as JBatcher  # noqa: E402
from repro.serve import SubgraphRequest as JRequest  # noqa: E402
from repro.serve import compose_entries as jcompose  # noqa: E402
from repro.serve import queue as jqueue  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.graph import datasets, packing, partition  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.serve import (AdmissionError, AdmissionPolicy,  # noqa: E402
                               GNNServer, MicroBatcher, SubgraphRequest,
                               compose_entries, make_buckets,
                               requests_from_partitions)
from repro_torch.serve.queue import buckets_for  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
COUNTERS = ("batches", "requests", "nodes", "transfer_bytes", "tiles_total",
            "tiles_nonzero", "cache_hits", "cache_misses",
            "cache_partial_hits", "cache_resident_bytes",
            "requests_admitted", "requests_shed", "submit_blocked",
            "shed_reasons", "replicas_live", "replica_faults",
            "replicas_evicted", "requests_retried", "retry_backoff_s",
            "cache_rehomed_entries", "cache_rehomed_bytes")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch thread
    each keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    jdata = jdatasets.load("ogbn-arxiv", scale=0.008, seed=0)
    tdata = datasets.load("ogbn-arxiv", scale=0.008, seed=0)
    jcfg = jgnn.GNNConfig.paper_gcn(jdata.features.shape[1], jdata.n_classes)
    tcfg = gnn.GNNConfig(**dataclasses.asdict(jcfg))
    jparams = jgnn.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    jreqs = jqueue.requests_from_partitions(
        jdata, jpartition.partition(jdata.csr, 8))
    treqs = requests_from_partitions(tdata, partition.partition(tdata.csr, 8))
    return dict(jcfg=jcfg, tcfg=tcfg, jq=jgnn.quantize_params(jparams, jcfg),
                tq=gnn.quantize_params(tparams, tcfg), jreqs=jreqs,
                treqs=treqs, jbuckets=jqueue.buckets_for(jreqs, levels=2),
                tbuckets=buckets_for(treqs, levels=2))


def _servers(s, jpol=None, tpol=None, **kw):
    """(reference server run op by op, port server) on the same buckets,
    with the jump mode pinned to none and no tuning table. ``jpol`` /
    ``tpol`` are each package's AdmissionPolicy."""
    jsrv = JServer(s["jq"], s["jcfg"], buckets=s["jbuckets"], admission=jpol,
                   policy=japi.ExecutionPolicy(), tuning_table=None, **kw)
    jsrv._fwd = jsrv._fwd.__wrapped__
    tsrv = GNNServer(s["tq"], s["tcfg"], buckets=s["tbuckets"], admission=tpol,
                     policy=api.ExecutionPolicy(), tuning_table=None,
                     devices=["cpu"], **kw)
    return jsrv, tsrv


def _fresh(cls, r, **kw):
    return cls(edges=r.edges, features=r.features, n_nodes=r.n_nodes, **kw)


def _counters(stats):
    return {k: getattr(stats, k) for k in COUNTERS}


# ----------------------------------------------------------- policy object

def test_admission_policy_validation():
    for kw, match in ((dict(on_full="drop"), "on_full"),
                      (dict(max_depth=0), "max_depth must be positive"),
                      (dict(max_depth=4, per_client_share=1.5),
                       "per_client_share"),
                      (dict(per_client_share=0.5), "needs max_depth")):
        with pytest.raises(ValueError, match=match) as got:
            AdmissionPolicy(**kw)
        with pytest.raises(ValueError) as want:
            JPolicy(**kw)
        assert str(got.value) == str(want.value)
    for depth, share in ((10, 0.25), (8, 0.25), (3, 1.0), (7, 0.01)):
        assert AdmissionPolicy(max_depth=depth,
                               per_client_share=share).client_cap == \
            JPolicy(max_depth=depth, per_client_share=share).client_cap
    assert AdmissionPolicy(max_depth=10).client_cap is None


def test_batcher_bounds_depth_nodes_edges(setup):
    """The same bounds refuse the same requests with the same reasons."""
    treqs, jreqs = setup["treqs"], setup["jreqs"]
    for kw in (dict(max_depth=2), dict(max_nodes=treqs[0].n_nodes + 1),
               dict(max_edges=treqs[0].n_edges),
               dict(max_depth=8, per_client_share=0.25)):
        mb = MicroBatcher(setup["tbuckets"], admission=AdmissionPolicy(**kw))
        jmb = JBatcher(setup["jbuckets"], admission=JPolicy(**kw))
        for i, (tr, jr) in enumerate(zip(treqs, jreqs)):
            client = "flood" if i % 3 else None
            t = _fresh(SubgraphRequest, tr, client_id=client)
            j = _fresh(JRequest, jr, client_id=client)
            reason = mb.admit_reason(t)
            assert reason == jmb.admit_reason(j), kw
            if reason is None:
                mb.add(t)
                jmb.add(j)
            else:
                with pytest.raises(AdmissionError) as err:
                    mb.add(t)
                assert err.value.reason == reason
                assert err.value.retry_after_s is None
                with pytest.raises(JAdmissionError):
                    jmb.add(j)
        assert (len(mb), mb.queued_nodes, mb.queued_edges) == \
            (len(jmb), jmb.queued_nodes, jmb.queued_edges)
        # draining frees the slots and the node/edge accounting
        while mb.next_plan() is not None:
            pass
        assert mb.queued_nodes == 0 and mb.queued_edges == 0
        assert mb.admit_reason(_fresh(SubgraphRequest, treqs[0])) is None


def test_oversized_request_still_config_error(setup):
    """Budget violations are misconfiguration (ValueError), not shed load."""
    mb = MicroBatcher(make_buckets(node_budget=128, edge_budget=64),
                      admission=AdmissionPolicy(max_depth=100))
    with pytest.raises(ValueError, match="exceeds the batch budget") as err:
        mb.add(_fresh(SubgraphRequest, setup["treqs"][0]))
    assert not isinstance(err.value, AdmissionError)


# -------------------------------------------------------- engine admission

def test_reject_mode_sheds_as_the_reference(setup):
    jsrv, tsrv = _servers(setup, JPolicy(max_depth=3),
                          AdmissionPolicy(max_depth=3))
    for _ in range(2):
        tids = [tsrv.submit(_fresh(SubgraphRequest, r)) for r in setup["treqs"]]
        jids = [jsrv.submit(_fresh(JRequest, r)) for r in setup["jreqs"]]
        assert [i is None for i in tids] == [i is None for i in jids]
        tout = tsrv.drain(return_logits=True)
        jout = jsrv.drain(return_logits=True)
        for ti, ji in zip(tids, jids):
            if ti is not None:
                np.testing.assert_allclose(tout[ti][1], np.asarray(jout[ji][1]),
                                           **TOL)
    st = tsrv.stats
    assert _counters(st) == _counters(jsrv.stats)
    assert st.requests_shed == 2 * (len(setup["treqs"]) - 3)
    assert st.shed_reasons == {"queue depth at max_depth=3": st.requests_shed}
    assert st.requests_admitted + st.requests_shed == 2 * len(setup["treqs"])
    assert st.summary()["queue_n"] == st.requests


def test_block_mode_backpressure_serves_everything(setup):
    jsrv, tsrv = _servers(setup, JPolicy(max_depth=2, on_full="block"),
                          AdmissionPolicy(max_depth=2, on_full="block"))
    tids = [tsrv.submit(_fresh(SubgraphRequest, r)) for r in setup["treqs"]]
    jids = [jsrv.submit(_fresh(JRequest, r)) for r in setup["jreqs"]]
    assert all(i is not None for i in tids)
    tout = tsrv.drain(return_logits=True)
    jout = jsrv.drain(return_logits=True)
    assert set(tout) == set(tids)  # blocked-submit results are not lost
    for ti, ji in zip(tids, jids):
        np.testing.assert_allclose(tout[ti][1], np.asarray(jout[ji][1]), **TOL)
    assert _counters(tsrv.stats) == _counters(jsrv.stats)
    assert tsrv.stats.submit_blocked > 0 and tsrv.stats.requests_shed == 0


def test_block_mode_impossible_request_raises(setup):
    srv = _servers(setup, tpol=AdmissionPolicy(max_nodes=1, on_full="block"))[1]
    with pytest.raises(ValueError, match="can never be admitted"):
        srv.submit(_fresh(SubgraphRequest, setup["treqs"][0]))


# --------------------------------------- per-subgraph cache composition

def test_shuffled_coalescing_order_hits_and_is_bit_identical(setup):
    """A repeat subgraph hits in any coalescing order; the composed batches
    give the logits of a cache-less scratch build bit for bit, and the
    reference's within 1e-5."""
    treqs, jreqs = setup["treqs"], setup["jreqs"]
    jwarm, warm = _servers(setup)
    for tr, jr in zip(treqs, jreqs):  # cold wave, original order
        warm.submit(_fresh(SubgraphRequest, tr))
        jwarm.submit(_fresh(JRequest, jr))
    warm.drain()
    jwarm.drain()
    hits0, misses0 = warm.cache.hits, warm.cache.misses
    assert warm.cache.full_misses > 0 and warm.cache.full_hits == 0
    rng = np.random.default_rng(3)
    for _ in range(2):
        order = rng.permutation(len(treqs))
        ref = GNNServer(setup["tq"], setup["tcfg"], buckets=setup["tbuckets"],
                        cache_entries=0, policy=api.ExecutionPolicy(),
                        tuning_table=None, devices=["cpu"])
        ids = [(warm.submit(_fresh(SubgraphRequest, treqs[i])),
                ref.submit(_fresh(SubgraphRequest, treqs[i])),
                jwarm.submit(_fresh(JRequest, jreqs[i]))) for i in order]
        got_w = warm.drain(return_logits=True)
        got_r = ref.drain(return_logits=True)
        got_j = jwarm.drain(return_logits=True)
        for wid, rid, jid in ids:
            np.testing.assert_array_equal(got_w[wid][1], got_r[rid][1])
            np.testing.assert_array_equal(got_w[wid][0], got_r[rid][0])
            np.testing.assert_allclose(got_w[wid][1],
                                       np.asarray(got_j[jid][1]), **TOL)
    assert warm.cache.misses == misses0
    assert warm.cache.hits == hits0 + 2 * len(treqs)
    assert warm.cache.partial_hits == 0
    assert warm.cache.full_hits == warm.stats.cache_hits > 0
    assert _counters(warm.stats) == _counters(jwarm.stats)


def test_partial_composition_hit_accounting(setup):
    """Some members cached is a partial hit, never a full one, on both."""
    treqs, jreqs = setup["treqs"], setup["jreqs"]
    top = setup["tbuckets"][-1].n_pad
    jsrv, tsrv = _servers(setup, node_budget=top)
    steps = ((0,), (0, 1), (0, 1))
    for i, members in enumerate(steps):
        for m in members:
            tsrv.submit(_fresh(SubgraphRequest, treqs[m]))
            jsrv.submit(_fresh(JRequest, jreqs[m]))
        assert len(tsrv.drain()) == len(jsrv.drain()) == len(members)
        c, jc = tsrv.cache, jsrv.cache
        assert (c.full_misses, c.partial_hits, c.full_hits) == \
            (jc.full_misses, jc.partial_hits, jc.full_hits) == \
            ((1, 0, 0), (1, 1, 0), (1, 1, 1))[i]
    assert tsrv.stats.cache_partial_hits == 1 and tsrv.stats.cache_hits == 1
    assert tsrv.cache.full_hit_rate == pytest.approx(1 / 3)
    assert _counters(tsrv.stats) == _counters(jsrv.stats)


def test_compose_entries_matches_whole_batch_build(setup):
    """Composed artifacts are the whole block-diagonal batch's built from
    scratch, and the reference's composition, word for word."""
    treqs, jreqs = setup["treqs"], setup["jreqs"]
    jsrv, tsrv = _servers(setup)
    for tr, jr in zip(treqs[:4], jreqs[:4]):
        tsrv.submit(_fresh(SubgraphRequest, tr))
        jsrv.submit(_fresh(JRequest, jr))
    plan, jplan = tsrv.batcher.next_plan(), jsrv.batcher.next_plan()
    assert len(plan.requests) >= 2
    adj, _, _ = packing.transfer_packed(plan.batch, nbits=8, device="cpu")
    jadj, _, _ = jpacking.transfer_packed(jplan.batch, nbits=8)
    whole = tsrv._build_entry(adj)
    subs, jsubs, offs = [], [], []
    for _, off, n in plan.spans:
        n_pad = -(-n // tsrv._align) * tsrv._align
        subs.append(tsrv._build_entry(adj[off:off + n_pad, off:off + n_pad]))
        jsubs.append(jsrv._build_entry(
            jax.lax.dynamic_slice(jadj, (off, off), (n_pad, n_pad))))
        offs.append(off)
    comp = compose_entries(subs, offs, plan.batch.n_nodes, *tsrv._tile_shape)
    jcomp = jcompose(jsubs, offs, jplan.batch.n_nodes, *jsrv._tile_shape)
    for f in ("adj", "inv_deg", "a_packed", "occupancy", "compact_idx",
              "compact_counts", "sgt_idx", "sgt_counts"):
        assert torch.equal(getattr(comp, f), getattr(whole, f)), f
        np.testing.assert_array_equal(
            getattr(comp, f).numpy().view(np.asarray(getattr(jcomp, f)).dtype),
            np.asarray(getattr(jcomp, f)), err_msg=f)
    assert comp.s_max == whole.s_max == jcomp.s_max
    assert comp.occ_stats == whole.occ_stats == jcomp.occ_stats


def test_compose_entries_rejects_misaligned_offsets(setup):
    tsrv = _servers(setup)[1]
    e = tsrv._build_entry(torch.zeros((128, 128), dtype=torch.int32))
    with pytest.raises(ValueError, match="not tile-aligned"):
        compose_entries([e], [64], 256, *tsrv._tile_shape)
    with pytest.raises(ValueError, match="not tile-aligned"):
        compose_entries([e], [256], 256, *tsrv._tile_shape)
    with pytest.raises(ValueError, match="not a multiple of the tile grid"):
        compose_entries([e], [0], 130, *tsrv._tile_shape)
    with pytest.raises(ValueError, match="at least one entry"):
        compose_entries([], [], 256, *tsrv._tile_shape)


def test_mismatched_ambient_grid_drops_cached_tiles(setup):
    """Cached compact tiles live on the construction-time grid; an ambient
    policy on another grid gets none."""
    srv = GNNServer(setup["tq"], setup["tcfg"], backend="cuda",
                    devices=["cpu"], tuning_table=None)
    entry = srv._build_entry(torch.eye(128, dtype=torch.int32))
    with api.use("cuda", policy=api.ExecutionPolicy(jump="compact",
                                                    block_m=16)):
        assert srv._jump_tiles(entry) == (None, None, 0, None)
    with api.use("cuda", policy=api.ExecutionPolicy(jump="compact")):
        assert srv._jump_tiles(entry)[0] is not None


def test_misaligned_buckets_fail_at_construction(setup):
    with pytest.raises(ValueError, match="tile") as got:
        GNNServer(setup["tq"], setup["tcfg"],
                  policy=api.ExecutionPolicy(block_w=8),
                  buckets=setup["tbuckets"], devices=["cpu"])
    with pytest.raises(ValueError) as want:
        JServer(setup["jq"], setup["jcfg"],
                policy=japi.ExecutionPolicy(block_w=8),
                buckets=setup["jbuckets"])
    assert str(got.value) == str(want.value)


def test_routing_fingerprint_is_order_insensitive(setup):
    """The routing key of a plan is its member set's, as the reference's."""
    treqs, jreqs = setup["treqs"], setup["jreqs"]
    fps = []
    for order in ((0, 1, 2), (2, 0, 1)):
        mb = MicroBatcher(setup["tbuckets"], align=128)
        jmb = JBatcher(setup["jbuckets"], align=128)
        for i in order:
            mb.add(_fresh(SubgraphRequest, treqs[i]))
            jmb.add(_fresh(JRequest, jreqs[i]))
        p, jp = mb.next_plan(), jmb.next_plan()
        assert p.fingerprint == jp.fingerprint
        assert [r.fingerprint for r in p.requests] == \
            [r.fingerprint for r in jp.requests]
        fps.append(p.fingerprint)
    assert fps[0] == fps[1]
