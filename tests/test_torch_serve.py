"""Port parity for continuous-batching GNN serving: ``repro_torch.serve``
against the reference's ``repro.serve`` on the same traffic, the cases of
tests/test_serve.py at its size (ogbn-arxiv at scale 0.008, seed 0, 8
parts).

Each package builds its own requests from its own copy of the graph; the
port's weights are the reference's (``convert.params_from_jax``, then the
port's ``quantize_params``). Requests are matched by submit order: each
package numbers its own. Exact: fingerprints, buckets, plans, every
``TileEntry`` field word for word (the port's int32 bit patterns viewed as
the reference's uint32), the ``ServeStats`` counters. Logits agree within
rtol = atol = 1e-5, the tolerance the reference holds its own engines to;
within the port, cached, composed, jumped and scratch logits are
bit-identical. Both servers pin their policy and take no tuning table.
The port runs on the CPU (``devices=["cpu"]``), its kernel engine on the
kernels' plain versions.

The reference server's forward runs op by op (its jitted ``_fwd``
unwrapped): XLA fuses the jitted float epilogues and rounds them
otherwise, which moves a quantization level now and then (0.0073 apart
on this traffic), where the op-by-op reference and the port agree.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.graph import batching as jbatching  # noqa: E402
from repro.graph import datasets as jdatasets  # noqa: E402
from repro.graph import partition as jpartition  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.serve import GNNServer as JServer  # noqa: E402
from repro.serve import MicroBatcher as JBatcher  # noqa: E402
from repro.serve import SubgraphRequest as JRequest  # noqa: E402
from repro.serve import cache as jcache  # noqa: E402
from repro.serve import queue as jqueue  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import zerotile  # noqa: E402
from repro_torch.graph import batching, datasets, packing, partition  # noqa: E402
from repro_torch.kernels import sgt  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.serve import (GNNServer, MicroBatcher, ServeStats,  # noqa: E402
                               SubgraphRequest, TileCache, compose_entries,
                               make_buckets, requests_from_partitions)
from repro_torch.serve import queue  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
# the ServeStats fields that count (latencies and the hints read from
# them are timings, which two runs never share)
COUNTERS = ("batches", "requests", "nodes", "transfer_bytes", "tiles_total",
            "tiles_nonzero", "cache_hits", "cache_misses",
            "cache_partial_hits", "cache_resident_bytes",
            "requests_admitted", "requests_shed", "submit_blocked",
            "shed_reasons", "replicas_live", "replica_faults",
            "replicas_evicted", "requests_retried", "retry_backoff_s",
            "cache_rehomed_entries", "cache_rehomed_bytes")
ENTRY_TENSORS = ("adj", "inv_deg", "a_packed", "occupancy", "compact_idx",
                 "compact_counts", "sgt_idx", "sgt_counts")


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
    """Both packages' graph, parts, config, quantized weights, requests."""
    jdata = jdatasets.load("ogbn-arxiv", scale=0.008, seed=0)
    tdata = datasets.load("ogbn-arxiv", scale=0.008, seed=0)
    jparts = jpartition.partition(jdata.csr, 8)
    tparts = partition.partition(tdata.csr, 8)
    jcfg = jgnn.GNNConfig.paper_gcn(jdata.features.shape[1], jdata.n_classes)
    tcfg = gnn.GNNConfig(**dataclasses.asdict(jcfg))
    jparams = jgnn.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return dict(jdata=jdata, tdata=tdata, jparts=jparts, tparts=tparts,
                jcfg=jcfg, tcfg=tcfg,
                jq=jgnn.quantize_params(jparams, jcfg),
                tq=gnn.quantize_params(tparams, tcfg),
                jreqs=jqueue.requests_from_partitions(jdata, jparts),
                treqs=requests_from_partitions(tdata, tparts))


def op_by_op(jsrv):
    """The reference server with its forward run op by op, not jitted."""
    jsrv._fwd = jsrv._fwd.__wrapped__
    return jsrv


def _servers(s, jpol=None, **kw):
    """(reference server, port server) with the same knobs; ``jpol`` is a
    policy's fields, pinned on both (its jump mode by default none)."""
    fields = jpol or {}
    jsrv = op_by_op(JServer(s["jq"], s["jcfg"], tuning_table=None,
                            policy=japi.ExecutionPolicy(**fields), **kw))
    tsrv = GNNServer(s["tq"], s["tcfg"], policy=api.ExecutionPolicy(**fields),
                     tuning_table=None, devices=["cpu"], **kw)
    return jsrv, tsrv


def _fresh(cls, r, shift=0.0):
    return cls(edges=r.edges, features=r.features + shift, n_nodes=r.n_nodes)


def _wave(srv, cls, reqs, shift=0.0):
    """Submit every request, drain; logits in submit order."""
    ids = [srv.submit(_fresh(cls, r, shift)) for r in reqs]
    out = srv.drain(return_logits=True)
    return [np.asarray(out[i][1]) for i in ids]


def _counters(stats):
    return {k: getattr(stats, k) for k in COUNTERS}


def _cache_counters(cache):
    return (cache.hits, cache.misses, cache.full_hits, cache.partial_hits,
            cache.full_misses, cache.evictions, cache.resident_bytes)


def _words(x):
    """An artifact as the reference holds it (packed words as uint32)."""
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def assert_entries_equal(got, want):
    """Every TileEntry field of the port's entry equals the reference's."""
    for f in ENTRY_TENSORS:
        g, w = getattr(got, f), getattr(want, f)
        if w is None:
            assert g is None, f
            continue
        assert g.element_size() == w.dtype.itemsize, f
        np.testing.assert_array_equal(_words(g), _words(w), err_msg=f)
    assert got.occ_stats == want.occ_stats
    assert (got.s_max, got.sgt_w) == (want.s_max, want.sgt_w)
    assert got.nbytes() == want.nbytes()


# ------------------------------------------------------------ micro-batcher

def test_fingerprints_and_bucket_ladders_match_reference(setup):
    jreqs, treqs = setup["jreqs"], setup["treqs"]
    assert len(jreqs) == len(treqs) == 8
    for jr, tr in zip(jreqs, treqs):
        assert tr.fingerprint == jr.fingerprint
        assert (tr.n_nodes, tr.n_edges) == (jr.n_nodes, jr.n_edges)
        np.testing.assert_array_equal(tr.edges, jr.edges)
        np.testing.assert_array_equal(tr.features, jr.features)
    assert queue.subgraph_fingerprint(5, np.zeros((2, 0), np.int32)) == \
        jqueue.subgraph_fingerprint(5, np.zeros((2, 0), np.int32))
    for args in ((128, 64, 128, 3), (1000, 5000, 128, 3), (4096, 9, 256, 5),
                 (256, 1, 128, 1)):
        assert make_buckets(*args) == tuple(
            queue.Bucket(b.n_pad, b.e_cap) for b in jqueue.make_buckets(*args))
    for levels in (1, 2, 3):
        got = queue.buckets_for(treqs, levels=levels)
        want = jqueue.buckets_for(jreqs, levels=levels)
        assert [(b.n_pad, b.e_cap) for b in got] == \
            [(b.n_pad, b.e_cap) for b in want]
        for n, e in ((1, 1), (got[0].n_pad, got[0].e_cap),
                     (got[-1].n_pad, got[-1].e_cap)):
            assert queue.pick_bucket(got, n, e).n_pad == \
                jqueue.pick_bucket(want, n, e).n_pad
        with pytest.raises(ValueError, match="no bucket fits"):
            queue.pick_bucket(got, got[-1].n_pad + 1, 1)


@pytest.mark.parametrize("align", [None, 128])
def test_plans_match_reference(setup, align):
    """Both batchers coalesce the same traffic into the same plans: spans,
    buckets, block-diagonal edges and features, word for word; and the
    invariants of tests/test_serve.py's coalescing case hold."""
    jreqs, treqs = setup["jreqs"], setup["treqs"]
    budget_n = 2 * max(r.n_nodes for r in treqs)
    buckets = make_buckets(node_budget=budget_n,
                           edge_budget=4 * max(r.n_edges for r in treqs),
                           levels=2)
    jbuckets = jqueue.make_buckets(node_budget=budget_n,
                                   edge_budget=4 * max(r.n_edges for r in jreqs),
                                   levels=2)
    mb, jmb = MicroBatcher(buckets, align=align), JBatcher(jbuckets, align=align)
    for jr, tr in zip(jreqs, treqs):
        jmb.add(jr)
        mb.add(tr)
    plans, jplans = [], []
    while (p := mb.next_plan()) is not None:
        plans.append(p)
    while (p := jmb.next_plan()) is not None:
        jplans.append(p)
    assert len(plans) == len(jplans) > 1
    order = {tr.req_id: i for i, tr in enumerate(treqs)}
    jorder = {jr.req_id: i for i, jr in enumerate(jreqs)}
    for p, jp in zip(plans, jplans):
        assert [(order[rid], off, n) for rid, off, n in p.spans] == \
            [(jorder[rid], off, n) for rid, off, n in jp.spans]
        assert (p.bucket.n_pad, p.bucket.e_cap) == (jp.bucket.n_pad,
                                                    jp.bucket.e_cap)
        assert p.fingerprint == jp.fingerprint
        for f in ("edges", "features", "labels", "train_mask", "node_ids"):
            np.testing.assert_array_equal(getattr(p.batch, f),
                                          getattr(jp.batch, f), err_msg=f)
        for f in ("n_nodes", "n_valid", "n_edges"):
            assert getattr(p.batch, f) == getattr(jp.batch, f), f
        # block-diagonal: every edge stays inside its request's span
        e = p.batch.edges
        valid = e[0] >= 0
        assert int(valid.sum()) == p.batch.n_edges
        for (rid, lo, n), r in zip(p.spans, p.requests):
            in_span = valid & (e[0] >= lo) & (e[0] < lo + n)
            np.testing.assert_array_equal(e[:, in_span], r.edges + lo)
            np.testing.assert_array_equal(p.batch.features[lo:lo + n],
                                          r.features)
    # every request served exactly once, FIFO order preserved
    assert [rid for p in plans for rid, _, _ in p.spans] == \
        [r.req_id for r in treqs]


def test_oversized_request_rejected(setup):
    mb = MicroBatcher(make_buckets(node_budget=128, edge_budget=64))
    with pytest.raises(ValueError, match="exceeds the batch budget"):
        mb.add(_fresh(SubgraphRequest, setup["treqs"][0]))


# ------------------------------------------------------- served traffic

@pytest.mark.parametrize("jump", ["none", "compact", "sgt"])
def test_traffic_matches_reference(setup, jump):
    """Two waves (the second with fresh feature values) through both
    servers: logits within 1e-5 request by request, every counter equal,
    and the repeat wave adds no forward signature."""
    buckets = queue.buckets_for(setup["treqs"], levels=3)
    jbuckets = jqueue.buckets_for(setup["jreqs"], levels=3)
    jsrv = op_by_op(JServer(setup["jq"], setup["jcfg"], buckets=jbuckets,
                            policy=japi.ExecutionPolicy(jump=jump),
                            tuning_table=None))
    tsrv = GNNServer(setup["tq"], setup["tcfg"], buckets=buckets,
                     policy=api.ExecutionPolicy(jump=jump), tuning_table=None,
                     devices=["cpu"])
    for wave, shift in enumerate((0.0, 0.25)):
        want = _wave(jsrv, JRequest, setup["jreqs"], shift)
        got = _wave(tsrv, SubgraphRequest, setup["treqs"], shift)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)
        assert _counters(tsrv.stats) == _counters(jsrv.stats)
        assert _cache_counters(tsrv.cache) == _cache_counters(jsrv.cache)
        if wave == 0:
            signatures = tsrv.n_compiles
            assert 0 < signatures <= len(buckets) * (1 if jump == "none" else 4)
    assert tsrv.n_compiles == signatures  # the repeat wave adds none
    assert tsrv.cache.hits > 0
    assert tsrv.stats.summary().keys() == jsrv.stats.summary().keys()


def test_tile_cache_hit_bit_identical(setup):
    """A repeat batch hits the cache, ships the features-only buffer and
    gives the cold logits bit for bit, as a cache-less server does; both
    match the reference's, and so do the bytes moved."""
    jb = jbatching.make_batches(setup["jdata"], setup["jparts"], 2,
                                shuffle=False)[0]
    tb = batching.make_batches(setup["tdata"], setup["tparts"], 2,
                               shuffle=False)[0]
    jsrv, tsrv = _servers(setup)
    _, jlg = jsrv.infer_batch(jb, return_logits=True)
    preds1, lg1 = tsrv.infer_batch(tb, return_logits=True)  # cold: miss
    preds2, lg2 = tsrv.infer_batch(tb, return_logits=True)  # repeat: hit
    jsrv.infer_batch(jb)
    assert tsrv.cache.misses == 1 and tsrv.cache.hits == 1
    np.testing.assert_array_equal(lg1, lg2)
    np.testing.assert_array_equal(preds1, preds2)
    np.testing.assert_array_equal(preds1, np.argmax(lg1[:tb.n_valid], -1))
    np.testing.assert_allclose(lg1, np.asarray(jlg), **TOL)
    fresh = GNNServer(setup["tq"], setup["tcfg"], cache_entries=0,
                      devices=["cpu"], tuning_table=None)
    _, lg3 = fresh.infer_batch(tb, return_logits=True)
    assert fresh.cache is None
    np.testing.assert_array_equal(lg1, lg3)
    nb = packing.compound_nbytes(tb, nbits=8)
    assert tsrv.stats.transfer_bytes == nb["III_packed"] + nb["III_feats"]
    assert _counters(tsrv.stats) == _counters(jsrv.stats)


def test_build_entry_matches_reference(setup):
    """The artifacts of a batch adjacency, word for word, and their bytes."""
    jb = jbatching.make_batches(setup["jdata"], setup["jparts"], 2,
                                shuffle=False)[0]
    tb = batching.make_batches(setup["tdata"], setup["tparts"], 2,
                               shuffle=False)[0]
    jsrv, tsrv = _servers(setup)
    want = jsrv._build_entry(jtrainer.make_device_batch(jb)["adj"])
    got = tsrv._build_entry(trainer.make_device_batch(tb, device="cpu")["adj"])
    assert_entries_equal(got, want)


def test_compose_entries_sgt_matches_scratch_and_reference(setup):
    """A coalesced batch's artifacts composed from per-subgraph entries are
    the whole batch's built from scratch, and the reference's composition,
    word for word; members without the SGT remap give a batch without it."""
    jsrv, tsrv = _servers(setup, jpol=dict(jump="sgt"))
    tm, tw = tsrv._tile_shape
    align = tsrv._align
    rng = np.random.default_rng(5)
    sizes = [align, 2 * align]
    adjs = [(rng.random((s, s)) < 0.08).astype(np.int32) for s in sizes]
    entries = [tsrv._build_entry(torch.as_tensor(a)) for a in adjs]
    jentries = [jsrv._build_entry(jnp.asarray(a)) for a in adjs]
    offsets = [0, align]
    n_pad = sum(sizes)
    composed = compose_entries(entries, offsets, n_pad, tm, tw)
    assert_entries_equal(composed, jcache.compose_entries(
        jentries, offsets, n_pad, tm, tw))
    full = np.zeros((n_pad, n_pad), np.int32)
    for a, off in zip(adjs, offsets):
        full[off:off + a.shape[0], off:off + a.shape[0]] = a
    scratch = tsrv._build_entry(torch.as_tensor(full))
    for f in ENTRY_TENSORS:
        assert torch.equal(getattr(composed, f), getattr(scratch, f)), f
    assert (composed.s_max, composed.sgt_w) == (scratch.s_max, scratch.sgt_w)
    legacy = dataclasses.replace(entries[0], sgt_idx=None, sgt_counts=None,
                                 sgt_w=0)
    degraded = compose_entries([legacy, entries[1]], offsets, n_pad, tm, tw)
    assert degraded.sgt_idx is None and degraded.sgt_counts is None


# ------------------------------------------------- zero-tile jumping serving

def test_serve_compact_tiles_consumed_and_bit_identical(setup, monkeypatch):
    """Under jump="compact" on the kernel engine the forward consumes the
    cached compact tiles: logits bit-identical to the dense forward, no
    in-call occupancy analysis, and an engine without the jump capability
    gets no tiles."""
    tb = batching.make_batches(setup["tdata"], setup["tparts"], 2,
                               shuffle=False)[0]
    dense = GNNServer(setup["tq"], setup["tcfg"], backend="cuda",
                      devices=["cpu"], tuning_table=None)
    _, lg_dense = dense.infer_batch(tb, return_logits=True)
    calls = {"n": 0}
    orig = zerotile.tile_occupancy_planes

    def counting(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(zerotile, "tile_occupancy_planes", counting)
    pol = api.ExecutionPolicy(jump="compact")
    srv = GNNServer(setup["tq"], setup["tcfg"], backend="cuda", policy=pol,
                    devices=["cpu"], tuning_table=None)
    _, lg1 = srv.infer_batch(tb, return_logits=True)
    _, lg2 = srv.infer_batch(tb, return_logits=True)
    assert srv.cache.misses == 1 and srv.cache.hits == 1
    assert calls["n"] == 0
    np.testing.assert_array_equal(lg1, lg2)
    np.testing.assert_array_equal(lg1, lg_dense)
    entry = next(iter(srv.cache._entries.values()))
    t_idx, t_cnt, s_max, t_kind = srv._jump_tiles(entry)
    assert t_idx is not None and 0 < s_max <= entry.compact_idx.shape[1]
    assert entry.s_max <= s_max and t_kind == "compact"
    assert s_max & (s_max - 1) == 0 or s_max == entry.compact_idx.shape[1]
    plain = GNNServer(setup["tq"], setup["tcfg"], backend="torch_dot",
                      policy=pol, devices=["cpu"], tuning_table=None)
    assert plain._jump_tiles(entry) == (None, None, 0, None)


def test_serve_sgt_tiles_consumed_and_bit_identical(setup, monkeypatch):
    """Under jump="sgt" the word-column remap is built once per subgraph
    and consumed: logits bit-identical to dense, the remap keyed on
    block_m alone, the resident bytes in the stats."""
    tb = batching.make_batches(setup["tdata"], setup["tparts"], 2,
                               shuffle=False)[0]
    dense = GNNServer(setup["tq"], setup["tcfg"], devices=["cpu"],
                      tuning_table=None)
    _, lg_dense = dense.infer_batch(tb, return_logits=True)
    calls = {"n": 0}
    orig = sgt.word_occupancy

    def counting(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(sgt, "word_occupancy", counting)
    pol = api.ExecutionPolicy(jump="sgt")
    srv = GNNServer(setup["tq"], setup["tcfg"], policy=pol, devices=["cpu"],
                    tuning_table=None)
    _, lg1 = srv.infer_batch(tb, return_logits=True)
    _, lg2 = srv.infer_batch(tb, return_logits=True)
    assert srv.cache.misses == 1 and srv.cache.hits == 1
    assert calls["n"] == 1  # at entry build, never in the forward
    np.testing.assert_array_equal(lg1, lg2)
    np.testing.assert_array_equal(lg1, lg_dense)
    entry = next(iter(srv.cache._entries.values()))
    t_idx, t_cnt, s_max, t_kind = srv._jump_tiles(entry)
    assert t_kind == "sgt" and t_idx is not None
    assert 0 < s_max <= entry.sgt_idx.shape[1] and entry.sgt_w <= s_max
    assert srv._jump_tiles(entry, api.ExecutionPolicy(
        jump="sgt", block_w=8))[3] == "sgt"
    assert srv._jump_tiles(entry, api.ExecutionPolicy(
        jump="sgt", block_m=16)) == (None, None, 0, None)
    assert srv.stats.cache_resident_bytes == srv.cache.resident_bytes > 0
    plain = GNNServer(setup["tq"], setup["tcfg"], backend="popcount",
                      policy=pol, devices=["cpu"], tuning_table=None)
    assert plain._jump_tiles(entry) == (None, None, 0, None)


# ------------------------------------------------------- tile cache bounds

def test_tile_cache_bytes_lru_bound(setup):
    """cache_bytes is a strict resident-bytes LRU bound over entries whose
    bytes are the reference's."""
    jsrv, tsrv = _servers(setup)
    e_small = tsrv._build_entry(torch.eye(128, dtype=torch.int32))
    e_big = tsrv._build_entry(torch.eye(256, dtype=torch.int32))
    nb_s, nb_b = e_small.nbytes(), e_big.nbytes()
    assert nb_s == jsrv._build_entry(jnp.eye(128, dtype=jnp.int32)).nbytes()
    assert nb_b == jsrv._build_entry(jnp.eye(256, dtype=jnp.int32)).nbytes()
    c = TileCache(capacity=16, cache_bytes=3 * nb_s)
    for k in "abc":
        c.put(k, e_small)
    assert len(c) == 3 and c.resident_bytes == 3 * nb_s
    assert c.get("a") is e_small  # refresh "a": "b" is now LRU
    c.put("d", e_small)
    assert set(c._entries) == {"a", "c", "d"}
    assert c.resident_bytes == 3 * nb_s and c.evictions == 1
    c.put("a", e_small)
    assert c.resident_bytes == 3 * nb_s and c.evictions == 1
    assert nb_b > 3 * nb_s
    c.put("big", e_big)
    assert len(c) == 0 and c.resident_bytes == 0
    c.put("a", e_small)
    assert c.resident_bytes == nb_s
    c.clear()
    assert c.resident_bytes == 0 and len(c) == 0
    tiny = TileCache(capacity=16, cache_bytes=nb_s // 2)
    tiny.put("x", e_small)
    assert len(tiny) == 0 and tiny.resident_bytes == 0
    with pytest.raises(ValueError, match="cache_bytes"):
        TileCache(capacity=4, cache_bytes=0)


def test_server_cache_bytes_plumbs_through(setup):
    """cache_bytes bounds the live cache, and the port evicts as the
    reference does under the same bound."""
    jbs = jbatching.make_batches(setup["jdata"], setup["jparts"], 2,
                                 shuffle=False)[:3]
    tbs = batching.make_batches(setup["tdata"], setup["tparts"], 2,
                                shuffle=False)[:3]
    probe = GNNServer(setup["tq"], setup["tcfg"], devices=["cpu"],
                      tuning_table=None)
    n = tbs[0].n_nodes
    budget = int(probe._build_entry(
        torch.zeros((n, n), dtype=torch.int32)).nbytes() * 1.5)
    jsrv, tsrv = _servers(setup, cache_bytes=budget)
    for jb, tb in zip(jbs + jbs[:1], tbs + tbs[:1]):
        jsrv.infer_batch(jb)
        tsrv.infer_batch(tb)
    assert tsrv.cache.cache_bytes == budget
    assert tsrv.cache.resident_bytes <= budget
    assert tsrv.stats.cache_resident_bytes == tsrv.cache.resident_bytes
    assert _cache_counters(tsrv.cache) == _cache_counters(jsrv.cache)
    assert _counters(tsrv.stats) == _counters(jsrv.stats)


# -------------------------------------------------------------- serve stats

def test_stats_latency_percentiles_and_throughput(setup):
    tsrv = _servers(setup)[1]
    for b in batching.make_batches(setup["tdata"], setup["tparts"], 2,
                                   shuffle=False)[:2]:
        tsrv.infer_batch(b)
    st = tsrv.stats
    assert len(st.batch_latencies_s) == 2
    assert 0 < st.p50_s <= st.p95_s <= st.wall_s
    assert st.nodes_per_s > 0
    s = st.summary()
    assert s["batch_n"] == 2 and s["batch_p95_s"] >= s["batch_p50_s"] > 0
    assert ServeStats().summary().keys() == s.keys()


def test_devices_default_to_the_card(setup, monkeypatch):
    """No ``devices=`` means the card, and raises without one; the weights
    move once per device, QuantParams included; ``mesh_plan`` answers
    only for an explicit device list."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GNNServer(setup["tq"], setup["tcfg"], tuning_table=None)
    srv = GNNServer(setup["tq"], setup["tcfg"], devices=["cpu"], replicas=3,
                    tuning_table=None)
    assert srv.mesh_plan() == (2, 1)  # 3 live -> the largest power of two
    p = srv._params_for(torch.device("cpu"))
    assert srv._params_for(torch.device("cpu")) is p
    w, qpw = p["layer0"]["w"]
    assert w.device.type == "cpu" and qpw.scale.device.type == "cpu"
    with pytest.raises(ValueError, match="at least one device"):
        GNNServer(setup["tq"], setup["tcfg"], devices=[], tuning_table=None)
