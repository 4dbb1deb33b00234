"""Port parity for the integer training path's graph side, word for word:
``kernels.sgt.condense`` / ``sgt_stats``, ``kernels.ops.edge_scatter_sum``,
``graph.batching.batch_iterator``, ``graph.partition.random_partition`` and
``train.intpath`` (``build_artifacts``, ``batch_caps``,
``blocked_aggregate``, ``ArtifactCache``) against the reference's
(``repro.kernels.sgt``, ``repro.kernels.ops``, ``repro.graph``,
``repro.train.intpath``), on the reference tests' proteins graph (scale
0.05, 8 parts, 4 a batch). Every comparison is exact; packed words are
compared as the reference's uint32.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import bitops as jbitops  # noqa: E402
from repro.graph import batching as jbatching  # noqa: E402
from repro.graph import datasets as jdatasets  # noqa: E402
from repro.graph import partition as jpartition  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import sgt as jsgt  # noqa: E402
from repro.train import intpath as jintpath  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.core import bitops  # noqa: E402
from repro_torch.graph import batching, datasets, partition  # noqa: E402
from repro_torch.kernels import ops, sgt  # noqa: E402
from repro_torch.train import intpath, trainer  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch thread
    each keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def batches():
    jd = jdatasets.load("proteins", scale=0.05, seed=0)
    jb = jtrainer.prepare_batches(jd, jpartition.partition(jd.csr, 8),
                                  batch_size=4)
    td = datasets.load("proteins", scale=0.05, seed=0)
    tb = trainer.prepare_batches(td, partition.partition(td.csr, 8),
                                 batch_size=4)
    return jb, tb


def _words(t):
    return t.numpy().view(np.uint32)


def _dense_adj(batch):
    e = np.asarray(batch.edges)
    live = e[0] >= 0
    adj = np.zeros((batch.n_nodes, batch.n_nodes), np.int64)
    adj[e[0][live], e[1][live]] = 1
    return adj


# ---------------------------------------------------------------- sgt

@pytest.mark.parametrize("s,t,tile_m", [(1, 1, 8), (2, 3, 8), (4, 2, 16),
                                        (1, 8, 32)])
def test_condense_and_sgt_stats_word_for_word(s, t, tile_m):
    rng = np.random.default_rng(s * 10 + t)
    m, k, n = 64, 40 * 32, 12
    a = rng.integers(0, 1 << s, (m, k)) * (rng.random((m, k)) < 0.02)
    b = rng.integers(0, 1 << t, (k, n))
    ja = jbitops.pack_a(jnp.asarray(a, jnp.int32), s)
    jb = jbitops.pack_b(jnp.asarray(b, jnp.int32), t)
    ta = bitops.pack_a(torch.tensor(a, dtype=torch.int32), s)
    tb = bitops.pack_b(torch.tensor(b, dtype=torch.int32), t)
    jidx, jcnt, js_w, _ = jsgt.sgt_artifacts(ja, tile_m)
    tidx, tcnt, ts_w, _ = sgt.sgt_artifacts(ta, tile_m)
    assert ts_w == js_w
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    for s_w in (None, k // 32):  # the largest count, and the full width
        want = jsgt.condense(ja, jb, jidx, jcnt, tile_m, s_w)
        got = sgt.condense(ta, tb, tidx, tcnt, tile_m, s_w)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_words(g), np.asarray(w))
    # a dense per-window popcount GEMM over the condensed words is A @ B
    a_cond, b_gath = sgt.condense(ta, tb, tidx, tcnt, tile_m)
    acc = torch.zeros(m, n, dtype=torch.int64)
    for i in range(s):
        for j in range(t):
            prod = bitops.popcount32(a_cond[i][:, :, :, None]
                                     & b_gath[j][:, None, :, :]).sum(2)
            acc += prod.reshape(m, n) << (i + j)
    np.testing.assert_array_equal(acc.numpy(), a @ b)
    occ_j = jsgt.word_occupancy(ja, tile_m)
    occ_t = sgt.word_occupancy(ta, tile_m)
    assert sgt.sgt_stats(occ_t) == jsgt.sgt_stats(occ_j)


# ------------------------------------------------------- edge_scatter_sum

@pytest.mark.parametrize("dtype", ("int32", "float32"))
def test_edge_scatter_sum_matches_reference(dtype):
    rng = np.random.default_rng(1)
    n, e, d = 50, 300, 6
    values = (rng.integers(0, 256, (n, d)) if dtype == "int32"
              else rng.standard_normal((n, d))).astype(dtype)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    src[-40:] = -1
    dst[-40:] = -1  # padding: must add nothing, row 0 included
    dst[:20] = 0
    want = np.asarray(jops.edge_scatter_sum(jnp.asarray(values),
                                            jnp.asarray(src), jnp.asarray(dst), n))
    got = ops.edge_scatter_sum(torch.tensor(values), torch.tensor(src),
                               torch.tensor(dst), n)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "int32":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the padded edges add nothing: the sum over live edges alone
    live = src >= 0
    plain = np.zeros_like(values, dtype=np.float64)
    np.add.at(plain, dst[live], values[src[live]].astype(np.float64))
    np.testing.assert_allclose(got.numpy(), plain, rtol=1e-5, atol=1e-5)


# ------------------------------------------------- batching and partition

def test_batch_iterator_same_sequence_and_infinite_mode(batches):
    jb, tb = batches
    jpos = {id(b): i for i, b in enumerate(jb)}
    tpos = {id(b): i for i, b in enumerate(tb)}
    for epochs in (1, 3):
        want = [(s, jpos[id(b)]) for s, b in jbatching.batch_iterator(
            jb, epochs=epochs, seed=7)]
        got = [(s, tpos[id(b)]) for s, b in batching.batch_iterator(
            tb, epochs=epochs, seed=7)]
        assert got == want
    finite = list(batching.batch_iterator(tb, epochs=3, seed=7))
    inf = list(itertools.islice(batching.batch_iterator(tb, epochs=None, seed=7),
                                len(finite) + len(tb)))
    assert all(sf == si and bf is bi for (sf, bf), (si, bi) in zip(finite, inf))
    assert len(inf) == len(finite) + len(tb) and inf[-1][0] == len(inf) - 1


@pytest.mark.parametrize("n,k,seed", [(100, 8, 0), (1001, 7, 3), (5, 5, 1)])
def test_random_partition_word_for_word(n, k, seed):
    got = partition.random_partition(n, k, seed)
    np.testing.assert_array_equal(got, jpartition.random_partition(n, k, seed))
    assert got.dtype == np.int32
    assert np.bincount(got, minlength=k).max() - np.bincount(got).min() <= 1


# ------------------------------------------------------------ intpath

def test_batch_caps_equal_reference(batches):
    jb, tb = batches
    assert intpath.batch_caps(tb) == jintpath.batch_caps(jb)


@pytest.mark.parametrize("bits", (1, 4, 8))
@pytest.mark.parametrize("capped", (False, True))
def test_build_artifacts_equal_reference(batches, bits, capped):
    jb, tb = batches
    caps = dict(zip(("block_pad", "rem_pad"), intpath.batch_caps(tb))) \
        if capped else {}
    for b_j, b_t in zip(jb, tb):
        want = jintpath.build_artifacts(b_j, bits, with_tiles=True, **caps)
        got = intpath.build_artifacts(b_t, bits, with_tiles=True,
                                      device="cpu", **caps)
        for name in ("adjb", "row_idx", "rem_src", "rem_dst", "deg", "deg_in",
                     "inv_deg", "xq"):
            g, w = getattr(got, name), np.asarray(getattr(want, name))
            assert g.dtype == getattr(torch, str(w.dtype)), name
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        assert got.qpx.nbits == bits
        np.testing.assert_array_equal(got.qpx.scale.numpy(), np.asarray(want.qpx.scale))
        np.testing.assert_array_equal(got.qpx.zero.numpy(), np.asarray(want.qpx.zero))
        assert got.s_maxes == want.s_maxes
        for (gi, gc), (wi, wc) in zip(got.tiles, want.tiles):
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
            np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("bits", (1, 4, 8))
def test_blocked_aggregate_is_bit_exact(batches, bits):
    jb, tb = batches
    bp, rp = intpath.batch_caps(tb)
    rng = np.random.default_rng(bits)
    for b_j, b_t in zip(jb, tb):
        vq = rng.integers(0, 1 << bits, (b_t.n_nodes, 8)).astype(np.int32)
        want = _dense_adj(b_t) @ vq.astype(np.int64)
        ref = np.asarray(jintpath.blocked_aggregate(
            jintpath.build_artifacts(b_j, bits, block_pad=bp, rem_pad=rp),
            jnp.asarray(vq), backend="xla_dot"))
        np.testing.assert_array_equal(ref, want)
        for tiles in (False, True):
            art = intpath.build_artifacts(b_t, bits, block_pad=bp, rem_pad=rp,
                                          with_tiles=tiles, device="cpu")
            for be in ("torch_dot", "popcount", "cuda"):
                got = intpath.blocked_aggregate(art, torch.tensor(vq), backend=be)
                assert got.dtype == torch.int32
                np.testing.assert_array_equal(got.numpy(), want)


def test_artifact_shapes_uniform_and_caps_fail_loudly(batches):
    _, tb = batches
    bp, rp = intpath.batch_caps(tb)
    arts = [intpath.build_artifacts(b, 4, block_pad=bp, rem_pad=rp, device="cpu")
            for b in tb]
    assert len({(a.adjb.shape, a.row_idx.shape, a.rem_src.shape, a.xq.shape)
                for a in arts}) == 1
    with pytest.raises(ValueError, match="block_pad"):
        intpath.build_artifacts(tb[0], 4, block_pad=1, device="cpu")
    n_rem = int(_dense_adj(tb[0]).sum()
                - intpath.build_artifacts(tb[0], 4, device="cpu").adjb.sum())
    assert n_rem > 0
    with pytest.raises(ValueError, match="rem_pad"):
        intpath.build_artifacts(tb[0], 4, rem_pad=0, device="cpu")
    adj = _dense_adj(tb[0])
    np.testing.assert_array_equal(arts[0].deg.numpy()[:, 0], adj.sum(1))
    np.testing.assert_array_equal(arts[0].deg_in.numpy()[:, 0], adj.sum(0))


def test_artifact_cache_builds_each_batch_once(batches):
    _, tb = batches
    bp, rp = intpath.batch_caps(tb)
    cache = intpath.ArtifactCache(4, block_pad=bp, rem_pad=rp, device="cpu")
    for _ in range(3):
        for b in tb:
            cache.get(b)
    assert cache.builds == len(tb)
