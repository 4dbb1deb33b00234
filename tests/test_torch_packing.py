"""Port parity for §4.6 subgraph packing: ``repro_torch.graph.packing``
against the reference's ``repro.graph.packing`` on the same batches.

Every comparison is exact: the compound words (the port's int32 bit
patterns viewed as the reference's uint32), the meta, the unpacked edges,
planes and 0/1 adjacency, the four transfers at ``device="cpu"`` and the
byte accounting. The batches are proteins and ppi at small scale on a
64-row tile, at nbits 1/2/4/8, with the edge list as built (an even
``e_cap``: the edges are symmetric) and padded to an odd ``e_cap``, which
leaves the packed planes 8- but not 16-byte aligned in the buffer. The
copy through the pinned staging buffer runs on the card only
(tests/test_torch_cuda.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graph import batching as jbatching  # noqa: E402
from repro.graph import datasets as jdatasets  # noqa: E402
from repro.graph import packing as jpacking  # noqa: E402
from repro.graph import partition as jpartition  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import bitops  # noqa: E402
from repro_torch.graph import batching, datasets, packing, partition  # noqa: E402

NBITS = (1, 2, 4, 8)
CASES = [("proteins", 0.02, False), ("ppi", 0.01, False), ("proteins", 0.02, True),
         ("ppi", 0.01, True)]
CASE_IDS = [f"{n}-{'odd' if odd else 'even'}_e_cap" for n, _, odd in CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch thread
    each keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _first_batch(ds, part, bat, name, scale, odd):
    data = ds.load(name, scale=scale, seed=2)
    parts = part.partition(data.csr, 4)
    bs = bat.make_batches(data, parts, batch_size=2, tile=64, shuffle=False)
    if not odd:
        return bs[0]
    # one odd edge capacity for every batch, past the widest edge list
    e_cap = max(b.edges.shape[1] for b in bs) | 1
    return bat.make_batches(data, parts, batch_size=2, tile=64,
                            pad_edges_to=e_cap, shuffle=False)[0]


@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def pair(request):
    """(reference batch, port batch) made by each package from seed 2."""
    name, scale, odd = request.param
    jb = _first_batch(jdatasets, jpartition, jbatching, name, scale, odd)
    pb = _first_batch(datasets, partition, batching, name, scale, odd)
    np.testing.assert_array_equal(pb.edges, jb.edges)
    np.testing.assert_array_equal(pb.features, jb.features)
    assert pb.edges.shape[1] % 2 == int(odd)
    return jb, pb


def _meta_equal(got, want):
    assert got == want
    assert all(type(got[k]) is type(want[k]) for k in want)


@pytest.mark.parametrize("nbits", NBITS)
def test_compound_words_and_meta_equal_reference(pair, nbits):
    jb, pb = pair
    for port_fn, ref_fn in ((packing.pack_compound, jpacking.pack_compound),
                            (packing.pack_feats, jpacking.pack_feats)):
        buf, meta = port_fn(pb, nbits)
        jbuf, jmeta = ref_fn(jb, nbits)
        assert buf.dtype == np.int32  # the port's bit patterns
        np.testing.assert_array_equal(buf.view(np.uint32), jbuf)
        _meta_equal(meta, jmeta)
    assert packing.compound_nbytes(pb, nbits) == jpacking.compound_nbytes(jb, nbits)


@pytest.mark.parametrize("nbits", NBITS)
def test_unpack_equal_reference(pair, nbits):
    jb, pb = pair
    buf, meta = packing.pack_compound(pb, nbits)
    jbuf, _ = jpacking.pack_compound(jb, nbits)
    kw = {k: meta[k] for k in ("n", "d", "nbits", "e_cap", "wpf")}
    tbuf = torch.from_numpy(buf)
    adj, planes = packing.unpack_compound(tbuf, **kw)
    jadj, jplanes = jpacking.unpack_compound(jbuf, **kw)
    assert adj.dtype == torch.int32
    np.testing.assert_array_equal(adj.numpy(), np.asarray(jadj))
    np.testing.assert_array_equal(planes.numpy().view(np.uint32), np.asarray(jplanes))
    # the edges, read back from the buffer as the device unpack reads them
    edges = tbuf[8:8 + 2 * meta["e_cap"]].view(2, meta["e_cap"])
    np.testing.assert_array_equal(edges.numpy(), jb.edges)
    # the planes are a view into the buffer at word 8 + 2 e_cap, which
    # .contiguous() does not copy
    off = 4 * (8 + 2 * meta["e_cap"])
    assert planes.data_ptr() == tbuf.data_ptr() + off
    assert planes.contiguous().data_ptr() == planes.data_ptr()
    assert off % 16 == (8 if meta["e_cap"] % 2 else 0)

    fbuf, fmeta = packing.pack_feats(pb, nbits)
    jfbuf, _ = jpacking.pack_feats(jb, nbits)
    fkw = {k: fmeta[k] for k in ("n", "nbits", "wpf")}
    feats = packing.unpack_feats(torch.from_numpy(fbuf), **fkw)
    np.testing.assert_array_equal(feats.numpy().view(np.uint32),
                                  np.asarray(jpacking.unpack_feats(jfbuf, **fkw)))
    np.testing.assert_array_equal(feats.numpy(), planes.numpy())


@pytest.mark.parametrize("nbits", (1, 8))
def test_transfers_equal_reference_on_cpu(pair, nbits):
    jb, pb = pair
    got = {
        "I": packing.transfer_dense(pb, device="cpu"),
        "II": packing.transfer_sparse(pb, device="cpu"),
        "III": packing.transfer_packed(pb, nbits, device="cpu"),
        "III_feats": packing.transfer_packed_feats(pb, nbits, device="cpu"),
    }
    want = {
        "I": jpacking.transfer_dense(jb),
        "II": jpacking.transfer_sparse(jb),
        "III": jpacking.transfer_packed(jb, nbits),
        "III_feats": jpacking.transfer_packed_feats(jb, nbits),
    }
    for key in ("I", "II"):
        for g, w in zip(got[key], want[key]):
            assert g.device.type == "cpu"
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    adj, planes, meta = got["III"]
    jadj, jplanes, jmeta = want["III"]
    np.testing.assert_array_equal(adj.numpy(), np.asarray(jadj))
    np.testing.assert_array_equal(planes.numpy().view(np.uint32), np.asarray(jplanes))
    _meta_equal(meta, jmeta)
    feats, fmeta = got["III_feats"]
    jfeats, jfmeta = want["III_feats"]
    np.testing.assert_array_equal(feats.numpy().view(np.uint32), np.asarray(jfeats))
    _meta_equal(fmeta, jfmeta)
    # every strategy gives the same adjacency
    assert torch.equal(got["I"][0], adj) and torch.equal(got["II"][0], adj)
    # a transfer copies: the features do not share the batch's memory
    got["I"][1][0, 0] += 1
    assert pb.features[0, 0] + 1 == got["I"][1][0, 0]


def test_packed_transfer_matches_dense(pair):
    """The reference's own decode check (tests/test_graph.py): strategy III
    reproduces strategy I's adjacency, and the features decode to the 8-bit
    quantization of the dense features, within one step."""
    _, pb = pair
    adj_d, feats_d = packing.transfer_dense(pb, device="cpu")
    adj_p, packed, meta = packing.transfer_packed(pb, nbits=8, device="cpu")
    assert torch.equal(adj_p, adj_d)
    xq = bitops.bit_compose(bitops.unpack_along_axis(packed, dim=2, size=meta["d"]))
    x = xq.numpy().astype(np.float32) * meta["scale"] + meta["zero"]
    err = np.abs(x - feats_d.numpy())
    assert err.max() <= meta["scale"] * 1.001
    nb = packing.compound_nbytes(pb, nbits=8)
    assert nb["III_feats"] < nb["III_packed"] < nb["II_sparse"] < nb["I_dense"]


@pytest.mark.parametrize("nbits", (1, 4))
def test_unpacked_planes_feed_the_gemm(pair, nbits):
    """The serving path feeds the unpacked planes, a view at an offset into
    the buffer, to the bit-serial GEMM as its A operand: on CPU tensors
    both modes give the exact product (the card's kernels are held to the
    same view in tests/test_torch_cuda.py)."""
    _, pb = pair
    _, planes, meta = packing.transfer_packed(pb, nbits, device="cpu")
    xq = bitops.bit_compose(bitops.unpack_along_axis(planes, dim=2, size=meta["d"]))
    rng = np.random.default_rng(nbits)
    w = torch.as_tensor(rng.integers(0, 4, (meta["d"], 7)), dtype=torch.int32)
    exact = xq.to(torch.int64) @ w.to(torch.int64)
    for mode in ("vpu", "mxu"):
        got = api.bitserial_mm_packed(planes, bitops.pack_b(w, 2), backend="cuda",
                                      policy=api.ExecutionPolicy(mode=mode))
        np.testing.assert_array_equal(got.numpy(), exact.numpy())
