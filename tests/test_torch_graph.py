"""Port parity: the graph substrate and batch transfer, array-equal to the
JAX reference for seed 0 (ogbn-arxiv at scale 0.008)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graph import batching as jbatching  # noqa: E402
from repro.graph import datasets as jdatasets  # noqa: E402
from repro.graph import partition as jpartition  # noqa: E402
from repro.graph import sparse as jsparse  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.graph import batching, datasets, partition, sparse  # noqa: E402
from repro_torch.train import trainer  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch thread
    each keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def graphs():
    ref = jdatasets.load("ogbn-arxiv", scale=0.008, seed=0)
    port = datasets.load("ogbn-arxiv", scale=0.008, seed=0)
    return ref, port


@pytest.fixture(scope="module")
def parts(graphs):
    ref, port = graphs
    return jpartition.partition(ref.csr, 8), partition.partition(port.csr, 8)


def test_dataset_array_equal(graphs):
    ref, port = graphs
    assert (port.name, port.n_classes, port.csr.n) == (ref.name, ref.n_classes, ref.csr.n)
    for f in ("features", "labels", "train_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
    np.testing.assert_array_equal(port.csr.indptr, ref.csr.indptr)
    np.testing.assert_array_equal(port.csr.indices, ref.csr.indices)


def test_partition_array_equal(graphs, parts):
    ref, port = graphs
    np.testing.assert_array_equal(parts[1], parts[0])
    assert partition.edge_cut(port.csr, parts[1]) == jpartition.edge_cut(ref.csr, parts[0])
    assert partition.balance(parts[1], 8) == jpartition.balance(parts[0], 8)


@pytest.mark.parametrize("batch_size,shuffle", [(2, False), (3, True)])
def test_batches_array_equal(graphs, parts, batch_size, shuffle):
    ref, port = graphs
    want = jbatching.make_batches(ref, parts[0], batch_size, shuffle=shuffle)
    got = batching.make_batches(port, parts[1], batch_size, shuffle=shuffle)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in ("edges", "features", "labels", "train_mask", "node_ids",
                  "part_sizes"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        assert (g.n_nodes, g.n_valid, g.n_edges) == (w.n_nodes, w.n_valid, w.n_edges)


def test_make_device_batch_equal(graphs, parts):
    ref, port = graphs
    wb = jbatching.make_batches(ref, parts[0], 2, shuffle=False)[0]
    gb = batching.make_batches(port, parts[1], 2, shuffle=False)[0]
    want = jtrainer.make_device_batch(wb)
    got = trainer.make_device_batch(gb, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_sparse_to_dense_drops_padding_and_matches_csr(graphs):
    _, port = graphs
    sub = port.csr.subgraph(np.arange(200))
    el = np.concatenate([sub.edge_list(), -np.ones((2, 5), np.int32)], axis=1)
    dense = sparse.sparse_to_dense(torch.as_tensor(el), sub.n)
    np.testing.assert_array_equal(dense.numpy(), sparse.csr_to_dense(sub))
    np.testing.assert_array_equal(
        dense.numpy(), np.asarray(jsparse.sparse_to_dense(el, sub.n)))
    np.testing.assert_array_equal(sparse.degrees(dense).numpy(), sub.degrees())
    loops = sparse.add_self_loops(dense)
    assert bool((torch.diagonal(loops) == 1).all())
