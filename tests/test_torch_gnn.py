"""Port parity: the quantized layers and the GNN forwards of repro_torch
against the JAX reference, on one ogbn-arxiv batch (scale 0.008, seed 0).

Layer by layer, each port layer is fed the reference's quantized input,
so that one floor flip cannot cascade: the int32 products must be equal,
the float outputs agree within rtol = atol = 1e-6 (one float32 epilogue).
End to end, the logits agree within rtol = atol = 1e-5, the tolerance the
reference holds its own engines to (tests/test_gnn_system.py). The port
runs on the CPU, where its kernel engine takes the kernel's plain version.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.api import nn as jnn  # noqa: E402
from repro.core import bitops as jbitops  # noqa: E402
from repro.core import quantize as jquant  # noqa: E402
from repro.core import zerotile as jzt  # noqa: E402
from repro.graph import batching as jbatching  # noqa: E402
from repro.graph import datasets as jdatasets  # noqa: E402
from repro.graph import partition as jpartition  # noqa: E402
from repro.kernels import sgt as jsgt  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import nn  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import bitops, quantize, zerotile  # noqa: E402
from repro_torch.graph import batching, datasets, partition  # noqa: E402
from repro_torch.kernels import sgt  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.train import trainer  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch thread
    each keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BITS = [2, 4, 8]


def _t(x):
    return torch.as_tensor(np.array(x))


def _qp(jqp):
    """The reference's QuantParams as the port's, same floats."""
    return quantize.QuantParams(jqp.nbits, _t(jqp.scale), _t(jqp.zero))


@pytest.fixture(scope="module")
def batch():
    """One two-part batch, as the reference and as the port build it."""
    ref = jdatasets.load("ogbn-arxiv", scale=0.008, seed=0)
    port = datasets.load("ogbn-arxiv", scale=0.008, seed=0)
    jb = jbatching.make_batches(ref, jpartition.partition(ref.csr, 8), 2,
                                shuffle=False)[0]
    tb = batching.make_batches(port, partition.partition(port.csr, 8), 2,
                               shuffle=False)[0]
    jdb = jtrainer.make_device_batch(jb)
    tdb = trainer.make_device_batch(tb, device="cpu")
    tdb["edges"] = torch.as_tensor(tb.edges)
    return ref, jb, jdb, tdb


@pytest.fixture(scope="module")
def models(batch):
    """{(model, bits): (jcfg, jparams, tcfg, tparams)} with the same weights."""
    ref = batch[0]
    out = {}
    for model in ("gcn", "gin"):
        make = (jgnn.GNNConfig.paper_gcn if model == "gcn"
                else jgnn.GNNConfig.paper_gin)
        jcfg = make(ref.features.shape[1], ref.n_classes)
        jparams = jgnn.init_params(jax.random.PRNGKey(0), jcfg)
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
        tcfg = gnn.GNNConfig(**dataclasses.asdict(jcfg))
        for bits in BITS:
            out[model, bits] = (
                dataclasses.replace(jcfg, x_bits=bits, w_bits=bits), jparams,
                dataclasses.replace(tcfg, x_bits=bits, w_bits=bits), tparams)
    return out


@pytest.mark.parametrize("bits", BITS)
def test_qlinear_matches_reference(bits):
    rng = np.random.default_rng(bits)
    x = rng.normal(size=(40, 128)).astype(np.float32)
    w = rng.normal(size=(128, 16)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    jqx, jqw = jquant.calibrate(jnp.asarray(x), bits), jquant.calibrate(jnp.asarray(w), bits)
    xq = np.asarray(jquant.quantize(jnp.asarray(x), jqx))
    wq = np.asarray(jquant.quantize(jnp.asarray(w), jqw))
    want_int = np.asarray(japi.bitserial_mm(jnp.asarray(xq), jnp.asarray(wq), bits,
                                            bits, backend="popcount"))
    got_int = api.bitserial_mm(_t(xq), _t(wq), bits, bits)
    assert got_int.dtype == torch.int32
    np.testing.assert_array_equal(got_int.numpy(), want_int)
    want = jnn.qlinear(jnp.asarray(xq), jqx, jnp.asarray(wq), jqw,
                       bias=jnp.asarray(b), relu=True, backend="popcount")
    got = nn.qlinear(_t(xq), _qp(jqx), _t(wq), _qp(jqw), bias=_t(b), relu=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("jump", ["none", "compact", "sgt"])
def test_qgraph_conv_matches_reference(batch, bits, jump):
    _, _, jdb, tdb = batch
    n = tdb["adj"].shape[0]
    h = np.random.default_rng(bits).normal(size=(n, 16)).astype(np.float32)
    jqh = jquant.calibrate(jnp.asarray(h), bits)
    hq = np.asarray(jquant.quantize(jnp.asarray(h), jqh))
    ap = bitops.pack_a(tdb["adj"], 1)
    tiles = {"none": None, "compact": zerotile.compact_artifacts(ap, 8, 4),
             "sgt": sgt.sgt_artifacts(ap, 8)}[jump]
    want_int = np.asarray(japi.bitserial_mm(jdb["adj"], jnp.asarray(hq), 1, bits,
                                            backend="popcount"))
    got_int = api.bitserial_mm(tdb["adj"], _t(hq), 1, bits, tiles=tiles)
    np.testing.assert_array_equal(got_int.numpy(), want_int)
    want = jnn.qgraph_conv(jdb["adj"], jnp.asarray(hq), jqh, jdb["inv_deg"],
                           backend="popcount")
    got = nn.qgraph_conv(tdb["adj"], _t(hq), _qp(jqh), tdb["inv_deg"], tiles=tiles)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_port_artifacts_drive_reference_kernel_path(batch):
    """The port's compact and sgt artifacts of the batch adjacency are the
    reference's, so the serve cache's artifacts carry across unchanged."""
    _, _, jdb, tdb = batch
    ja = jbitops.pack_a(jdb["adj"], 1)
    ta = bitops.pack_a(tdb["adj"], 1)
    for got, want in ((zerotile.compact_artifacts(ta, 8, 4),
                       jzt.compact_artifacts(ja, 8, 4)),
                      (sgt.sgt_artifacts(ta, 8), jsgt.sgt_artifacts(ja, 8))):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[2:] == want[2:]


@pytest.mark.parametrize("model", ["gcn", "gin"])
@pytest.mark.parametrize("bits", BITS)
def test_forward_qgtc_matches_reference(batch, models, model, bits):
    _, _, jdb, tdb = batch
    jcfg, jparams, tcfg, tparams = models[model, bits]
    want = np.asarray(jgnn.forward_qgtc(
        jgnn.quantize_params(jparams, jcfg), jdb["adj"], jdb["x"], jdb["inv_deg"],
        jcfg, backend="popcount"))
    qp = gnn.quantize_params(tparams, tcfg)
    got = gnn.forward_qgtc(qp, tdb["adj"], tdb["x"], tdb["inv_deg"], tcfg)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_forward_qgtc_engines_and_tiles_agree(batch, models, model):
    """Every engine, and every jump schedule of the kernel engine, gives the
    same logits bit for bit: the integer products are exact everywhere."""
    _, _, _, tdb = batch
    _, _, tcfg, tparams = models[model, 4]
    qp = gnn.quantize_params(tparams, tcfg)
    args = (qp, tdb["adj"], tdb["x"], tdb["inv_deg"], tcfg)
    ref = gnn.forward_qgtc(*args, backend="popcount")
    ap = bitops.pack_a(tdb["adj"], 1)
    for kw in ({"backend": "torch_dot"}, {},
               {"tiles": zerotile.compact_artifacts(ap, 8, 4)},
               {"tiles": sgt.sgt_artifacts(ap, 8)},
               {"policy": api.DEFAULT_POLICY.replace(jump="mask")}):
        assert torch.equal(gnn.forward_qgtc(*args, **kw), ref), kw
    with api.use("torch_dot"):
        assert torch.equal(gnn.forward_qgtc(*args), ref)


@pytest.mark.parametrize("model", ["gcn", "gin"])
@pytest.mark.parametrize("path", ["fp32_dense", "fp32_csr"])
def test_fp32_forward_matches_reference(batch, models, model, path):
    _, jb, jdb, tdb = batch
    jcfg, jparams, tcfg, tparams = models[model, 8]
    graph_j = jdb["adj"] if path == "fp32_dense" else jnp.asarray(jb.edges)
    graph_t = tdb["adj"] if path == "fp32_dense" else tdb["edges"]
    want = np.asarray(jgnn.forward(jparams, graph_j, jdb["x"], jdb["inv_deg"],
                                   jcfg, path=path))
    got = gnn.forward(tparams, graph_t, tdb["x"], tdb["inv_deg"], tcfg, path=path)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_init_params_shapes_match_reference(models):
    for model in ("gcn", "gin"):
        jcfg, jparams, tcfg, _ = models[model, 8]
        got = gnn.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
        assert jax.tree.map(np.shape, jparams) == {
            layer: {k: tuple(v.shape) for k, v in p.items()}
            for layer, p in got.items()}
