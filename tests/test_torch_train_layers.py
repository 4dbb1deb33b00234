"""Port parity for the training layers: ``repro_torch.core.quantize``'s
``fake_quant`` and ``quantize_stochastic``, and ``repro_torch.api.nn``'s
``qlinear_train`` and ``qgraph_conv_train``, against the reference
(``repro.core.quantize``, ``repro.api.nn``) on the same numpy inputs.

Tolerances: the quantized integers, the fake-quant values and the STE
masks are bit-equal. Each layer's output and gradients are held at
rtol/atol 1e-5, fed the same input (the layer-0 pair pre-quantized by the
reference), at 2/4/8 bits with grad_bits 0 and 8; stochastic rounding is
off there, or fed the reference's own uniform draw. The reference runs on
its ``xla_dot`` engine, whose integers equal its Pallas kernel's
(tests/test_int_train.py::test_backends_bit_exact_with_sr_off); the port
runs its default engine, the kernel's plain version on these CPU tensors,
and its two plain engines, which must agree bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import nn as jnn  # noqa: E402
from repro.core import quantize as JQ  # noqa: E402
from repro.graph import datasets as jdatasets  # noqa: E402
from repro.graph import partition as jpartition  # noqa: E402
from repro.train import intpath as jintpath  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.api import nn as tnn  # noqa: E402
from repro_torch.core import quantize as TQ  # noqa: E402
from repro_torch.graph import datasets, partition  # noqa: E402
from repro_torch.train import intpath, trainer  # noqa: E402

BITS = (2, 4, 8)
GRAD_BITS = (0, 8)
TOL = dict(rtol=1e-5, atol=1e-5)


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
    """(reference batches, port batches): the reference tests' proteins
    graph at scale 0.05, 8 parts, 4 a batch."""
    jd = jdatasets.load("proteins", scale=0.05, seed=0)
    jb = jtrainer.prepare_batches(jd, jpartition.partition(jd.csr, 8),
                                  batch_size=4)
    td = datasets.load("proteins", scale=0.05, seed=0)
    tb = trainer.prepare_batches(td, partition.partition(td.csr, 8),
                                 batch_size=4)
    return jb, tb


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _qp(qp):
    return TQ.QuantParams(qp.nbits, _t(qp.scale), _t(qp.zero))


# ------------------------------------------------------------- quantize

def _edge_input(rng, shape):
    """Uniform values, the calibrated extremes repeated, and values on and
    beside the grid points, where floor and the strict STE bound decide."""
    x = rng.uniform(-3, 5, shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[:3] = flat.max()
    flat[3:6] = flat.min()
    return x


@pytest.mark.parametrize("nbits", (1, 2, 4, 8))
@pytest.mark.parametrize("shape", ((37,), (16, 24), (5, 7, 3)))
def test_fake_quant_values_and_ste_mask_bit_equal(nbits, shape):
    rng = np.random.default_rng(nbits * 100 + len(shape))
    x = _edge_input(rng, shape)
    qp = JQ.calibrate(jnp.asarray(x), nbits)
    grid = (np.asarray(qp.zero) + np.asarray(qp.scale)
            * rng.integers(0, 1 << nbits, x.size)).astype(np.float32)
    x.reshape(-1)[6:6 + x.size // 4] = grid[:x.size // 4]
    r = rng.uniform(-1, 1, shape).astype(np.float32)
    want_g = jax.grad(
        lambda v: jnp.sum(JQ.fake_quant(v, nbits) * r))(jnp.asarray(x))
    vals = JQ.fake_quant(jnp.asarray(x), nbits)
    tx = _t(x, grad=True)
    got = TQ.fake_quant(tx, nbits)
    torch.sum(got * _t(r)).backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(vals))
    # the gradient is r where the gate passes and 0 where it does not
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want_g))
    # the calibrated maximum is clipped, so the strict upper bound blocks it
    assert not tx.grad.numpy().reshape(-1)[:3].any()


@pytest.mark.parametrize("nbits", (2, 8))
def test_fake_quant_with_given_params_bit_equal(nbits):
    rng = np.random.default_rng(nbits)
    x = rng.uniform(-2, 2, (12, 9)).astype(np.float32)
    qp = JQ.QuantParams(nbits, jnp.float32(0.01), jnp.float32(-0.5))
    want = np.asarray(JQ.fake_quant(jnp.asarray(x), nbits, qp))
    want_g = np.asarray(jax.grad(
        lambda v: jnp.sum(JQ.fake_quant(v, nbits, qp)))(jnp.asarray(x)))
    tx = _t(x, grad=True)
    got = TQ.fake_quant(tx, nbits, _qp(qp))
    got.sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(tx.grad.numpy(), want_g)


@pytest.mark.parametrize("nbits", (1, 4, 8))
def test_quantize_stochastic_with_the_reference_draw_bit_equal(nbits):
    rng = np.random.default_rng(nbits)
    x = jnp.asarray(rng.uniform(-2, 3, (33, 17)).astype(np.float32))
    qp = JQ.calibrate(x, nbits)
    key = jax.random.PRNGKey(nbits)
    want = np.asarray(JQ.quantize_stochastic(x, qp, key))
    # the reference draws u = uniform(key, x.shape); the port takes it as is
    u = jax.random.uniform(key, x.shape, jnp.float32)
    got = TQ.quantize_stochastic(_t(x), _qp(qp), _t(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # u = 0 is the deterministic quantizer
    zero = TQ.quantize_stochastic(_t(x), _qp(qp), torch.zeros(x.shape))
    np.testing.assert_array_equal(zero.numpy(), np.asarray(JQ.quantize(x, qp)))


def test_quantize_stochastic_same_seed_same_draw_within_one_level():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.uniform(-2, 2, (64, 32)).astype(np.float32))
    qp = TQ.calibrate(x, 4)
    a = TQ.quantize_stochastic(x, qp, generator=torch.Generator().manual_seed(3))
    b = TQ.quantize_stochastic(x, qp, generator=torch.Generator().manual_seed(3))
    c = TQ.quantize_stochastic(x, qp, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    step = a - TQ.quantize(x, qp)
    assert set(step.unique().tolist()) <= {0, 1}
    assert int(a.min()) >= 0 and int(a.max()) <= qp.qmax


# ------------------------------------------------------------ qlinear_train

def _linear_inputs(bits):
    rng = np.random.default_rng(bits)
    return (rng.uniform(-2, 2, (48, 24)).astype(np.float32),
            rng.uniform(-1, 1, (24, 12)).astype(np.float32),
            rng.uniform(-1, 1, 12).astype(np.float32),
            rng.uniform(-1, 1, (48, 12)).astype(np.float32))


@pytest.mark.parametrize("grad_bits", GRAD_BITS)
@pytest.mark.parametrize("bits", BITS)
def test_qlinear_train_matches_reference(bits, grad_bits):
    h, w, b, r = _linear_inputs(bits)
    kw = dict(x_bits=bits, w_bits=bits, grad_bits=grad_bits)
    out_j = jnn.qlinear_train(h, w, b, backend="xla_dot", **kw)
    grads_j = jax.grad(lambda *a: jnp.sum(jnn.qlinear_train(
        *a, backend="xla_dot", **kw) * r), argnums=(0, 1, 2))(h, w, b)
    th, tw, tb = _t(h, True), _t(w, True), _t(b, True)
    out = tnn.qlinear_train(th, tw, tb, **kw)
    torch.sum(out * _t(r)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    for got, want in zip((th, tw, tb), grads_j):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("grad_bits", GRAD_BITS)
@pytest.mark.parametrize("bits", BITS)
def test_qlinear_train_prequantized_input_matches_reference(bits, grad_bits):
    """Layer 0's form: the features arrive quantized, (hq, QuantParams)."""
    h, w, b, r = _linear_inputs(bits)
    qph = JQ.calibrate(jnp.asarray(h), bits)
    hq = JQ.quantize(jnp.asarray(h), qph)
    kw = dict(x_bits=bits, w_bits=bits, grad_bits=grad_bits)
    out_j = jnn.qlinear_train((hq, qph), w, b, backend="xla_dot", **kw)
    gw_j, gb_j = jax.grad(
        lambda w, b: jnp.sum(jnn.qlinear_train((hq, qph), w, b,
                                               backend="xla_dot", **kw) * r),
        argnums=(0, 1))(w, b)
    tw, tb = _t(w, True), _t(b, True)
    out = tnn.qlinear_train((_t(hq), _qp(qph)), tw, tb, **kw)
    torch.sum(out * _t(r)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw_j), **TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb_j), **TOL)


@pytest.mark.parametrize("grad_bits", GRAD_BITS)
def test_qlinear_train_engines_bit_equal(grad_bits):
    h, w, b, r = _linear_inputs(4)
    res = {}
    for be in ("torch_dot", "popcount", "cuda"):
        th, tw = _t(h, True), _t(w, True)
        out = tnn.qlinear_train(th, tw, _t(b), x_bits=4, w_bits=4,
                                grad_bits=grad_bits, backend=be)
        torch.sum(out * _t(r)).backward()
        res[be] = (out.detach(), th.grad, tw.grad)
    for be in ("popcount", "cuda"):
        for got, want in zip(res[be], res["torch_dot"]):
            assert torch.equal(got, want), be


def test_qlinear_train_no_input_grad_where_none_is_needed():
    h, w, b, r = _linear_inputs(8)
    tw = _t(w, True)
    out = tnn.qlinear_train(_t(h), tw, _t(b), grad_bits=8)
    torch.sum(out * _t(r)).backward()
    assert tw.grad is not None and bool(tw.grad.abs().sum() > 0)


# ------------------------------------------------------- qgraph_conv_train

@pytest.fixture(scope="module")
def arts(batches):
    """{bits: (reference artifacts, port artifacts)} of batch 0."""
    jb, tb = batches
    return {bits: (jintpath.build_artifacts(jb[0], bits),
                   intpath.build_artifacts(tb[0], bits, device="cpu"))
            for bits in BITS}


@pytest.mark.parametrize("grad_bits", GRAD_BITS)
@pytest.mark.parametrize("bits", BITS)
def test_qgraph_conv_train_matches_reference(arts, bits, grad_bits):
    art_j, art_t = arts[bits]
    rng = np.random.default_rng(bits)
    n = art_t.inv_deg.shape[0]
    u = rng.uniform(-2, 2, (n, 8)).astype(np.float32)
    r = rng.uniform(-1, 1, u.shape).astype(np.float32)
    kw = dict(x_bits=bits, grad_bits=grad_bits)
    out_j = jnn.qgraph_conv_train(u, art_j, backend="xla_dot", **kw)
    g_j = jax.grad(lambda v: jnp.sum(jnn.qgraph_conv_train(
        v, art_j, backend="xla_dot", **kw) * r))(u)
    tu = _t(u, True)
    out = tnn.qgraph_conv_train(tu, art_t, **kw)
    torch.sum(out * _t(r)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(g_j), **TOL)


@pytest.mark.parametrize("grad_bits", GRAD_BITS)
def test_qgraph_conv_train_engines_and_tiles_bit_equal(batches, grad_bits):
    """Every engine, and the per-block zero-tile artifacts, give the same
    floats: the integer products are exact and the epilogue is one code."""
    _, tb = batches
    plain = intpath.build_artifacts(tb[1], 4, device="cpu")
    tiled = intpath.build_artifacts(tb[1], 4, with_tiles=True, device="cpu")
    rng = np.random.default_rng(7)
    u = rng.uniform(-2, 2, (plain.inv_deg.shape[0], 16)).astype(np.float32)
    r = _t(rng.uniform(-1, 1, u.shape).astype(np.float32))
    res = {}
    for name, art, be in (("torch_dot", plain, "torch_dot"),
                          ("popcount", plain, "popcount"),
                          ("cuda", plain, "cuda"), ("cuda-tiles", tiled, "cuda")):
        tu = _t(u, True)
        out = tnn.qgraph_conv_train(tu, art, x_bits=4, grad_bits=grad_bits,
                                    backend=be)
        torch.sum(out * r).backward()
        res[name] = (out.detach(), tu.grad)
    for name in ("popcount", "cuda", "cuda-tiles"):
        for got, want in zip(res[name], res["torch_dot"]):
            assert torch.equal(got, want), name


def test_stochastic_requires_a_generator_and_repeats_per_seed(arts):
    h, w, b, _ = _linear_inputs(8)
    with pytest.raises(ValueError, match="generator"):
        tnn.qlinear_train(_t(h), _t(w), stochastic=True)
    _, art = arts[8]
    u = torch.tensor(np.random.default_rng(1).uniform(
        -2, 2, (art.inv_deg.shape[0], 4)).astype(np.float32))
    with pytest.raises(ValueError, match="generator"):
        tnn.qgraph_conv_train(u, art, stochastic=True)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        tw, tu = _t(w, True), u.clone().requires_grad_()
        a = tnn.qlinear_train(_t(h), tw, _t(b), stochastic=True, grad_bits=8,
                              generator=gen)
        c = tnn.qgraph_conv_train(tu, art, stochastic=True, grad_bits=8,
                                  generator=gen)
        (a.sum() + c.sum()).backward()
        return a.detach(), c.detach(), tw.grad, tu.grad

    first, again, other = run(5), run(5), run(6)
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    assert not torch.equal(first[0], other[0])
    # SR moves each activation at most one level above floor rounding, so
    # the output moves by at most scale_h * sum_k |w_dq[k, n]| (plus the
    # float epilogue's rounding)
    det = tnn.qlinear_train(_t(h), _t(w), _t(b))
    qph, qpw = TQ.calibrate(_t(h), 8), TQ.calibrate(_t(w), 8)
    w_dq = TQ.dequantize(TQ.quantize(_t(w), qpw), qpw)
    bound = float(qph.scale) * float(w_dq.abs().sum(0).max())
    assert float((first[0] - det).abs().max()) <= bound + 1e-5


def test_backward_runs_under_the_forwards_engine_and_policy(arts, monkeypatch):
    """Autograd runs a CUDA backward on a thread of its own, where the
    caller's ``api.use`` context is not set: the layers carry the forward's
    engine and policy into their backward. Here the backward runs on a
    fresh thread, as it does on the card."""
    import threading

    from repro_torch import api
    from repro_torch.api import backends

    seen = []
    real = backends.PopcountBackend.bitserial_mm

    def spy(self, a_packed, b_packed, *, policy, **kw):
        seen.append(policy.mode)
        return real(self, a_packed, b_packed, policy=policy, **kw)

    monkeypatch.setattr(backends.PopcountBackend, "bitserial_mm", spy)
    _, art = arts[4]
    h, w, b, _ = _linear_inputs(4)
    tw = _t(w, True)
    tu = torch.tensor(np.random.default_rng(2).uniform(
        -2, 2, (art.inv_deg.shape[0], 8)).astype(np.float32), requires_grad=True)
    with api.use("popcount", policy=api.ExecutionPolicy(mode="mxu")):
        out = tnn.qlinear_train(_t(h), tw, _t(b), x_bits=4, w_bits=4, grad_bits=8)
        conv = tnn.qgraph_conv_train(tu, art, x_bits=4, grad_bits=8)
    forward = len(seen)
    worker = threading.Thread(target=lambda: (out.sum() + conv.sum()).backward())
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive()
    assert tw.grad is not None and tu.grad is not None
    # the weight-gradient GEMM and one per transposed block, all on popcount
    # at the forward's policy
    assert len(seen) == forward + 1 + art.adjb.shape[0]
    assert set(seen) == {"mxu"}
