"""Port parity for the §5 Tensor API: ``repro_torch.core.bittensor``,
``core.qgemm`` and the ``repro_torch.api`` dispatchers beneath them, against
the reference's ``repro.core.bittensor`` and ``repro.api`` on the same numpy
inputs.

Tolerance 0 throughout: packed words are equal (compared as uint32),
integer results are equal, and the floats of ``to_float`` are equal because
both packages take the same IEEE float32 steps. The reference's matmuls run
on its ``pallas`` backend in interpret mode. Shapes stay small: Pallas
interpret retraces per shape.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import bitops as jbitops  # noqa: E402
from repro.core import bittensor as jbt  # noqa: E402
from repro.core.quantize import calibrate as jcalibrate  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import registry  # noqa: E402
from repro_torch.convert import bittensor_from_jax  # noqa: E402
from repro_torch.core import bitops, bittensor as bt  # noqa: E402
from repro_torch.core.qgemm import qgemm  # noqa: E402
from repro_torch.core.quantize import QuantParams, calibrate  # noqa: E402
from repro_torch.kernels._build import LAUNCHES  # noqa: E402

ENGINES = ("torch_dot", "popcount", "cuda")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch thread
    each keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_launches():
    """On the CPU every wrapper takes its plain version: nothing launches."""
    before = dict(LAUNCHES)
    yield
    assert LAUNCHES == before


def _words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _pair(s, t, m=8, k=65, n=9, seed=None):
    rng = np.random.default_rng(seed if seed is not None else s * 100 + t)
    a = rng.integers(0, 1 << s, (m, k)).astype(np.int32)
    b = rng.integers(0, 1 << t, (k, n)).astype(np.int32)
    return a, b


def _from_ref(jt):
    """A reference BitTensor carried across through numpy."""
    qp = jt.qp
    return bittensor_from_jax(np.asarray(jt.data), jt.nbits, jt.shape,
                              jt.pack_axis,
                              None if qp is None else np.asarray(qp.scale),
                              None if qp is None else np.asarray(qp.zero),
                              device="cpu")


# --------------------------------------------------- to_bit / to_val / to_float

@pytest.mark.parametrize("nbits", range(1, 13))
@pytest.mark.parametrize("pack_axis", [0, 1, -1])
def test_to_bit_round_trip_matches_reference(nbits, pack_axis):
    rng = np.random.default_rng(nbits * 3 + pack_axis)
    x = rng.normal(size=(10, 70)).astype(np.float32)
    jt = jbt.to_bit(jnp.asarray(x), nbits, pack_axis=pack_axis)
    tt = bt.to_bit(torch.as_tensor(x), nbits, pack_axis=pack_axis)
    assert (tt.nbits, tt.shape, tt.pack_axis) == (jt.nbits, jt.shape, jt.pack_axis)
    assert tt.data.dtype == torch.int32 and tt.nbytes == jt.nbytes
    np.testing.assert_array_equal(_words(tt.data), np.asarray(jt.data))
    np.testing.assert_array_equal(tt.qp.scale.numpy(), np.asarray(jt.qp.scale))
    np.testing.assert_array_equal(tt.qp.zero.numpy(), np.asarray(jt.qp.zero))
    np.testing.assert_array_equal(bt.to_val(tt).numpy(), np.asarray(jbt.to_val(jt)))
    np.testing.assert_array_equal(bt.to_float(tt).numpy(),
                                  np.asarray(jbt.to_float(jt)))
    # an integer tensor is taken as already quantized, and has no qp
    q = bt.to_val(tt)
    ti = bt.to_bit(q, nbits, pack_axis=pack_axis)
    assert ti.qp is None and torch.equal(ti.data, tt.data)
    np.testing.assert_array_equal(bt.to_float(ti).numpy(), q.numpy().astype(np.float32))


def test_bittensor_from_reference_fields():
    x = np.random.default_rng(1).normal(size=(6, 40)).astype(np.float32)
    jt = jbt.to_bit(jnp.asarray(x), 5, pack_axis=1)
    tt = _from_ref(jt)
    assert torch.equal(tt.data, bt.to_bit(torch.as_tensor(x), 5, pack_axis=1).data)
    np.testing.assert_array_equal(bt.to_float(tt).numpy(), np.asarray(jbt.to_float(jt)))
    ja = jbt.to_bit(jnp.asarray((x > 0).astype(np.int32)), 1, pack_axis=1)
    assert _from_ref(ja).qp is None


# ------------------------------------------------------------------ bitmm2int

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("s,t", [(1, 1), (1, 8), (2, 4), (3, 5), (8, 8)])
def test_bitmm2int_exact_on_every_engine(engine, s, t):
    a, b = _pair(s, t, m=11, k=100, n=7)
    ta = bt.to_bit(torch.as_tensor(a), s, pack_axis=1)
    tb = bt.to_bit(torch.as_tensor(b), t, pack_axis=0)
    got = bt.bitmm2int(ta, tb, backend=engine)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b)
    with api.use(engine):
        np.testing.assert_array_equal(qgemm(torch.as_tensor(a), torch.as_tensor(b),
                                            s, t).numpy(), a.astype(np.int64) @ b)


def test_bitmm2int_checks_layout():
    def ones(shape, axis):
        return bt.to_bit(torch.ones(shape, dtype=torch.int32), 1, pack_axis=axis)

    with pytest.raises(ValueError, match="packed along K"):
        bt.bitmm2int(ones((4, 40), 1), ones((40, 4), 1))
    with pytest.raises(ValueError, match="inner dims"):
        bt.bitmm2int(ones((4, 40), 1), ones((30, 4), 0))
    with pytest.raises(ValueError, match="rank-2"):
        bt.bitmm2int(ones((4, 40), 1), ones((40,), 0))


@pytest.mark.parametrize("engine", ["torch_dot", "popcount"])
def test_wide_bitwidths_exact_where_the_reference_is(engine):
    """The >8-bit repair: a 12-bit x 10-bit product is exact on torch_dot
    and popcount and equals the reference's bitmm2int. The cuda engine
    raises when named with ``backend=``; its fallback is tested in
    test_wide_bitwidths_fall_back_off_the_kernel_engine."""
    a, b = _pair(12, 10, m=5, k=40, n=4, seed=8)
    jwant = np.asarray(jbt.bitmm2int(jbt.to_bit(jnp.asarray(a), 12, pack_axis=1),
                                     jbt.to_bit(jnp.asarray(b), 10, pack_axis=0),
                                     backend="popcount"))
    ta = bt.to_bit(torch.as_tensor(a), 12, pack_axis=1)
    tb = bt.to_bit(torch.as_tensor(b), 10, pack_axis=0)
    got = bt.bitmm2int(ta, tb, backend=engine)
    np.testing.assert_array_equal(got.numpy(), jwant)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b)
    vals = api.bitserial_mm(torch.as_tensor(a), torch.as_tensor(b), 12, 10,
                            backend=engine)
    np.testing.assert_array_equal(vals.numpy(), jwant)
    with pytest.raises(api.UnsupportedOpError, match="s=12, t=10"):
        bt.bitmm2int(ta, tb, backend="cuda")
    with pytest.raises(api.UnsupportedOpError, match="s=12, t=10"):
        api.bitserial_mm(torch.as_tensor(a), torch.as_tensor(b), 12, 10,
                         backend="cuda")


def _wide_case(s, t, m, k, n):
    """Operands for torch_dot's card route: whole int32s at 32 bits (the
    first case, default_rng(0) at 4 x 16 x 4, is the input where a float64
    product is wrong in all 16 entries), unsigned values below."""
    rng = np.random.default_rng(0)
    lo_a, hi_a = (-2**31, 2**31) if s == 32 else (0, 1 << s)
    lo_b, hi_b = (-2**31, 2**31) if t == 32 else (0, 1 << t)
    return (rng.integers(lo_a, hi_a, (m, k)).astype(np.int32),
            rng.integers(lo_b, hi_b, (k, n)).astype(np.int32))


TORCH_DOT_CARD_CASES = [(32, 32, (4, 16, 4)), (24, 24, (20, 4096, 12)),
                        (8, 8, (37, 333, 5)), (1, 8, (8, 65, 9))]


@pytest.mark.parametrize("s,t,shape", TORCH_DOT_CARD_CASES)
def test_torch_dot_card_route_exact_on_cpu_tensors(s, t, shape):
    """torch_dot's card route (7-bit limbs through int8 x int8 -> int32
    ``torch._int_mm``), run on CPU tensors, equals the exact product wrapped
    to int32 and the reference's xla_dot, whose int32 dot wraps the same
    way; so does the engine itself (its int64 CPU branch)."""
    from repro_torch.api.backends import int_matmul_mod32

    a, b = _wide_case(s, t, *shape)
    want = (a.astype(np.int64) @ b.astype(np.int64)).astype(np.int32)
    got = bitops.wrap_int32(int_matmul_mod32(torch.as_tensor(a),
                                             torch.as_tensor(b), s, t))
    np.testing.assert_array_equal(got.numpy(), want)
    jwant = np.asarray(japi.bitserial_mm(jnp.asarray(a), jnp.asarray(b), s, t,
                                         backend="xla_dot"))
    np.testing.assert_array_equal(jwant, want)
    eng = api.bitserial_mm(torch.as_tensor(a), torch.as_tensor(b), s, t,
                           backend="torch_dot")
    np.testing.assert_array_equal(eng.numpy(), want)
    if s == t == 32:  # what the float64 route gave: wrong in every entry
        f64 = (a.astype(np.float64) @ b.astype(np.float64))
        low = np.asarray([int(v) % 2**32 for v in f64.ravel()], np.uint64)
        assert (low.astype(np.uint32).view(np.int32) != want.ravel()).all()


def test_torch_dot_card_route_splits_k(monkeypatch):
    """K beyond the int32 accumulator's safe length runs in chunks; the
    padding to _int_mm's CUDA shape rules (rows > 16, K and N multiples of
    8) is cropped away."""
    from repro_torch.api import backends

    monkeypatch.setattr(backends, "_K_CHUNK", 16)
    a, b = _wide_case(32, 7, 3, 70, 5)
    want = (a.astype(np.int64) @ b.astype(np.int64)).astype(np.int32)
    got = bitops.wrap_int32(backends.int_matmul_mod32(
        torch.as_tensor(a), torch.as_tensor(b), 32, 7))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tuple(got.shape) == (3, 5)


def test_wide_bitwidths_fall_back_off_the_kernel_engine(monkeypatch):
    """With no ``backend=``, a 12-bit x 10-bit product on the default cuda
    engine falls back to torch_dot, the first registered engine that takes
    it, with one RuntimeWarning, and is the exact ``a @ b``, as in the
    reference."""
    monkeypatch.setattr(registry, "_warned_fallbacks", set())
    a, b = _pair(12, 10, m=5, k=40, n=4, seed=8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jwant = np.asarray(japi.bitserial_mm(jnp.asarray(a), jnp.asarray(b), 12, 10))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = api.bitserial_mm(ta, tb, 12, 10)
        again = qgemm(ta, tb, 12, 10)
        packed = bt.bitmm2int(bt.to_bit(ta, 12, pack_axis=1),
                              bt.to_bit(tb, 10, pack_axis=0))
    assert [str(w.message) for w in seen] == [
        "backend 'cuda' does not support bitserial_mm with s=12, t=10; "
        "falling back to 'torch_dot'"]
    assert all(w.category is RuntimeWarning for w in seen)
    for y in (got, again, packed):
        assert y.dtype == torch.int32
        np.testing.assert_array_equal(y.numpy(), a.astype(np.int64) @ b)
    np.testing.assert_array_equal(got.numpy(), jwant)
    # within 8 bits the default engine serves the op itself: no warning
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        api.bitserial_mm(ta & 255, tb & 255, 8, 8)


@pytest.mark.parametrize("jump", ["none", "compact", "sgt"])
@pytest.mark.parametrize("s,t", [(1, 8), (3, 2)])
def test_reuse_false_equals_reuse_true(s, t, jump):
    a, b = _pair(s, t, m=20, k=200, n=10)
    a[:, 64:] = 0  # zero tiles for the jump schedules to skip
    ta = bt.to_bit(torch.as_tensor(a), s, pack_axis=1)
    tb = bt.to_bit(torch.as_tensor(b), t, pack_axis=0)
    want = bt.bitmm2int(ta, tb, policy=api.ExecutionPolicy(jump=jump))
    got = bt.bitmm2int(ta, tb, policy=api.ExecutionPolicy(jump=jump, reuse=False))
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b)


# ------------------------------------------------------------------ bitmm2bit

@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("out_bits", [8, 4, 2])
def test_bitmm2bit_matches_reference(out_bits, fused):
    """bitmm2bit, fused and unfused, against the reference's on its pallas
    backend (interpret mode), from the same quantized operands and the same
    output quantization parameters."""
    rng = np.random.default_rng(out_bits)
    x = rng.normal(size=(12, 96)).astype(np.float32)
    w = rng.normal(size=(96, 16)).astype(np.float32)
    jx = jbt.to_bit(jnp.asarray(x), 4, pack_axis=1)
    jw = jbt.to_bit(jnp.asarray(w), 3, pack_axis=0)
    acc = np.asarray(jbt.bitmm2int(jx, jw, backend="popcount")).astype(np.float32)
    jqp = jcalibrate(jnp.asarray(acc), out_bits)
    qp = QuantParams(out_bits, torch.tensor(np.asarray(jqp.scale)),
                     torch.tensor(np.asarray(jqp.zero)))
    jpol = japi.ExecutionPolicy(fused_requantize=fused, interpret=True)
    pol = api.ExecutionPolicy(fused_requantize=fused)
    jout = jbt.bitmm2bit(jx, jw, out_bits, jqp, backend="pallas", policy=jpol)
    out = bt.bitmm2bit(_from_ref(jx), _from_ref(jw), out_bits, qp, policy=pol)
    assert (out.nbits, out.shape, out.pack_axis) == (jout.nbits, jout.shape, 1)
    np.testing.assert_array_equal(_words(out.data), np.asarray(jout.data))
    np.testing.assert_array_equal(bt.to_val(out).numpy(), np.asarray(jbt.to_val(jout)))
    # and with calibration left to bitmm2bit (unfused either way)
    jout = jbt.bitmm2bit(jx, jw, out_bits, backend="pallas", policy=jpol)
    out = bt.bitmm2bit(_from_ref(jx), _from_ref(jw), out_bits, policy=pol)
    np.testing.assert_array_equal(bt.to_val(out).numpy(), np.asarray(jbt.to_val(jout)))
    np.testing.assert_array_equal(out.qp.scale.numpy(), np.asarray(jout.qp.scale))


@pytest.mark.parametrize("engine", ENGINES)
def test_bitmm2bit_fused_equal_on_every_engine(engine):
    a, b = _pair(3, 2, m=17, k=130, n=12, seed=5)
    ta = bt.to_bit(torch.as_tensor(a), 3, pack_axis=1)
    tb = bt.to_bit(torch.as_tensor(b), 2, pack_axis=0)
    acc = torch.as_tensor(a.astype(np.int64) @ b).to(torch.float32)
    qp = calibrate(acc, 4)
    pol = api.ExecutionPolicy(fused_requantize=True)
    want = bt.bitmm2bit(ta, tb, 4, qp, backend="popcount", policy=pol)
    got = bt.bitmm2bit(ta, tb, 4, qp, backend=engine, policy=pol)
    assert torch.equal(got.data, want.data)
    # fused and unfused agree within one quantization level
    unfused = bt.bitmm2bit(ta, tb, 4, qp, backend=engine)
    assert int((bt.to_val(got) - bt.to_val(unfused)).abs().max()) <= 1


# ------------------------------------------- dispatchers (reference equivalences)

@pytest.mark.parametrize("engine", ENGINES)
def test_packed_path_matches_vals_path(engine):
    s, t = 3, 2
    a, b = _pair(s, t, m=11, k=100, n=7)
    ta = bt.to_bit(torch.as_tensor(a), s, pack_axis=1)
    tb = bt.to_bit(torch.as_tensor(b), t, pack_axis=0)
    with api.use(engine):
        got = bt.bitmm2int(ta, tb)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b)
    np.testing.assert_array_equal(
        api.bitserial_mm(torch.as_tensor(a), torch.as_tensor(b), s, t,
                         backend=engine).numpy(), got.numpy())


@pytest.mark.parametrize("engine", ENGINES)
def test_bgemm_equivalence(engine):
    rng = np.random.default_rng(5)
    a = (rng.random((40, 200)) < 0.2).astype(np.int32)
    b = (rng.random((200, 24)) < 0.5).astype(np.int32)
    ap = bitops.pack_a(torch.as_tensor(a), 1)[0]
    bp = bitops.pack_b(torch.as_tensor(b), 1)[0]
    got = api.bgemm(ap, bp, backend=engine)
    want = np.asarray(japi.bgemm(jbitops.pack_a(jnp.asarray(a), 1)[0],
                                 jbitops.pack_b(jnp.asarray(b), 1)[0],
                                 backend="pallas"))
    np.testing.assert_array_equal(got.numpy(), a @ b)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("engine", ENGINES)
def test_bitpack_equivalence(engine):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(13, 70)).astype(np.float32)
    jqp = jcalibrate(jnp.asarray(x), 5)
    want = np.asarray(japi.bitpack(jnp.asarray(x), jqp.scale, jqp.zero, nbits=5,
                                   backend="pallas"))
    qp = calibrate(torch.as_tensor(x), 5)
    got = api.bitpack(torch.as_tensor(x), qp.scale, qp.zero, nbits=5,
                      backend=engine)
    # every engine emits (nbits, M, ceil(K/32)), as the reference's do
    assert got.shape == want.shape == (5, 13, 3)
    np.testing.assert_array_equal(_words(got), want)
    # and equals to_bit's packing of the same quantization, word for word
    assert torch.equal(got, bt.to_bit(torch.as_tensor(x), 5, qp, pack_axis=1).data)


@pytest.mark.parametrize("engine", ENGINES)
def test_bitserial_fused_equivalence(engine):
    s, t, m, k, n = 2, 3, 16, 96, 24
    a, b = _pair(s, t, m=m, k=k, n=n, seed=3)
    rng = np.random.default_rng(4)
    alpha = (rng.random((m, 1)) * 0.01).astype(np.float32)
    beta = rng.random((1, n)).astype(np.float32)
    want = np.asarray(jref.bitserial_fused_ref(
        jbitops.pack_a(jnp.asarray(a), s), jbitops.pack_b(jnp.asarray(b), t),
        jnp.asarray(alpha), jnp.asarray(beta), 4, True))
    got = api.bitserial_fused(bitops.pack_a(torch.as_tensor(a), s),
                              bitops.pack_b(torch.as_tensor(b), t),
                              torch.as_tensor(alpha), torch.as_tensor(beta),
                              out_bits=4, relu=True, backend=engine)
    np.testing.assert_array_equal(got.numpy(), want)


def test_new_ops_are_probed_capabilities():
    for name in ENGINES:
        be = api.get_backend(name)
        for op in ("bgemm", "bitpack", "bitserial_fused"):
            assert op in api.OPS and be.supports(op, s=8, t=8), (name, op)
    assert not api.get_backend("cuda").supports("bitpack", s=9, t=9)
    assert api.get_backend("popcount").supports("bitpack", s=32, t=32)
