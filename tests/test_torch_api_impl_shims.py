"""The reference's deprecated ``impl=`` shims in the port, held against the
reference on the same numpy inputs (``tests/test_api_dispatch.py``'s
deprecation-shim cases): ``api.backend_from_impl`` / ``shim_backend``, the
``impl=`` of ``core.qgemm.qgemm`` and ``core.bittensor.bitmm2int`` /
``bitmm2bit``, and ``core.bitops.bitserial_matmul`` /
``bitserial_matmul_planes`` / ``packing_ratio``.

The same int32 results (tolerance 0), the same warnings (a
``DeprecationWarning`` naming ``impl``) and the same errors. The reference's
impl strings map onto the port's engines: "dot" and "xla_dot" to
torch_dot, "popcount" to popcount, "pallas" to cuda (its plain version on
CPU tensors); any other string, "cuda" included, raises ``ValueError`` as
in the reference.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import bitops as jbitops  # noqa: E402
from repro.core import bittensor as jbt  # noqa: E402
from repro.core.qgemm import qgemm as jqgemm  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import bitops, bittensor as bt  # noqa: E402
from repro_torch.core.qgemm import qgemm  # noqa: E402

IMPLS = {"dot": ("xla_dot", "torch_dot"), "xla_dot": ("xla_dot", "torch_dot"),
         "popcount": ("popcount", "popcount"), "pallas": ("pallas", "cuda")}


def _pair(s, t, m, k, n, seed):
    """tests/test_api_dispatch.py's operands."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << s, (m, k)).astype(np.int32)
    b = rng.integers(0, 1 << t, (k, n)).astype(np.int32)
    return a, b


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_backend_from_impl_maps_as_the_reference(impl):
    ref_name, name = IMPLS[impl]
    with pytest.warns(DeprecationWarning, match="impl"):
        assert japi.backend_from_impl(impl, "f") == ref_name
    with pytest.warns(DeprecationWarning, match="impl"):
        assert api.backend_from_impl(impl, "f") == name
    assert name in api.list_backends()


@pytest.mark.parametrize("impl", ["cuda", "tensorrt", ""])
def test_unknown_impl_raises_in_both(impl):
    for mod in (japi, api):
        with pytest.raises(ValueError, match="unknown impl"):
            with pytest.warns(DeprecationWarning):
                mod.backend_from_impl(impl, "f")


def test_shim_backend_passes_backend_and_refuses_both():
    for mod, be in ((japi, "pallas"), (api, "cuda")):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert mod.shim_backend(None, be, "f") == be
            assert mod.shim_backend(None, None, "f") is None
        with pytest.raises(ValueError, match="not both"):
            mod.shim_backend("dot", be, "f")


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_qgemm_impl_shim_warns_and_routes(impl):
    a, b = _pair(2, 2, m=5, k=40, n=6, seed=1)
    want = a.astype(np.int64) @ b
    with pytest.warns(DeprecationWarning, match="impl"):
        ref = np.asarray(jqgemm(jnp.asarray(a), jnp.asarray(b), 2, 2,
                                impl=impl))
    with pytest.warns(DeprecationWarning, match="impl"):
        got = qgemm(_t(a), _t(b), 2, 2, impl=impl)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), want)


def test_qgemm_impl_shim_errors_as_the_reference():
    a, b = _pair(2, 2, m=5, k=40, n=6, seed=1)
    for fn, x, y, be in ((jqgemm, jnp.asarray(a), jnp.asarray(b), "pallas"),
                         (qgemm, _t(a), _t(b), "cuda")):
        with pytest.raises(ValueError, match="unknown impl"):
            with pytest.warns(DeprecationWarning):
                fn(x, y, 2, 2, impl="cuda")
        with pytest.raises(ValueError, match="not both"):
            fn(x, y, 2, 2, impl="dot", backend=be)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_bitmm_impl_shims_warn_and_route(impl):
    a, b = _pair(3, 2, m=6, k=50, n=5, seed=2)
    ja = jbt.to_bit(jnp.asarray(a), 3, pack_axis=1)
    jb = jbt.to_bit(jnp.asarray(b), 2, pack_axis=0)
    ta = bt.to_bit(_t(a), 3, pack_axis=1)
    tb = bt.to_bit(_t(b), 2, pack_axis=0)
    with pytest.warns(DeprecationWarning, match="impl"):
        ref = np.asarray(jbt.bitmm2int(ja, jb, impl=impl))
    with pytest.warns(DeprecationWarning, match="impl"):
        got = bt.bitmm2int(ta, tb, impl=impl)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b)
    with pytest.warns(DeprecationWarning, match="impl"):
        ref_q = jbt.bitmm2bit(ja, jb, 4, impl=impl)
    with pytest.warns(DeprecationWarning, match="impl"):
        got_q = bt.bitmm2bit(ta, tb, 4, impl=impl)
    np.testing.assert_array_equal(bt.to_val(got_q).numpy(),
                                  np.asarray(jbt.to_val(ref_q)))
    np.testing.assert_array_equal(bt.to_val(got_q).numpy(),
                                  bt.to_val(bt.bitmm2bit(ta, tb, 4)).numpy())


def test_bitmm_impl_shims_error_as_the_reference():
    a, b = _pair(3, 2, m=6, k=50, n=5, seed=2)
    for mod, x, y, be in (
            (jbt, jnp.asarray(a), jnp.asarray(b), "pallas"),
            (bt, _t(a), _t(b), "cuda")):
        ta, tb = mod.to_bit(x, 3, pack_axis=1), mod.to_bit(y, 2, pack_axis=0)
        for fn in (lambda **kw: mod.bitmm2int(ta, tb, **kw),
                   lambda **kw: mod.bitmm2bit(ta, tb, 4, **kw)):
            with pytest.raises(ValueError, match="unknown impl"):
                with pytest.warns(DeprecationWarning):
                    fn(impl="cuda")
            with pytest.raises(ValueError, match="not both"):
                fn(impl="dot", backend=be)


@pytest.mark.parametrize("s,t", [(1, 1), (2, 3), (8, 8), (4, 7)])
@pytest.mark.parametrize("impl", ["dot", "popcount"])
def test_bitserial_matmul_shim_matches_the_reference(s, t, impl):
    a, b = _pair(s, t, m=7, k=70, n=9, seed=s * 10 + t)
    with pytest.warns(DeprecationWarning, match="impl"):
        ref = np.asarray(jbitops.bitserial_matmul(jnp.asarray(a),
                                                  jnp.asarray(b), s, t,
                                                  impl=impl))
    with pytest.warns(DeprecationWarning, match="impl"):
        got = bitops.bitserial_matmul(_t(a), _t(b), s, t, impl=impl)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    planes = bitops.bitserial_matmul_planes(_t(a), _t(b), s, t)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(
        jbitops.bitserial_matmul_planes(jnp.asarray(a), jnp.asarray(b), s, t)))


@pytest.mark.parametrize("impl", ["xla_dot", "pallas", "cuda"])
def test_bitserial_matmul_shim_refuses_other_impls(impl):
    a, b = _pair(2, 2, m=4, k=33, n=3, seed=5)
    for mod, x, y in ((jbitops, jnp.asarray(a), jnp.asarray(b)),
                      (bitops, _t(a), _t(b))):
        with pytest.raises(ValueError, match="unknown impl"):
            with pytest.warns(DeprecationWarning, match="impl"):
                mod.bitserial_matmul(x, y, 2, 2, impl=impl)


@pytest.mark.parametrize("nbits,dtype_bits", [(1, 32), (3, 32), (8, 16),
                                              (5, 8)])
def test_packing_ratio_matches_the_reference(nbits, dtype_bits):
    assert bitops.packing_ratio(nbits, dtype_bits) == \
        jbitops.packing_ratio(nbits, dtype_bits)
    assert bitops.packing_ratio(nbits) == jbitops.packing_ratio(nbits)
