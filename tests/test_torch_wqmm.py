"""Port parity for weight-only quantization: ``repro_torch.kernels.wqmm``
(``pack_w4``, the plain version of the 4-bit ``wq_gemm``),
``kernels.ops.wq_gemm``, ``core.qgemm`` (``WeightQ``, ``weight_quantize``,
``wq_matmul``), ``api.wq_mm`` and ``api.nn`` (``wq_linear``,
``quantize_lm_params``), against the reference on the same numpy inputs.

Tolerances:
- bit-equal: the packed bytes and scales of ``pack_w4``, every field of
  ``WeightQ`` (planes compared as uint32), the dequantized leaves of
  ``quantize_lm_params`` (the same IEEE float32 steps on both sides);
- rtol 1e-5, atol 1e-5, the reference test's own tolerance
  (``tests/test_kernels.py::test_wq_gemm_4bit_weight_matmul``), for the
  float products at the reference test's shapes (K <= 256) and for the
  weight-only layers: the two packages sum in different orders;
- at the larger ragged shapes, the float32 dot-product error bound
  K * 2^-24 * (|x| @ |W|) around a float64 product of the same dequantized
  weight, for the port and for the reference alike (it holds in any
  summation order; a fixed rtol does not, once K grows and terms cancel).

The reference's Pallas ``wq_gemm`` runs in interpret mode, as its own tests
run it on the CPU. The CUDA kernel is held against the plain version on the
card in tests/test_torch_cuda.py.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.api import nn as jnn  # noqa: E402
from repro.core.qgemm import weight_dequantize as jweight_dequantize  # noqa: E402
from repro.core.qgemm import weight_quantize as jweight_quantize  # noqa: E402
from repro.core.qgemm import wq_matmul as jwq_matmul  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import wqmm as jwqmm  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import nn, registry  # noqa: E402
from repro_torch.convert import weightq_from_jax  # noqa: E402
from repro_torch.core.qgemm import (weight_dequantize, weight_quantize,  # noqa: E402
                                    wq_matmul)
from repro_torch.kernels import ops, wqmm  # noqa: E402
from repro_torch.kernels._build import LAUNCHES  # noqa: E402

RTOL = ATOL = 1e-5
# the reference test's shapes (tests/test_kernels.py), (M, K, N)
SHAPES = [(1, 128, 256), (8, 256, 512), (5, 160, 64)]
X_DTYPES = ["float32", "bfloat16"]


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


def _x(rng, m, k, dtype):
    """x as a torch tensor and as the numpy float32 of the same values; a
    bf16 x is rounded once, in torch, and both packages get its values."""
    xt = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32))
    if dtype == "bfloat16":
        xt = xt.to(torch.bfloat16)
    return xt, xt.to(torch.float32).numpy()


def _jx(x_np, dtype):
    return jnp.asarray(x_np, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _packed(rng, k, n, group):
    """The reference's pack_w4 of a random weight, and the port's copy."""
    w = rng.normal(size=(k, n)).astype(np.float32)
    jwp, js = jwqmm.pack_w4(jnp.asarray(w), group=group)
    return (np.asarray(jwp), np.asarray(js),
            torch.tensor(np.asarray(jwp)), torch.tensor(np.asarray(js)))


# ------------------------------------------------------------------ pack_w4

@pytest.mark.parametrize("k,n", [(128, 256), (160, 64), (96, 6), (416, 300)])
@pytest.mark.parametrize("group", [32, 16])
def test_pack_w4_bit_equal_to_reference(k, n, group):
    rng = np.random.default_rng(k + n + group)
    w = rng.normal(size=(k, n)).astype(np.float32)
    w[:group, 0] = 0.0  # an all-zero group: the scale is eps alone
    w[group:2 * group, 1] = 7.0 * np.arange(group) / 2  # exact .5 ties
    jwp, js = jwqmm.pack_w4(jnp.asarray(w), group=group)
    wp, s = wqmm.pack_w4(torch.as_tensor(w), group=group)
    assert wp.dtype == torch.uint8 and s.dtype == torch.float32
    np.testing.assert_array_equal(wp.numpy(), np.asarray(jwp))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_pack_w4_rejects_what_it_cannot_pack():
    with pytest.raises(ValueError, match="N even"):
        wqmm.pack_w4(torch.zeros((64, 5)), group=32)
    with pytest.raises(ValueError, match="group=32"):
        wqmm.pack_w4(torch.zeros((48, 4)), group=32)


# ---------------------------------------------------------------- wq_gemm

@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("group", [32, 16])
@pytest.mark.parametrize("dtype", X_DTYPES)
def test_wq_gemm_plain_matches_reference(m, k, n, group, dtype):
    rng = np.random.default_rng(m * 7 + k + n + group)
    xt, x_np = _x(rng, m, k, dtype)
    jwp, js, wp, s = _packed(rng, k, n, group)
    got = wqmm.wq_gemm_plain(xt, wp, s, group=group).numpy()
    jx = _jx(x_np, dtype)
    kernel = jops.wq_gemm(jx, jnp.asarray(jwp), jnp.asarray(js), group=group)
    oracle = jref.wq_gemm_ref(jx, jnp.asarray(jwp), jnp.asarray(js), group=group)
    assert got.shape == (m, n)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=RTOL, atol=ATOL)
    # through the public wrapper (K padded to block_k, the plain version)
    np.testing.assert_allclose(ops.wq_gemm(xt, wp, s, group=group).numpy(),
                               np.asarray(kernel), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m,k,n", [(13, 416, 300), (1, 96, 6), (33, 64, 514)])
@pytest.mark.parametrize("group", [32, 16])
@pytest.mark.parametrize("blocks", [(8, 256, 128), (1, 64, 32), (32, 128, 64)])
def test_ops_wq_gemm_pads_ragged_shapes(m, k, n, group, blocks):
    """Ragged M, N and K at several tile sizes, through ``ops.wq_gemm`` on
    the CPU: K is padded with zero weights and zero scales, M and N come
    back as they went in."""
    block_m, block_n, block_k = blocks
    rng = np.random.default_rng(m + k + n + group + block_k)
    xt, x_np = _x(rng, m, k, "float32")
    jwp, js, wp, s = _packed(rng, k, n, group)
    got = ops.wq_gemm(xt, wp, s, group=group, block_m=block_m,
                      block_n=block_n, block_k=block_k)
    want = jref.wq_gemm_ref(jnp.asarray(x_np), jnp.asarray(jwp),
                            jnp.asarray(js), group=group)
    assert got.shape == (m, n) and got.dtype == torch.float32
    w_deq = wqmm.unpack_w4(wp, s, group).numpy().astype(np.float64)
    exact = x_np.astype(np.float64) @ w_deq
    bound = k * 2.0 ** -24 * (np.abs(x_np.astype(np.float64)) @ np.abs(w_deq))
    assert np.all(np.abs(got.numpy() - exact) <= bound)
    assert np.all(np.abs(np.asarray(want) - exact) <= bound)


def test_wq_gemm_rejects_what_it_cannot_take():
    x = torch.zeros((2, 96))
    wp = torch.zeros((96, 4), dtype=torch.uint8)
    s = torch.zeros((3, 8))
    with pytest.raises(ValueError, match="group=32"):
        ops.wq_gemm(x, wp, s, group=32, block_k=48)  # block_k % group
    with pytest.raises(ValueError, match="group=64"):
        ops.wq_gemm(x, wp, torch.zeros((1, 8)), group=64)  # K % group
    with pytest.raises(ValueError, match="scales"):
        ops.wq_gemm(x, wp, torch.zeros((4, 8)), group=32)
    with pytest.raises(ValueError, match="block_n"):
        ops.wq_gemm(x, wp, s, group=32, block_n=255)
    # the kernel's own wrapper takes K padded to block_k only
    with pytest.raises(ValueError, match="block_k"):
        wqmm.wq_gemm(x, wp, s, group=32, block_m=8, block_n=256, block_k=128)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.wq_gemm(x.to("meta"), wp.to("meta"), s.to("meta"), group=32)


# ----------------------------------------------- WeightQ and weight_quantize

def _jweightq_fields(jw):
    return (np.asarray(jw.data), np.asarray(jw.scale), np.asarray(jw.zero),
            jw.nbits, None if jw.packed is None else np.asarray(jw.packed))


@pytest.mark.parametrize("nbits", [2, 4, 8])
@pytest.mark.parametrize("k,n", [(64, 16), (70, 9)])
def test_weight_quantize_bit_equal_to_reference(nbits, k, n):
    rng = np.random.default_rng(nbits * 10 + k)
    w = rng.normal(size=(k, n)).astype(np.float32)
    jw = jweight_quantize(jnp.asarray(w), nbits, keep_packed=True)
    pw = weight_quantize(torch.as_tensor(w), nbits, keep_packed=True)
    assert pw.data.dtype == torch.int8 and pw.packed.dtype == torch.int32
    assert pw.scale.shape == pw.zero.shape == (1, n)
    np.testing.assert_array_equal(pw.data.numpy(), np.asarray(jw.data))
    np.testing.assert_array_equal(pw.scale.numpy(), np.asarray(jw.scale))
    np.testing.assert_array_equal(pw.zero.numpy(), np.asarray(jw.zero))
    np.testing.assert_array_equal(pw.packed.numpy().view(np.uint32),
                                  np.asarray(jw.packed))
    np.testing.assert_array_equal(weight_dequantize(pw).numpy(),
                                  np.asarray(jweight_dequantize(jw)))
    # the reference's state, carried across, is the same WeightQ
    carried = weightq_from_jax(*_jweightq_fields(jw), device="cpu")
    for a, b in ((carried.data, pw.data), (carried.scale, pw.scale),
                 (carried.zero, pw.zero), (carried.packed, pw.packed)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert weight_quantize(torch.as_tensor(w), nbits).packed is None


def test_weight_quantize_rejects_above_8_bits():
    with pytest.raises(ValueError, match="nbits <= 8"):
        weight_quantize(torch.zeros((4, 4)), 9)


# ------------------------------------------- wq_mm, wq_matmul and wq_linear

def _weightq_pair(rng, k, n, nbits):
    w = rng.normal(size=(k, n)).astype(np.float32)
    jw = jweight_quantize(jnp.asarray(w), nbits)
    return jw, weightq_from_jax(*_jweightq_fields(jw), device="cpu")


@pytest.mark.parametrize("nbits", [2, 4, 8])
@pytest.mark.parametrize("x_shape", [(4, 64), (2, 3, 64)])
@pytest.mark.parametrize("engine", ["torch_dot", "cuda"])
def test_wq_mm_matches_reference_xla_dot(nbits, x_shape, engine):
    rng = np.random.default_rng(nbits + len(x_shape))
    jw, pw = _weightq_pair(rng, 64, 16, nbits)
    x = rng.normal(size=x_shape).astype(np.float32)
    jx, xt = jnp.asarray(x), torch.as_tensor(x)
    want = np.asarray(japi.wq_mm(jx, jw, out_dtype=jnp.float32,
                                 backend="xla_dot"))
    got = api.wq_mm(xt, pw, out_dtype=torch.float32, backend=engine)
    assert got.dtype == torch.float32 and got.shape == (*x_shape[:-1], 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    with api.use(engine):
        got = wq_matmul(xt, pw, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    bias = rng.normal(size=(16,)).astype(np.float32)
    want = np.asarray(jnn.wq_linear(jx, jw, bias=jnp.asarray(bias),
                                    out_dtype=jnp.float32, backend="xla_dot"))
    got = nn.wq_linear(xt, pw, bias=torch.as_tensor(bias),
                       out_dtype=torch.float32, backend=engine)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_wq_mm_default_dtype_is_bfloat16_as_in_the_reference():
    rng = np.random.default_rng(3)
    jw, pw = _weightq_pair(rng, 32, 8, 4)
    x = rng.normal(size=(2, 32)).astype(np.float32)
    want = np.asarray(jwq_matmul(jnp.asarray(x), jw,
                                       backend="xla_dot")).astype(np.float32)
    got = wq_matmul(torch.as_tensor(x), pw, backend="torch_dot")
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of float32 values that agree within 1e-5: at most
    # one bf16 step (2^-8 relative) apart
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                               rtol=2 ** -8, atol=ATOL)


def test_wq_mm_raises_on_an_engine_without_it(monkeypatch):
    """popcount lacks wq_mm: named with ``backend=`` it raises; as the
    context engine, dispatch falls back to torch_dot with one
    RuntimeWarning, as the reference's registry hands the call to xla_dot."""
    monkeypatch.setattr(registry, "_warned_fallbacks", set())
    rng = np.random.default_rng(0)
    _, pw = _weightq_pair(rng, 32, 8, 4)
    x = torch.as_tensor(rng.normal(size=(2, 32)).astype(np.float32))
    with pytest.raises(api.UnsupportedOpError, match="popcount"):
        api.wq_mm(x, pw, backend="popcount")
    want = wq_matmul(x, pw, backend="torch_dot")
    with api.use("popcount"), pytest.warns(
            RuntimeWarning, match="'popcount' does not support wq_mm.*'torch_dot'"):
        got = wq_matmul(x, pw)
    assert torch.equal(got, want)
    # the warning is given once per (engine, op, fallback)
    with api.use("popcount"), warnings.catch_warnings():
        warnings.simplefilter("error")
        assert torch.equal(nn.wq_linear(x, pw),
                           nn.wq_linear(x, pw, backend="torch_dot"))
    assert "wq_mm" in api.OPS
    assert api.get_backend("torch_dot").supports("wq_mm", s=8, t=8)
    assert api.get_backend("cuda").supports("wq_mm", s=4, t=4)
    assert not api.get_backend("popcount").supports("wq_mm")


def test_wq_mm_falls_back_as_the_reference_does(monkeypatch):
    """The reference's ``test_wq_mm_dispatch_and_fallback`` input: under
    ``use("popcount")`` both registries serve wq_matmul on their plain
    float engine, and the products agree within float32 rounding."""
    monkeypatch.setattr(registry, "_warned_fallbacks", set())
    rng = np.random.default_rng(9)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    w = rng.normal(size=(64, 16)).astype(np.float32)
    jw = jweight_quantize(jnp.asarray(w), 8)
    with japi.use("popcount"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = np.asarray(jwq_matmul(jnp.asarray(x), jw, out_dtype=jnp.float32))
    pw = weightq_from_jax(*_jweightq_fields(jw), device="cpu")
    with api.use("popcount"), warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = wq_matmul(torch.as_tensor(x), pw, out_dtype=torch.float32)
        again = wq_matmul(torch.as_tensor(x), pw, out_dtype=torch.float32)
    assert [str(w.message) for w in seen] == [
        "backend 'popcount' does not support wq_mm with s=8, t=8; "
        "falling back to 'torch_dot'"]
    assert got.shape == (4, 16) and torch.equal(got, again)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the port's weight_quantize gives the same WeightQ as the reference's
    with api.use("popcount"):
        mine = wq_matmul(torch.as_tensor(x), weight_quantize(torch.as_tensor(w), 8),
                         out_dtype=torch.float32)
    np.testing.assert_allclose(mine.numpy(), want, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------ quantize_lm_params

def _lm_params(rng):
    def w(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.02
    return {"embed": w(96, 64), "lm_head": w(64, 96),
            "layer0": {"wq": w(64, 72), "wo": w(72, 64), "norm": w(64),
                       "small": w(32, 32)}}


@pytest.mark.parametrize("nbits", [4, 8])
def test_quantize_lm_params_matches_reference(nbits):
    params = _lm_params(np.random.default_rng(nbits))
    jq, jstats = jnn.quantize_lm_params(
        {k: (jnp.asarray(v) if not isinstance(v, dict) else
             {kk: jnp.asarray(vv) for kk, vv in v.items()})
         for k, v in params.items()}, nbits=nbits)
    tq, tstats = nn.quantize_lm_params(
        {k: (torch.as_tensor(v) if not isinstance(v, dict) else
             {kk: torch.as_tensor(vv) for kk, vv in v.items()})
         for k, v in params.items()}, nbits=nbits)
    assert tstats == jstats
    assert tstats["n_quantized"] == 3  # lm_head, wq, wo; not embed, norm, small
    np.testing.assert_array_equal(tq["embed"].numpy(), params["embed"])
    np.testing.assert_array_equal(tq["lm_head"].numpy(), np.asarray(jq["lm_head"]))
    for name in ("wq", "wo", "norm", "small"):
        np.testing.assert_array_equal(tq["layer0"][name].numpy(),
                                      np.asarray(jq["layer0"][name]))
    assert not np.array_equal(tq["layer0"]["wq"].numpy(), params["layer0"]["wq"])


@pytest.mark.parametrize("skip", [("['blocks']['mlp']",), ("proj",), ()])
def test_quantize_lm_params_keys_follow_the_reference_keystr(skip):
    """``skip`` matches substrings of the path as jax.tree_util.keystr
    spells it: the same leaves are skipped in both packages."""
    rng = np.random.default_rng(1)
    params = {"blocks": {"embed_proj": rng.normal(size=(80, 80)).astype(np.float32),
                         "mlp": rng.normal(size=(80, 80)).astype(np.float32)}}
    jq, jstats = jnn.quantize_lm_params(
        {"blocks": {k: jnp.asarray(v) for k, v in params["blocks"].items()}},
        skip=skip)
    tq, tstats = nn.quantize_lm_params(
        {"blocks": {k: torch.as_tensor(v) for k, v in params["blocks"].items()}},
        skip=skip)
    assert tstats == jstats
    for name in ("embed_proj", "mlp"):
        np.testing.assert_array_equal(tq["blocks"][name].numpy(),
                                      np.asarray(jq["blocks"][name]))


# --------------------------------------------------------- the slice whole

def test_decode_projections_end_to_end_match_reference():
    """A narrow decode step's projections (q, k, v, o, gate, up, down, head)
    packed by both packages, each product through ``ops.wq_gemm`` against
    the reference's Pallas kernel in interpret mode, and ``wq_linear`` on a
    4-bit WeightQ of the same weights against xla_dot."""
    rng = np.random.default_rng(7)
    d, ff, vocab = 64, 96, 160
    shapes = {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
              "wg": (d, ff), "wu": (d, ff), "wd": (ff, d), "lm_head": (d, vocab)}
    for name, (k, n) in shapes.items():
        w = (rng.normal(size=(k, n)) * 0.02).astype(np.float32)
        x = rng.normal(size=(2, k)).astype(np.float32)
        jwp, js = jwqmm.pack_w4(jnp.asarray(w))
        wp, s = wqmm.pack_w4(torch.as_tensor(w))
        np.testing.assert_array_equal(wp.numpy(), np.asarray(jwp))
        want = np.asarray(jops.wq_gemm(jnp.asarray(x), jwp, js))
        got = ops.wq_gemm(torch.as_tensor(x), wp, s)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
        jw = jweight_quantize(jnp.asarray(w), 4)
        pw = weight_quantize(torch.as_tensor(w), 4)
        want = np.asarray(jnn.wq_linear(jnp.asarray(x), jw,
                                        out_dtype=jnp.float32, backend="xla_dot"))
        got = nn.wq_linear(torch.as_tensor(x), pw, out_dtype=torch.float32,
                           backend="torch_dot")
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
