"""Port parity: core numerics of repro_torch against the JAX reference.

Packed words, occupancy and jump artifacts must match the reference bit
for bit at the same (block_m, block_w) grid; calibration and quantization
too; the affine correction within rtol = atol = 1e-6 (float32 rounding of
one fused expression).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import bitops as jbitops  # noqa: E402
from repro.core import quantize as jquant  # noqa: E402
from repro.core import zerotile as jzt  # noqa: E402
from repro.kernels import sgt as jsgt  # noqa: E402
from repro_torch.core import bitops, quantize, zerotile  # noqa: E402
from repro_torch.kernels import sgt  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch thread
    each keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BITS = list(range(1, 9))


def _u32(t):
    """Port words (int32 bit patterns) -> the reference's uint32 words."""
    return t.numpy().view(np.uint32)


def _operand(rng, m, k, bits, pattern):
    a = rng.integers(0, 1 << bits, (m, k)).astype(np.int32)
    if pattern == "zero":
        return np.zeros_like(a)
    if pattern == "block_diag":
        out = np.zeros_like(a)
        sm, sk = max(m // 4, 1), max(k // 4, 1)
        for i in range(4):
            out[i * sm:(i + 1) * sm, i * sk:(i + 1) * sk] = \
                a[i * sm:(i + 1) * sm, i * sk:(i + 1) * sk]
        return out
    return a


@pytest.mark.parametrize("bits", BITS)
def test_pack_unpack_match_reference(bits):
    rng = np.random.default_rng(bits)
    a = rng.integers(0, 1 << bits, (13, 100)).astype(np.int32)
    b = rng.integers(0, 1 << bits, (100, 7)).astype(np.int32)
    ja, jb = jbitops.pack_a(jnp.asarray(a), bits), jbitops.pack_b(jnp.asarray(b), bits)
    ta, tb = bitops.pack_a(torch.as_tensor(a), bits), bitops.pack_b(torch.as_tensor(b), bits)
    np.testing.assert_array_equal(_u32(ta), np.asarray(ja))
    np.testing.assert_array_equal(_u32(tb), np.asarray(jb))
    # every plane round-trips, including words with bit 31 set
    np.testing.assert_array_equal(
        bitops.unpack_along_axis(ta, dim=2, size=100).numpy(),
        np.asarray(jbitops.unpack_along_axis(ja, axis=2, size=100)))
    np.testing.assert_array_equal(
        bitops.bit_compose(bitops.bit_decompose(torch.as_tensor(a), bits)).numpy(), a)


def test_np_pack_words_matches_reference():
    bits = np.random.default_rng(0).integers(0, 2, (5, 77)).astype(np.int32)
    np.testing.assert_array_equal(bitops.np_pack_words(bits),
                                  jbitops.np_pack_words(bits))


def test_popcount32_counts_high_bit_words():
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0xDEADBEEF, 0x7FFFFFFF],
                     dtype=np.uint32)
    got = bitops.popcount32(torch.as_tensor(words.view(np.int32))).numpy()
    want = [bin(int(w)).count("1") for w in words]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s,t", [(1, 1), (1, 8), (3, 5), (8, 8)])
def test_packed_oracles_match_reference(s, t):
    rng = np.random.default_rng(s * 10 + t)
    a = rng.integers(0, 1 << s, (9, 70)).astype(np.int32)
    b = rng.integers(0, 1 << t, (70, 11)).astype(np.int32)
    ja, jb = jbitops.pack_a(jnp.asarray(a), s), jbitops.pack_b(jnp.asarray(b), t)
    ta, tb = bitops.pack_a(torch.as_tensor(a), s), bitops.pack_b(torch.as_tensor(b), t)
    np.testing.assert_array_equal(
        bitops.bitserial_matmul_packed(ta, tb).numpy(),
        np.asarray(jbitops.bitserial_matmul_packed(ja, jb)))
    np.testing.assert_array_equal(
        bitops.popcount_matmul_packed(ta[0], tb[0]).numpy(),
        np.asarray(jbitops.popcount_matmul_packed(ja[0], jb[0])))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("pattern", ["random", "block_diag", "zero"])
def test_jump_artifacts_match_reference(bits, pattern):
    rng = np.random.default_rng(bits)
    a = _operand(rng, 44, 900, bits, pattern)
    ja = jbitops.pack_a(jnp.asarray(a), bits)
    ta = bitops.pack_a(torch.as_tensor(a), bits)
    bm, bw = 8, 4
    ja_pad = jbitops.pad_to(jbitops.pad_to(ja, 1, bm), 2, bw)
    ta_pad = bitops.pad_to(bitops.pad_to(ta, 1, bm), 2, bw)
    occ = zerotile.tile_occupancy_planes(ta_pad, bm, bw)
    np.testing.assert_array_equal(
        occ.numpy(), np.asarray(jzt.tile_occupancy_planes(ja_pad, bm, bw)))
    for got, want in zip(zerotile.compact_artifacts(ta, bm, bw),
                         jzt.compact_artifacts(ja, bm, bw)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(sgt.word_occupancy(ta_pad, bm).numpy(),
                                  np.asarray(jsgt.word_occupancy(ja_pad, bm)))
    got, want = sgt.sgt_artifacts(ta, bm), jsgt.sgt_artifacts(ja, bm)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2:] == want[2:]
    assert zerotile.occupancy_stats(occ) == jzt.occupancy_stats(
        jzt.tile_occupancy_planes(ja_pad, bm, bw))


def test_occupancy_rejects_unpadded_plane():
    with pytest.raises(ValueError, match="tile grid"):
        zerotile.tile_occupancy(torch.zeros((10, 8), dtype=torch.int32), 8, 4)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("dim", [None, 1])
def test_calibrate_quantize_bit_exact(bits, dim):
    x = np.random.default_rng(bits).normal(size=(37, 29)).astype(np.float32) * 3
    jqp = jquant.calibrate(jnp.asarray(x), bits, axis=dim)
    tqp = quantize.calibrate(torch.as_tensor(x), bits, dim=dim)
    np.testing.assert_array_equal(tqp.scale.numpy(), np.asarray(jqp.scale))
    np.testing.assert_array_equal(tqp.zero.numpy(), np.asarray(jqp.zero))
    assert tqp.qmax == jqp.qmax
    tq = quantize.quantize(torch.as_tensor(x), tqp)
    assert tq.dtype == torch.int32
    np.testing.assert_array_equal(tq.numpy(),
                                  np.asarray(jquant.quantize(jnp.asarray(x), jqp)))
    np.testing.assert_allclose(
        quantize.dequantize(tq, tqp).numpy(),
        np.asarray(jquant.dequantize(jnp.asarray(tq.numpy()), jqp)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s,t", [(2, 2), (4, 8), (8, 8)])
def test_affine_matmul_correction_matches_reference(s, t):
    rng = np.random.default_rng(s + t)
    x = rng.normal(size=(16, 40)).astype(np.float32)
    w = rng.normal(size=(40, 12)).astype(np.float32)
    jqa, jqb = jquant.calibrate(jnp.asarray(x), s), jquant.calibrate(jnp.asarray(w), t)
    xq = np.asarray(jquant.quantize(jnp.asarray(x), jqa))
    wq = np.asarray(jquant.quantize(jnp.asarray(w), jqb))
    prod = (xq.astype(np.int64) @ wq).astype(np.int32)
    want = jquant.affine_matmul_correction(jnp.asarray(xq), jnp.asarray(wq), jqa,
                                           jqb, jnp.asarray(prod))
    tqa = quantize.calibrate(torch.as_tensor(x), s)
    tqb = quantize.calibrate(torch.as_tensor(w), t)
    got = quantize.affine_matmul_correction(torch.as_tensor(xq), torch.as_tensor(wq),
                                            tqa, tqb, torch.as_tensor(prod))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
