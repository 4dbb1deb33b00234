"""Port parity: the plain versions of the fused bit-serial GEMM, the 1-bit
GEMM and the bitpack quantizer, through ``repro_torch.kernels.ops``, against
the reference's Pallas kernels in interpret mode through
``repro.kernels.ops``, with the same explicit policy passed to both.

Tolerance 0: every int32 result and every packed word must be equal (words
compared as uint32). The CUDA kernels are held against these plain
versions on the card in tests/test_torch_cuda.py. Shapes stay small: Pallas
interpret retraces per shape and policy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.api.policy import ExecutionPolicy as JPolicy  # noqa: E402
from repro.core import bitops as jbitops  # noqa: E402
from repro.core import zerotile as jzt  # noqa: E402
from repro.core.quantize import calibrate as jcalibrate  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import sgt as jsgt  # noqa: E402
from repro_torch.api import ExecutionPolicy  # noqa: E402
from repro_torch.core import bitops, zerotile  # noqa: E402
from repro_torch.kernels import bgemm, bitpack, bitserial, ops, sgt  # noqa: E402
from repro_torch.kernels._build import LAUNCHES  # noqa: E402

# one tile grid both packages take: the reference wants block_n % 128 == 0,
# the port block_m * block_n <= 1024
GRID = dict(block_m=8, block_n=128, block_w=4)
JPOL = JPolicy(**GRID, interpret=True)
POL = ExecutionPolicy(**GRID)
SCHEDULES = ["none", "mask", "compact", "sgt"]


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


def _jump_kwargs(schedule, ap, artifacts):
    """The same schedule for either package: ``artifacts`` are the
    package's zerotile/sgt modules."""
    zt, sg = artifacts
    if schedule == "compact":
        return {"tiles": zt.compact_artifacts(ap, GRID["block_m"], GRID["block_w"])}
    if schedule == "sgt":
        return {"tiles": sg.sgt_artifacts(ap, GRID["block_m"])}
    return {"jump": schedule}


def _both_packed(a, b, s, t):
    ja, jb = jbitops.pack_a(jnp.asarray(a), s), jbitops.pack_b(jnp.asarray(b), t)
    ta, tb = bitops.pack_a(torch.as_tensor(a), s), bitops.pack_b(torch.as_tensor(b), t)
    return ja, jb, ta, tb


# ------------------------------------------------------------ bitserial_fused

@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("out_bits", [8, 4, 2])
def test_fused_plain_matches_pallas_interpret(out_bits, relu, schedule):
    rng = np.random.default_rng(out_bits * 10 + relu)
    s, t, m, k, n = 2, 3, 20, 300, 24
    a = _operand(rng, m, k, s, "block_diag")
    b = rng.integers(0, 1 << t, (k, n)).astype(np.int32)
    alpha = (rng.random((m, 1)) * 0.02).astype(np.float32)
    # negative shifts too, so that ReLU and the low clip both bite
    beta = (rng.random((1, n)) * 4 - 2).astype(np.float32)
    ja, jb, ta, tb = _both_packed(a, b, s, t)
    want = np.asarray(jops.bitserial_fused(
        ja, jb, jnp.asarray(alpha), jnp.asarray(beta), out_bits=out_bits,
        relu=relu, policy=JPOL, **_jump_kwargs(schedule, ja, (jzt, jsgt))))
    got = ops.bitserial_fused(ta, tb, torch.as_tensor(alpha),
                              torch.as_tensor(beta), out_bits=out_bits,
                              relu=relu, policy=POL,
                              **_jump_kwargs(schedule, ta, (zerotile, sgt)))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.min() >= 0 and want.max() <= (1 << out_bits) - 1


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_fused_all_zero_a_writes_the_epilogue_of_zero(schedule):
    """A row tile that visits no K tile still writes clip(floor(beta)),
    as the reference's regression test wants (2 where beta is 2.0)."""
    m, k, n = 16, 128, 24
    a = np.zeros((m, k), np.int32)
    b = np.random.default_rng(3).integers(0, 4, (k, n)).astype(np.int32)
    alpha = np.ones((m, 1), np.float32)
    beta = np.full((1, n), 2.0, np.float32)
    ja, jb, ta, tb = _both_packed(a, b, 2, 2)
    want = np.asarray(jops.bitserial_fused(
        ja, jb, jnp.asarray(alpha), jnp.asarray(beta), out_bits=4,
        policy=JPOL, **_jump_kwargs(schedule, ja, (jzt, jsgt))))
    got = ops.bitserial_fused(ta, tb, torch.as_tensor(alpha),
                              torch.as_tensor(beta), out_bits=4, policy=POL,
                              **_jump_kwargs(schedule, ta, (zerotile, sgt)))
    np.testing.assert_array_equal(want, 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_rounds_twice_as_the_reference():
    """acc * alpha + beta rounds after the product and after the sum, as
    the reference does. For these inputs one rounding (an FMA) lands just
    below 1 and floors a level lower."""
    alpha = np.float32(3 / 19)
    beta = np.float32(-2.0)
    assert np.floor(19.0 * np.float64(alpha) + np.float64(beta)) == 0
    want = np.floor(np.float32(np.float32(19) * alpha) + beta)
    assert want == 1
    got = bitserial.fused_epilogue(torch.tensor([[19]], dtype=torch.int32),
                                   torch.tensor([[alpha]]), torch.tensor([[beta]]),
                                   4, False)
    assert got.item() == want


# ---------------------------------------------------------------------- bgemm

@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("pattern", ["random", "block_diag", "zero"])
def test_bgemm_plain_matches_pallas_interpret(schedule, pattern):
    rng = np.random.default_rng(len(pattern))
    m, k, n = 20, 300, 18
    a = _operand(rng, m, k, 1, pattern)
    b = rng.integers(0, 2, (k, n)).astype(np.int32)
    ja, jb, ta, tb = _both_packed(a, b, 1, 1)
    want = np.asarray(jops.bgemm(ja[0], jb[0], policy=JPOL,
                                 **_jump_kwargs(schedule, ja[0], (jzt, jsgt))))
    got = ops.bgemm(ta[0], tb[0], policy=POL,
                    **_jump_kwargs(schedule, ta[0], (zerotile, sgt)))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, a.astype(np.int64) @ b)


def test_bgemm_tiles_contract():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2, (16, 256)).astype(np.int32)
    ta = bitops.pack_a(torch.as_tensor(a), 1)[0]
    tb = bitops.pack_b(torch.as_tensor(a.T.copy()), 1)[0]
    idx, cnt, s_max = zerotile.compact_artifacts(ta, 8, 4)
    with pytest.raises(TypeError, match="host int"):
        ops.bgemm(ta, tb, tiles=(idx, cnt, torch.tensor(s_max)))
    with pytest.raises(TypeError, match="host int"):
        ops.bgemm(ta, tb, tiles=(idx, cnt, float(s_max), "sgt"))
    with pytest.raises(ValueError, match="kind"):
        ops.bgemm(ta, tb, tiles=(idx, cnt, s_max, "bogus"))
    # mode="mxu" on CPU tensors takes the plain version: the 'vpu' int32
    mxu = ops.bgemm(ta, tb, mode="mxu")
    assert torch.equal(mxu, ops.bgemm(ta, tb, mode="vpu"))
    np.testing.assert_array_equal(mxu.numpy(), a.astype(np.int64) @ a.T)


def test_bgemm_plain_honours_the_artifacts():
    """A list that leaves a tile out drops exactly that tile's terms."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 2, (16, 256)).astype(np.int32)
    b = rng.integers(0, 2, (256, 5)).astype(np.int32)
    ta, tb = bitops.pack_a(torch.as_tensor(a), 1)[0], bitops.pack_b(torch.as_tensor(b), 1)[0]
    idx = torch.tensor([[1, 0], [0, 0]], dtype=torch.int32)
    cnt = torch.tensor([1, 0], dtype=torch.int32)
    got = ops.bgemm(ta, tb, tiles=(idx, cnt, 2)).numpy()
    want = np.concatenate([a[:8, 128:].astype(np.int64) @ b[128:],
                           np.zeros((8, 5), np.int64)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        bgemm.bgemm_plain(ta, tb, block_m=8, block_w=4).numpy(),
        a.astype(np.int64) @ b)


# -------------------------------------------------------------------- bitpack

@pytest.mark.parametrize("nbits", [1, 2, 5, 8])
@pytest.mark.parametrize("m,k", [(8, 256), (20, 100), (129, 33)])
def test_bitpack_plain_matches_pallas_interpret(nbits, m, k):
    rng = np.random.default_rng(nbits * 10 + m)
    x = rng.normal(size=(m, k)).astype(np.float32)
    qp = jcalibrate(jnp.asarray(x), nbits)
    want = np.asarray(jops.bitpack(jnp.asarray(x), qp.scale, qp.zero,
                                   nbits=nbits, policy=JPOL))
    got = ops.bitpack(torch.as_tensor(x), torch.tensor(np.asarray(qp.scale)),
                      torch.tensor(np.asarray(qp.zero)), nbits=nbits,
                      policy=POL)
    # the reference's shape: M unpadded, K padded to block_w * 32 columns
    words = -(-k // (32 * GRID["block_w"])) * GRID["block_w"]
    assert want.shape == got.shape == (nbits, m, words)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # the padding words are zero
    assert not want[:, :, -(-k // 32):].any()


def test_bitpack_takes_scalar_scale_and_zero_only():
    x = torch.zeros((4, 40))
    with pytest.raises(ValueError, match="scalar"):
        ops.bitpack(x, torch.ones(4), 0.0, nbits=2)
    with pytest.raises(ValueError, match="nbits"):
        bitpack.bitpack(x, 1.0, 0.0, nbits=9, words=2)
    with pytest.raises(ValueError, match="words"):
        bitpack.bitpack(x, 1.0, 0.0, nbits=2, words=1)
    # host scalars work and give the same words as tensors: q = 2 = 0b10
    x = torch.full((4, 64), 0.5)
    got = ops.bitpack(x, 0.25, 0.0, nbits=2)
    assert torch.equal(got, ops.bitpack(x, torch.tensor(0.25), torch.tensor(0.0),
                                        nbits=2))
    assert not bool(got[0].any()) and bool(got[1, :, :2].eq(-1).all())
