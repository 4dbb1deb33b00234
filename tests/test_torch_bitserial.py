"""Port parity: the bit-serial GEMM's plain version against the reference's
Pallas kernel in interpret mode, in the dense, mask, compact and sgt
schedules. The CUDA kernel is held against the plain version on the card
in tests/test_torch_cuda.py.

The int32 results must be equal. Shapes stay small: Pallas interpret
retraces per shape.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import bitops as jbitops  # noqa: E402
from repro.core import zerotile as jzt  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import sgt as jsgt  # noqa: E402
from repro_torch.core import bitops, zerotile  # noqa: E402
from repro_torch.kernels import bitserial, ops, sgt  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch thread
    each keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _operands(pattern, s, t, m=24, k=300, n=18, seed=0):
    rng = np.random.default_rng(seed)
    a = _operand(rng, m, k, s, pattern)
    b = rng.integers(0, 1 << t, (k, n)).astype(np.int32)
    return a, b


def _jump_kwargs(schedule, ap, artifacts):
    """The same schedule for either package: ``artifacts`` are the
    package's zerotile/sgt modules."""
    zt, sg = artifacts
    if schedule == "compact":
        return {"tiles": zt.compact_artifacts(ap, 8, 4)}
    if schedule == "sgt":
        return {"tiles": sg.sgt_artifacts(ap, 8)}
    return {"jump": schedule}


@pytest.mark.parametrize("schedule", ["none", "mask", "compact", "sgt"])
@pytest.mark.parametrize("pattern", ["random", "block_diag", "zero"])
@pytest.mark.parametrize("s,t", [(1, 3), (2, 2)])
def test_plain_matches_pallas_interpret(schedule, pattern, s, t):
    a, b = _operands(pattern, s, t)
    ja, jb = jbitops.pack_a(jnp.asarray(a), s), jbitops.pack_b(jnp.asarray(b), t)
    want = np.asarray(jops.bitserial_gemm(
        ja, jb, interpret=True, **_jump_kwargs(schedule, ja, (jzt, jsgt))))
    ta, tb = bitops.pack_a(torch.as_tensor(a), s), bitops.pack_b(torch.as_tensor(b), t)
    got = ops.bitserial_gemm(ta, tb, **_jump_kwargs(schedule, ta, (zerotile, sgt)))
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, a.astype(np.int64) @ b)


@pytest.mark.parametrize("kind", ["compact", "sgt"])
def test_plain_consumes_reference_artifacts(kind):
    a, b = _operands("block_diag", 1, 8, m=40, k=700, n=9, seed=3)
    ja = jbitops.pack_a(jnp.asarray(a), 1)
    art = (jzt.compact_artifacts(ja, 8, 4) if kind == "compact"
           else jsgt.sgt_artifacts(ja, 8))
    tiles = (torch.as_tensor(np.asarray(art[0])), torch.as_tensor(np.asarray(art[1])),
             *art[2:])
    got = ops.bitserial_gemm(bitops.pack_a(torch.as_tensor(a), 1),
                             bitops.pack_b(torch.as_tensor(b), 8), tiles=tiles)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b)


@pytest.mark.parametrize("s,t", [(1, 1), (1, 8), (2, 4), (3, 5), (8, 8)])
def test_plain_exact_at_every_width(s, t):
    a, b = _operands("random", s, t, m=13, k=150, n=7, seed=s * 8 + t)
    ta, tb = bitops.pack_a(torch.as_tensor(a), s), bitops.pack_b(torch.as_tensor(b), t)
    for jump in ("none", "mask", "compact", "sgt"):
        np.testing.assert_array_equal(ops.bitserial_gemm(ta, tb, jump=jump).numpy(),
                                      a.astype(np.int64) @ b, err_msg=jump)


def test_plain_honours_the_artifacts():
    """A list that leaves a tile out drops exactly that tile's terms, and a
    tile listed twice counts twice — as in the kernel's K loop."""
    a, b = _operands("random", 1, 2, m=16, k=256, n=5, seed=4)
    ta, tb = bitops.pack_a(torch.as_tensor(a), 1), bitops.pack_b(torch.as_tensor(b), 2)
    # 2 row tiles x 2 k-tiles (block_w = 4 words = 128 columns)
    idx = torch.tensor([[1, 0], [0, 0]], dtype=torch.int32)
    cnt = torch.tensor([1, 2], dtype=torch.int32)
    got = ops.bitserial_gemm(ta, tb, tiles=(idx, cnt, 2)).numpy()
    want = a.astype(np.int64) @ b
    want[:8] = a[:8, 128:].astype(np.int64) @ b[128:]
    want[8:] = 2 * (a[8:, :128].astype(np.int64) @ b[:128])
    np.testing.assert_array_equal(got, want)
    occ = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32)
    got = ops.bitserial_gemm(ta, tb, occupancy=occ).numpy()
    want = np.concatenate([a[:8, 128:].astype(np.int64) @ b[128:],
                           a[8:, :128].astype(np.int64) @ b[:128]])
    np.testing.assert_array_equal(got, want)


def test_all_zero_rows_write_zeros():
    a = np.zeros((16, 96), np.int32)
    b = np.ones((96, 3), np.int32)
    ta, tb = bitops.pack_a(torch.as_tensor(a), 1), bitops.pack_b(torch.as_tensor(b), 1)
    idx, cnt, s_max = zerotile.compact_artifacts(ta, 8, 4)
    assert s_max == 0 and int(cnt.sum()) == 0
    for tiles in ((idx, cnt, s_max), sgt.sgt_artifacts(ta, 8)):
        out = ops.bitserial_gemm(ta, tb, tiles=tiles)
        assert out.shape == (16, 3) and not bool(out.any())


def test_padded_level_rejects_what_the_kernel_does_not_take():
    ta = torch.zeros((1, 12, 4), dtype=torch.int32)
    tb = torch.zeros((1, 4, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="not padded"):
        bitserial.bitserial_gemm(ta, tb, block_m=8, block_n=32, block_w=4)
    ta = torch.zeros((1, 16, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most one"):
        bitserial.bitserial_gemm(ta, tb, block_m=8, block_n=32, block_w=4,
                                 occupancy=torch.ones((2, 1), dtype=torch.int32),
                                 sgt=(torch.zeros((2, 4), dtype=torch.int32),
                                      torch.zeros(2, dtype=torch.int32), 1))
    with pytest.raises(ValueError, match="exceeds"):
        bitserial.bitserial_gemm(ta, tb, block_m=8, block_n=32, block_w=4,
                                 compact=(torch.zeros((2, 4), dtype=torch.int32),
                                          torch.zeros(2, dtype=torch.int32), 3))
