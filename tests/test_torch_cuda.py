"""The CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and the CUDA toolkit: each carries the
``cuda`` marker and skips where there is no card. The file imports no JAX,
so it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import DEFAULT_POLICY as POL  # noqa: E402
from repro_torch.api import nn  # noqa: E402
from repro_torch.core import bitops, bittensor as bt, zerotile  # noqa: E402
from repro_torch.core.qgemm import WeightQ, weight_quantize  # noqa: E402
from repro_torch.core.quantize import calibrate  # noqa: E402
from repro_torch.kernels import bgemm, bitpack, bitserial, ops, sgt, wqmm  # noqa: E402
from repro_torch.kernels._build import LAUNCHES  # noqa: E402
from repro_torch.models import gnn  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _untuned():
    """Tuning off unless a test turns it on: the packaged table may move an
    untiled GEMM to the other mode, and these tests count each mode's
    launches or assume the default policy. The tuning tests scope their own
    table inside."""
    from repro_torch.tune import use_table

    with use_table(None):
        yield


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


def _jump_kwargs(schedule, ap):
    if schedule == "compact":
        return {"tiles": zerotile.compact_artifacts(ap, POL.block_m, POL.block_w)}
    if schedule == "sgt":
        return {"tiles": sgt.sgt_artifacts(ap, POL.block_m)}
    return {"jump": schedule}


@pytest.mark.parametrize("schedule", ["none", "mask", "compact", "sgt"])
@pytest.mark.parametrize("pattern", ["random", "block_diag", "zero"])
@pytest.mark.parametrize("s,t", [(1, 1), (1, 8), (2, 4), (3, 5), (8, 8)])
def test_kernel_matches_plain_on_card(cuda_device, schedule, pattern, s, t):
    rng = np.random.default_rng(s * 8 + t)
    a = _operand(rng, 61, 1000, s, pattern)
    b = rng.integers(0, 1 << t, (1000, 70)).astype(np.int32)
    ta = bitops.pack_a(torch.as_tensor(a), s)
    tb = bitops.pack_b(torch.as_tensor(b), t)
    before = bitserial.LAUNCHES["bitserial_gemm"]
    got = ops.bitserial_gemm(ta.to(cuda_device), tb.to(cuda_device),
                             **_jump_kwargs(schedule, ta.to(cuda_device)))
    assert bitserial.LAUNCHES["bitserial_gemm"] == before + 1
    want = ops.bitserial_gemm(ta, tb, **_jump_kwargs(schedule, ta))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    np.testing.assert_array_equal(want.numpy(), a.astype(np.int64) @ b)


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    a = torch.zeros((1, 8, 4), dtype=torch.int32, device=cuda_device)
    b = torch.zeros((1, 4, 32), dtype=torch.int32, device=cuda_device)
    kw = dict(block_m=8, block_n=32, block_w=4)
    with pytest.raises(TypeError, match="int32"):
        bitserial.bitserial_gemm(a.to(torch.int64), b.to(torch.int64), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        bitserial.bitserial_gemm(a, b.transpose(1, 2).contiguous().transpose(1, 2),
                                 **kw)
    with pytest.raises(ValueError, match="bit planes"):
        bitserial.bitserial_gemm(a.expand(9, 8, 4).contiguous(), b, **kw)
    with pytest.raises(ValueError):
        bitserial.bitserial_gemm(a, b.cpu(), **kw)


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_forward_qgtc_on_card_equals_plain_engine(cuda_device, model):
    n, d = 300, 128
    rng = np.random.default_rng(0)
    adj = (rng.random((n, n)) < 0.02).astype(np.int32)
    np.fill_diagonal(adj, 0)
    adj = torch.as_tensor(adj, device=cuda_device)
    x = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32), device=cuda_device)
    inv_deg = 1.0 / (adj.sum(1, keepdim=True).float() + 1.0)
    make = gnn.GNNConfig.paper_gcn if model == "gcn" else gnn.GNNConfig.paper_gin
    cfg = dataclasses.replace(make(d, 40), x_bits=4, w_bits=4)
    params = gnn.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device=cuda_device)
    qp = gnn.quantize_params(params, cfg)
    ap = bitops.pack_a(adj, 1)
    want = gnn.forward_qgtc(qp, adj, x, inv_deg, cfg, backend="popcount")
    for tiles in (None, zerotile.compact_artifacts(ap, POL.block_m, POL.block_w),
                  sgt.sgt_artifacts(ap, POL.block_m)):
        before = bitserial.LAUNCHES["bitserial_gemm"]
        got = gnn.forward_qgtc(qp, adj, x, inv_deg, cfg, tiles=tiles)
        assert bitserial.LAUNCHES["bitserial_gemm"] - before == cfg.layers * (
            2 if model == "gcn" else 3)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _on(device, *xs):
    return [x.to(device) for x in xs]


@pytest.mark.parametrize("schedule", ["none", "mask", "compact", "sgt"])
@pytest.mark.parametrize("pattern", ["random", "block_diag", "zero"])
@pytest.mark.parametrize("out_bits,relu", [(8, True), (4, False), (2, True)])
def test_fused_kernel_matches_plain_on_card(cuda_device, schedule, pattern,
                                            out_bits, relu):
    rng = np.random.default_rng(out_bits)
    s, t, m, k, n = 2, 3, 61, 1000, 70
    a = _operand(rng, m, k, s, pattern)
    b = rng.integers(0, 1 << t, (k, n)).astype(np.int32)
    alpha = torch.as_tensor((rng.random((m, 1)) * 0.004).astype(np.float32))
    beta = torch.as_tensor((rng.random((1, n)) * 4 - 2).astype(np.float32))
    ta = bitops.pack_a(torch.as_tensor(a), s)
    tb = bitops.pack_b(torch.as_tensor(b), t)
    kw = dict(out_bits=out_bits, relu=relu)
    before = LAUNCHES["bitserial_fused"]
    ca, cb, cal, cbe = _on(cuda_device, ta, tb, alpha, beta)
    got = ops.bitserial_fused(ca, cb, cal, cbe, **kw,
                              **_jump_kwargs(schedule, ca))
    assert LAUNCHES["bitserial_fused"] == before + 1
    want = ops.bitserial_fused(ta, tb, alpha, beta, **kw,
                               **_jump_kwargs(schedule, ta))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    if pattern == "zero":  # the epilogue of a zero accumulator
        want_zero = torch.clamp(torch.floor(beta.clamp_min(0) if relu else beta),
                                0, (1 << out_bits) - 1).to(torch.int32)
        assert torch.equal(want, want_zero.expand(m, n))


@pytest.mark.parametrize("schedule", ["none", "mask", "compact", "sgt"])
@pytest.mark.parametrize("pattern", ["random", "block_diag", "zero"])
def test_bgemm_kernel_matches_plain_on_card(cuda_device, schedule, pattern):
    rng = np.random.default_rng(len(pattern))
    a = _operand(rng, 61, 1000, 1, pattern)
    b = rng.integers(0, 2, (1000, 70)).astype(np.int32)
    ta = bitops.pack_a(torch.as_tensor(a), 1)[0]
    tb = bitops.pack_b(torch.as_tensor(b), 1)[0]
    before = LAUNCHES["bgemm"]
    ca, cb = _on(cuda_device, ta, tb)
    got = ops.bgemm(ca, cb, **_jump_kwargs(schedule, ca))
    assert LAUNCHES["bgemm"] == before + 1
    want = ops.bgemm(ta, tb, **_jump_kwargs(schedule, ta))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    np.testing.assert_array_equal(want.numpy(), a.astype(np.int64) @ b)


# ragged shapes, K = 1, 50 (not a multiple of 4: the 4-byte path) and 100,
# M = 1, a row wider than a tile's 4096 columns, and the four timed shapes:
# one batch, all of ogbn-arxiv's, ogbn-products' and ppi's features
BITPACK_TIMED = [(2304, 128), (169343, 128), (2449029, 100), (56944, 50)]


def _bitpack_on_card(x, scale, zero, nbits, words=None):
    """The kernel on x, checked against the plain version on the same CUDA
    tensors (and against the CPU port on small x): one launch, padding words
    zero. ``words`` None is ops.bitpack's word count."""
    before = LAUNCHES["bitpack"]
    if words is None:
        got = ops.bitpack(x, scale, zero, nbits=nbits)
    else:
        got = bitpack.bitpack(x, scale, zero, nbits=nbits, words=words)
    assert LAUNCHES["bitpack"] == before + 1
    torch.cuda.synchronize()
    words = got.shape[2]
    assert torch.equal(got, chip_smoke._bitpack_plain_slices(torch, x, scale, zero,
                                                             nbits, words))
    assert not got[:, :, -(-x.shape[1] // 32):].any()
    if x.numel() <= 1 << 20:
        assert torch.equal(got.cpu(), bitpack.bitpack_plain(
            x.cpu(), scale.cpu(), zero.cpu(), nbits=nbits, words=words))
    return got


@pytest.mark.parametrize("nbits", [1, 2, 5, 8])
@pytest.mark.parametrize("m,k", [(8, 256), (20, 100), (129, 33), (2304, 128),
                                 (37, 50), (5, 1), (1, 128), (1, 50), (9, 4200)]
                         + BITPACK_TIMED)
def test_bitpack_kernel_matches_plain_on_card(cuda_device, nbits, m, k):
    if m * k > 1 << 22:  # a whole graph's features: made on the card
        gen = torch.Generator(device=cuda_device).manual_seed(nbits * 10 + m)
        cx = torch.randn((m, k), generator=gen, device=cuda_device)
        qp = calibrate(cx, nbits)
        cs, cz = qp.scale, qp.zero
    else:
        rng = np.random.default_rng(nbits * 10 + m)
        x = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32))
        qp = calibrate(x, nbits)
        cx, cs, cz = _on(cuda_device, x, qp.scale, qp.zero)
        # on the same CUDA tensors, and against the CPU
        got = ops.bitpack(cx, cs, cz, nbits=nbits)
        assert torch.equal(got.cpu(), ops.bitpack(x, qp.scale, qp.zero, nbits=nbits))
    _bitpack_on_card(cx, cs, cz, nbits)
    need = -(-k // 32)
    if m * k <= 1 << 22:
        # words past ceil(K / 32), some not a multiple of 4
        for words in (need + 1, need + 5, -(-need // 4) * 4 + 8):
            _bitpack_on_card(cx, cs, cz, nbits, words)
        # a row that is not 16-byte aligned: the 4-byte path at any K
        buf = torch.empty(m * k + 1, device=cuda_device)
        shifted = buf[1:].view(m, k)
        shifted.copy_(cx)
        assert shifted.data_ptr() % 16 != 0
        _bitpack_on_card(shifted, cs, cz, nbits)
    _bitpack_on_card(chip_smoke._special_values(torch, cx, cs, cz, nbits), cs, cz,
                     nbits)


@pytest.mark.parametrize("nbits", [1, 2, 5, 8])
@pytest.mark.parametrize("step", [2.0 ** -110, 2.0 ** 110, 1e-8])
def test_bitpack_kernel_at_any_scale_on_card(cuda_device, nbits, step):
    """Scales outside the kernel's fast quotient (2^-100 .. 2^100) take
    __fdiv_rn; calibrate's smallest scale (1e-8) the fast one."""
    rng = np.random.default_rng(nbits)
    x = torch.as_tensor((rng.normal(size=(33, 100)) * 100 * step).astype(np.float32),
                        device=cuda_device)
    scale = torch.tensor(step, device=cuda_device)
    zero = torch.tensor(0.0, device=cuda_device)
    _bitpack_on_card(x, scale, zero, nbits)
    _bitpack_on_card(chip_smoke._special_values(torch, x, scale, zero, nbits),
                     scale, zero, nbits)


def test_new_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    a = torch.zeros((8, 4), dtype=torch.int32, device=cuda_device)
    b = torch.zeros((4, 32), dtype=torch.int32, device=cuda_device)
    kw = dict(block_m=8, block_n=32, block_w=4)
    with pytest.raises(TypeError, match="int32"):
        bgemm.bgemm(a.to(torch.int64), b.to(torch.int64), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        bgemm.bgemm(a, b.t().contiguous().t(), **kw)
    with pytest.raises(ValueError):
        bgemm.bgemm(a, b.cpu(), **kw)
    alpha = torch.ones((8, 1), device=cuda_device)
    beta = torch.ones((1, 32), device=cuda_device)
    fkw = dict(out_bits=4, relu=False, **kw)
    with pytest.raises(TypeError, match="float32"):
        bitserial.bitserial_fused(a[None], b[None], alpha.double(), beta, **fkw)
    with pytest.raises(ValueError, match="contiguous"):
        bitserial.bitserial_fused(a[None], b[None], alpha,
                                  torch.ones((1, 64), device=cuda_device)[:, ::2],
                                  **fkw)
    with pytest.raises(ValueError, match="on cpu"):
        bitserial.bitserial_fused(a[None], b[None], alpha.cpu(), beta, **fkw)
    with pytest.raises(ValueError, match="must be"):
        bitserial.bitserial_fused(a[None], b[None], alpha[:4], beta, **fkw)
    x = torch.zeros((4, 40), device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        bitpack.bitpack(x.double(), 1.0, 0.0, nbits=2, words=2)
    with pytest.raises(ValueError, match="contiguous"):
        bitpack.bitpack(torch.zeros((40, 4), device=cuda_device).t(), 1.0, 0.0,
                        nbits=2, words=2)
    with pytest.raises(ValueError, match="scalar"):
        bitpack.bitpack(x, torch.ones(2, device=cuda_device), 0.0, nbits=2,
                        words=2)


def test_tensor_api_on_card(cuda_device):
    """bitmm2bit fused and unfused, and reuse=False, on the card: equal to
    the popcount engine, through the launches each route should make."""
    rng = np.random.default_rng(0)
    adj = torch.as_tensor((rng.random((300, 300)) < 0.03).astype(np.int32),
                          device=cuda_device)
    h = torch.as_tensor(rng.normal(size=(300, 128)).astype(np.float32),
                        device=cuda_device)
    w = torch.as_tensor(rng.normal(size=(128, 16)).astype(np.float32),
                        device=cuda_device)
    th = bt.to_bit(h, 4, pack_axis=1)
    assert torch.equal(th.data, api.bitpack(h, th.qp.scale, th.qp.zero, nbits=4))
    tw = bt.to_bit(w, 4, pack_axis=0)
    acc = bt.bitmm2int(th, tw, backend="popcount").float()
    qp = calibrate(acc, 4)
    for fused in (False, True):
        pol = api.ExecutionPolicy(fused_requantize=fused)
        before = dict(LAUNCHES)
        got = bt.bitmm2bit(th, tw, 4, qp, policy=pol)
        key = "bitserial_fused" if fused else "bitserial_gemm"
        assert LAUNCHES[key] == before[key] + 1
        want = bt.bitmm2bit(th, tw, 4, qp, backend="popcount", policy=pol)
        assert torch.equal(got.data, want.data)
    ta = bt.to_bit(adj, 1, pack_axis=1)
    tx = bt.to_bit(bt.to_val(th), 4, pack_axis=0)
    before = dict(LAUNCHES)
    reuse = bt.bitmm2int(ta, tx)
    no_reuse = bt.bitmm2int(ta, tx, policy=api.ExecutionPolicy(reuse=False))
    assert LAUNCHES["bitserial_gemm"] == before["bitserial_gemm"] + 1
    assert LAUNCHES["bgemm"] == before["bgemm"] + 4
    torch.cuda.synchronize()
    assert torch.equal(reuse, no_reuse)


def _within_float32_bound(got, x, w_deq):
    """|got - x @ W| <= K * 2^-24 * (|x| @ |W|) around float64: the float32
    dot-product error bound, which holds in any summation order."""
    x64, w64 = x.double(), w_deq.double()
    bound = x.shape[1] * 2.0 ** -24 * (x64.abs() @ w64.abs())
    return bool(((got.double() - x64 @ w64).abs() <= bound).all())


@pytest.mark.parametrize("m,k,n", [(1, 128, 256), (8, 256, 512), (5, 160, 64),
                                   (13, 416, 300), (128, 1024, 1000),
                                   (1, 4096, 4096), (8, 13440, 512),
                                   (37, 416, 300)])
@pytest.mark.parametrize("group", [32, 16, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("blocks", [(8, 256, 128), (1, 64, 32), (32, 128, 64)])
def test_wq_gemm_kernel_matches_plain_on_card(cuda_device, m, k, n, group,
                                              dtype, blocks):
    rng = np.random.default_rng(m + k + n + group)
    x = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32),
                        device=cuda_device).to(getattr(torch, dtype))
    w = torch.as_tensor(rng.normal(size=(k, n)).astype(np.float32),
                        device=cuda_device)
    wp, sc = wqmm.pack_w4(w, group)
    bm, bn, bk = blocks
    before = LAUNCHES["wq_gemm"]
    got = ops.wq_gemm(x, wp, sc, group=group, block_m=bm, block_n=bn, block_k=bk)
    assert LAUNCHES["wq_gemm"] == before + 1
    plain = wqmm.wq_gemm_plain(x, wp, sc, group=group)
    torch.cuda.synchronize()
    assert got.shape == (m, n) and got.dtype == torch.float32
    w_deq = wqmm.unpack_w4(wp, sc, group)
    assert _within_float32_bound(got, x, w_deq)
    assert _within_float32_bound(plain, x, w_deq)
    # the CPU's plain version packs the same bytes
    wp_cpu, sc_cpu = wqmm.pack_w4(w.cpu(), group)
    assert torch.equal(wp.cpu(), wp_cpu) and torch.equal(sc.cpu(), sc_cpu)


@pytest.mark.parametrize("scale", [2.0 ** 20, 2.0 ** -20])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,group", [(1, 4096, 4096, 32), (8, 416, 300, 16),
                                         (37, 1024, 1000, 8), (3, 36, 40, 12),
                                         (2, 15, 10, 5)])
def test_wq_gemm_wide_range_x_within_bound_on_card(cuda_device, scale, dtype,
                                                   m, k, n, group):
    """x scaled by 2^20 or 2^-20: the three bf16 pieces of float32 x carry
    it, and groups and rows that are not multiples of 16 take the element
    copies and the masked chunks."""
    rng = np.random.default_rng(m + k + n + group)
    x = torch.as_tensor((rng.normal(size=(m, k)) * scale).astype(np.float32),
                        device=cuda_device).to(getattr(torch, dtype))
    w = torch.as_tensor(rng.normal(size=(k, n)).astype(np.float32),
                        device=cuda_device)
    wp, sc = wqmm.pack_w4(w, group)
    got = ops.wq_gemm(x, wp, sc, group=group, block_k=group)
    torch.cuda.synchronize()
    assert got.shape == (m, n) and bool(torch.isfinite(got).all())
    assert _within_float32_bound(got, x, wqmm.unpack_w4(wp, sc, group))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wq_gemm_row_results_do_not_depend_on_m(cuda_device, dtype):
    """The split of K and the order of the adds follow N, K and the group,
    never M: the first rows of x give the same output bit for bit at every
    M (wg's K, N = 4096)."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(128, 4096)).astype(np.float32),
                        device=cuda_device).to(getattr(torch, dtype))
    wp, sc = wqmm.pack_w4(torch.as_tensor(
        (rng.normal(size=(4096, 4096)) * 0.02).astype(np.float32),
        device=cuda_device))
    full = ops.wq_gemm(x, wp, sc)
    for m in (1, 3, 8, 37):
        got = ops.wq_gemm(x[:m].contiguous(), wp, sc)
        torch.cuda.synchronize()
        assert torch.equal(got, full[:m])


def test_wq_gemm_rows_below_the_tile_are_bit_equal(cuda_device):
    """M below block_m runs a smaller row instance: the same sums, bit for bit."""
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(3, 512)).astype(np.float32),
                        device=cuda_device)
    wp, sc = wqmm.pack_w4(torch.as_tensor(
        rng.normal(size=(512, 640)).astype(np.float32), device=cuda_device))
    outs = [ops.wq_gemm(x, wp, sc, block_m=bm) for bm in (4, 8, 32)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert torch.equal(outs[0][:1], ops.wq_gemm(x[:1], wp, sc, block_m=1))


def test_wq_gemm_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros((2, 128), device=cuda_device)
    wp = torch.zeros((128, 32), dtype=torch.uint8, device=cuda_device)
    sc = torch.zeros((4, 64), device=cuda_device)
    kw = dict(group=32, block_m=8, block_n=256, block_k=128)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        wqmm.wq_gemm(x.double(), wp, sc, **kw)
    with pytest.raises(TypeError, match="uint8"):
        wqmm.wq_gemm(x, wp.to(torch.int8), sc, **kw)
    with pytest.raises(TypeError, match="float32"):
        wqmm.wq_gemm(x, wp, sc.double(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        wqmm.wq_gemm(torch.zeros((128, 2), device=cuda_device).t(), wp, sc, **kw)
    with pytest.raises(ValueError):
        wqmm.wq_gemm(x, wp, sc.cpu(), **kw)
    with pytest.raises(ValueError, match="block_m"):
        wqmm.wq_gemm(x, wp, sc, **{**kw, "block_m": 3})
    with pytest.raises(ValueError, match="shared memory"):
        ops.wq_gemm(torch.zeros((2, 512), device=cuda_device),
                    torch.zeros((512, 32), dtype=torch.uint8, device=cuda_device),
                    torch.zeros((16, 64), device=cuda_device),
                    block_m=32, block_k=1024)
    with pytest.raises(ValueError, match="scales"):
        ops.wq_gemm(x, wp, sc[:3])
    assert LAUNCHES["wq_gemm"] >= 0


def test_wq_linear_on_card_is_a_float_product(cuda_device):
    """The cuda engine serves wq_mm with a float matmul, launching no
    kernel, and agrees with the port on the CPU within the float32 bound."""
    rng = np.random.default_rng(2)
    w = torch.as_tensor(rng.normal(size=(512, 96)).astype(np.float32),
                        device=cuda_device)
    x = torch.as_tensor(rng.normal(size=(8, 512)).astype(np.float32),
                        device=cuda_device)
    wq = weight_quantize(w, 4)
    before = dict(LAUNCHES)
    on_card = nn.wq_linear(x, wq, out_dtype=torch.float32)
    assert LAUNCHES == before
    wq_cpu = WeightQ(wq.data.cpu(), wq.scale.cpu(), wq.zero.cpu(), 4)
    on_cpu = nn.wq_linear(x.cpu(), wq_cpu, out_dtype=torch.float32,
                          backend="torch_dot")
    # the float32 bound of (x @ q) * scale + rowsum(x) * zero around float64
    x64, d64 = x.double(), wq.data.double()
    s64, z64 = wq.scale.double(), wq.zero.double()
    core, rowsum = x64 @ d64, x64.sum(-1, keepdim=True)
    u, k = 2.0 ** -24, x.shape[1]
    bound = (k * u * ((x64.abs() @ d64.abs()) * s64.abs()
                      + x64.abs().sum(-1, keepdim=True) * z64.abs())
             + 3 * u * ((core * s64).abs() + (rowsum * z64).abs()))
    exact = core * s64 + rowsum * z64
    torch.cuda.synchronize()
    for y in (on_card, on_cpu.to(cuda_device)):
        assert bool(((y.double() - exact).abs() <= bound).all())
    with pytest.raises(api.UnsupportedOpError):
        nn.wq_linear(x, wq, backend="popcount")


# ------------------------------------------------ mode="mxu": the tensor cores

# every kind of tile the policy accepts: the default, one row, one fragment,
# a K tile of 9 words, and the two extremes, 1 x 1024 and 1024 x 1
MXU_TILES = [(8, 32, 4), (1, 32, 1), (16, 8, 8), (32, 32, 9), (1, 1024, 4),
             (1024, 1, 1)]


def _mxu_policy(tile):
    bm, bn, bw = tile
    return api.ExecutionPolicy(block_m=bm, block_n=bn, block_w=bw, mode="mxu")


def _tile_jump_kwargs(schedule, ap, pol):
    if schedule == "compact":
        return {"tiles": zerotile.compact_artifacts(ap, pol.block_m, pol.block_w)}
    if schedule == "sgt":
        return {"tiles": sgt.sgt_artifacts(ap, pol.block_m)}
    return {"jump": schedule}


@pytest.mark.parametrize("schedule", ["none", "mask", "compact", "sgt"])
@pytest.mark.parametrize("tile", MXU_TILES)
@pytest.mark.parametrize("s,t", [(1, 1), (1, 8), (2, 4), (3, 5), (8, 8)])
def test_mxu_kernel_matches_plain_on_card(cuda_device, schedule, tile, s, t):
    pol = _mxu_policy(tile)
    for pattern in ("random", "block_diag", "zero"):
        rng = np.random.default_rng(s * 8 + t)
        a = _operand(rng, 61, 1000, s, pattern)
        b = rng.integers(0, 1 << t, (1000, 70)).astype(np.int32)
        ta = bitops.pack_a(torch.as_tensor(a), s)
        tb = bitops.pack_b(torch.as_tensor(b), t)
        ca, cb = _on(cuda_device, ta, tb)
        kw = _tile_jump_kwargs(schedule, ca, pol)
        before = dict(LAUNCHES)
        got = ops.bitserial_gemm(ca, cb, policy=pol, **kw)
        assert LAUNCHES["bitserial_gemm_mxu"] == before["bitserial_gemm_mxu"] + 1
        assert LAUNCHES["bitserial_gemm"] == before["bitserial_gemm"]
        vpu = ops.bitserial_gemm(ca, cb, policy=pol.replace(mode="vpu"), **kw)
        want = ops.bitserial_gemm(ta, tb, policy=pol,
                                  **_tile_jump_kwargs(schedule, ta, pol))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), pattern
        assert torch.equal(got, vpu), pattern
        np.testing.assert_array_equal(want.numpy(), a.astype(np.int64) @ b)


@pytest.mark.parametrize("schedule", ["none", "mask", "compact", "sgt"])
@pytest.mark.parametrize("tile", MXU_TILES)
@pytest.mark.parametrize("out_bits,relu", [(8, True), (4, False), (2, True)])
def test_mxu_fused_kernel_matches_plain_on_card(cuda_device, schedule, tile,
                                                out_bits, relu):
    pol = _mxu_policy(tile)
    s, t, m, k, n = 2, 3, 61, 1000, 70
    for pattern in ("random", "block_diag", "zero"):
        rng = np.random.default_rng(out_bits)
        a = _operand(rng, m, k, s, pattern)
        b = rng.integers(0, 1 << t, (k, n)).astype(np.int32)
        alpha = torch.as_tensor((rng.random((m, 1)) * 0.004).astype(np.float32))
        beta = torch.as_tensor((rng.random((1, n)) * 4 - 2).astype(np.float32))
        ta = bitops.pack_a(torch.as_tensor(a), s)
        tb = bitops.pack_b(torch.as_tensor(b), t)
        ca, cb, cal, cbe = _on(cuda_device, ta, tb, alpha, beta)
        kw = dict(out_bits=out_bits, relu=relu, **_tile_jump_kwargs(schedule, ca, pol))
        before = dict(LAUNCHES)
        got = ops.bitserial_fused(ca, cb, cal, cbe, policy=pol, **kw)
        assert LAUNCHES["bitserial_fused_mxu"] == before["bitserial_fused_mxu"] + 1
        assert LAUNCHES["bitserial_fused"] == before["bitserial_fused"]
        vpu = ops.bitserial_fused(ca, cb, cal, cbe, policy=pol.replace(mode="vpu"),
                                  **kw)
        want = ops.bitserial_fused(ta, tb, alpha, beta, out_bits=out_bits,
                                   relu=relu, policy=pol,
                                   **_tile_jump_kwargs(schedule, ta, pol))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), pattern
        assert torch.equal(got, vpu), pattern


@pytest.mark.parametrize("schedule", ["none", "mask", "compact", "sgt"])
@pytest.mark.parametrize("pattern", ["random", "block_diag", "zero"])
@pytest.mark.parametrize("tile", MXU_TILES)
def test_mxu_bgemm_kernel_matches_plain_on_card(cuda_device, schedule, pattern,
                                                tile):
    pol = _mxu_policy(tile)
    rng = np.random.default_rng(len(pattern))
    a = _operand(rng, 61, 1000, 1, pattern)
    b = rng.integers(0, 2, (1000, 70)).astype(np.int32)
    ta = bitops.pack_a(torch.as_tensor(a), 1)[0]
    tb = bitops.pack_b(torch.as_tensor(b), 1)[0]
    ca, cb = _on(cuda_device, ta, tb)
    kw = _tile_jump_kwargs(schedule, ca, pol)
    before = dict(LAUNCHES)
    got = ops.bgemm(ca, cb, policy=pol, **kw)
    assert LAUNCHES["bgemm_mxu"] == before["bgemm_mxu"] + 1
    assert LAUNCHES["bgemm"] == before["bgemm"]
    vpu = ops.bgemm(ca, cb, policy=pol.replace(mode="vpu"), **kw)
    want = ops.bgemm(ta, tb, policy=pol, **_tile_jump_kwargs(schedule, ta, pol))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, vpu)
    np.testing.assert_array_equal(want.numpy(), a.astype(np.int64) @ b)


def _word(bit):
    """A 32-bit word with one bit set, as the int32 bit pattern."""
    return (1 << bit) - (1 << 32) if bit == 31 else 1 << bit


@pytest.mark.parametrize("tile", [(16, 8, 8), (8, 32, 4)])
def test_mxu_fragment_layout_one_hot(cuda_device, tile):
    """One set bit of A at every (row < 16, word < 8, bit in {0, 31})
    against a B of all ones lights exactly that row; one set bit of B at
    every (word, column) against an A of all ones lights exactly that
    column. This pins the m16n8k256 fragment layout."""
    pol = _mxu_policy(tile)
    ones_b = torch.full((8, 8), -1, dtype=torch.int32, device=cuda_device)
    ones_a = torch.full((16, 8), -1, dtype=torch.int32, device=cuda_device)
    for row, word, bit in itertools.product(range(16), range(8), (0, 31)):
        a = torch.zeros((16, 8), dtype=torch.int32)
        a[row, word] = _word(bit)
        want = torch.zeros((16, 8), dtype=torch.int32)
        want[row] = 1
        got = ops.bgemm(a.to(cuda_device), ones_b, policy=pol)
        assert torch.equal(got.cpu(), want), (row, word, bit)
        got = ops.bitserial_gemm(a[None].to(cuda_device), ones_b[None], policy=pol)
        assert torch.equal(got.cpu(), want), (row, word, bit)
        col = row % 8
        bw = torch.zeros((8, 8), dtype=torch.int32)
        bw[word, col] = _word(bit)
        want = torch.zeros((16, 8), dtype=torch.int32)
        want[:, col] = 1
        got = ops.bgemm(ones_a, bw.to(cuda_device), policy=pol)
        assert torch.equal(got.cpu(), want), (word, col, bit)


def _mxu_exact(pol, a, b, s, t, schedule, device, what):
    """bitserial_gemm, the identity-epilogue bitserial_fused and (at one
    bit) bgemm at 'mxu' on ``a`` (M, K) and ``b`` (K, N): each equal to the
    exact product, to the plain version and to the 'vpu' kernel."""
    exact = a.astype(np.int64) @ b.astype(np.int64)
    ta = bitops.pack_a(torch.as_tensor(a, dtype=torch.int32), s)
    tb = bitops.pack_b(torch.as_tensor(b, dtype=torch.int32), t)
    ca, cb = _on(device, ta, tb)
    kw = _tile_jump_kwargs(schedule, ca, pol)
    vpu = pol.replace(mode="vpu")
    one = torch.ones((a.shape[0], 1), device=device)
    zero = torch.zeros((1, b.shape[1]), device=device)
    before = dict(LAUNCHES)
    got = {"gemm": ops.bitserial_gemm(ca, cb, policy=pol, **kw),
           "fused": ops.bitserial_fused(ca, cb, one, zero, out_bits=30,
                                        relu=False, policy=pol, **kw)}
    want = {"gemm": ops.bitserial_gemm(ca, cb, policy=vpu, **kw),
            "fused": ops.bitserial_fused(ca, cb, one, zero, out_bits=30,
                                         relu=False, policy=vpu, **kw)}
    launched = {"bitserial_gemm_mxu": 1, "bitserial_fused_mxu": 1}
    if s == t == 1:
        got["bgemm"] = ops.bgemm(ca[0], cb[0], policy=pol, **kw)
        want["bgemm"] = ops.bgemm(ca[0], cb[0], policy=vpu, **kw)
        launched["bgemm_mxu"] = 1
    for name, count in launched.items():
        assert LAUNCHES[name] == before[name] + count, (name, what)
    plain = ops.bitserial_gemm(ta, tb, policy=pol,
                               **_tile_jump_kwargs(schedule, ta, pol))
    np.testing.assert_array_equal(plain.numpy(), exact, err_msg=what)
    torch.cuda.synchronize()
    for name in got:
        np.testing.assert_array_equal(got[name].cpu().numpy(), exact,
                                      err_msg=f"{name} {what}")
        assert torch.equal(got[name], want[name]), (name, what)


@pytest.mark.parametrize("schedule", ["none", "mask", "compact", "sgt"])
@pytest.mark.parametrize("s,t", [(8, 8), (3, 5), (1, 8), (1, 1)])
@pytest.mark.parametrize("tile", [(8, 32, 1), (8, 32, 4), (16, 8, 8)])
def test_mxu_short_walks_pair_planes_on_card(cuda_device, schedule, s, t, tile):
    """K of 1, 2, 3, 4 and 5 words: the short walk pairs same-weight plane
    pairs into one mma over 1, 2 or 4 live words (3 leave one word of the
    mma empty), 5 takes the long walk; at block_w = 1 the words are exact,
    at 4 and 8 the padding words are zero and dropped. Random, all-zero and
    one-word-only A."""
    pol = _mxu_policy(tile)
    rng = np.random.default_rng(s * 8 + t)
    for words in (1, 2, 3, 4, 5):
        k = 32 * words - 7  # ragged: the last word is partly padding
        b = rng.integers(0, 1 << t, (k, 40))
        for pattern in ("random", "zero", "one_word"):
            a = rng.integers(0, 1 << s, (37, k))
            if pattern == "zero":
                a[:] = 0
            elif pattern == "one_word":
                keep = 32 * int(rng.integers(0, words))
                a[:, :keep] = 0
                a[:, keep + 32:] = 0
            _mxu_exact(pol, a, b, s, t, schedule, cuda_device,
                       f"words={words} {pattern}")


@pytest.mark.parametrize("schedule", ["none", "mask", "compact", "sgt"])
@pytest.mark.parametrize("s,t", [(1, 8), (1, 1), (3, 5)])
def test_mxu_zero_runs_skipped_on_card(cuda_device, schedule, s, t):
    """One non-zero word per 16-row strip, anywhere in a 72-word K (the
    adjacency's): every other run of the strip is zero in every lane and
    plane and issues no mma; the one that is not must still count."""
    pol = _mxu_policy((8, 32, 4))
    rng = np.random.default_rng(s + t)
    m, k = 100, 32 * 72
    for _ in range(3):
        a = np.zeros((m, k), dtype=np.int64)
        for r0 in range(0, m, 16):
            row = r0 + int(rng.integers(0, min(16, m - r0)))
            word = int(rng.integers(0, 72))
            a[row, 32 * word:32 * word + 32] = rng.integers(0, 1 << s, 32)
        b = rng.integers(0, 1 << t, (k, 16))
        _mxu_exact(pol, a, b, s, t, schedule, cuda_device, "one word a strip")


@pytest.mark.parametrize("m,k,n,s,t", [
    (61, 1000, 70, 2, 3),     # 70 columns: past one 64-column block
    (40, 2304, 130, 1, 1),    # 1-bit: past one 128-column block
    (40, 2304, 64, 1, 8),     # t = 8 of 72 words: a narrower column block
    (24, 12800, 9, 1, 8),     # 400 words x 8 planes: two K windows
    (18, 100000, 8, 1, 1),    # 1-bit, 3125 words: two K windows
])
def test_mxu_staged_windows_on_card(cuda_device, m, k, n, s, t):
    """Shapes whose B does not fit one column block or one K window of the
    staged copy: N past a block, and K past the window, in every schedule."""
    pol = _mxu_policy((8, 32, 4))
    rng = np.random.default_rng(m + n)
    a = _operand(rng, m, k, s, "block_diag")
    a[:, : k // 3] = rng.integers(0, 1 << s, (m, k // 3))
    b = rng.integers(0, 1 << t, (k, n))
    for schedule in ("none", "mask", "compact", "sgt"):
        _mxu_exact(pol, a, b, s, t, schedule, cuda_device, f"{(m, k, n)}")


@pytest.mark.parametrize("schedule", ["mask", "compact", "sgt"])
@pytest.mark.parametrize("tile", [(1, 32, 1), (2, 16, 3), (4, 8, 5), (8, 32, 4),
                                  (12, 8, 4), (24, 4, 2)])
def test_mxu_row_tiles_below_a_strip_on_card(cuda_device, schedule, tile):
    """block_m < 16, or not a divisor of 16: a strip spans several row tiles,
    and each row's words enter only where its own row tile visits them.
    Banded A, so that the row tiles' lists differ."""
    pol = _mxu_policy(tile)
    rng = np.random.default_rng(tile[0])
    for s, t in ((3, 5), (1, 8), (1, 1)):
        m, k = 72, 32 * 40
        a = rng.integers(0, 1 << s, (m, k))
        for r in range(m):  # each row keeps a band of its own
            lo = (r * 7) % 30 * 32
            a[r, :lo] = 0
            a[r, lo + 5 * 32:] = 0
        a[::5] = 0
        b = rng.integers(0, 1 << t, (k, 24))
        _mxu_exact(pol, a, b, s, t, schedule, cuda_device, f"s={s} t={t}")


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_forward_qgtc_at_mxu_on_card_equals_plain_engine(cuda_device, model):
    n, d = 300, 128
    rng = np.random.default_rng(0)
    adj = (rng.random((n, n)) < 0.02).astype(np.int32)
    np.fill_diagonal(adj, 0)
    adj = torch.as_tensor(adj, device=cuda_device)
    x = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32), device=cuda_device)
    inv_deg = 1.0 / (adj.sum(1, keepdim=True).float() + 1.0)
    make = gnn.GNNConfig.paper_gcn if model == "gcn" else gnn.GNNConfig.paper_gin
    cfg = dataclasses.replace(make(d, 40), x_bits=4, w_bits=4)
    params = gnn.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device=cuda_device)
    qp = gnn.quantize_params(params, cfg)
    ap = bitops.pack_a(adj, 1)
    mxu = api.ExecutionPolicy(mode="mxu")
    want = gnn.forward_qgtc(qp, adj, x, inv_deg, cfg, backend="popcount")
    for tiles in (None, zerotile.compact_artifacts(ap, POL.block_m, POL.block_w),
                  sgt.sgt_artifacts(ap, POL.block_m)):
        before = dict(LAUNCHES)
        got = gnn.forward_qgtc(qp, adj, x, inv_deg, cfg, tiles=tiles, policy=mxu)
        assert LAUNCHES["bitserial_gemm_mxu"] - before["bitserial_gemm_mxu"] == \
            cfg.layers * (2 if model == "gcn" else 3)
        assert LAUNCHES["bitserial_gemm"] == before["bitserial_gemm"]
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_tensor_api_at_mxu_on_card(cuda_device):
    """The fused bitmm2bit and the reuse=False adjacency product at 'mxu':
    equal to 'vpu', through the mxu kernels only."""
    rng = np.random.default_rng(1)
    adj = torch.as_tensor((rng.random((300, 300)) < 0.03).astype(np.int32),
                          device=cuda_device)
    h = torch.as_tensor(rng.normal(size=(300, 128)).astype(np.float32),
                        device=cuda_device)
    w = torch.as_tensor(rng.normal(size=(128, 16)).astype(np.float32),
                        device=cuda_device)
    th, tw = bt.to_bit(h, 4, pack_axis=1), bt.to_bit(w, 4, pack_axis=0)
    qp = calibrate(bt.bitmm2int(th, tw, backend="popcount").float(), 4)
    mxu = api.ExecutionPolicy(mode="mxu", fused_requantize=True)
    before = dict(LAUNCHES)
    got = bt.bitmm2bit(th, tw, 4, qp, policy=mxu)
    assert LAUNCHES["bitserial_fused_mxu"] == before["bitserial_fused_mxu"] + 1
    want = bt.bitmm2bit(th, tw, 4, qp, policy=mxu.replace(mode="vpu"))
    assert torch.equal(got.data, want.data)
    ta = bt.to_bit(adj, 1, pack_axis=1)
    tx = bt.to_bit(bt.to_val(th), 4, pack_axis=0)
    before = dict(LAUNCHES)
    no_reuse = bt.bitmm2int(ta, tx, policy=mxu.replace(reuse=False))
    assert LAUNCHES["bgemm_mxu"] == before["bgemm_mxu"] + 4
    assert LAUNCHES["bgemm"] == before["bgemm"]
    torch.cuda.synchronize()
    assert torch.equal(no_reuse, bt.bitmm2int(ta, tx))


# ------------------------------- mode="vpu" at every kind of tile the policy takes

# the 'vpu' kernel launches a warp a row whatever the tile; the tile still
# sets the grid of the jump artifacts and the padding, so each is checked
VPU_TILES = MXU_TILES
# ragged N: not a multiple of block_n, and below 32
VPU_SHAPES = [(61, 1000, 70), (37, 333, 5), (20, 1100, 16)]


def _vpu_policy(tile):
    return _mxu_policy(tile).replace(mode="vpu")


@pytest.mark.parametrize("schedule", ["none", "mask", "compact", "sgt"])
@pytest.mark.parametrize("tile", VPU_TILES)
@pytest.mark.parametrize("s,t", [(1, 1), (1, 8), (3, 5), (8, 8)])
def test_vpu_kernel_at_every_tile_is_exact_on_card(cuda_device, schedule, tile, s, t):
    pol = _vpu_policy(tile)
    rng = np.random.default_rng(s * 8 + t)
    for (m, k, n), pattern in itertools.product(
            VPU_SHAPES, ("random", "block_diag", "zero")):
        a = _operand(rng, m, k, s, pattern)
        b = rng.integers(0, 1 << t, (k, n)).astype(np.int32)
        ca, cb = _on(cuda_device, bitops.pack_a(torch.as_tensor(a), s),
                     bitops.pack_b(torch.as_tensor(b), t))
        before = dict(LAUNCHES)
        got = ops.bitserial_gemm(ca, cb, policy=pol,
                                 **_tile_jump_kwargs(schedule, ca, pol))
        assert LAUNCHES["bitserial_gemm"] == before["bitserial_gemm"] + 1
        assert LAUNCHES["bitserial_gemm_mxu"] == before["bitserial_gemm_mxu"]
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), a.astype(np.int64) @ b,
                                      err_msg=f"{(m, k, n)} {pattern}")


@pytest.mark.parametrize("schedule", ["none", "mask", "compact", "sgt"])
@pytest.mark.parametrize("tile", VPU_TILES)
@pytest.mark.parametrize("out_bits,relu", [(8, True), (4, False), (2, True)])
def test_vpu_fused_kernel_at_every_tile_matches_plain_on_card(
        cuda_device, schedule, tile, out_bits, relu):
    pol = _vpu_policy(tile)
    rng = np.random.default_rng(out_bits)
    for (m, k, n), (s, t), pattern in itertools.product(
            VPU_SHAPES, ((2, 3), (8, 8)), ("random", "zero")):
        a = _operand(rng, m, k, s, pattern)
        b = rng.integers(0, 1 << t, (k, n)).astype(np.int32)
        exact = torch.as_tensor(a.astype(np.int64) @ b)
        top = max(int(exact.max()), 1)
        alpha = torch.as_tensor((rng.random((m, 1)) * 1.5 * (1 << out_bits) / top)
                                .astype(np.float32))
        beta = torch.as_tensor(((rng.random((1, n)) - 0.5) * (1 << out_bits))
                               .astype(np.float32))
        ca, cb, cal, cbe = _on(cuda_device, bitops.pack_a(torch.as_tensor(a), s),
                               bitops.pack_b(torch.as_tensor(b), t), alpha, beta)
        before = LAUNCHES["bitserial_fused"]
        got = ops.bitserial_fused(ca, cb, cal, cbe, out_bits=out_bits, relu=relu,
                                  policy=pol, **_tile_jump_kwargs(schedule, ca, pol))
        assert LAUNCHES["bitserial_fused"] == before + 1
        want = bitserial.fused_epilogue(exact, alpha, beta, out_bits, relu)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), ((m, k, n), (s, t), pattern)


@pytest.mark.parametrize("schedule", ["none", "mask", "compact", "sgt"])
@pytest.mark.parametrize("pattern", ["random", "block_diag", "zero"])
@pytest.mark.parametrize("tile", VPU_TILES)
def test_vpu_bgemm_at_every_tile_is_exact_on_card(cuda_device, schedule, pattern,
                                                  tile):
    pol = _vpu_policy(tile)
    rng = np.random.default_rng(len(pattern))
    for m, k, n in VPU_SHAPES + [(40, 2304, 128)]:
        a = _operand(rng, m, k, 1, pattern)
        b = rng.integers(0, 2, (k, n)).astype(np.int32)
        ca, cb = _on(cuda_device, bitops.pack_a(torch.as_tensor(a), 1)[0],
                     bitops.pack_b(torch.as_tensor(b), 1)[0])
        before = dict(LAUNCHES)
        got = ops.bgemm(ca, cb, policy=pol, **_tile_jump_kwargs(schedule, ca, pol))
        assert LAUNCHES["bgemm"] == before["bgemm"] + 1
        assert LAUNCHES["bgemm_mxu"] == before["bgemm_mxu"]
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), a.astype(np.int64) @ b,
                                      err_msg=f"{(m, k, n)}")


def _one_hot_words(device, pol, s, t):
    """A with one set bit a row, at every (plane < s, word < 40, bit 0 or
    31), against a random B; and a random A against B with one set bit a
    column, at every (plane < t, word, bit). 40 words cross the 'vpu'
    kernel's 32-word chunks and the 'mxu' kernel's 8-word runs, and t * 80
    columns the column blocks of both, so a wrong lane-to-word, plane or
    column mapping cannot pass. Every product is exact: bitserial_gemm and
    the identity-epilogue bitserial_fused in the four schedules, and bgemm
    at s = t = 1."""
    words = 40
    k = 32 * words
    rng = np.random.default_rng(s * 16 + t)
    a_hot = np.zeros((s * words * 2, k), dtype=np.int64)
    for r, (p, wd, bit) in enumerate(itertools.product(range(s), range(words),
                                                       (0, 31))):
        a_hot[r, 32 * wd + bit] = 1 << p
    b_hot = np.zeros((k, t * words * 2), dtype=np.int64)
    for col, (q, wd, bit) in enumerate(itertools.product(range(t), range(words),
                                                         (0, 31))):
        b_hot[32 * wd + bit, col] = 1 << q
    pairs = ((a_hot, rng.integers(0, 1 << t, (k, 40))),
             (rng.integers(0, 1 << s, (64, k)), b_hot))
    for a, b in pairs:
        exact = a @ b
        ca, cb = _on(device, bitops.pack_a(torch.as_tensor(a, dtype=torch.int32), s),
                     bitops.pack_b(torch.as_tensor(b, dtype=torch.int32), t))
        one = torch.ones((a.shape[0], 1), device=device)
        zero = torch.zeros((1, b.shape[1]), device=device)
        for schedule in ("none", "mask", "compact", "sgt"):
            kw = _tile_jump_kwargs(schedule, ca, pol)
            got = [ops.bitserial_gemm(ca, cb, policy=pol, **kw),
                   ops.bitserial_fused(ca, cb, one, zero, out_bits=30, relu=False,
                                       policy=pol, **kw)]
            if s == t == 1:
                got.append(ops.bgemm(ca[0], cb[0], policy=pol, **kw))
            torch.cuda.synchronize()
            for out in got:
                np.testing.assert_array_equal(out.cpu().numpy(), exact,
                                              err_msg=schedule)


@pytest.mark.parametrize("tile", [(8, 32, 4), (1, 1024, 4), (1024, 1, 1)])
@pytest.mark.parametrize("s,t", [(1, 1), (1, 8), (8, 8), (3, 5)])
def test_vpu_one_hot_words(cuda_device, tile, s, t):
    """One-hot words through the 'vpu' kernels (_one_hot_words)."""
    _one_hot_words(cuda_device, _vpu_policy(tile), s, t)


@pytest.mark.parametrize("tile", [(8, 32, 4), (1, 1024, 4), (1024, 1, 1)])
@pytest.mark.parametrize("s,t", [(1, 1), (1, 8), (8, 8), (3, 5)])
def test_mxu_one_hot_words(cuda_device, tile, s, t):
    """One-hot words through the 'mxu' kernels (_one_hot_words)."""
    _one_hot_words(cuda_device, _mxu_policy(tile), s, t)


# ------------------------------------- §4.6 subgraph packing and the figures

def _packing_batch(odd):
    from repro_torch.graph import batching, datasets, partition

    data = datasets.load("proteins", scale=0.02, seed=2)
    parts = partition.partition(data.csr, 4)
    b = batching.make_batches(data, parts, batch_size=2, tile=64,
                              shuffle=False)[0]
    if odd:
        b = dataclasses.replace(b, edges=np.concatenate(
            [b.edges, -np.ones((2, 1 + b.edges.shape[1] % 2), np.int32)], 1))
    return b


@pytest.mark.parametrize("odd", [False, True], ids=["even_e_cap", "odd_e_cap"])
@pytest.mark.parametrize("nbits", [1, 8])
def test_transfers_on_card_equal_cpu(cuda_device, odd, nbits):
    from repro_torch.graph import packing

    b = _packing_batch(odd)
    for fn in (packing.transfer_dense, packing.transfer_sparse):
        for got, want in zip(fn(b, device=cuda_device), fn(b, device="cpu")):
            assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    adj, planes, meta = packing.transfer_packed(b, nbits, device=cuda_device)
    cadj, cplanes, cmeta = packing.transfer_packed(b, nbits, device="cpu")
    assert meta == cmeta and torch.equal(adj.cpu(), cadj)
    assert torch.equal(planes.cpu(), cplanes)
    assert planes.data_ptr() % 16 == (8 if odd else 0)
    feats, fmeta = packing.transfer_packed_feats(b, nbits, device=cuda_device)
    assert torch.equal(feats.cpu(), cplanes) and fmeta["e_cap"] == 0


def test_staging_buffer_is_reused_and_grown(cuda_device):
    from repro_torch.graph import packing

    b = _packing_batch(False)
    packing._STAGING.pop(cuda_device, None)  # start with no buffer
    packing.transfer_packed(b, 8, device=cuda_device)
    slot = packing._STAGING[cuda_device]
    first = slot.buf.data_ptr(), slot.buf.numel()
    out = [packing.transfer_packed(b, 8, device=cuda_device)[1] for _ in range(3)]
    assert (slot.buf.data_ptr(), slot.buf.numel()) == first  # reused
    packing.transfer_dense(b, device=cuda_device)  # more bytes: grown
    assert slot.buf.numel() > first[1]
    torch.cuda.synchronize()
    assert all(torch.equal(o, out[0]) for o in out)
    assert slot.done.query()


@pytest.mark.parametrize("mode", ["vpu", "mxu"])
@pytest.mark.parametrize("nbits", [1, 4, 8])
def test_unpacked_planes_feed_the_kernels_on_card(cuda_device, mode, nbits):
    """The planes, a view 8- but not 16-byte aligned into the copied buffer
    (odd e_cap), as A of both modes' kernels: equal to the plain engine."""
    from repro_torch.graph import packing

    _, planes, meta = packing.transfer_packed(_packing_batch(True), nbits,
                                              device=cuda_device)
    assert planes.data_ptr() % 16 == 8
    rng = np.random.default_rng(nbits)
    w = torch.as_tensor(rng.integers(0, 1 << nbits, (meta["d"], 16)),
                        dtype=torch.int32, device=cuda_device)
    wp = bitops.pack_b(w, nbits)
    name = "bitserial_gemm" + ("_mxu" if mode == "mxu" else "")
    before = LAUNCHES[name]
    got = api.bitserial_mm_packed(planes, wp, backend="cuda",
                                  policy=api.ExecutionPolicy(mode=mode))
    assert LAUNCHES[name] == before + 1
    want = api.bitserial_mm_packed(planes, wp, backend="popcount")
    assert torch.equal(got, want)


def test_figure_suites_run_on_card_at_smoke_sizes(cuda_device):
    import contextlib
    import io

    from repro_torch.benchmarks import run

    with contextlib.redirect_stdout(io.StringIO()):
        records = run.main(device=cuda_device, smoke=True)
    assert {r["suite"] for r in records} == {s for s, _ in run.SUITES}
    assert any(r["name"] == "fig9b_link_peak" for r in records)


def test_bench_median_times_the_card_with_events(cuda_device):
    from repro_torch.perf.report import bench_median

    x = torch.ones((2048, 2048), device=cuda_device)
    t = bench_median(torch.matmul, x, x, warmup=2, iters=5)
    assert 0 < t < 1


# ------------------------------------------------------------------ training

@pytest.fixture(scope="module")
def train_setup():
    """The reference tests' proteins graph (scale 0.05, 8 parts, 4 a batch),
    built by the port on the host."""
    from repro_torch.graph import datasets, partition
    from repro_torch.train import intpath, trainer

    data = datasets.load("proteins", scale=0.05, seed=0)
    parts = partition.partition(data.csr, 8)
    batches = trainer.prepare_batches(data, parts, batch_size=4)
    return data, parts, batches, intpath.batch_caps(batches)


@pytest.mark.parametrize("grad_bits,sr", chip_smoke.TRAIN_EQUAL)
@pytest.mark.parametrize("mode", ["vpu", "mxu"])
@pytest.mark.parametrize("bits", [2, 8])
def test_int_training_step_equals_plain_engine_on_card(cuda_device, train_setup,
                                                       bits, mode, grad_bits, sr):
    """One int_bitserial step on the kernels and on torch_dot: loss,
    gradients, updated params and AdamW moments bit-equal."""
    from repro_torch.train import intpath

    data, _, batches, (bp, rp) = train_setup
    cfg = gnn.GNNConfig.paper_gcn(data.features.shape[1], data.n_classes,
                                  bits, bits)
    b = batches[0]
    db = {"art": intpath.build_artifacts(b, bits, block_pad=bp, rem_pad=rp,
                                         device=cuda_device),
          "y": torch.as_tensor(b.labels, device=cuda_device),
          "mask": torch.as_tensor(b.train_mask, device=cuda_device)}
    params = gnn.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device=cuda_device)
    state = torch.Generator(device=cuda_device).manual_seed(5).get_state()
    kernel = bitserial.kernel_name("bitserial_gemm", mode)
    before = dict(LAUNCHES)
    with api.use("cuda", policy=api.ExecutionPolicy(mode=mode)):
        got = chip_smoke.int_step(torch, params, db, cfg, state, grad_bits=grad_bits,
                                  stochastic=sr, device=cuda_device)
    launched = {k: v - before[k] for k, v in LAUNCHES.items() if v != before[k]}
    before = dict(LAUNCHES)
    with api.use("torch_dot"):
        want = chip_smoke.int_step(torch, params, db, cfg, state,
                                   grad_bits=grad_bits, stochastic=sr,
                                   device=cuda_device)
    assert LAUNCHES == before  # the backward, on autograd's thread, too
    assert launched == {kernel: chip_smoke.int_launches_per_step(
        cfg.layers, len(b.part_sizes), grad_bits)}
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert bool(torch.isfinite(got[0]))


@pytest.mark.parametrize("mode", ["vpu", "mxu"])
@pytest.mark.parametrize("bits", [1, 4, 8])
def test_blocked_aggregation_equals_dense_on_card(cuda_device, train_setup, bits,
                                                  mode):
    from repro_torch.train import intpath, trainer

    _, _, batches, (bp, rp) = train_setup
    gen = torch.Generator().manual_seed(bits)
    for b in batches:
        adj = trainer.make_device_batch(b, device=cuda_device)["adj"]
        vq = torch.randint(0, 1 << bits, (b.n_nodes, 16), generator=gen,
                           dtype=torch.int32).to(cuda_device)
        want = (adj.to(torch.float64) @ vq.to(torch.float64)).to(torch.int32)
        for tiles in (False, True):
            art = intpath.build_artifacts(b, bits, block_pad=bp, rem_pad=rp,
                                          with_tiles=tiles, device=cuda_device)
            got = intpath.blocked_aggregate(
                art, vq, backend="cuda", policy=api.ExecutionPolicy(mode=mode))
            assert torch.equal(got, want)


def test_float_edge_scatter_sum_repeats_on_card(cuda_device):
    """Many messages into few rows: the float sum has the same bits on every
    run, and agrees with the CPU's within float32 rounding."""
    gen = torch.Generator().manual_seed(0)
    v = torch.randn((3000, 16), generator=gen)
    src = torch.randint(0, 3000, (40000,), generator=gen, dtype=torch.int32)
    dst = torch.randint(0, 50, (40000,), generator=gen, dtype=torch.int32)
    src[-100:] = -1
    dst[-100:] = -1
    runs = [ops.edge_scatter_sum(v.to(cuda_device), src.to(cuda_device),
                                 dst.to(cuda_device), 3000) for _ in range(4)]
    assert all(torch.equal(r, runs[0]) for r in runs)
    cpu = ops.edge_scatter_sum(v, src, dst, 3000)
    torch.testing.assert_close(runs[0].cpu(), cpu, rtol=1e-4, atol=1e-4)
    vi = torch.randint(0, 256, (3000, 16), generator=gen, dtype=torch.int32)
    got = ops.edge_scatter_sum(vi.to(cuda_device), src.to(cuda_device),
                               dst.to(cuda_device), 3000)
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), ops.edge_scatter_sum(vi, src, dst, 3000))


def test_trainer_runs_both_paths_on_card(cuda_device, train_setup):
    from repro_torch.train import trainer

    data, parts, batches, _ = train_setup
    cfg = gnn.GNNConfig.paper_gcn(data.features.shape[1], data.n_classes, 4, 4)
    for kw in ({"path": "fake"}, {"path": "int_bitserial", "grad_bits": 8,
                                  "stochastic": True, "grad_compress_bits": 8}):
        before = LAUNCHES["bitserial_gemm"]
        params, _, hist = trainer.train(
            data, parts, cfg, trainer.TrainConfig(steps=3, log_every=1, **kw),
            batch_size=4, device=cuda_device)
        launched = LAUNCHES["bitserial_gemm"] - before
        per_step = (chip_smoke.int_launches_per_step(cfg.layers, 4, 8)
                    if kw["path"] != "fake" else 0)
        assert launched == 3 * per_step
        assert all(np.isfinite(r["loss"]) for r in hist)
        assert params["layer0"]["w"].device.type == cuda_device.type
        acc = trainer.evaluate(params, data, parts, cfg, qat=True,
                               device=cuda_device)
        assert 0.0 <= acc <= 1.0


# ------------------------------------------------------------------ serving

@pytest.fixture(scope="module")
def serve_setup():
    """ogbn-arxiv at 0.008, 8 parts: requests, buckets, qgtc-gcn 8-bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.graph import datasets, partition
    from repro_torch.serve import requests_from_partitions
    from repro_torch.serve.queue import buckets_for

    data = datasets.load("ogbn-arxiv", scale=0.008, seed=0)
    reqs = requests_from_partitions(data, partition.partition(data.csr, 8))
    cfg = gnn.GNNConfig.paper_gcn(data.features.shape[1], data.n_classes)
    params = gnn.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cuda")
    return cfg, gnn.quantize_params(params, cfg), reqs, buckets_for(reqs, levels=3)


def _serve(serve_setup, rounds=2, **kw):
    """Serve the traffic ``rounds`` times; (server, logits in submit order)."""
    from repro_torch.serve import GNNServer, SubgraphRequest

    cfg, qp, reqs, buckets = serve_setup
    srv = GNNServer(qp, cfg, buckets=buckets, tuning_table=None,
                    devices=["cuda"], **kw)
    out = []
    for _ in range(rounds):
        ids = [srv.submit(SubgraphRequest(edges=r.edges, features=r.features,
                                          n_nodes=r.n_nodes)) for r in reqs]
        got = srv.drain(return_logits=True)
        out += [got[i][1] for i in ids]
    return srv, out


@pytest.mark.parametrize("jump", ["none", "compact", "sgt"])
@pytest.mark.parametrize("mode", ["vpu", "mxu"])
def test_server_on_card_equals_torch_dot(cuda_device, serve_setup, mode, jump):
    """GNNServer on the kernel engine serves the logits of the plain
    engine on the card, bit for bit, through one kernel launched 6 times
    a GCN batch."""
    pol = api.ExecutionPolicy(mode=mode, jump=jump)
    _, want = _serve(serve_setup, backend="torch_dot", policy=pol)
    bitserial.reset_launches()
    srv, got = _serve(serve_setup, backend="cuda", policy=pol)
    kernel = "bitserial_gemm" if mode == "vpu" else "bitserial_gemm_mxu"
    assert bitserial.LAUNCHES[kernel] == 6 * srv.stats.batches > 0
    assert sum(bitserial.LAUNCHES.values()) == bitserial.LAUNCHES[kernel]
    for g, w in zip(got, want):
        assert torch.equal(torch.from_numpy(g), torch.from_numpy(w))
    assert srv.cache.hits > 0 and srv.stats.replicas_live == 1


def test_server_on_card_equals_the_cpu(cuda_device, serve_setup):
    """The card's logits are the port's on the CPU within 1e-5."""
    pol = api.ExecutionPolicy(jump="compact")
    _, got = _serve(serve_setup, rounds=1, policy=pol)
    cfg, qp, reqs, buckets = serve_setup
    from repro_torch.serve import GNNServer, SubgraphRequest

    cpu = GNNServer(qp, cfg, buckets=buckets, tuning_table=None, policy=pol,
                    devices=["cpu"])
    ids = [cpu.submit(SubgraphRequest(edges=r.edges, features=r.features,
                                      n_nodes=r.n_nodes)) for r in reqs]
    want = cpu.drain(return_logits=True)
    for g, i in zip(got, ids):
        np.testing.assert_allclose(g, want[i][1], rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- tuning
def test_smoke_sweep_on_card(cuda_device):
    """The smoke grid on the card: every arm equal to torch_dot (asserted
    inside run_sweep), one entry a cell and a bucket, the 1200-thread
    candidate rejected legibly, the table stamped with this card."""
    from repro_torch.tune import sweep

    res = sweep.run_sweep(dict(sweep.SMOKE_CONFIG), log=lambda *_: None,
                          source="smoke", device=cuda_device)
    assert len(res.table) == 6 + 2
    assert [r["source"] for r in res.rejected] == ["smoke:candidates[3]"]
    assert all(r["median_ms"] > 0 for r in res.records)
    meta = res.table.meta
    assert meta["swept_on"] == "cuda"
    assert meta["device"] == torch.cuda.get_device_name(0)
    assert meta["card"] and meta["card"].endswith("W")


def test_packaged_table_loads_strict_on_card(cuda_device):
    """The packaged H100 table loads strict, was measured on this kind of
    card, and holds a bitserial_mm entry at the main path's adjacency."""
    from repro_torch.tune import table

    t = table.TuningTable.load(table.DEFAULT_TABLE_PATH, strict=True)
    assert t.meta["device"] == torch.cuda.get_device_name(0)
    assert t.meta["generated_by"] == "repro_torch.launch.sweep"
    assert t.lookup("bitserial_mm", bits=8, sparsity=0.0,
                    shape=(2304, 2304, 16)).shape_bucket == (2304, 2304, 16)
    assert {e.op for e in t.entries} >= {"bgemm", "bitserial_mm",
                                         "bitserial_fused", "serve_forward"}


@pytest.mark.parametrize("bits", [2, 8])
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_tuned_forward_equals_untuned_on_card(cuda_device, model, bits):
    """forward_qgtc with no policy under the packaged table: the same logits
    as with tuning off, through the layers' count of bit-serial launches in
    whichever modes the table picked."""
    from repro_torch.tune import table

    packaged = table.TuningTable.load(table.DEFAULT_TABLE_PATH, strict=True)
    rng = np.random.default_rng(bits)
    n, d = 640, 128
    adj = (rng.random((n, n)) < 0.02).astype(np.float32)
    adj = torch.as_tensor(np.maximum(adj, adj.T), device=cuda_device)
    x = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32),
                        device=cuda_device)
    inv_deg = 1.0 / (adj.sum(1, keepdim=True).float() + 1.0)
    make = gnn.GNNConfig.paper_gcn if model == "gcn" else gnn.GNNConfig.paper_gin
    cfg = dataclasses.replace(make(d, 40), x_bits=bits, w_bits=bits)
    params = gnn.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device=cuda_device)
    qp = gnn.quantize_params(params, cfg)
    out = {}
    for name, tbl in (("tuned", packaged), ("untuned", None)):
        with table.use_table(tbl):
            before = dict(LAUNCHES)
            out[name] = gnn.forward_qgtc(qp, adj, x, inv_deg, cfg)
            launched = {k: v - before[k] for k, v in LAUNCHES.items()
                        if v != before[k]}
        assert set(launched) <= {"bitserial_gemm", "bitserial_gemm_mxu"}
        assert sum(launched.values()) == cfg.layers * (2 if model == "gcn"
                                                       else 3)
    torch.cuda.synchronize()
    assert torch.equal(out["tuned"], out["untuned"])


# ------------------------------------------------------------------ analysis

@pytest.mark.parametrize("s,t,shape", [(32, 32, (4, 16, 4)),
                                       (24, 24, (64, 4096, 48)),
                                       (8, 8, (300, 700, 130)),
                                       (1, 8, (37, 333, 5))])
def test_torch_dot_exact_int32_on_card(cuda_device, s, t, shape):
    """torch_dot's card route (int8 limb products) equals the exact int64
    product wrapped to int32, with no float GEMM among its aten ops; the
    first case is a 4 x 16 x 4 product of whole int32s, where a float64
    product is wrong in every entry."""
    from repro_torch.analysis import trace

    m, k, n = shape
    rng = np.random.default_rng(0)
    lo_a, hi_a = (-2**31, 2**31) if s == 32 else (0, 1 << s)
    lo_b, hi_b = (-2**31, 2**31) if t == 32 else (0, 1 << t)
    a, b = rng.integers(lo_a, hi_a, (m, k)), rng.integers(lo_b, hi_b, (k, n))
    want = (a.astype(np.int64) @ b.astype(np.int64)).astype(np.int32)
    ta = torch.as_tensor(a.astype(np.int32), device=cuda_device)
    tb = torch.as_tensor(b.astype(np.int32), device=cuda_device)
    got, ops = trace.record_ops(
        lambda x, y: api.bitserial_mm(x, y, s, t, backend="torch_dot"), ta, tb)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert "_int_mm" in {op for op, _ in ops}
    assert not set(trace.float_ops(ops)) & trace.GEMM_OPS


def test_trace_checks_pass_on_card(cuda_device):
    """Every engine's integer paths, the fused path, the tiles= errors, the
    int training step and the policy sites, on the card: no failure, and
    the cuda engine's ops launched their kernels."""
    from repro_torch.analysis import trace

    report = trace.run_trace_checks(device=cuda_device, log=lambda *_: None)
    assert report["failures"] == []
    assert report["device"].startswith("cuda")
    assert {"bitserial_gemm", "bitserial_fused", "bgemm"} <= set(
        report["launches"])


# ------------------------------------------------------------- LM serving

def _lm_case(arch):
    """A float32 smoke config of ``arch`` (MoE dropless), its parameters
    drawn on the CPU, and a batch of 2 x 17 tokens with its stub inputs."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.train import data

    cfg = dataclasses.replace(configs.smoke_config(configs.get(arch)),
                              dtype="float32")
    if cfg.moe_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=float(cfg.moe_experts) / cfg.moe_top_k)
    params, _ = lm.init_lm(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    batch = data.batch_for_arch(cfg, 0, 0, 2, 17, device="cpu")
    batch = {k: v.float() if v.is_floating_point() else v
             for k, v in batch.items()}
    return cfg, params, batch


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _lm_rel(got, ref) -> float:
    got, ref = got.float().cpu(), ref.float().cpu()
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-12))


@pytest.fixture
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "olmoe-1b-7b",
                                  "internvl2-2b", "rwkv6-1.6b", "zamba2-7b",
                                  "whisper-large-v3", "h2o-danube-3-4b"])
def test_lm_on_card_matches_cpu(cuda_device, no_tf32, arch):
    """Each family (and SWA): prefill and 4 teacher-forced decode steps on
    the card against the port on the CPU, within 1e-4 relative."""
    from repro_torch.models import lm

    cfg, params, batch = _lm_case(arch)
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    prompt["tokens"] = batch["tokens"][:, :13]
    outs = {}
    for dev in ("cpu", cuda_device):
        p, b = _to(params, dev), _to(prompt, dev)
        logits, cache = lm.prefill(p, b, cfg, max_seq=24)
        got = [logits]
        for i in range(4):
            tok = batch["tokens"][:, 13 + i:14 + i].to(dev)
            logits, cache = lm.decode_step(p, cache, tok, cfg)
            got.append(logits)
        outs[str(dev)] = got
    for a, b in zip(outs["cpu"], outs[str(cuda_device)]):
        assert b.device.type == "cuda"
        assert _lm_rel(b, a) <= 1e-4


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "moonshot-v1-16b-a3b",
                                  "rwkv6-1.6b", "zamba2-7b",
                                  "whisper-large-v3", "internvl2-2b"])
def test_lm_decode_matches_forward_on_card(cuda_device, no_tf32, arch):
    from repro_torch.models import lm

    cfg, params, batch = _lm_case(arch)
    p, b = _to(params, cuda_device), _to(batch, cuda_device)
    h = lm.forward_hidden(p, b, cfg)
    want = h[:, -1] @ lm._head_matrix(p, cfg)
    _, cache = lm.prefill(p, dict(b, tokens=b["tokens"][:, :-1]), cfg,
                          max_seq=24)
    got, _ = lm.decode_step(p, cache, b["tokens"][:, -1:], cfg)
    assert _lm_rel(got, want) <= 1e-4


def test_lm_launcher_on_card(cuda_device):
    from repro_torch.launch import serve

    result = serve.main(["--arch", "rwkv6-1.6b", "--smoke", "--requests", "4",
                         "--batch-slots", "2", "--max-new", "4",
                         "--wq-bits", "4"])
    assert result["requests"] == 4 and result["device"] != "cpu"
    assert all(s["tokens_generated"] == 8 for s in result["stats"])


# ------------------------------------------------------------ LM training

def _grads_on(cfg, params, batch, device):
    from repro_torch.launch import steps

    loss, _, grads = steps.loss_and_grads(_to(params, device),
                                          _to(batch, device), cfg, t_chunk=8)
    return loss, grads


def _flat_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_leaves(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "olmoe-1b-7b",
                                  "internvl2-2b", "rwkv6-1.6b", "zamba2-7b",
                                  "whisper-large-v3", "h2o-danube-3-4b"])
def test_lm_gradients_on_card_match_cpu(cuda_device, no_tf32, arch):
    """Each family: the loss and every leaf's gradient on the card against
    the port on the CPU, within 1e-4 of the leaf's largest CPU value."""
    cfg, params, batch = _lm_case(arch)
    loss_c, g_c = _grads_on(cfg, params, batch, "cpu")
    loss_d, g_d = _grads_on(cfg, params, batch, cuda_device)
    assert abs(loss_d.item() - loss_c.item()) <= 1e-4 * abs(loss_c.item())
    g_c, g_d = _flat_leaves(g_c), _flat_leaves(g_d)
    assert set(g_c) == set(g_d)
    for name, g in g_c.items():
        assert g_d[name].device.type == "cuda"
        assert _lm_rel(g_d[name], g) <= 1e-4, name


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "olmoe-1b-7b",
                                  "rwkv6-1.6b", "zamba2-7b",
                                  "whisper-large-v3"])
def test_lm_remat_modes_agree_on_card(cuda_device, no_tf32, arch):
    """none, dots and full on the card: within 1e-6 of each other (MoE
    combines its experts with a scatter whose adds may run in any order),
    bit for bit on the dense arch."""
    cfg, params, batch = _lm_case(arch)
    out = {r: _grads_on(dataclasses.replace(cfg, remat=r), params, batch,
                        cuda_device) for r in ("none", "dots", "full")}
    base = _flat_leaves(out["none"][1])
    for r in ("dots", "full"):
        for name, g in _flat_leaves(out[r][1]).items():
            if arch == "codeqwen1.5-7b":
                assert torch.equal(g, base[name]), (r, name)
            else:
                assert _lm_rel(g, base[name]) <= 1e-6, (r, name)


def test_train_launchers_on_card(cuda_device, tmp_path, capsys):
    """The LM launcher on the card, and the GNN launcher's int path through
    the hand-written bitserial_gemm: its launches a step as the trainer's
    GEMMs count them (3 layers, 4 diagonal blocks a batch)."""
    from repro_torch.kernels import _build
    from repro_torch.launch import train

    res = train.main(["--arch", "rwkv6-1.6b", "--smoke", "--steps", "4",
                      "--batch", "2", "--seq", "32", "--log-every", "1",
                      "--ckpt-dir", str(tmp_path)])
    assert res["device"].startswith("cuda") and len(res["history"]) == 4
    _build.reset_launches()
    res = train.main(["--arch", "qgtc-gcn", "--smoke", "--int-path",
                      "--steps", "2", "--log-every", "1"])
    assert res["device"].startswith("cuda")
    assert _build.LAUNCHES["bitserial_gemm"] == 2 * \
        chip_smoke.int_launches_per_step(3, 4, 0)
