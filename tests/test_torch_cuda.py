"""The CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and the CUDA toolkit: each carries the
``cuda`` marker and skips where there is no card. The file imports no JAX,
so it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.api import DEFAULT_POLICY as POL  # noqa: E402
from repro_torch.core import bitops, bittensor as bt, zerotile  # noqa: E402
from repro_torch.core.quantize import calibrate  # noqa: E402
from repro_torch.kernels import bgemm, bitpack, bitserial, ops, sgt  # noqa: E402
from repro_torch.kernels._build import LAUNCHES  # noqa: E402
from repro_torch.models import gnn  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


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


@pytest.mark.parametrize("nbits", [1, 2, 5, 8])
@pytest.mark.parametrize("m,k", [(8, 256), (20, 100), (129, 33), (2304, 128)])
def test_bitpack_kernel_matches_plain_on_card(cuda_device, nbits, m, k):
    rng = np.random.default_rng(nbits * 10 + m)
    x = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32))
    qp = calibrate(x, nbits)
    before = LAUNCHES["bitpack"]
    cx, cs, cz = _on(cuda_device, x, qp.scale, qp.zero)
    got = ops.bitpack(cx, cs, cz, nbits=nbits)
    assert LAUNCHES["bitpack"] == before + 1
    torch.cuda.synchronize()
    # on the same CUDA tensors, and against the CPU
    assert torch.equal(got, bitpack.bitpack_plain(cx, cs, cz, nbits=nbits,
                                                  words=got.shape[2]))
    assert torch.equal(got.cpu(), ops.bitpack(x, qp.scale, qp.zero, nbits=nbits))


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
