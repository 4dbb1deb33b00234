"""The CUDA kernel on the card, against its plain version.

Every test here needs a CUDA device and the CUDA toolkit: each carries the
``cuda`` marker and skips where there is no card. The file imports no JAX,
so it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import DEFAULT_POLICY as POL  # noqa: E402
from repro_torch.core import bitops, zerotile  # noqa: E402
from repro_torch.kernels import bitserial, ops, sgt  # noqa: E402
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
