"""Port parity for ``mode="mxu"``, the tensor-core compute mode of the three
bit-GEMM kernels (``bitserial_gemm``, ``bitserial_fused``, ``bgemm``).

On the CPU every wrapper takes its kernel's plain version, which does not
depend on the mode, so 'mxu' must give exactly the int32 that 'vpu' gives
and that the reference's Pallas kernels give at ``mode="mxu"`` in interpret
mode (tolerance 0, as ``tests/test_kernels.py`` holds its compute modes).
The GNN forwards agree with the reference's within rtol = atol = 1e-5, the
tolerance of ``tests/test_torch_gnn.py``. The tensor-core kernel itself is
held to its plain version on the card in ``tests/test_torch_cuda.py``.
"""
import dataclasses
import itertools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api.policy import ExecutionPolicy as JPolicy  # noqa: E402
from repro.core import bitops as jbitops  # noqa: E402
from repro.core import zerotile as jzt  # noqa: E402
from repro.graph import batching as jbatching  # noqa: E402
from repro.graph import datasets as jdatasets  # noqa: E402
from repro.graph import partition as jpartition  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import sgt as jsgt  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import backends  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import bitops, bittensor as bt, zerotile  # noqa: E402
from repro_torch.core.bitops import popcount32, wrap_int32  # noqa: E402
from repro_torch.graph import batching, datasets, partition  # noqa: E402
from repro_torch.kernels import bitserial, ops, sgt  # noqa: E402
from repro_torch.kernels._build import LAUNCHES  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

# one tile grid both packages take (the reference wants block_n % 128 == 0)
GRID = dict(block_m=8, block_n=128, block_w=4)
JMXU = JPolicy(**GRID, mode="mxu", interpret=True)
MXU = api.ExecutionPolicy(**GRID, mode="mxu")
SCHEDULES = ["none", "mask", "compact", "sgt"]
ST_PAIRS = [(1, 1), (2, 3), (8, 2), (3, 8)]
# tiles the port's policy accepts, down to one row or one column and up to
# 1024 threads: the mxu kernel rounds each up to m16 x n8 fragments
TILES = [(8, 32, 4), (1, 32, 1), (16, 8, 8), (32, 32, 9), (1, 1024, 4),
         (32, 1, 2), (2, 16, 3), (4, 8, 5), (1024, 1, 1)]


MMA_HEADER = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
              / "bitserial_mma.cuh")
MAX_SMEM = 232_448  # shared memory one block may use on Hopper


def _header_constants():
    """The launch constants of csrc/bitserial_mma.cuh, read from the header,
    so that the mirror below follows the kernel's own numbers."""
    text = MMA_HEADER.read_text()
    found = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;?]+);", text, re.M):
        found[name] = eval(expr, {}, dict(found))  # products of earlier names
    frags = re.search(r"kMaxFrags = kOneBit \? (\d+) : (\d+);", text)
    found["kMaxFrags"] = {True: int(frags[1]), False: int(frags[2])}
    return found


MMA = _header_constants()


def _mxu_launch(t, w, n, m, schedule, block_m, one_bit=False):
    """What launch_mma_kernel (csrc/bitserial_mma.cuh) launches for t planes
    of B, W words of K, N columns and M rows: a warp a 16-row strip,
    kMmaWarps strips a block, a column block of a power of two fragments
    halved while t planes of all of K would exceed kStageBytes, and the K
    window that then fits. The tile enters only through block_m, and only
    to say whether a list schedule's strips lie in one row tile."""
    frags = 1
    while frags < MMA["kMaxFrags"][one_bit] and 8 * frags < n:
        frags *= 2

    def row_words(f):
        return 8 * f + (8 if (8 * f) % 16 == 0 else 0)

    while frags > 1 and 4 * t * w * row_words(frags) > MMA["kStageBytes"]:
        frags //= 2
    kwin = min(w, MMA["kStageBytes"] // (4 * t * row_words(frags)))
    if kwin < w:
        kwin = max(4, kwin // 4 * 4)
    short = w <= MMA["kPairWords"] and (schedule != "list" or block_m % 16 == 0)
    stage = (MMA["kMaxPlanes"] * 16 * MMA["kPairWords"] if short
             else MMA["kWarpStageWords"])
    strips = -(-m // 16)
    return {"grid": (-(-strips // MMA["kMmaWarps"]), -(-n // (8 * frags))),
            "threads": 32 * MMA["kMmaWarps"], "frags": frags, "kwin": kwin,
            "short": short,
            "smem": 4 * (t * kwin * row_words(frags) + MMA["kMmaWarps"] * stage)}


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


def _banded(rng, m, k, bits):
    """An s-bit operand with a zero band across K and zero row tiles, so that
    every jump schedule skips something."""
    a = rng.integers(0, 1 << bits, (m, k)).astype(np.int32)
    a[:, k // 4: 3 * k // 4] = 0
    a[: m // 3] = 0
    return a


def _both_packed(a, b, s, t):
    ja, jb = jbitops.pack_a(jnp.asarray(a), s), jbitops.pack_b(jnp.asarray(b), t)
    ta, tb = bitops.pack_a(torch.as_tensor(a), s), bitops.pack_b(torch.as_tensor(b), t)
    return ja, jb, ta, tb


def _jump_kwargs(schedule, ap, zt, sg, block_m=GRID["block_m"],
                 block_w=GRID["block_w"]):
    """The same schedule for either package (``zt``/``sg`` are the package's
    zerotile and sgt modules): compact and sgt as precomputed tiles."""
    if schedule == "compact":
        return {"tiles": zt.compact_artifacts(ap, block_m, block_w)}
    if schedule == "sgt":
        return {"tiles": sg.sgt_artifacts(ap, block_m)}
    return {"jump": schedule}


def test_mxu_on_cpu_tensors_returns_the_exact_product():
    """The mode="mxu" call that once raised on CPU tensors: a @ b exactly."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randint(0, 16, (16, 64), generator=gen)
    b = torch.randint(0, 16, (64, 32), generator=gen)
    mxu = api.ExecutionPolicy(mode="mxu")
    got = api.bitserial_mm(a, b, 4, 4, policy=mxu)
    assert got.dtype == torch.int32
    assert torch.equal(got.to(torch.int64), a @ b)
    for backend in ("torch_dot", "popcount"):
        assert torch.equal(api.bitserial_mm(a, b, 4, 4, policy=mxu,
                                            backend=backend), got)
    assert torch.equal(api.bitserial_mm(a, b, 4, 4), got)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("s,t", ST_PAIRS)
def test_bitserial_gemm_mxu_matches_reference(schedule, s, t):
    rng = np.random.default_rng(s * 10 + t)
    m, k, n = 24, 320, 18
    a = _banded(rng, m, k, s)
    b = rng.integers(0, 1 << t, (k, n)).astype(np.int32)
    ja, jb, ta, tb = _both_packed(a, b, s, t)
    want = np.asarray(jops.bitserial_gemm(
        ja, jb, policy=JMXU, **_jump_kwargs(schedule, ja, jzt, jsgt)))
    got = ops.bitserial_gemm(ta, tb, policy=MXU,
                             **_jump_kwargs(schedule, ta, zerotile, sgt))
    vpu = ops.bitserial_gemm(ta, tb, policy=MXU.replace(mode="vpu"),
                             **_jump_kwargs(schedule, ta, zerotile, sgt))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, vpu)
    np.testing.assert_array_equal(want, a.astype(np.int64) @ b)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("s,t", ST_PAIRS)
def test_bitserial_fused_mxu_matches_reference(schedule, s, t):
    rng = np.random.default_rng(s * 10 + t + 1)
    m, k, n = 16, 256, 24
    a = _banded(rng, m, k, s)
    b = rng.integers(0, 1 << t, (k, n)).astype(np.int32)
    ja, jb, ta, tb = _both_packed(a, b, s, t)
    top = max(int((a.astype(np.int64) @ b).max()), 1)
    alpha = (rng.random((m, 1)) * 20 / top).astype(np.float32)
    beta = (rng.random((1, n)) * 8 - 4).astype(np.float32)
    kw = dict(out_bits=4, relu=bool(s % 2))
    want = np.asarray(jops.bitserial_fused(
        ja, jb, jnp.asarray(alpha), jnp.asarray(beta), policy=JMXU, **kw,
        **_jump_kwargs(schedule, ja, jzt, jsgt)))
    args = (ta, tb, torch.as_tensor(alpha), torch.as_tensor(beta))
    got = ops.bitserial_fused(*args, policy=MXU, **kw,
                              **_jump_kwargs(schedule, ta, zerotile, sgt))
    vpu = ops.bitserial_fused(*args, policy=MXU.replace(mode="vpu"), **kw,
                              **_jump_kwargs(schedule, ta, zerotile, sgt))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, vpu)
    assert 0 < len(np.unique(want)) <= 16  # the epilogue spreads the levels


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("pattern", ["random", "banded"])
def test_bgemm_mxu_matches_reference(schedule, pattern):
    rng = np.random.default_rng(7)
    m, k, n = 24, 200, 40
    a = (_banded(rng, m, k, 1) if pattern == "banded"
         else rng.integers(0, 2, (m, k)).astype(np.int32))
    b = rng.integers(0, 2, (k, n)).astype(np.int32)
    ja, jb, ta, tb = _both_packed(a, b, 1, 1)
    want = np.asarray(jops.bgemm(ja[0], jb[0], policy=JMXU,
                                 **_jump_kwargs(schedule, ja[0], jzt, jsgt)))
    got = ops.bgemm(ta[0], tb[0], policy=MXU,
                    **_jump_kwargs(schedule, ta[0], zerotile, sgt))
    vpu = ops.bgemm(ta[0], tb[0], policy=MXU.replace(mode="vpu"),
                    **_jump_kwargs(schedule, ta[0], zerotile, sgt))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, vpu)
    np.testing.assert_array_equal(want, a.astype(np.int64) @ b)


@pytest.mark.parametrize("block_m,block_n,block_w", TILES)
def test_every_vpu_tile_computes_at_mxu(block_m, block_n, block_w):
    """A tile valid at 'vpu' constructs at 'mxu', and all three ops give the
    'vpu' int32 there, in every schedule."""
    vpu = api.ExecutionPolicy(block_m=block_m, block_n=block_n, block_w=block_w)
    mxu = api.ExecutionPolicy(block_m=block_m, block_n=block_n,
                              block_w=block_w, mode="mxu")
    rng = np.random.default_rng(block_m + block_n + block_w)
    s, t, m, k, n = 3, 2, 37, 333, 21
    for schedule in ("dense", "mask", "list"):
        w = -(-k // 32 // block_w) * block_w
        plan = _mxu_launch(t, w, n, m + (-m) % block_m, schedule, block_m)
        assert plan["smem"] <= MAX_SMEM and plan["kwin"] == w
    a = _banded(rng, m, k, s)
    b = rng.integers(0, 1 << t, (k, n)).astype(np.int32)
    ta, tb = bitops.pack_a(torch.as_tensor(a), s), bitops.pack_b(torch.as_tensor(b), t)
    exact = a.astype(np.int64) @ b
    alpha = torch.full((m, 1), 0.05)
    beta = torch.full((1, n), -1.0)
    for schedule in SCHEDULES:
        kw = _jump_kwargs(schedule, ta, zerotile, sgt, block_m, block_w)
        got = ops.bitserial_gemm(ta, tb, policy=mxu, **kw)
        np.testing.assert_array_equal(got.numpy(), exact, err_msg=schedule)
        assert torch.equal(got, ops.bitserial_gemm(ta, tb, policy=vpu, **kw))
        fused = [ops.bitserial_fused(ta, tb, alpha, beta, out_bits=4,
                                     policy=pol, **kw) for pol in (mxu, vpu)]
        assert torch.equal(*fused), schedule
        kw1 = _jump_kwargs(schedule, ta[0], zerotile, sgt, block_m, block_w)
        one = [ops.bgemm(ta[0], tb[0], policy=pol, **kw1) for pol in (mxu, vpu)]
        assert torch.equal(*one), schedule
        np.testing.assert_array_equal(one[0].numpy(),
                                      (a & 1).astype(np.int64) @ (b & 1))


def test_mxu_fragments_fit_every_tile_the_policy_accepts():
    """The mxu launch no longer follows the tile: for every (block_m,
    block_n) that ExecutionPolicy accepts, at shapes from one word of K to
    3125 (two K windows) and from 5 to 130 columns, the launch of
    csrc/bitserial_mma.cuh (mirrored by _mxu_launch from the header's own
    constants) is the same whatever block_n, keeps its shared memory within
    what a block may use and its fragments within kMaxFrags, covers K with
    its windows, keeps a window's words within the 16 bits a slot word
    takes, and finds a window row's plane exactly by its multiply-high; so
    no policy is refused at 'mxu'."""
    block_ms = sorted({bm for bm, bn in itertools.product(range(1, 1025), repeat=2)
                       if bm * bn <= bitserial.MAX_THREADS and bm * bn % 32 == 0})
    assert block_ms[0] == 1 and block_ms[-1] == 1024
    shapes = [(t, w, n, one_bit) for t in (1, 2, 3, 5, 8) for w in (1, 4, 5, 72, 400, 3125)
              for n in (5, 16, 64, 70, 130) for one_bit in (False, True)
              if not one_bit or t == 1]
    for t, w, n, one_bit in shapes:
        plans = {}
        for block_m, schedule in itertools.product(block_ms, ("dense", "mask", "list")):
            plan = _mxu_launch(t, w, n, 2304, schedule, block_m, one_bit)
            # block_m decides only whether a list walk is short, and so
            # its stage of shared memory
            varies = ("short", "smem") if schedule == "list" else ()
            plans.setdefault(schedule, set()).add(
                tuple((k, v) for k, v in plan.items() if k not in varies))
            assert plan["smem"] <= MAX_SMEM, (t, w, n, block_m, plan)
            assert 1 <= plan["frags"] <= MMA["kMaxFrags"][one_bit]
            assert plan["kwin"] == w or plan["kwin"] % 4 == 0
            assert 0 < plan["kwin"] < 0xffff
            kwin = plan["kwin"]
            inv = 0xffffffff // kwin + 1
            rows = range(t * kwin)
            assert kwin == 1 or all((r * inv) >> 32 == r // kwin for r in rows)
        assert all(len(v) == 1 for v in plans.values()), (t, w, n)
    with pytest.raises(ValueError):
        api.ExecutionPolicy(block_m=3, block_n=5, mode="mxu")
    with pytest.raises(ValueError, match="mode"):
        ops.bitserial_gemm(torch.zeros((1, 8, 4), dtype=torch.int32),
                           torch.zeros((1, 4, 8), dtype=torch.int32),
                           mode="tensor")


def _pairing_plan(s, t, words):
    """The short walk's mmas (csrc/bitserial_mma.cuh, ``paired``): for each
    weight d = p + q, groups k < words of 8 // words plane pairs (p, d - p)
    from p_lo + k * (8 // words) on; a group past the weight's last pair
    issues no mma."""
    per = 8 // words
    for d in range(s + t - 1):
        p_lo, p_hi = max(0, d - t + 1), min(d, s - 1)
        for k in range(words):
            start = p_lo + k * per
            if start <= p_hi:
                yield d, [(p, d - p) for p in range(start, min(start + per, p_hi + 1))]


def _paired_product(ap, bp):
    """The short walk's product, mirrored in torch popcounts on packed
    (s, M, W <= 4) x (t, W, N): the words zero in every row and plane are
    dropped, R = 1, 2 or 4 words a pair remain, and an mma's slot j holds
    word j % R of pair j // R; its popcounts carry the one weight 2^d.
    Returns (the int32 product, the mmas issued)."""
    s, m, w = ap.shape
    t, _, n = bp.shape
    used = [x for x in range(w) if bool(ap[:, :, x].ne(0).any())]
    acc = torch.zeros((m, n), dtype=torch.int64)
    if not used:
        return wrap_int32(acc), 0
    words = 1 if len(used) == 1 else 2 if len(used) == 2 else 4
    mmas = 0
    for d, pairs in _pairing_plan(s, t, words):
        mmas += 1
        for j in range(8):
            pair, wi = divmod(j, words)
            if pair >= len(pairs) or wi >= len(used):
                continue  # a slot the mma reads as zero words
            p, q = pairs[pair]
            x = used[wi]
            acc += popcount32(ap[p, :, x][:, None] & bp[q, x, :][None, :]) << d
    return wrap_int32(acc), mmas


@pytest.mark.parametrize("s,t", list(itertools.product(range(1, 9), repeat=2)))
def test_mxu_pairing_plan_equals_plain(s, t):
    """Same-weight plane pairs sharing one k256 mma give the plain
    version's int32, at every K of at most 128 bits (1, 2, 3 or 4 words
    left once the zero words are dropped, a K of 64 bits padded to 128
    included)."""
    rng = np.random.default_rng(s * 9 + t)
    for k, pad in ((16, 0), (32, 0), (40, 0), (64, 64), (100, 0), (128, 0)):
        a = rng.integers(0, 1 << s, (16, k))
        b = rng.integers(0, 1 << t, (k, 8))
        ap = bitops.pack_a(torch.as_tensor(np.pad(a, ((0, 0), (0, pad)))
                                           .astype(np.int32)), s)
        bp = bitops.pack_b(torch.as_tensor(np.pad(b, ((0, pad), (0, 0)))
                                           .astype(np.int32)), t)
        got, mmas = _paired_product(ap, bp)
        want = bitserial.bitserial_gemm_plain(ap, bp, block_m=1, block_w=1)
        assert torch.equal(got, want), k
        np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b)
        words = {1: 1, 2: 2, 3: 4, 4: 4}[-(-k // 32)]
        assert mmas == len(list(_pairing_plan(s, t, words)))
        assert mmas <= -(-s * t * words // 8) + s + t  # fuller than one pair an mma


def test_mxu_pairing_cuts_the_mmas_of_the_feature_gemms():
    """At s = t = 8 the short walk issues 36 mmas a fragment for a K of 4
    words (GIN's and GCN's 128-wide features), 22 for 2 words (64 bits) and
    15 for 1, against the 64 of one plane pair an mma."""
    assert [len(list(_pairing_plan(8, 8, r))) for r in (4, 2, 1)] == [36, 22, 15]
    assert len(list(_pairing_plan(8, 8, 8))) == 64


def test_reuse_false_reaches_bgemm_at_mxu(monkeypatch):
    """The cuda engine's reuse=False route (one bgemm per plane pair) keeps
    the policy's mode, and its sum equals the reuse=True product."""
    seen = []
    real = backends.kops.bgemm

    def spy(a, b, *, policy, tiles=None):
        seen.append(policy.mode)
        return real(a, b, policy=policy, tiles=tiles)

    monkeypatch.setattr(backends.kops, "bgemm", spy)
    rng = np.random.default_rng(3)
    a = torch.as_tensor(rng.integers(0, 4, (20, 100)).astype(np.int32))
    b = torch.as_tensor(rng.integers(0, 8, (100, 9)).astype(np.int32))
    pol = api.ExecutionPolicy(mode="mxu", reuse=False)
    got = api.bitserial_mm(a, b, 2, 3, policy=pol)
    assert seen == ["mxu"] * 6
    assert torch.equal(got, api.bitserial_mm(a, b, 2, 3,
                                             policy=pol.replace(reuse=True)))
    assert torch.equal(got.to(torch.int64), a.to(torch.int64) @ b.to(torch.int64))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_tensor_api_chain_at_mxu_equals_vpu(bits):
    """bitmm2bit -> bitmm2int with the fused epilogue and with reuse=False:
    'mxu' gives the 'vpu' words and int32 on CPU tensors."""
    rng = np.random.default_rng(bits)
    x = torch.as_tensor(rng.normal(size=(40, 64)).astype(np.float32))
    w1 = torch.as_tensor(rng.normal(size=(64, 16)).astype(np.float32))
    w2 = torch.as_tensor(rng.normal(size=(16, 8)).astype(np.float32))
    tx = bt.to_bit(x, bits, pack_axis=1)
    tw1, tw2 = bt.to_bit(w1, bits, pack_axis=0), bt.to_bit(w2, bits, pack_axis=0)
    qp = bt.bitmm2bit(tx, tw1, bits, backend="popcount").qp
    outs = {}
    for mode in ("vpu", "mxu"):
        for fused, reuse in ((True, True), (False, False)):
            pol = api.ExecutionPolicy(mode=mode, fused_requantize=fused,
                                      reuse=reuse)
            h = bt.bitmm2bit(tx, tw1, bits, qp, policy=pol)
            outs[mode, fused] = (h.data, bt.bitmm2int(h, tw2, policy=pol))
    for fused in (True, False):
        assert torch.equal(outs["mxu", fused][0], outs["vpu", fused][0])
        assert torch.equal(outs["mxu", fused][1], outs["vpu", fused][1])


@pytest.fixture(scope="module")
def batch():
    """One two-part ogbn-arxiv batch (scale 0.008), as each package builds it."""
    ref = jdatasets.load("ogbn-arxiv", scale=0.008, seed=0)
    port = datasets.load("ogbn-arxiv", scale=0.008, seed=0)
    jb = jbatching.make_batches(ref, jpartition.partition(ref.csr, 8), 2,
                                shuffle=False)[0]
    tb = batching.make_batches(port, partition.partition(port.csr, 8), 2,
                               shuffle=False)[0]
    return ref, jtrainer.make_device_batch(jb), trainer.make_device_batch(
        tb, device="cpu")


@pytest.mark.parametrize("model", ["gcn", "gin"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_forward_qgtc_mxu_matches_reference(batch, model, bits):
    """The reference's pallas engine at mode="mxu" (interpret) and the
    port's kernel engine at mode="mxu", the same policy and weights."""
    ref, jdb, tdb = batch
    make = jgnn.GNNConfig.paper_gcn if model == "gcn" else jgnn.GNNConfig.paper_gin
    jcfg = dataclasses.replace(make(ref.features.shape[1], ref.n_classes),
                               x_bits=bits, w_bits=bits)
    jparams = jgnn.init_params(jax.random.PRNGKey(0), jcfg)
    want = np.asarray(jgnn.forward_qgtc(
        jgnn.quantize_params(jparams, jcfg), jdb["adj"], jdb["x"],
        jdb["inv_deg"], jcfg, backend="pallas", policy=JMXU))
    tcfg = gnn.GNNConfig(**dataclasses.asdict(jcfg))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    qp = gnn.quantize_params(tparams, tcfg)
    args = (qp, tdb["adj"], tdb["x"], tdb["inv_deg"], tcfg)
    got = gnn.forward_qgtc(*args, policy=MXU)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, gnn.forward_qgtc(*args, policy=MXU.replace(mode="vpu")))
