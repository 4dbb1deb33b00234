"""CPU checks of the arithmetic of the 4-bit ``wq_gemm`` kernel
(``src/repro_torch/csrc/wqmm.cu``), mirrored in torch and numpy: no card
and no JAX.

- float32 x as three bf16 pieces: hi + mid + lo is x exactly, for random
  normals at every scale the kernel is given and across the exponent range
  down to 2^-110 (below it the last piece is a bf16 subnormal and the
  residual is at most half of 2^-133, the test's stated bound).
- The kernel's summation order: per group, x's pieces times (q - 8) summed
  16 k at a time in float32, that sum times the group's scale added to a
  float32 accumulator (one rounding, as the kernel's fma), the groups in
  the K slices of the kernel's cluster split, the slices added in rank
  order. It lies within the float32 bound K * 2^-24 * (|x| @ |W|) around a
  float64 product, at every shape of ``chip_smoke.WQ_SHAPES`` and at
  K = 4096 and 13440, groups 8, 16 and 32. The mirror keeps the order, not
  the tensor cores' own rounding inside an mma; the card checks the kernel
  itself (tests/test_torch_cuda.py, chip_smoke.py).
- Why three pieces: at K = 16 and 32, x built so that every two-piece
  residual has the sign of its weight, two pieces break the bound and
  three hold it.
- The kernel's fragment layout: the staged packed tile (swizzled 32-byte
  segments), the words a lane reads, the byte permutes and the 0x4300
  trick give, under the mma's A-fragment layout, exactly W^T's (q - 8) at
  the permuted k order that x's B fragment takes.
The kernel's constants are read from the source itself.
"""
import math
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from repro_torch.kernels import wqmm  # noqa: E402

CU = pathlib.Path(wqmm.__file__).resolve().parents[1] / "csrc" / "wqmm.cu"
SMS = 132  # the H100's SMs, which the split rule reads from the card
U = 2.0 ** -24


def _constants() -> dict:
    """The kernel's `constexpr int` constants, evaluated in order."""
    vals = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;,]+);",
                                 CU.read_text(), re.M):
        vals[name] = eval(expr.replace("/", "//"), {}, dict(vals))
    return vals


C = _constants()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch thread
    each keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def split3(x: torch.Tensor):
    """hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), as float32
    tensors of bf16 values (round to nearest even, as the kernel's cvt)."""
    hi = x.to(torch.bfloat16).float()
    mid = (x - hi).to(torch.bfloat16).float()
    lo = (x - hi - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def choose_split(n: int, k: int, group: int, sms: int = SMS) -> int:
    """csrc/wqmm.cu choose_split: the fewest blocks of a cluster (a power of
    two, at most kMaxSplit) that give every SM a block, while each keeps a
    stage of K and the units allow it. N, K, the group and the SM count."""
    tiles = -(-n // C["kBlockN"])
    unit = group if group % C["kChunk"] == 0 else C["kChunk"]
    units = -(-k // unit)
    split = 1
    while (split < C["kMaxSplit"] and tiles * split < sms and 2 * split <= units
           and k // (2 * split) >= C["kStageK"]):
        split *= 2
    return split


def slices(k: int, group: int, split: int):
    """The K slices [kb, ke) of a cluster's blocks, rank by rank."""
    unit = group if group % C["kChunk"] == 0 else C["kChunk"]
    units = -(-k // unit)
    return [(r * units // split * unit, min((r + 1) * units // split * unit, k))
            for r in range(split)]


def _q(wp: torch.Tensor) -> torch.Tensor:
    """The packed nibbles as (q - 8), float32 (K, N)."""
    k, n = wp.shape[0], 2 * wp.shape[1]
    b = wp.to(torch.int32)
    return torch.stack([(b & 0xF) - 8, ((b >> 4) & 0xF) - 8], -1).reshape(
        k, n).float()


def kernel_order(x: torch.Tensor, wp: torch.Tensor, sc: torch.Tensor,
                 group: int, pieces: int = 3) -> torch.Tensor:
    """x @ W in the kernel's order of adds, in float32 (see the module
    docstring); ``pieces`` of float32 x (bf16 x is its own single piece)."""
    k, n = x.shape[1], 2 * wp.shape[1]
    xs = split3(x.float())[:pieces] if x.dtype == torch.float32 else (x.float(),)
    q = _q(wp)
    chunk = C["kChunk"]
    total = None
    for kb, ke in slices(k, group, choose_split(n, k, group)):
        acc = torch.zeros((x.shape[0], n), dtype=torch.float32)
        g = kb // group
        while g * group < ke:
            lo, hi = max(g * group, kb), min((g + 1) * group, ke)
            # the group's k, cut where the 16-row chunks cut it
            cuts = sorted({lo, hi, *range((lo // chunk + 1) * chunk, hi, chunk)})
            s = None
            for a, b in zip(cuts, cuts[1:]):
                for piece in xs:
                    prod = piece[:, a:b] @ q[a:b]
                    s = prod if s is None else s + prod
            # acc = fma(s, scale, acc): s * scale is exact in float64
            acc = (s.double() * sc[g].double() + acc.double()).float()
            g += 1
        total = acc if total is None else total + acc
    return total


def _bound_ratio(got, x, wp, sc, group):
    w64 = wqmm.unpack_w4(wp, sc, group).double()
    x64 = x.double()
    err = (got.double() - x64 @ w64).abs()
    bound = x.shape[1] * U * (x64.abs() @ w64.abs())
    return (err / bound.clamp_min(1e-300)).max().item()


def _packed(rng, k, n, group):
    w = torch.as_tensor(rng.normal(size=(k, n)).astype(np.float32))
    return wqmm.pack_w4(w, group)


# --------------------------------------------------------- the three pieces

@pytest.mark.parametrize("scale", [1.0, 2.0 ** 20, 2.0 ** -20, 2.0 ** 100,
                                   2.0 ** -100])
def test_three_pieces_sum_to_x_exactly(scale):
    rng = np.random.default_rng(int(math.log2(scale)) + 200)
    x = torch.as_tensor((rng.normal(size=4096) * scale).astype(np.float32))
    hi, mid, lo = split3(x)
    res = (x.double() - hi.double() - mid.double() - lo.double()).abs()
    normal = x.abs() >= 2.0 ** -110
    assert bool((res[normal] == 0).all()) and bool((res <= 2.0 ** -134).all())
    # each piece is bf16 and the pieces fall by 2^8 at least
    for piece in (hi, mid, lo):
        assert torch.equal(piece.to(torch.bfloat16).float(), piece)
    assert bool((mid.abs() <= hi.abs() * 2.0 ** -8).all())
    assert bool((lo.abs() <= mid.abs() * 2.0 ** -8).all())


def test_three_pieces_across_the_exponent_range():
    """Every float32 exponent, 64 random mantissas each: exact down to
    2^-110; below it the residual stays under half the smallest bf16
    subnormal (2^-134)."""
    rng = np.random.default_rng(9)
    exps = np.repeat(np.arange(-126, 127), 64)
    mant = rng.integers(0, 1 << 23, size=exps.size)
    sign = rng.choice([-1.0, 1.0], size=exps.size)
    x = torch.as_tensor((sign * (1 + mant / 2.0 ** 23) * 2.0 ** exps)
                        .astype(np.float32))
    hi, mid, lo = split3(x)
    res = (x.double() - hi.double() - mid.double() - lo.double()).abs()
    normal = torch.as_tensor(exps >= -110)
    assert bool((res[normal] == 0).all())
    assert bool((res[~normal] <= 2.0 ** -134).all())


def test_two_pieces_leave_what_three_take():
    """The two-piece residual is the third piece: below 2^-16 |x|."""
    rng = np.random.default_rng(10)
    x = torch.as_tensor(rng.normal(size=4096).astype(np.float32))
    hi, mid, lo = split3(x)
    res2 = x.double() - hi.double() - mid.double()
    assert torch.equal(res2, lo.double())
    assert bool((res2.abs() <= 2.0 ** -16 * x.double().abs()).all())


# ------------------------------------------------- the kernel's add order

def _order_case(m, k, n, group, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32)).to(dtype)
    wp, sc = _packed(rng, k, n, group)
    got = kernel_order(x, wp, sc, group)
    assert got.shape == (m, n) and bool(torch.isfinite(got).all())
    return _bound_ratio(got, x, wp, sc, group)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [32, 16, 8])
@pytest.mark.parametrize("m,k,n", chip_smoke.WQ_SHAPES)
def test_kernel_order_within_float32_bound(m, k, n, group, dtype):
    assert _order_case(m, k, n, group, dtype, m + k + n + group) <= 1.0


@pytest.mark.parametrize("group", [32, 16, 8])
@pytest.mark.parametrize("k", [4096, 13440])
def test_kernel_order_within_float32_bound_at_lm_depths(k, group):
    """codeqwen1.5-7b's K: d_model (every projection but wd) and d_ff (wd),
    at a narrow N that still takes a cluster of 8."""
    assert choose_split(64, k, group) == 8
    assert _order_case(2, k, 64, group, torch.float32, k + group) <= 1.0


@pytest.mark.parametrize("k", [16, 32])
def test_two_pieces_break_the_bound_three_hold_it(k):
    """One group of K = 16 or 32 (so the bound is 16 or 32 units of 2^-24
    of |x| @ |W|): every x is hi + mid + lo with lo = 1.75 * 2^-18 of the
    sign of its weight, so that the two-piece residuals add up to some 40
    to 75 units."""
    rng = np.random.default_rng(k)
    w = torch.as_tensor(rng.normal(size=(k, 8)).astype(np.float32))
    wp, sc = wqmm.pack_w4(w, k)
    sign = torch.where(_q(wp)[:, 0] >= 0, 1.0, -1.0)
    # hi a bf16 in [1, 2), mid a bf16 in (2^-9, 2^-8), below half hi's last
    # place, lo below half of mid's: x = hi + mid + lo is a float32 and
    # splits back into exactly these three
    hi = torch.as_tensor(1 + rng.integers(0, 128, size=k) / 128.0).float()
    mid = torch.as_tensor(2.0 ** -9 * (1 + rng.integers(1, 128, size=k) / 128.0)
                          ).float()
    lo = sign * 1.75 * 2.0 ** -18
    x = (hi + mid + lo).reshape(1, k)
    assert torch.equal(torch.stack(split3(x[0])), torch.stack([hi, mid, lo]))
    w0 = wqmm.unpack_w4(wp, sc, k)[:, :1]
    three = kernel_order(x, wp, sc, k, pieces=3)[:, :1]
    two = kernel_order(x, wp, sc, k, pieces=2)[:, :1]
    assert _ratio_col(three, x, w0) <= 1.0
    assert _ratio_col(two, x, w0) > 1.0


def _ratio_col(got, x, w):
    x64, w64 = x.double(), w.double()
    err = (got.double() - x64 @ w64).abs()
    return (err / (x.shape[1] * U * (x64.abs() @ w64.abs()))).max().item()


# ------------------------------------------------------- the cluster split

@pytest.mark.parametrize("name,k,n,split", [
    ("wq", 4096, 4096, 8), ("wg", 4096, 13440, 4), ("wd", 13440, 4096, 8),
    ("lm_head", 4096, 92416, 1)])
def test_split_at_the_decode_shapes(name, k, n, split):
    """The cluster sizes PERF.md reports for codeqwen1.5-7b at group 32."""
    assert choose_split(n, k, 32) == split


@pytest.mark.parametrize("k,group", [(4096, 32), (13440, 32), (416, 32),
                                     (416, 16), (416, 8), (96, 12), (15, 5),
                                     (128, 128)])
@pytest.mark.parametrize("n", [64, 300, 4096])
def test_split_slices_cover_k_in_whole_units(k, group, n):
    """The slices partition [0, K), none empty, each boundary on a whole
    group (G a multiple of 16) or a 16-row chunk."""
    split = choose_split(n, k, group)
    assert 1 <= split <= C["kMaxSplit"]
    cuts = slices(k, group, split)
    unit = group if group % C["kChunk"] == 0 else C["kChunk"]
    assert cuts[0][0] == 0 and cuts[-1][1] == k
    for (a, b), (c, _) in zip(cuts, cuts[1:] + [(k, k)]):
        assert a < b and b == c and a % unit == 0


# -------------------------------------------------- the fragment layout

def _byte_perm(x, y, sel):
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
          [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _bf16x2_minus_136(v):
    """nibbles_to_bf16x2: (v & 0x000F000F) | 0x43004300, each half a bf16
    of 128 + q, minus 136 in bf16 -> the two halves as floats."""
    biased = (v & 0x000F000F) | 0x43004300
    halves = np.array([biased & 0xFFFF, biased >> 16], dtype=np.uint16)
    vals = torch.from_numpy(halves.view(np.int16)).view(torch.bfloat16)
    return (vals - torch.tensor(136.0, dtype=torch.bfloat16)).float().tolist()


@pytest.mark.parametrize("chunk", range(4))
@pytest.mark.parametrize("warp_n", range(4))
def test_fragment_layout_is_w_transposed(warp_n, chunk):
    rng = np.random.default_rng(warp_n * 4 + chunk)
    rows, row_bytes = C["kStageK"], C["kRowBytes"]
    tile = rng.integers(0, 256, size=(rows, row_bytes))  # the stage's bytes
    # the copies' swizzle: 32-byte segment s of row r at s ^ ((r / 4) % 4)
    slot = np.zeros(rows * row_bytes, dtype=np.int64)
    for r in range(rows):
        for b in range(row_bytes):
            slot[r * row_bytes + (((b >> 5) ^ ((r >> 2) & 3)) << 5) + (b & 31)] = \
                tile[r, b]
    a = np.zeros((4, 16, 16))  # four m16 tiles of A = W^T (q - 8)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        base = 4 * t * row_bytes + ((warp_n ^ t) << 5) + 4 * g
        w = [sum(int(slot[base + (chunk * 16 + i) * row_bytes + j]) << (8 * j)
                 for j in range(4)) for i in range(4)]
        for p in range(4):
            sel = p | (p << 4) | ((4 + p) << 8) | ((4 + p) << 12)
            d01, d23 = _byte_perm(w[0], w[1], sel), _byte_perm(w[2], w[3], sel)
            # the mma.m16n8k16 A fragment: registers 0..3 hold (row g, k 2t..),
            # (row g+8, k 2t..), (row g, k 2t+8..), (row g+8, k 2t+8..)
            a[p, g, 2 * t:2 * t + 2] = _bf16x2_minus_136(d01)
            a[p, g + 8, 2 * t:2 * t + 2] = _bf16x2_minus_136(d01 >> 4)
            a[p, g, 2 * t + 8:2 * t + 10] = _bf16x2_minus_136(d23)
            a[p, g + 8, 2 * t + 8:2 * t + 10] = _bf16x2_minus_136(d23 >> 4)
    # what it must be: tile p's row g is column 2(4g + p) of the warp's 64,
    # row g+8 the next one; the mma's k 2t, 2t+1, 2t+8, 2t+9 are the chunk's
    # rows 4t .. 4t+3 (x's B fragment takes the same order)
    q = np.stack([(tile & 0xF) - 8, (tile >> 4) - 8], -1).reshape(rows, 2 * row_bytes)
    perm = [4 * (kk % 8 // 2) + 2 * (kk // 8) + kk % 2 for kk in range(16)]
    for p in range(4):
        cols = [warp_n * 64 + 2 * (4 * g + p) for g in range(8)]
        cols += [c + 1 for c in cols]
        want = q[chunk * 16 + np.array(perm)][:, cols].T
        np.testing.assert_array_equal(a[p], want)
