"""CPU mirror of how the bitpack kernel (``src/repro_torch/csrc/bitpack.cu``)
builds its words, in numpy: no card and no JAX.

The kernel gives each lane 4 consecutive columns of a 128-column chunk,
packs the lane's four levels a byte each, moves all planes across the 8
lanes of a word with three xor shuffles (a butterfly transpose), fixes the
bit order with two delta swaps, stages each tile's words in shared memory
plane by plane and stores each plane's rows as one run. The mirror repeats
those steps, with the kernel's constants, exchanges, delta swaps and
lane-to-plane rule read from the source itself, and the launcher's tile
choice, and must give ``bitpack_plain``'s planes word for word: nbits 1..8,
K from 1 to past a tile's 4096 columns, words past ceil(K / 32) (some not a
multiple of 4), rows not a multiple of a tile's, and the SM counts that make
a tile's rows differ. The levels there are the plain version's; the
kernel's quotient, RN(a * RN(1/scale)) corrected by one fma (Markstein), is
held apart against the exact rational quotient, rounded to float32, at
scales across the kernel's range and at quotients next to every integer a
level can take. The card checks the kernel itself (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import math
import pathlib
import re
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.quantize import calibrate  # noqa: E402
from repro_torch.kernels import bitpack  # noqa: E402

CU = pathlib.Path(bitpack.__file__).resolve().parents[1] / "csrc" / "bitpack.cu"
SOURCE = CU.read_text()
SMS = 132  # the H100's SMs, which the launcher reads from the card
MASK32 = np.uint64(0xFFFFFFFF)


def _constants() -> dict:
    """The kernel's `constexpr int` constants, evaluated in order."""
    vals = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);", SOURCE, re.M):
        vals[name] = eval(expr.replace("/", "//"), {}, dict(vals))
    return vals


C = _constants()
# (lane bit, bit-index bit, mask) of each exchange, in the kernel's order
EXCHANGES = [(int(a), int(b), int(m, 16)) for a, b, m in
             re.findall(r"x = exchange<(\d+), (\d+), (0x[0-9A-Fa-f]+)u>\(x, h\);",
                        SOURCE)]
# (mask, shift) of each delta swap, in order
DELTA_SWAPS = [(int(m, 16), int(s)) for m, s in
               re.findall(r"x = delta_swap\(x, (0x[0-9A-Fa-f]+)u, (\d+)\);", SOURCE)]
PLANE_OF_LANE = re.search(r"int plane_of_lane\(int h\) \{\s*return (.+?);",
                          SOURCE, re.S).group(1)


def plane_of_lane(h):
    return eval(PLANE_OF_LANE, {}, {"h": h})


def test_the_source_states_what_the_mirror_reads():
    assert C["kColsPerLane"] * C["kLanesPerWord"] == 32
    assert C["kWordsPerChunk"] * C["kLanesPerWord"] == 32
    assert C["kTasks"] == C["kWarps"] * C["kUnroll"]
    assert C["kThreads"] == 32 * C["kWarps"]
    assert C["kPlaneStride"] >= C["kTasks"] * C["kWordsPerChunk"]
    assert C["kPlaneStride"] % 4 == 0  # 16-byte reads of a plane's run
    assert len(EXCHANGES) == 3 and len(DELTA_SWAPS) == 2
    # the exchanges pair the three bits of a word group's lane index with
    # the three plane bits of the bit index (bit 8c + p)
    assert sorted(e[0] for e in EXCHANGES) == [0, 1, 2]
    assert sorted(e[1] for e in EXCHANGES) == [0, 1, 2]
    for _, bit, mask in EXCHANGES:
        assert mask == sum(1 << i for i in range(32) if i >> bit & 1)
    assert sorted(plane_of_lane(h) for h in range(8)) == list(range(8))


def _exchange(x, lane_bit, bit, mask):
    """One `exchange` over the last (lane) axis of 32."""
    h = np.arange(32) & (C["kLanesPerWord"] - 1)
    up = (h >> lane_bit) & 1 == 1
    mask = np.uint64(mask)
    keep = np.where(up, mask, ~mask & MASK32)
    d = np.uint64(1 << bit)
    rotl = ((x << d) | (x >> (np.uint64(32) - d))) & MASK32  # __funnelshift_l
    rotr = ((x >> d) | (x << (np.uint64(32) - d))) & MASK32
    send = np.where(up, rotl, rotr)
    got = send[..., np.arange(32) ^ (1 << lane_bit)]  # __shfl_xor_sync
    return (x & keep) | (got & ~keep & MASK32)


def _delta_swap(x, mask, shift):
    mask, shift = np.uint64(mask), np.uint64(shift)
    t = ((x >> shift) ^ x) & mask
    return (x ^ t ^ (t << shift)) & MASK32


def lane_words(q):
    """The word each lane holds after the transpose, for levels q (..., 32
    lanes, 4 columns): the kernel's byte packing, exchanges and swaps."""
    q = q.astype(np.uint64)
    x = q[..., 0] | q[..., 1] << np.uint64(8) | q[..., 2] << np.uint64(16) \
        | q[..., 3] << np.uint64(24)
    for lane_bit, bit, mask in EXCHANGES:
        x = _exchange(x, lane_bit, bit, mask)
    for mask, shift in DELTA_SWAPS:
        x = _delta_swap(x, mask, shift)
    return x


def tiling(m, words, sms=SMS):
    """The launcher's tile choice: (chunks, log_tc, rows, col_tiles, tiles)."""
    chunks = -(-words // C["kWordsPerChunk"])
    log_tc = 0
    while (1 << log_tc) < chunks and (1 << log_tc) < C["kTasks"]:
        log_tc += 1
    rows = min(C["kTasks"] >> log_tc, max(-(-m // sms), 1))
    col_tiles = -(-chunks // (1 << log_tc))
    return chunks, log_tc, rows, col_tiles, -(-m // rows) * col_tiles


def mirror(q, nbits, words, sms=SMS):
    """The kernel's planes, (nbits, M, words) uint32, from the levels q (M, K)
    int: tasks, transpose, staging and stores, tile by tile."""
    m, k = q.shape
    cpl, wpc = C["kColsPerLane"], C["kWordsPerChunk"]
    chunk_cols = 32 * wpc
    chunks, log_tc, rows, col_tiles, tiles = tiling(m, words, sms)
    tc = 1 << log_tc
    # every (row, chunk) task's lanes: columns >= K are level 0
    qp = np.zeros((m, chunks * chunk_cols), np.uint64)
    qp[:, :k] = q
    lanes = lane_words(qp.reshape(m, chunks, 32, cpl))      # (M, chunks, 32)
    out = np.full((nbits, m, words), 0xDEADBEEF, np.uint64)  # every word written
    for t in range(tiles):
        rt, ct = divmod(t, col_tiles)
        r0, c0 = rt * rows, ct * tc
        g_rows = min(rows, m - r0)
        twv = min(wpc * tc, words - c0 * wpc)
        stage = np.full(C["kMaxPlanes"] * C["kPlaneStride"], 0xBAD, np.uint64)
        lane = np.arange(32)
        plane = np.array([plane_of_lane(h) for h in lane % C["kLanesPerWord"]])
        for warp in range(C["kWarps"]):
            for u in range(C["kUnroll"]):
                slot = warp + C["kWarps"] * u
                rr, cc = slot >> log_tc, slot & (tc - 1)
                if not (rr < g_rows and c0 + cc < chunks):
                    continue
                word = cc * wpc + lane // C["kLanesPerWord"]
                ok = (plane < nbits) & (word < twv)
                stage[(plane * C["kPlaneStride"] + rr * twv + word)[ok]] = \
                    lanes[r0 + rr, c0 + cc][ok]
        run = g_rows * twv
        p, e = np.divmod(np.arange(nbits * run), run)  # the store loop's index
        if col_tiles == 1:
            dst = (p * m + r0) * words + e
        else:
            rr, ww = np.divmod(e, twv)
            dst = (p * m + r0 + rr) * words + c0 * wpc + ww
        out.reshape(-1)[dst] = stage[p * C["kPlaneStride"] + e]
    return out.astype(np.uint32)


def _plain(x, qp, nbits, words):
    return bitpack.bitpack_plain(x, qp.scale, qp.zero, nbits=nbits,
                                 words=words).numpy().view(np.uint32)


def _levels(x, qp):
    q = torch.clamp(torch.floor((x - qp.zero) / qp.scale), 0, (1 << qp.nbits) - 1)
    return q.to(torch.int64).numpy()


KS = (1, 31, 32, 33, 50, 100, 127, 128, 129, 1000)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("nbits", range(1, 9))
def test_mirror_equals_plain_word_for_word(nbits, k):
    """Rows not a multiple of a tile's, words from ceil(K/32) up (not always
    a multiple of 4), and SM counts that give a tile 1..32 rows."""
    rng = np.random.default_rng(nbits * 1000 + k)
    need = -(-k // 32)
    for m, words, sms in ((37, need, SMS), (37, need + 1, 5), (70, -(-need // 4) * 4, 3),
                          (1, need + 5, SMS), (45, -(-need // 4) * 4 + 4, 2)):
        x = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32))
        qp = calibrate(x, nbits)
        got = mirror(_levels(x, qp), nbits, words, sms)
        np.testing.assert_array_equal(got, _plain(x, qp, nbits, words),
                                      err_msg=f"M={m} words={words} sms={sms}")


@pytest.mark.parametrize("k,words", [(4200, 132), (4200, 133), (8192, 256)])
def test_mirror_across_column_tiles(k, words):
    """A row wider than a tile's kTasks chunks: segments a (plane, row)."""
    _, _, _, col_tiles, _ = tiling(9, words)
    assert col_tiles > 1
    rng = np.random.default_rng(k + words)
    x = torch.as_tensor(rng.normal(size=(9, k)).astype(np.float32))
    for nbits in (1, 3, 8):
        qp = calibrate(x, nbits)
        np.testing.assert_array_equal(mirror(_levels(x, qp), nbits, words, 4),
                                      _plain(x, qp, nbits, words))


def test_one_hot_levels_land_on_their_bit():
    """One level 2^p at one column lights bit (column mod 32) of its word in
    plane p and nothing else, at every column of a chunk and every plane."""
    for col in range(128):
        for p in range(8):
            q = np.zeros((1, 1, 32, 4), np.uint64)
            q[0, 0, col // 4, col % 4] = 1 << p
            words = lane_words(q)[0, 0]
            for lane in range(32):
                h, w = lane % 8, lane // 8
                want = 1 << (col % 32) if (plane_of_lane(h) == p and
                                           w == col // 32) else 0
                assert int(words[lane]) == want, (col, p, lane)


def test_tiles_cover_every_row_and_word_once():
    for m, words in ((2304, 4), (169343, 4), (2449029, 4), (56944, 4), (1, 1),
                     (37, 5), (9, 133)):
        chunks, log_tc, rows, col_tiles, tiles = tiling(m, words)
        assert rows * (1 << log_tc) <= C["kTasks"]
        assert rows * (1 << log_tc) * C["kWordsPerChunk"] <= C["kPlaneStride"]
        assert col_tiles * (1 << log_tc) >= chunks
        assert tiles * rows >= m * col_tiles > (tiles - col_tiles) * rows
        if m >= SMS * C["kTasks"]:  # whole-graph features: full tiles
            assert rows == C["kTasks"] >> log_tc


def test_grid_points_infinities_and_clip_ends():
    """x exactly at zero + j * scale, +-inf and past both clip ends."""
    for nbits in (1, 2, 5, 8):
        scale, zero = 4.0 / (1 << nbits), -2.0
        j = np.arange(-3, (1 << nbits) + 3, dtype=np.float32)
        vals = np.concatenate([zero + j * np.float32(scale),
                               [np.inf, -np.inf, 1e30, -1e30]]).astype(np.float32)
        x = torch.as_tensor(np.resize(vals, (13, 50)))
        qp = calibrate(x[torch.isfinite(x)], nbits)
        qp = type(qp)(nbits=nbits, scale=torch.tensor(scale), zero=torch.tensor(zero))
        for words in (2, 4):
            np.testing.assert_array_equal(mirror(_levels(x, qp), nbits, words),
                                          _plain(x, qp, nbits, words))


def test_stage_stores_keep_32_banks():
    """A staging store of a warp: the 32 lanes hit 32 banks when they write
    8 planes of 4 words of one row."""
    banks = {(plane_of_lane(lane % 8) * C["kPlaneStride"] + lane // 8) % 32
             for lane in range(32)}
    assert len(banks) == 32
    assert math.gcd(C["kPlaneStride"], 32) == 4


def rn32(v: Fraction) -> np.float32:
    """v rounded to the nearest float32, ties to even (subnormals too)."""
    if v == 0:
        return np.float32(0.0)
    mag = abs(v)
    e = mag.numerator.bit_length() - mag.denominator.bit_length()
    if Fraction(2) ** e > mag:
        e -= 1
    quantum = Fraction(2) ** (max(e, -126) - 23)
    n = mag / quantum
    whole, rest = divmod(n.numerator, n.denominator)
    if 2 * rest > n.denominator or (2 * rest == n.denominator and whole % 2):
        whole += 1
    out = np.float32(float(whole * quantum)) if whole * quantum < 2 ** 128 \
        else np.float32(np.inf)
    return -out if v < 0 else out


def F(v) -> Fraction:
    """A float32 as the exact rational it is."""
    return Fraction(float(v))


def kernel_quotient(a: np.float32, b: np.float32) -> np.float32:
    """The kernel's fast quotient: recip = RN(1/b), q = RN(a * recip),
    r = RN(a - b q) and RN(q + r recip), each fma one rounding of the exact
    value; q itself where |q| >= 2^24."""
    recip = np.float32(1) / b
    with np.errstate(over="ignore"):  # a * recip may overflow to +-inf
        q = np.float32(a * recip)
    if not abs(q) < 2 ** 24:
        return q
    r = rn32(F(a) - F(b) * F(q))
    return rn32(F(q) + F(r) * F(recip))


def _scales(rng):
    """Scales across the kernel's fast range: log-uniform over 2^-100 ..
    2^100 and over calibrate's usual 1e-8 .. 10, every significand bit set,
    and powers of two."""
    logu = lambda lo, hi, n: np.exp2(rng.uniform(lo, hi, n)).astype(np.float32)
    ones = np.array([0x3F7FFFFF, 0x3FFFFFFF, 0x0DFFFFFF, 0x71FFFFFF, 0x3C7FFFFF],
                    np.uint32).view(np.float32)
    return np.concatenate([logu(-100, 100, 40), logu(-26.6, 3.3, 40), ones,
                           np.float32([2.0 ** -100, 2.0 ** -7, 1.0, 2.0 ** 100])])


@pytest.mark.parametrize("part", range(4))
def test_fast_quotient_is_the_ieee_quotient(part):
    """Next to every integer a level can take (a = RN(b j) and its float
    neighbours), and at random a of either sign and any size: the kernel's
    quotient equals the correctly rounded one for 1/2 <= |a / b| < 2^24
    (below, r = a - b q may underflow: a level of 0 either way), and its
    level (floor, clip to 8 bits) always does."""
    rng = np.random.default_rng(part)
    scales = _scales(rng)[part::4]
    for scale in scales:
        for b in (np.float32(scale), np.float32(-scale)):
            a_vals = [rn32(F(b) * j) for j in rng.integers(-2, 258, 12)]
            a_vals = [np.nextafter(a, np.float32(d * np.inf), dtype=np.float32)
                      if d else a for a in a_vals for d in (-1, 0, 1)]
            wide = rng.standard_normal(12) * np.exp2(rng.uniform(-30, 30, 12)) * abs(b)
            a_vals += list(np.clip(wide, -3e38, 3e38).astype(np.float32))
            for a in a_vals:
                got = kernel_quotient(a, b)
                want = rn32(F(a) / F(b))
                if 0.5 <= abs(want) < 2 ** 24:  # below, the level is 0 anyway
                    assert got == want, (a, b)
                assert _level8(got) == _level8(want), (a, b)


def _level8(v) -> int:
    """floor, clipped to 8 bits; +-inf saturate."""
    if not math.isfinite(v):
        return 255 if v > 0 else 0
    return min(max(math.floor(v), 0), 255)


def test_fast_quotient_at_infinities_and_clip_ends():
    b = np.float32(4.0 / 256)
    for a, level in ((np.inf, 255), (-np.inf, 0), (3e38, 255), (-3e38, 0),
                     (1e-45, 0), (-1e-45, 0)):
        assert _level8(kernel_quotient(np.float32(a), b)) == level, a
