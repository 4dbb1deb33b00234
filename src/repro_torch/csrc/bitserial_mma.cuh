// The tensor-core tile core of mode="mxu", shared by bitserial.cu (any
// bitwidth, plain and fused epilogue) and bgemm.cu (1 bit).
//
//   A (s, M, W) x B (t, W, N) 32-bit words  ->  C (M, N) int32
//   C = sum_{p<s, q<t} 2^(p+q) * sum_w popcount(A_p[m, w] & B_q[w, n])
//
// Replaces the mode == "mxu" branch (:53) of
// src/repro/kernels/bgemm.py:43 _tile_product, reached from bgemm.py:112
// bgemm and, through src/repro/kernels/bitserial.py:54 _plane_accumulate,
// from bitserial_gemm (:245) and bitserial_fused (:273) in all four
// schedules. The reference unpacks both operands' bits to int8 and issues
// one int8 dot. This kernel computes the same int32 from the packed words
// with Hopper's b1 tensor-core product (the paper's design):
//
//   mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc
//   D[r, c] = C[r, c] + sum over 256 K bits of popc(A[r] & B[c])
//
// Fragment layout of .m16n8k256 .b1 (A row-major, B column-major), lane =
// 4 g + c: A (row g, slot c), (row g+8, slot c), (row g, slot 4+c), (row
// g+8, slot 4+c); B (slot c, col g), (slot 4+c, col g); D (row g, cols 2c
// and 2c+1), (row g+8, cols 2c and 2c+1). A slot is one 32-bit word of K;
// only the pairing of A's word with B's word matters, since the bit order
// inside a word is the same in both.
//
// Launch. It does not follow the policy's tile: a warp owns a 16-row strip
// of C and a column block of kMaxFrags n8 fragments at most (8 columns; 32
// at one bit), kMmaWarps strips a block, so all 16 rows of every fragment
// are live and the accumulators stay in registers. gridDim.y covers N in
// column blocks. block_m only names the row tile whose walk a row follows
// (and says whether a list walk can be short); block_n shapes nothing.
//
// Accumulators. One per weight d = p + q a fragment (15 at most), fed by
// the mma's own C, so that no instruction waits on an mma's result until
// the end: C = sum_d acc_d << d in uint32_t, which wraps as the reference's
// int32 and the 'vpu' kernel's accumulator do, in any order. (Adding each
// mma's D << (p + q) as it came made every mma wait out its ~100-cycle
// latency, in the timings of PERF.md §6.)
//
// Walks. The schedules visit what bitserial_tile.cuh's do: dense every
// word; mask the K tiles whose occupancy is not 0; list idx[i, :min(cnt[i],
// steps)] (ids off the grid skipped, a tile named twice counted twice). A
// strip spans row tiles r0 / block_m .. (r0 + 15) / block_m. Dense and mask
// walk K once for the whole strip: under mask a row's words are copied as
// zeros where its own row tile's occupancy is 0 (a lane reads its copy
// row's first 32 occupancies once, as bits). A list strip walks each of
// its row tiles' lists in turn (a sub-walk) with the other tiles' rows fed
// as zero words. Either way a row's word enters the product only if its
// own row tile visits that K tile: exact at every block_m, the default 8
// included.
//
// Long walks: runs of 8 slots, one mma a plane pair a fragment. A warp
// copies the A words of a batch of runs (up to kBatchRunPlanes run-planes,
// all s planes of each run) into shared memory with cp.async, zero-filled
// where a slot or row has no word, while it works on the batch before: in
// the dense and mask walks, and in list walks of K tiles of a multiple of 4
// words, a run's words are two groups of 4 neighbours and each lane copies
// 16 bytes, else each lane copies its own words. Run R of a strip is found
// from a scan of its sub-walks' run counts, so no run waits on the one
// before. A run whose words are zero in every lane and every plane
// (__any_sync) issues no mma: popc(0 & b) is 0, so this is exact, and it
// gives the sparse adjacency the skipping the 'vpu' kernel has.
//
// Short walks (K of at most kPairWords words: the feature GEMMs' 128 bits
// and less), a kernel instance of their own (kShort), taken where every
// strip has one (sub-)walk: the strip's words of all s planes go to shared
// memory, and the slots that are zero in every row and plane are dropped
// (a K of 64 bits padded to four words keeps two). With R words left (1, 2
// or 4), 8 / R plane pairs of equal weight p + q share one k256 mma: slot j
// holds word j % R of pair j / R, A's words [A_p | A_p' | ...] against B's
// [B_q | B_q' | ...]. The sum of their popcounts carries the one weight
// 2^(p+q), so the int32 is unchanged. At s = t = 8 that is 36 mmas a
// fragment for 4 words, 22 for 2 and 15 for 1, against 64.
//
// B. Each block copies B's words of its column block, all t planes and a
// window of K words, into shared memory with cp.async once, and every warp
// reads its B fragments there. The window is the whole of K unless t planes
// of it would exceed kStageBytes even at one fragment's columns; then the
// block walks once a window, each walk taking only the words inside it. The
// launcher first narrows the column block before it cuts K. A row of the
// staged window is padded to a multiple of 16 words plus 8, so that the 4
// lanes of a fragment that read 4 neighbouring words hit different banks.
// Columns past N stage as zero.
//
// kOneBit fixes s = t = 1: one weight, up to 4 fragments. kFused applies the
// epilogue of bitserial_tile.cuh (fused_value) on the way out, with each
// lane's alpha and beta loaded at the start.
//
// Bound on this card: it reads the same bytes as the 'vpu' kernel, s*M*W*4
// + t*W*N*4, and writes M*N*4; at the GNN path's shapes (N = 16..128, W <=
// 72) bytes bound it. What the time goes to is a warp's chain of dependent
// instructions and memory round trips: the b1 mma issues at ~1.8 cycles an
// SM with 16 warps (PERF.md §6), far from the limit here.
#pragma once

#include <type_traits>

#include "bitserial_tile.cuh"

namespace {

constexpr int kDense = 0;
constexpr int kMmaWarps = 4;     // 16-row strips a block
constexpr int kMaxPlanes = 8;    // s, t <= 8 (the wrapper checks)
constexpr int kWeights = 2 * kMaxPlanes - 1;  // p + q in 0..14
constexpr int kRunWords = 8;     // 256 K bits: the depth of one mma
constexpr int kPairWords = 4;    // a walk this short pairs planes
constexpr int kStageBytes = 96 * 1024;  // B's window in shared memory
// A of a long walk comes in batches of run-planes (one run of one plane:
// 16 rows x 8 slots), two batches a warp, one filling while one is used;
// each lane keeps its two slots' words of every run of a batch beside them
constexpr int kBatchRunPlanes = 16;
constexpr int kRunPlaneWords = 16 * kRunWords;
constexpr int kBatchWords = kBatchRunPlanes * kRunPlaneWords;
constexpr int kWarpStageWords = 2 * kBatchWords + 2 * kBatchRunPlanes * 32;

// n8 fragments a warp holds: 8 columns, whose 15 per-weight accumulators
// stay in registers; 32 columns at one bit, which has one weight
template <bool kOneBit>
constexpr int kMaxFrags = kOneBit ? 4 : 1;

// the A layout of a run-plane: 16 rows of 8 slots, the two halves of rows
// 4..7 and 12..15 swapped, so that the 4 lanes of a fragment row and the
// 8 rows of a fragment read 32 different banks
__device__ __forceinline__ int run_slot(int row, int slot) {
  return row * kRunWords + ((slot ^ (row & 4)) & 7);
}

// Words a staged row of B takes for `frags` fragments: padded so that the
// stride is 8 mod 16 words (see "B" above).
inline int staged_row_words(int frags) {
  const int nb = 8 * frags;
  return nb % 16 ? nb : nb + 8;
}

// d += popc-sum over 256 K bits of A & B, one m16n8k256 b1 fragment.
__device__ __forceinline__ void mma_b1_and_popc(uint32_t a0, uint32_t a1,
                                                uint32_t a2, uint32_t a3,
                                                uint32_t b0, uint32_t b1,
                                                uint32_t (&d)[4]) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 4 bytes (or 16 where `vec`) from global to shared memory, zero-filled
// where not `full` (then `src` is only a valid address)
__device__ __forceinline__ void cp_async(uint32_t* dst, const uint32_t* src,
                                         bool vec, bool full) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(to), "l"(src), "r"(full ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(to), "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

template <bool kOneBit, bool kFused, bool kShort>
__global__ void __launch_bounds__(32 * kMmaWarps)
    bitserial_mma_kernel(const uint32_t* __restrict__ a,
                         const uint32_t* __restrict__ b,
                         int32_t* __restrict__ c, int s_rt, int t_rt, int m,
                         int w, int n, int block_m, int kw, int schedule,
                         const int32_t* __restrict__ occ,
                         const int32_t* __restrict__ idx, int idx_stride,
                         const int32_t* __restrict__ cnt, int steps,
                         int frags, int row_words, int kwin, int flags,
                         int stage_words, Epilogue epi) {
  constexpr int kFrags = kMaxFrags<kOneBit>;
  constexpr int kW = kOneBit ? 1 : kWeights;
  constexpr int kThreads = 32 * kMmaWarps;
  const int s = kOneBit ? 1 : s_rt;
  const int t = kOneBit ? 1 : t_rt;
  const bool vec = flags & 1;    // B's rows copy 16 bytes at a time
  const bool vec_a = flags & 2;  // A's runs come as 4-word groups
  extern __shared__ uint4 smem[];
  uint32_t* bs = reinterpret_cast<uint32_t*>(smem);  // [t][kwin][row_words]
  const int plane_words = kwin * row_words;
  uint32_t* stage = bs + t * plane_words + threadIdx.y * stage_words;
  int* slot_words = reinterpret_cast<int*>(stage + 2 * kBatchWords);
  const int lane = threadIdx.x;
  const int g = lane >> 2;
  const int cq = lane & 3;
  const int r0 = (blockIdx.x * kMmaWarps + threadIdx.y) * 16;
  const int col0 = blockIdx.y * 8 * frags;
  const size_t a_plane = static_cast<size_t>(m) * w;

  // the epilogue's alpha of rows g, g + 8 and beta of this lane's columns,
  // loaded now so that the store does not wait for them
  float alpha_v[2] = {0.f, 0.f}, beta_v[kFrags][2];
#pragma unroll
  for (int j = 0; j < kFrags; ++j) beta_v[j][0] = beta_v[j][1] = 0.f;
  if (kFused) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (r0 + g + 8 * e < m) alpha_v[e] = __ldg(epi.alpha + r0 + g + 8 * e);
      const int col = col0 + 2 * cq + e;
#pragma unroll
      for (int j = 0; j < kFrags; ++j)
        if (j < frags && col + 8 * j < n) beta_v[j][e] = __ldg(epi.beta + col + 8 * j);
    }
  }

  // sub-walks: one for dense and mask, one a row tile the strip spans for
  // the list schedules (nsub <= 16); lane u holds sub-walk u's slot count and, summed over 0..u, its
  // runs, so that run R of the strip is found without walking to it
  const int i_first = r0 / block_m;
  const int nsub = r0 >= m ? 0
                   : schedule != kList ? 1
                   : min(r0 + 15, m - 1) / block_m - i_first + 1;
  const int my_len =
      lane >= nsub ? 0
      : schedule == kList ? min(__ldg(cnt + i_first + lane), steps) * kw : w;
  int run_end = (my_len + kRunWords - 1) / kRunWords;
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) {
    const int v = __shfl_up_sync(kFullWarp, run_end, off);
    if (lane >= off) run_end += v;
  }
  const int total_runs =
      nsub > 0 ? __shfl_sync(kFullWarp, run_end, nsub - 1) : 0;

  // sub-walk u and run r of the strip's run R (uniform over the warp)
  auto run_at = [&](int R, int& u, int& r) {
    if (schedule != kList) {
      u = 0;
      r = R;
      return;
    }
    u = __popc(__ballot_sync(kFullWarp, lane < nsub && run_end <= R));
    const int before = __shfl_sync(kFullWarp, run_end, max(u - 1, 0));
    r = u > 0 ? R - before : R;
  };
  // the rows [lo, hi) of the strip that sub-walk u feeds
  auto row_range = [&](int u, int& lo, int& hi) {
    lo = r0;
    hi = min(r0 + 16, m);
    if (schedule == kList) {
      const int i = i_first + u;
      lo = max(lo, i * block_m);
      hi = min(hi, (i + 1) * block_m);
    }
  };
  // mask: bit j of occ_bits says whether K tile j of the row tile of this
  // lane's copy row (lane >> 1) is occupied, for the first 32 K tiles
  unsigned occ_bits = 0u;
  if (schedule == kMask && r0 + (lane >> 1) < m) {
    const int32_t* row_occ =
        occ + static_cast<size_t>((r0 + (lane >> 1)) / block_m) * (w / kw);
    for (int j = 0; j < min(32, w / kw); ++j)
      occ_bits |= (__ldg(row_occ + j) != 0 ? 1u : 0u) << j;
  }
  // whether `row` of the strip takes its local `word`: the mask schedule
  // walks every K tile once for the whole strip, and a row's words enter
  // only where its own row tile's occupancy is not 0
  auto occupied = [&](int row, int word, int kb) {
    if (schedule != kMask) return true;
    const int step = (word + kb) / kw;
    if (row == (lane >> 1) && step < 32) return ((occ_bits >> step) & 1u) != 0;
    return __ldg(occ + static_cast<size_t>((r0 + row) / block_m) * (w / kw) +
                 step) != 0;
  };
  // the word slot k of sub-walk u visits, local to the window [kb, kb +
  // kwe), or -1
  auto word_at = [&](int u, int k, int len, int kb, int kwe) -> int {
    if (k >= len) return -1;
    int word = k;
    if (schedule == kList) {
      const int step = k / kw;
      const int tile =
          __ldg(idx + static_cast<size_t>(i_first + u) * idx_stride + step);
      if (tile < 0 || tile >= w / kw) return -1;
      word = tile * kw + (k - step * kw);
    }
    word -= kb;
    return word >= 0 && word < kwe ? word : -1;
  };
  // Copy the A words of runs R0, R0 + 1, ... (a batch at most) into
  // buffer `buf` with cp.async, every plane of a run as a run-plane (zeros
  // where a slot or row has no word), and note this lane's slots c and 4 + c
  // of each run as (hi << 16) | lo, 0xffff for none. Where `vec_a` a run's
  // slots come as two groups of 4 neighbouring words (dense, or K tiles of a
  // multiple of 4 words): lane l copies 16 bytes, half l & 1 of row l >> 1.
  // Else each lane copies its own rows g, g + 8 at its slots. Returns the
  // runs copied.
  const int batch_runs = kBatchRunPlanes / s;
  auto issue_batch = [&](int buf, int R0, int kb, int kwe) -> int {
    const int runs = max(0, min(batch_runs, total_runs - R0));
    uint32_t* base = stage + buf * kBatchWords;
    if (schedule != kList && vec_a) {
      // run R's slots are words 8 R .. 8 R + 7 of the whole strip: no
      // lookup, and the runs are independent of one another
      const int row = lane >> 1;
      const int half = (lane & 1) * 4;
      const bool row_ok = r0 + row < m;
      const uint32_t* ap = a + static_cast<size_t>(r0 + row) * w + kb;
#pragma unroll 4
      for (int jr = 0; jr < runs; ++jr) {
        const int word = (R0 + jr) * kRunWords - kb;  // local, slot 0
        auto local = [&](int x) { return x >= 0 && x < kwe ? x : -1; };
        const int lo = local(word + cq), hi = local(word + 4 + cq);
        slot_words[(buf * kBatchRunPlanes + jr) * 32 + lane] =
            (hi < 0 ? 0xffff0000u : static_cast<unsigned>(hi) << 16) |
            (lo < 0 ? 0xffffu : static_cast<unsigned>(lo));
        const int mine = local(word + half);
        const bool ok = row_ok && mine >= 0 && occupied(row, mine, kb);
        for (int p = 0; p < s; ++p)
          cp_async(base + (jr * s + p) * kRunPlaneWords + run_slot(row, half),
                   ok ? ap + p * a_plane + mine : a, true, ok);
      }
      cp_async_commit();
      return runs;
    }
    for (int jr = 0; jr < runs; ++jr) {
      int u, r, row_lo, row_hi;
      run_at(R0 + jr, u, r);
      row_range(u, row_lo, row_hi);
      const int len = __shfl_sync(kFullWarp, my_len, u);
      const int k = r * kRunWords;
      int lo, hi, grp = -1;
      if (vec_a) {
        const int w0 = word_at(u, k, len, kb, kwe);
        const int w1 = word_at(u, k + 4, len, kb, kwe);
        lo = w0 < 0 ? -1 : w0 + cq;
        hi = w1 < 0 ? -1 : w1 + cq;
        grp = lane & 1 ? w1 : w0;
      } else {
        lo = word_at(u, k + cq, len, kb, kwe);
        hi = word_at(u, k + 4 + cq, len, kb, kwe);
      }
      slot_words[(buf * kBatchRunPlanes + jr) * 32 + lane] =
          (hi < 0 ? 0xffff0000u : static_cast<unsigned>(hi) << 16) |
          (lo < 0 ? 0xffffu : static_cast<unsigned>(lo));
      auto live = [&](int row, int word) {
        return word >= 0 && r0 + row >= row_lo && r0 + row < row_hi &&
               occupied(row, word, kb);
      };
      const uint32_t* ap = a + static_cast<size_t>(r0) * w + kb;
      for (int p = 0; p < s; ++p, ap += a_plane) {
        uint32_t* d = base + (jr * s + p) * kRunPlaneWords;
        if (vec_a) {
          const int row = lane >> 1;
          const bool ok = live(row, grp);
          cp_async(d + run_slot(row, (lane & 1) * 4),
                   ok ? ap + static_cast<size_t>(row) * w + grp : a, true, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = g + (e & 1) * 8;
            const int word = e & 2 ? hi : lo;
            const bool ok = live(row, word);
            cp_async(d + run_slot(row, (e & 2) * 2 + cq),
                     ok ? ap + static_cast<size_t>(row) * w + word : a, false,
                     ok);
          }
        }
      }
    }
    cp_async_commit();
    return runs;
  };

  // one accumulator a weight p + q a fragment, fed by the mma's own C
  uint32_t acc[kW][kFrags][4];
#pragma unroll
  for (int d = 0; d < kW; ++d)
#pragma unroll
    for (int j = 0; j < kFrags; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][j][e] = 0u;
  // fragments past N in the last column block issue nothing
  const int live_frags = min(frags, (n - col0 + 7) / 8);

  for (int kb = 0; kb < w; kb += kwin) {
    const int kwe = min(kwin, w - kb);
    // A first, so that its loads fly while B is copied
    int runs = 0;
    int short_word = -1;  // short walk: this lane's slot cq, local word
    __syncwarp();         // every lane is done with the last window's A
    if (kShort) {
      int row_lo, row_hi;
      row_range(0, row_lo, row_hi);
      const bool row_g = r0 + g >= row_lo && r0 + g < row_hi;
      const bool row_g8 = r0 + g + 8 >= row_lo && r0 + g + 8 < row_hi;
      short_word = word_at(0, cq, __shfl_sync(kFullWarp, my_len, 0), kb, kwe);
      const bool ok = short_word >= 0;
      const bool ok_g = ok && row_g && occupied(g, short_word, kb);
      const bool ok_g8 = ok && row_g8 && occupied(g + 8, short_word, kb);
      const uint32_t* ap = a + static_cast<size_t>(r0 + g) * w + kb;
      for (int p = 0; p < s; ++p, ap += a_plane) {
        cp_async(stage + p * 64 + g * 4 + cq, ok_g ? ap + short_word : a,
                 false, ok_g);
        cp_async(stage + p * 64 + (g + 8) * 4 + cq,
                 ok_g8 ? ap + 8 * static_cast<size_t>(w) + short_word : a,
                 false, ok_g8);
      }
      cp_async_commit();
    } else if (nsub > 0) {
      runs = issue_batch(0, 0, kb, kwe);
    }

    if (kb > 0) __syncthreads();  // every warp is done with the last window
    {
      // B's window: copy e is row e >> rc_log, that is plane q = row / kwe
      // (a multiply-high by ceil(2^32 / kwe), exact for the window's fewer
      // than 2^16 rows) and
      // word row - q * kwe, `per` words at column (e & (row copies - 1)) *
      // per
      const int per = vec ? 4 : 1;
      const int rc_log = __ffs(8 * frags / per) - 1;
      const int copies = t * kwe << rc_log;
      const unsigned inv = 0xffffffffu / kwe + 1;
#pragma unroll 4
      for (int e = threadIdx.y * 32 + lane; e < copies; e += kThreads) {
        const int row = e >> rc_log;
        const int q = kwe == 1 ? row : __umulhi(row, inv);
        const int kk = row - q * kwe;
        const int col = (e - (row << rc_log)) * per;
        const bool full = col0 + col < n;
        const uint32_t* src = b + static_cast<size_t>(q) * w * n +
                              static_cast<size_t>(kb + kk) * n + col0 + col;
        cp_async(bs + q * plane_words + kk * row_words + col, full ? src : b,
                 vec, full);
      }
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();

    if (kShort) {
      __syncwarp();
      uint32_t nz = 0u;
      for (int p = 0; p < s; ++p)
        nz |= stage[p * 64 + g * 4 + cq] | stage[p * 64 + (g + 8) * 4 + cq];
      const unsigned ballot = __ballot_sync(kFullWarp, nz != 0u);
      unsigned used = 0u;  // slots non-zero in some row and plane
#pragma unroll
      for (int k = 0; k < kPairWords; ++k)
        if (ballot & (0x11111111u << k)) used |= 1u << k;
      const int nused = __popc(used);
      if (nused == 0) continue;
      // R = words (1, 2 or 4) a pair, 8 / R pairs an mma, at most R mmas
      // a weight; the mmas of one weight are straight-line code, so that
      // their shared-memory reads overlap
      auto paired = [&](auto words_c) {
        constexpr int words = decltype(words_c)::value;
        constexpr int per_mma = kRunWords / words;
        const int wi = cq & (words - 1);  // this lane's word of its pairs
        const bool has_word = wi < nused;
        unsigned rest = used;
        for (int z = 0; z < wi; ++z) rest &= rest - 1;
        const int slot = has_word ? __ffs(rest) - 1 : 0;
        // lane `slot` (g = 0) holds that slot's word
        const int word = __shfl_sync(kFullWarp, short_word, slot);
        const int k0 = cq / words;        // pair of slot cq
        const int k1 = (4 + cq) / words;  // pair of slot 4 + cq
        const uint32_t* bw = bs + max(word, 0) * row_words + g;
        const uint32_t* aw = stage + g * 4 + slot;
#pragma unroll
        for (int d = 0; d < kW; ++d) {
          if (d > s + t - 2) break;
          const int p_lo = max(0, d - t + 1);
          const int p_hi = min(d, s - 1);
#pragma unroll
          for (int k = 0; k < words; ++k) {
            const int start = p_lo + k * per_mma;
            const int p0 = start + k0, p1 = start + k1;
            const bool ok0 = has_word && p0 <= p_hi;
            const bool ok1 = has_word && p1 <= p_hi;
            const uint32_t a0 = ok0 ? aw[p0 * 64] : 0u;
            const uint32_t a1 = ok0 ? aw[p0 * 64 + 32] : 0u;
            const uint32_t a2 = ok1 ? aw[p1 * 64] : 0u;
            const uint32_t a3 = ok1 ? aw[p1 * 64 + 32] : 0u;
#pragma unroll
            for (int j = 0; j < kFrags; ++j) {
              if (j >= live_frags) break;
              const uint32_t b0 =
                  ok0 ? bw[(d - p0) * plane_words + j * 8] : 0u;
              const uint32_t b1 =
                  ok1 ? bw[(d - p1) * plane_words + j * 8] : 0u;
              if (start <= p_hi)
                mma_b1_and_popc(a0, a1, a2, a3, b0, b1, acc[d][j]);
            }
          }
        }
      };
      if (nused == 1)
        paired(std::integral_constant<int, 1>{});
      else if (nused == 2)
        paired(std::integral_constant<int, 2>{});
      else
        paired(std::integral_constant<int, 4>{});
      continue;
    }

    for (int R0 = 0, buf = 0; runs > 0; R0 += batch_runs, buf ^= 1) {
      __syncwarp();  // every lane is done reading buffer buf ^ 1
      const int next = issue_batch(buf ^ 1, R0 + batch_runs, kb, kwe);
      cp_async_wait<1>();  // this lane's copies of batch `buf` are in
      __syncwarp();        // and every lane's
      const uint32_t* batch = stage + buf * kBatchWords;
      const int at_lo = run_slot(g, cq), at_hi = run_slot(g, 4 + cq);
      for (int jr = 0; jr < runs; ++jr) {
        uint32_t av[kMaxPlanes][4];
        uint32_t any = 0u;
#pragma unroll
        for (int p = 0; p < kMaxPlanes; ++p) {
          if (p >= s) break;
          const uint32_t* ap = batch + (jr * s + p) * kRunPlaneWords;
          av[p][0] = ap[at_lo];
          av[p][1] = ap[at_lo + 64];
          av[p][2] = ap[at_hi];
          av[p][3] = ap[at_hi + 64];
          any |= av[p][0] | av[p][1] | av[p][2] | av[p][3];
        }
        if (!__any_sync(kFullWarp, any != 0u)) continue;
        const int words = slot_words[(buf * kBatchRunPlanes + jr) * 32 + lane];
        // a slot without a word reads word 0: its A words are zero
        const int lo = words & 0xffff, hi = static_cast<unsigned>(words) >> 16;
        const uint32_t* blo = bs + (lo == 0xffff ? 0 : lo) * row_words + g;
        const uint32_t* bhi = bs + (hi == 0xffff ? 0 : hi) * row_words + g;
        uint32_t bf[kMaxPlanes][kFrags][2];
#pragma unroll
        for (int q = 0; q < kMaxPlanes; ++q) {
          if (q >= t) break;
#pragma unroll
          for (int j = 0; j < kFrags; ++j) {
            if (j >= live_frags) break;
            bf[q][j][0] = blo[q * plane_words + j * 8];
            bf[q][j][1] = bhi[q * plane_words + j * 8];
          }
        }
#pragma unroll
        for (int p = 0; p < kMaxPlanes; ++p) {
          if (p >= s) break;
#pragma unroll
          for (int q = 0; q < kMaxPlanes; ++q) {
            if (q >= t) break;
#pragma unroll
            for (int j = 0; j < kFrags; ++j) {
              if (j >= live_frags) break;
              mma_b1_and_popc(av[p][0], av[p][1], av[p][2], av[p][3],
                              bf[q][j][0], bf[q][j][1],
                              acc[kOneBit ? 0 : p + q][j]);
            }
          }
        }
      }
      runs = next;
    }
    cp_async_wait<0>();  // the empty last group
  }

  uint32_t sum[kFrags][4];
#pragma unroll
  for (int j = 0; j < kFrags; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sum[j][e] = 0u;
#pragma unroll
      for (int d = 0; d < kW; ++d) {
        if (d > s + t - 2) break;
        sum[j][e] += acc[d][j][e] << d;
      }
    }
  if (r0 >= m) return;  // after the last barrier
#pragma unroll
  for (int j = 0; j < kFrags; ++j) {
    if (j >= frags) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + (e >> 1) * 8;
      const int col = col0 + j * 8 + 2 * cq + (e & 1);
      if (row < m && col < n) {
        const int32_t out = static_cast<int32_t>(sum[j][e]);
        c[static_cast<size_t>(row) * n + col] =
            kFused ? fused_value(out, alpha_v[e >> 1], beta_v[j][e & 1], epi)
                   : out;
      }
    }
  }
}

// Launches on `stream` and returns cudaGetLastError() (0 on success), with
// the arguments and the caller's checks of launch_tile_kernel. block_n
// shapes nothing here. The column block holds as many fragments as N needs
// (a power of two), up to kMaxFrags, halved while t planes of all W words
// would exceed kStageBytes; the K window is what then fits. Every strip's
// walk is short where K is at most kPairWords words and a strip lies in one
// row tile or the schedule is not a list.
template <bool kOneBit, bool kFused>
int launch_mma_kernel(const void* a, const void* b, void* c, int s, int t,
                      int m, int w, int n, int block_m, int block_n, int kw,
                      int schedule, const void* occ, const void* idx,
                      int idx_stride, const void* cnt, int steps,
                      Epilogue epi, void* stream) {
  (void)block_n;
  const bool is_short =
      w <= kPairWords && (schedule != kList || block_m % 16 == 0);
  auto kernel = is_short ? bitserial_mma_kernel<kOneBit, kFused, true>
                         : bitserial_mma_kernel<kOneBit, kFused, false>;
  constexpr int kMaxSmem = kStageBytes + 4 * kMmaWarps * kWarpStageWords;
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(bitserial_mma_kernel<kOneBit, kFused, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem),
      cudaFuncSetAttribute(bitserial_mma_kernel<kOneBit, kFused, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem)};
  if (attr[is_short] != cudaSuccess) return static_cast<int>(attr[is_short]);
  int frags = 1;
  while (frags < kMaxFrags<kOneBit> && 8 * frags < n) frags *= 2;
  while (frags > 1 && 4LL * t * w * staged_row_words(frags) > kStageBytes)
    frags /= 2;
  const int row_words = staged_row_words(frags);
  int kwin = min(w, kStageBytes / (4 * t * row_words));
  if (kwin < w) kwin = max(4, kwin / 4 * 4);  // windows cut K at 4 words
  // a warp's stage: A's batches, or a short walk's A
  const int stage_words =
      is_short ? kMaxPlanes * 16 * kPairWords : kWarpStageWords;
  const size_t smem = 4 * (static_cast<size_t>(t) * kwin * row_words +
                           kMmaWarps * stage_words);
  const int vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  // A's runs come as groups of 4 aligned neighbouring words of one K tile
  const int vec_a = (schedule == kDense || kw % 4 == 0) && w % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const int strips = (m + 15) / 16;
  const dim3 grid((strips + kMmaWarps - 1) / kMmaWarps,
                  (n + 8 * frags - 1) / (8 * frags));
  const dim3 block(32, kMmaWarps);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<int32_t*>(c), s, t, m, w, n, block_m, kw, schedule,
      static_cast<const int32_t*>(occ), static_cast<const int32_t*>(idx),
      idx_stride, static_cast<const int32_t*>(cnt), steps, frags, row_words,
      kwin, vec | vec_a << 1, stage_words, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
