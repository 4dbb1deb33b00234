// The popcount GEMM of mode="vpu" on the CUDA cores, shared by bitserial.cu
// (any bitwidth, plain and fused epilogue) and bgemm.cu (1 bit).
//
//   A (s, M, W) x B (t, W, N) 32-bit words  ->  C (M, N) int32
//   C = sum_{p<s, q<t} 2^(p+q) * sum_w popcount(A_p[m, w] & B_q[w, n])
//
// One kernel serves the four schedules of the TPU kernels; they differ only
// in where the K loop of a row tile takes its tile ids from:
//
//   dense    k = step,                    step < W / kw
//   mask     k = step, skipped when occ[i, step] == 0
//   list     k = idx[i, step],            step < min(cnt[i], steps)
//            (compact: kw = block_w words; sgt: kw = 1 word)
//
// The artifacts are per row tile of block_m rows and K tiles of kw words,
// the grid they were built on; a list id outside [0, W / kw) is skipped.
// A row tile that visits no K tile still writes its output: zeros, or the
// epilogue of a zero accumulator, clip(floor(beta)).
//
// Design for Hopper: one warp per output row, several rows (warps) per
// block, no shared memory and no block barrier. The launch does not follow
// the artifact tile: block_m only names the row tile whose artifacts a row
// reads, and block_n shapes nothing, since columns are independent.
//
//   Walk. The visited words of a row are numbered as slots: slot j is word
//   ww = j % kw of the K tile at step j / kw. The warp takes 32 slots at a
//   time, one a lane: each lane reads its slot's word of all s planes of A
//   straight into registers (one load each, neighbouring lanes on
//   neighbouring words in the dense schedule), and the next 32 slots' loads
//   are issued before this chunk is used, so their latency overlaps its
//   work. A slot that the schedule skips reads nothing.
//   Skip. A __ballot_sync of "any plane non-zero" gives the chunk's
//   non-zero words, and the warp walks them together, kWordsPerStep at a
//   time: each word and its s planes are broadcast with __shfl_sync, and
//   the B loads of both words are issued before either is used. A zero
//   word costs no B load and no popcount, and no lane of the warp branches
//   apart (the adjacency of the GNN path is ~10 % non-zero tiles and fewer
//   non-zero words).
//   Columns. A lane holds kColsPerLane columns, L lanes apart, and a plane
//   group of B: the warp is split into g = 32 / L groups, group r taking
//   planes r, r + g, ... . L is the fewest lanes, down to 32 / t, that
//   still cover min(N, 32) columns, so at N = 16 and t = 8 two groups of 16
//   lanes each take 4 planes and no lane idles. For each broadcast word a
//   lane reads its B words straight from global memory (read-only path,
//   coalesced along N) and adds popcount(a_p & b_q) << (p + q) into one
//   uint32_t a column; the groups' sums meet in a __shfl_xor_sync tree at
//   the end. Columns past the lane's kColsPerLane go to more blocks
//   (gridDim.y), each walking the row again.
//   Timed on an H100 against other choices (PERF.md §6, with
//   compare_kernels.py): 1, 2 or 8 rows a block, 4 columns a lane, 1 or 4
//   words a step, an L1 prefetch pass over a chunk's B rows, and B staged
//   in shared memory when it fits: none was faster at the GNN path's
//   shapes, and B read through a generic pointer instead of __ldg made
//   the dense 8-bit shapes half again slower.
//
// Every accumulator is a uint32_t: a sum of shifted terms wraps as the
// reference's int32 does, in any order and grouping, so the plane groups,
// the order of the words and a list that names a tile twice (it counts
// twice) all give the plain version's int32.
//
// kOneBit fixes s = t = 1 at compile time: one plane group of 32 lanes, no
// plane loops, no shifts (bgemm). kFused applies the §4.5 epilogue on the
// way out:
//   y = f32(acc) * alpha[row] + beta[col], max(y, 0) under relu,
//   floor, clip to [0, qmax]
// rounded twice, as the reference does: __fmul_rn and __fadd_rn keep nvcc
// from contracting the two steps into one FMA, which would round once and
// could move the floor by one level.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

// schedule 0 is dense
constexpr int kMask = 1;
constexpr int kList = 2;

struct Epilogue {
  const float* alpha;  // (M,) per row, padded to the row tiles
  const float* beta;   // (N,) per column
  float qmax;          // 2^out_bits - 1
  int relu;
};

// The §4.5 epilogue of an int32 whose row scales by `alpha` and whose
// column shifts by `beta`, rounded twice as the reference does.
__device__ __forceinline__ int32_t fused_value(int32_t out, float alpha,
                                               float beta,
                                               const Epilogue& epi) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(out), alpha), beta);
  if (epi.relu) y = fmaxf(y, 0.f);
  return static_cast<int32_t>(fminf(fmaxf(floorf(y), 0.f), epi.qmax));
}

// The int32 the kernels store for an accumulator: itself, or under kFused
// the §4.5 epilogue at (row, col).
template <bool kFused>
__device__ __forceinline__ int32_t tile_output(uint32_t acc, int row, int col,
                                               const Epilogue& epi) {
  const int32_t out = static_cast<int32_t>(acc);
  return kFused ? fused_value(out, epi.alpha[row], epi.beta[col], epi) : out;
}

constexpr int kRowsPerBlock = 4;  // warps a block, one row each
constexpr int kColsPerLane = 2;   // output columns a lane accumulates
constexpr int kWordsPerStep = 2;  // non-zero words whose B loads fly together
constexpr int kMaxBits = 8;       // s, t <= 8 (the wrapper checks)
constexpr unsigned kFullWarp = 0xffffffffu;

template <bool kOneBit, bool kFused>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    bitserial_tile_kernel(const uint32_t* __restrict__ a,
                          const uint32_t* __restrict__ b,
                          int32_t* __restrict__ c, int s_rt, int t_rt, int m,
                          int w, int n, int block_m, int kw, int schedule,
                          const int32_t* __restrict__ occ,
                          const int32_t* __restrict__ idx, int idx_stride,
                          const int32_t* __restrict__ cnt, int steps,
                          int lanes_log2, Epilogue epi) {
  const int s = kOneBit ? 1 : s_rt;
  const int t = kOneBit ? 1 : t_rt;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (row >= m) return;  // the whole warp: nothing below waits for others
  const int lane = threadIdx.x;
  const int lanes = kOneBit ? 32 : 1 << lanes_log2;  // L, lanes a group
  const int groups = 32 / lanes;                       // g
  const int group = kOneBit ? 0 : lane >> lanes_log2;
  const int col0 = blockIdx.y * lanes * kColsPerLane;  // the block's first
  const int my_col = col0 + (lane & (lanes - 1));      // this lane's first
  const int i = row / block_m;                         // row tile
  const int k_tiles = w / kw;
  const int slots = steps * kw;
  // list: steps past cnt[i] read as skipped; idx[i, :steps] is in bounds,
  // so its loads need not wait for cnt
  const int live = schedule == kList ? min(__ldg(cnt + i), steps) : steps;
  const uint32_t* a_row = a + static_cast<size_t>(row) * w;
  const size_t a_plane = static_cast<size_t>(m) * w;
  const size_t b_plane = static_cast<size_t>(w) * n;

  // the word slot j visits, or -1 where the schedule skips it
  auto word_at = [&](int j) -> int {
    if (j >= slots) return -1;
    if (schedule == kList) {
      const int step = j / kw;
      const int k = __ldg(idx + static_cast<size_t>(i) * idx_stride + step);
      if (step >= live || k < 0 || k >= k_tiles) return -1;
      return k * kw + (j - step * kw);
    }
    if (schedule == kMask &&
        __ldg(occ + static_cast<size_t>(i) * k_tiles + j / kw) == 0)
      return -1;
    return j;
  };
  auto load_a = [&](int word, uint32_t (&av)[kMaxBits]) {
#pragma unroll
    for (int p = 0; p < kMaxBits; ++p) {
      if (p >= s) break;
      av[p] = word >= 0 ? __ldg(a_row + p * a_plane + word) : 0u;
    }
  };

  uint32_t acc[kColsPerLane];
#pragma unroll
  for (int jc = 0; jc < kColsPerLane; ++jc) acc[jc] = 0u;

  int word = word_at(lane);
  uint32_t av[kMaxBits];
  load_a(word, av);
  for (int base = 0; base < slots; base += 32) {
    const int next_word = word_at(base + 32 + lane);
    uint32_t next_av[kMaxBits];
    load_a(next_word, next_av);

    uint32_t any = 0u;
#pragma unroll
    for (int p = 0; p < kMaxBits; ++p) {
      if (p >= s) break;
      any |= av[p];
    }
    uint32_t nonzero = __ballot_sync(kFullWarp, any != 0u);
    while (nonzero) {  // uniform: every lane walks the same words
      // the next kWordsPerStep non-zero words, broadcast from their lanes;
      // past the last, word -1 and zero planes
      int wds[kWordsPerStep];
      uint32_t ap[kWordsPerStep][kMaxBits];
#pragma unroll
      for (int u = 0; u < kWordsPerStep; ++u) {
        const int src = nonzero ? __ffs(nonzero) - 1 : 0;
        wds[u] = nonzero ? __shfl_sync(kFullWarp, word, src) : -1;
#pragma unroll
        for (int p = 0; p < kMaxBits; ++p) {
          if (p >= s) break;
          const uint32_t v = __shfl_sync(kFullWarp, av[p], src);
          ap[u][p] = nonzero ? v : 0u;
        }
        nonzero &= nonzero - 1;
      }
      // this lane's B words of all of them first, so that their loads are
      // in flight together; a plane or column past the edge reads as zero
      uint32_t bv[kWordsPerStep][kMaxBits][kColsPerLane];
#pragma unroll
      for (int u = 0; u < kWordsPerStep; ++u) {
        const uint32_t* b_word = b + static_cast<size_t>(max(wds[u], 0)) * n;
#pragma unroll
        for (int jq = 0; jq < kMaxBits; ++jq) {
          if (jq * groups >= t) break;
          const int q = group + jq * groups;
#pragma unroll
          for (int jc = 0; jc < kColsPerLane; ++jc) {
            if (col0 + jc * lanes >= n) break;
            const int col = my_col + jc * lanes;
            bv[u][jq][jc] = wds[u] >= 0 && q < t && col < n
                                ? __ldg(b_word + q * b_plane + col) : 0u;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kWordsPerStep; ++u) {
#pragma unroll
        for (int jq = 0; jq < kMaxBits; ++jq) {
          if (jq * groups >= t) break;
          const int q = group + jq * groups;
#pragma unroll
          for (int jc = 0; jc < kColsPerLane; ++jc) {
            if (col0 + jc * lanes >= n) break;
            if (kOneBit) {
              acc[jc] += __popc(ap[u][0] & bv[u][jq][jc]);
              continue;
            }
            uint32_t sum = 0u;
#pragma unroll
            for (int p = 0; p < kMaxBits; ++p) {
              if (p >= s) break;
              sum += static_cast<uint32_t>(__popc(ap[u][p] & bv[u][jq][jc]))
                     << p;
            }
            acc[jc] += sum << q;
          }
        }
      }
    }
    word = next_word;
#pragma unroll
    for (int p = 0; p < kMaxBits; ++p) {
      if (p >= s) break;
      av[p] = next_av[p];
    }
  }

  // the plane groups' sums meet; group 0 stores
#pragma unroll
  for (int jc = 0; jc < kColsPerLane; ++jc)
    for (int off = lanes; off < 32; off <<= 1)
      acc[jc] += __shfl_xor_sync(kFullWarp, acc[jc], off);
  if (group != 0) return;
#pragma unroll
  for (int jc = 0; jc < kColsPerLane; ++jc) {
    const int col = my_col + jc * lanes;
    if (col < n)
      c[static_cast<size_t>(row) * n + col] =
          tile_output<kFused>(acc[jc], row, col, epi);
  }
}

// log2 of L, the lanes of a plane group: halve L from 32 while the half
// still covers min(n, 32) columns and the groups stay at most t.
inline int plane_group_lanes_log2(int t, int n) {
  int log2 = 5;
  while (log2 > 0 && (1 << (log2 - 1)) >= n && (32 >> (log2 - 1)) <= t)
    --log2;
  return log2;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller has checked shapes: m % block_m == 0, w % kw == 0, 1 <= s, t <= 8,
// and for the list schedule steps <= idx_stride. `occ` is (m / block_m,
// w / kw); `idx` is (m / block_m, idx_stride); `cnt` is (m / block_m,).
// block_n is the policy's column tile: columns are independent, so it
// shapes no artifact and this kernel does not read it.
template <bool kOneBit, bool kFused>
int launch_tile_kernel(const void* a, const void* b, void* c, int s, int t,
                       int m, int w, int n, int block_m, int block_n, int kw,
                       int schedule, const void* occ, const void* idx,
                       int idx_stride, const void* cnt, int steps,
                       Epilogue epi, void* stream) {
  (void)block_n;
  const int lanes_log2 = kOneBit ? 5 : plane_group_lanes_log2(t, n);
  const int cols_per_block = (1 << lanes_log2) * kColsPerLane;
  const dim3 grid((m + kRowsPerBlock - 1) / kRowsPerBlock,
                  (n + cols_per_block - 1) / cols_per_block);
  const dim3 block(32, kRowsPerBlock);
  bitserial_tile_kernel<kOneBit, kFused>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
          static_cast<int32_t*>(c), s, t, m, w, n, block_m, kw, schedule,
          static_cast<const int32_t*>(occ), static_cast<const int32_t*>(idx),
          idx_stride, static_cast<const int32_t*>(cnt), steps, lanes_log2,
          epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
