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
// An int8 mma on unpacked planes would be the literal counterpart; it moves
// 32x the bytes of the packed words through shared memory or registers, and
// b1 AND + popcount gives the same int32 without unpacking.
//
// Grid and walk are those of bitserial_tile.cuh: one block per (row tile i
// of block_m rows, column tile of block_n), block_m * block_n threads (whole
// warps, at most 1024: the policy's checks), and a copy of its walk over the
// K tiles that row tile i visits (Walk below), so that the two modes sum the
// same words.
//
// Gather, then multiply. One mma consumes 8 words (256 K bits) of each row
// and column. The words of the visited tiles are appended one by one to a
// run of 8 slots: every thread walks the same schedule, and the lanes that
// feed slot c and slot 4 + c of a fragment (lane % 4 == c) keep those slots'
// word indices in two registers. When the run is full, each warp loads its
// fragments' words of all s and t planes from global memory (read-only,
// cached) and issues the mmas. After the last visited tile the partial run
// is flushed, with the slots past its end read as zero words. A zero word
// ANDs to zero and the sum is an integer in any order, so this is exact for
// any tile depth kw: the default 4-word tiles (half an mma) and SGT's 1-word
// tiles take the same path as 8-word ones.
//
// Fragments. The block's output tile is rounded up to 16 rows and 8 columns
// and cut into m16 x n8 fragments, dealt to the warps round robin. With
// block_m * block_n / 32 warps no warp gets more than kMaxFrags = 4 for any
// tile the policy accepts (the most is at 1 x 32: four fragments, one
// warp), so the accumulators stay in registers. Rows >= block_m and columns
// >= block_n or >= N read as zero and are not stored; a fragment wholly
// past N is skipped. At the default 8 x 32 tile that is 4 fragments over 8
// warps, with a1 and a3 (rows 8..15) zero.
//
// Fragment layout of .m16n8k256 .b1 (A row-major, B column-major), lane =
// 4 g + c: A (row g, word c), (row g+8, word c), (row g, word 4+c),
// (row g+8, word 4+c); B (word c, col g), (word 4+c, col g); D (row g, cols
// 2c and 2c+1), (row g+8, cols 2c and 2c+1). Only the pairing of A's word
// with B's word matters: the bit order inside a word is the same in both.
//
// Plane pairs: one mma with C = 0 for each (p, q), then D << (p + q) added
// into uint32_t accumulators, which wrap as the reference's int32 and the
// 'vpu' kernel's accumulator do. kOneBit fixes s = t = 1; kFused applies
// the epilogue of bitserial_tile.cuh (tile_output) on the way out, the
// function the 'vpu' kernel calls.
//
// Why the run is not staged in shared memory: 8 words of s planes for
// block_m rows and of t planes for block_n columns take 32 * (s * block_m +
// t * block_n) bytes, 262,400 at the 1 x 1024 tile with s = t = 8, which the
// policy accepts, above the 232,448 a block may use. Loading the fragments
// from global memory fits every tile and needs no barrier.
//
// Bound on this card: it reads the same bytes as the 'vpu' kernel, s*M*W*4
// + t*W*N*4, and writes M*N*4; at the GNN path's shapes (N = 16..128, W <=
// 72) bytes bound it, and launch latency and the latency of each run's
// loads dominate. Later work: wgmma m64nNk256 .b1, ldmatrix/cp.async
// staging with the next run's loads in flight, and several row tiles per
// block in the dense schedule.
#pragma once

#include "bitserial_tile.cuh"

namespace {

constexpr int kMaxFrags = 4;   // m16 x n8 fragments a warp holds
constexpr int kMaxPlanes = 8;  // s, t <= 8 (the wrapper checks)
constexpr int kRunWords = 8;   // 256 K bits: the depth of one mma

// The schedule's walk of bitserial_tile_kernel (bitserial_tile.cuh), copied
// so that both modes visit the same K tiles: steps_of(i) is the length of
// row tile i's K loop, tile_at(i, step) the K tile it visits at that step,
// or -1 where the schedule skips it. Both depend only on (i, step). (Calling
// this struct from the 'vpu' kernel too made its 1-bit instance 34 % slower
// on the H100, so that kernel keeps its own copy inline.)
struct Walk {
  int schedule;
  int k_tiles;  // w / kw
  const int32_t* occ;
  const int32_t* idx;
  int idx_stride;
  const int32_t* cnt;
  int steps;

  __device__ __forceinline__ int steps_of(int i) const {
    return schedule == kList ? min(cnt[i], steps) : steps;
  }

  __device__ __forceinline__ int tile_at(int i, int step) const {
    if (schedule == kList) {
      const int k = idx[static_cast<size_t>(i) * idx_stride + step];
      return (k < 0 || k >= k_tiles) ? -1 : k;
    }
    if (schedule == kMask && occ[static_cast<size_t>(i) * k_tiles + step] == 0)
      return -1;
    return step;
  }
};

__device__ __forceinline__ void mma_b1_and_popc(const uint32_t (&a)[4],
                                                const uint32_t (&b)[2],
                                                int32_t (&d)[4]) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "r"(0), "r"(0), "r"(0), "r"(0));
}

// __launch_bounds__: a block may hold 1024 threads (the 32 x 32 tile), so
// ptxas must keep a thread within 64 registers (it spills a few bytes of
// the any-bitwidth instances to do so).
template <bool kOneBit, bool kFused>
__global__ void __launch_bounds__(1024)
    bitserial_mma_kernel(const uint32_t* __restrict__ a,
                         const uint32_t* __restrict__ b,
                         int32_t* __restrict__ c, int s_rt, int t_rt, int m,
                         int w, int n, int kw, int schedule,
                         const int32_t* __restrict__ occ,
                         const int32_t* __restrict__ idx, int idx_stride,
                         const int32_t* __restrict__ cnt, int steps,
                         Epilogue epi) {
  const int s = kOneBit ? 1 : s_rt;
  const int t = kOneBit ? 1 : t_rt;
  const int block_m = blockDim.y;
  const int block_n = blockDim.x;
  const int i = blockIdx.x;  // row tile
  const int col0 = blockIdx.y * block_n;
  const int tid = threadIdx.y * block_n + threadIdx.x;
  const int warp = tid >> 5;
  const int nwarps = (block_m * block_n) >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int cq = lane & 3;
  const int frag_n = (block_n + 7) / 8;
  const int frags = (block_m + 15) / 16 * frag_n;
  if (warp >= frags) return;  // no barrier anywhere: idle warps may leave

  const Walk walk{schedule, w / kw, occ, idx, idx_stride, cnt, steps};
  const int live = walk.steps_of(i);
  const uint32_t* a_tile = a + static_cast<size_t>(i) * block_m * w;

  uint32_t acc[kMaxFrags][4];
#pragma unroll
  for (int j = 0; j < kMaxFrags; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0u;

  // Multiply the run: its slots cq and 4 + cq hold words lo and hi of K,
  // and slots >= fill read as zero. Everything that decides a branch around
  // an mma (fill, the fragment, its column range) is uniform over the warp.
  auto flush = [&](int fill, int lo, int hi) {
    const bool has_lo = cq < fill;
    const bool has_hi = cq + 4 < fill;
#pragma unroll
    for (int j = 0; j < kMaxFrags; ++j) {
      const int f = warp + j * nwarps;
      if (f >= frags) continue;
      const int fm = f / frag_n;
      const int fc = (f - fm * frag_n) * 8;  // first column in the tile
      if (col0 + fc >= n) continue;
      const int r0 = fm * 16 + g;
      const int col = fc + g;
      const bool ok_r0 = r0 < block_m;
      const bool ok_r1 = r0 + 8 < block_m;
      const bool ok_c = col < block_n && col0 + col < n;
      uint32_t bf[kMaxPlanes][2];
#pragma unroll
      for (int q = 0; q < kMaxPlanes; ++q) {
        if (q >= t) break;
        const uint32_t* bq = b + static_cast<size_t>(q) * w * n + col0 + col;
        bf[q][0] = ok_c && has_lo ? __ldg(bq + static_cast<size_t>(lo) * n) : 0u;
        bf[q][1] = ok_c && has_hi ? __ldg(bq + static_cast<size_t>(hi) * n) : 0u;
      }
#pragma unroll
      for (int p = 0; p < kMaxPlanes; ++p) {
        if (p >= s) break;
        const uint32_t* ap = a_tile + static_cast<size_t>(p) * m * w +
                             static_cast<size_t>(r0) * w;
        const uint32_t af[4] = {
            ok_r0 && has_lo ? __ldg(ap + lo) : 0u,
            ok_r1 && has_lo ? __ldg(ap + 8 * static_cast<size_t>(w) + lo) : 0u,
            ok_r0 && has_hi ? __ldg(ap + hi) : 0u,
            ok_r1 && has_hi ? __ldg(ap + 8 * static_cast<size_t>(w) + hi) : 0u};
#pragma unroll
        for (int q = 0; q < kMaxPlanes; ++q) {
          if (q >= t) break;
          int32_t d[4];
          mma_b1_and_popc(af, bf[q], d);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[j][e] += static_cast<uint32_t>(d[e]) << (p + q);
        }
      }
    }
  };

  int fill = 0, lo = 0, hi = 0;
  for (int step = 0; step < live; ++step) {
    const int k = walk.tile_at(i, step);
    if (k < 0) continue;
    for (int ww = 0; ww < kw; ++ww) {
      const int word = k * kw + ww;
      if (fill == cq) lo = word;
      if (fill == cq + 4) hi = word;
      if (++fill == kRunWords) {
        flush(kRunWords, lo, hi);
        fill = 0;
      }
    }
  }
  if (fill > 0) flush(fill, lo, hi);

#pragma unroll
  for (int j = 0; j < kMaxFrags; ++j) {
    const int f = warp + j * nwarps;
    if (f >= frags) continue;
    const int fm = f / frag_n;
    const int fc = (f - fm * frag_n) * 8;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = fm * 16 + g + (e >> 1) * 8;
      const int cl = fc + 2 * cq + (e & 1);
      const int row = i * block_m + r;
      const int col = col0 + cl;
      if (r < block_m && cl < block_n && col < n)
        c[static_cast<size_t>(row) * n + col] =
            tile_output<kFused>(acc[j][e], row, col, epi);
    }
  }
}

// Launches on `stream` and returns cudaGetLastError() (0 on success), with
// the arguments and the caller's checks of launch_tile_kernel. It uses no
// shared memory. A tile that would give a warp more than kMaxFrags
// fragments (none that the policy accepts) is refused with
// cudaErrorInvalidConfiguration and not launched.
template <bool kOneBit, bool kFused>
int launch_mma_kernel(const void* a, const void* b, void* c, int s, int t,
                      int m, int w, int n, int block_m, int block_n, int kw,
                      int schedule, const void* occ, const void* idx,
                      int idx_stride, const void* cnt, int steps,
                      Epilogue epi, void* stream) {
  const int frags = (block_m + 15) / 16 * ((block_n + 7) / 8);
  const int nwarps = block_m * block_n / 32;
  if (nwarps < 1 || frags > kMaxFrags * nwarps)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(m / block_m, (n + block_n - 1) / block_n);
  const dim3 block(block_n, block_m);
  bitserial_mma_kernel<kOneBit, kFused>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
          static_cast<int32_t*>(c), s, t, m, w, n, kw, schedule,
          static_cast<const int32_t*>(occ), static_cast<const int32_t*>(idx),
          idx_stride, static_cast<const int32_t*>(cnt), steps, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
