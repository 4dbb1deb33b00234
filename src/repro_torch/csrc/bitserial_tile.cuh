// The tiled popcount GEMM shared by bitserial.cu (any bitwidth, plain and
// fused epilogue) and bgemm.cu (1 bit).
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
// Design, simple and exact: one block per (row tile i, column tile), one
// thread per output element. Per K tile the block stages the A words of all
// s planes and the B words of all t planes in shared memory (B read
// coalesced along N, the ragged N edge masked), so each A word is loaded
// once for all s*t plane pairs (paper §4.4). Each thread accumulates its
// output in a uint32_t, so overflow wraps as the reference's int32 does.
//
// kOneBit fixes s = t = 1 at compile time: the body has no plane loops and
// no shifts (bgemm). kFused applies the §4.5 epilogue on the way out:
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

// The int32 the kernels store for an accumulator: itself, or under kFused
// the §4.5 epilogue at (row, col), rounded twice as the reference does.
template <bool kFused>
__device__ __forceinline__ int32_t tile_output(uint32_t acc, int row, int col,
                                               const Epilogue& epi) {
  int32_t out = static_cast<int32_t>(acc);
  if (kFused) {
    float y = __fadd_rn(__fmul_rn(__int2float_rn(out), epi.alpha[row]),
                        epi.beta[col]);
    if (epi.relu) y = fmaxf(y, 0.f);
    out = static_cast<int32_t>(fminf(fmaxf(floorf(y), 0.f), epi.qmax));
  }
  return out;
}

template <bool kOneBit, bool kFused>
__global__ void bitserial_tile_kernel(const uint32_t* __restrict__ a,
                                      const uint32_t* __restrict__ b,
                                      int32_t* __restrict__ c, int s_rt,
                                      int t_rt, int m, int w, int n, int kw,
                                      int schedule,
                                      const int32_t* __restrict__ occ,
                                      const int32_t* __restrict__ idx,
                                      int idx_stride,
                                      const int32_t* __restrict__ cnt,
                                      int steps, Epilogue epi) {
  extern __shared__ uint32_t smem[];
  const int s = kOneBit ? 1 : s_rt;
  const int t = kOneBit ? 1 : t_rt;
  const int block_m = blockDim.y;
  const int block_n = blockDim.x;
  uint32_t* a_s = smem;                              // [s][block_m][kw]
  uint32_t* b_s = smem + s * block_m * kw;           // [t][kw][block_n]

  const int i = blockIdx.x;                          // row tile
  const int col0 = blockIdx.y * block_n;
  const int r = threadIdx.y;
  const int cl = threadIdx.x;
  const int tid = r * block_n + cl;
  const int nthreads = block_m * block_n;
  const int k_tiles = w / kw;
  const int a_elems = s * block_m * kw;
  const int b_elems = t * kw * block_n;

  int live = steps;
  if (schedule == kList) live = min(cnt[i], steps);

  uint32_t acc = 0;
  for (int step = 0; step < live; ++step) {
    // k depends only on (i, step): every thread of the block takes the same
    // branch, so the skips below never split a __syncthreads().
    int k = step;
    if (schedule == kList) {
      k = idx[static_cast<size_t>(i) * idx_stride + step];
      if (k < 0 || k >= k_tiles) continue;
    } else if (schedule == kMask &&
               occ[static_cast<size_t>(i) * k_tiles + step] == 0) {
      continue;
    }
    const size_t w0 = static_cast<size_t>(k) * kw;
    for (int e = tid; e < a_elems; e += nthreads) {
      const int p = e / (block_m * kw);
      const int rem = e - p * block_m * kw;
      const int rr = rem / kw;
      const int ww = rem - rr * kw;
      a_s[e] = a[(static_cast<size_t>(p) * m +
                  static_cast<size_t>(i) * block_m + rr) * w + w0 + ww];
    }
    for (int e = tid; e < b_elems; e += nthreads) {
      const int q = e / (kw * block_n);
      const int rem = e - q * kw * block_n;
      const int ww = rem / block_n;
      const int col = col0 + rem - ww * block_n;
      b_s[e] = col < n
                   ? b[(static_cast<size_t>(q) * w + w0 + ww) * n + col]
                   : 0u;
    }
    __syncthreads();
    for (int ww = 0; ww < kw; ++ww) {
      if (kOneBit) {
        acc += __popc(a_s[r * kw + ww] & b_s[ww * block_n + cl]);
        continue;
      }
      for (int p = 0; p < s; ++p) {
        const uint32_t av = a_s[(p * block_m + r) * kw + ww];
        if (av == 0u) continue;
        for (int q = 0; q < t; ++q) {
          acc += static_cast<uint32_t>(
                     __popc(av & b_s[(q * kw + ww) * block_n + cl]))
                 << (p + q);
        }
      }
    }
    __syncthreads();
  }
  const int row = i * block_m + r;
  const int col = col0 + cl;
  if (col >= n) return;
  c[static_cast<size_t>(row) * n + col] =
      tile_output<kFused>(acc, row, col, epi);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller has checked shapes: m % block_m == 0, w % kw == 0, block_m *
// block_n <= 1024 and a multiple of 32, 1 <= s, t <= 8, and for the list
// schedule steps <= idx_stride. `occ` is (m / block_m, w / kw); `idx` is
// (m / block_m, idx_stride); `cnt` is (m / block_m,).
template <bool kOneBit, bool kFused>
int launch_tile_kernel(const void* a, const void* b, void* c, int s, int t,
                       int m, int w, int n, int block_m, int block_n, int kw,
                       int schedule, const void* occ, const void* idx,
                       int idx_stride, const void* cnt, int steps,
                       Epilogue epi, void* stream) {
  const size_t smem = sizeof(uint32_t) *
                      (static_cast<size_t>(s) * block_m * kw +
                       static_cast<size_t>(t) * kw * block_n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bitserial_tile_kernel<kOneBit, kFused>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(m / block_m, (n + block_n - 1) / block_n);
  const dim3 block(block_n, block_m);
  bitserial_tile_kernel<kOneBit, kFused>
      <<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
          static_cast<int32_t*>(c), s, t, m, w, n, kw, schedule,
          static_cast<const int32_t*>(occ), static_cast<const int32_t*>(idx),
          idx_stride, static_cast<const int32_t*>(cnt), steps, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
