// 4-bit weight-only quantized matmul for Hopper (sm_90a): the LM decode
// projection with its weight stored at 4 bits.
//
//   x (M, K) float32 or bfloat16  @  W4 packed (K, N/2) uint8
//     (+ scales (K/G, N) float32)  ->  (M, N) float32
//   W[k, 2j + i] = (nibble i of w_packed[k, j] - 8) * scales[k / G, 2j + i]
//
// Replaces the TPU kernel src/repro/kernels/wqmm.py:62 wq_gemm (_kernel,
// _unpack_w4): the weight crosses from device memory at 4 bits and is
// dequantized on chip, never stored at full precision.
//
// Design: one block per (block_m x block_n) output tile. A loop over K
// inside the block takes the place of the TPU's sequential K grid axis and
// its VMEM accumulator. The packed weight rows of a K step and their
// scales are copied into shared memory by asynchronous copies (cp.async;
// 16 bytes a copy for the weight where the row length allows, else byte
// loads), double-buffered: step s+1's copies are in flight while step s
// computes. Each step also stages x[rows, k0:k0+bk] as float32 (bf16
// through __bfloat162float, in the kernel), stored k-major so a thread
// reads a k's rows four at a time. The block has block_n / 2 x 4 threads:
// thread (j, i) owns the two adjacent columns 2j and 2j+1 of packed byte j
// and walks rows i/4 .. (i+1)/4 of each step, one scale pair per group,
// keeping block_m x 2 float32 sums in registers; at the end the four
// slices' sums are added in slice order through shared memory. With one
// thread per packed column alone, a batch-1 call at N = 13440 would have
// 6720 threads each walking all of K. The ragged M and N edges are masked
// here; the wrapper pads K to block_k with zero scales. A call with M at
// most half of block_m (decode at batch 1) runs the smallest row count, a
// power of two, that covers M: the rows past M would only be masked, and
// each row's sums are taken in the same order whatever the row count, so
// the result is the same bit for bit.
//
// Rounding: the dequantizing product is __fmul_rn, rounded on its own as
// the reference rounds it; only the accumulate `acc += x * w` may contract
// into an FMA. Never built with --use_fast_math.
//
// Bound on this card: at decode batch 1-8 it is bytes (the packed weight
// is 4 bits plus 1 bit of scale per weight, G = 32); at batch 128 it is
// float32 operations, which this kernel does outside the tensor cores.
// Later work: wgmma on dequantized bf16 tiles, TMA loads of the packed
// tiles, and split-K across blocks for batch 1, where an (M = 1,
// N = 13440) call at block_n 256 fills only 53 of the card's 132 SMs.
//
// Built as bitserial.cu is, into the same shared library.

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Each K step is split into kSlices slices of rows, one per group of
// block_n / 2 threads, so a block has kSlices times the threads that walk
// K; their sums are added at the end, kReduceRows rows at a time.
constexpr int kSlices = 4;
constexpr int kReduceRows = 8;
constexpr int kThreadsMax = 512;  // block_n <= 256

// Sizes rounded up to 16 bytes (4 floats), so that what follows in shared
// memory stays aligned for 16-byte accesses.
__host__ __device__ __forceinline__ int padded_bytes(int bytes) {
  return (bytes + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int padded_floats(int floats) {
  return (floats + 3) / 4 * 4;
}

// An asynchronous copy of BYTES (4 or 16, aligned to that) from device
// memory into shared memory: the thread goes on at once, and the copies
// land by the next cp.async.wait_all.
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
  }
}

// Shared memory the final reduction needs.
__host__ __device__ __forceinline__ int reduce_bytes(int block_n) {
  return (kSlices - 1) * kReduceRows * block_n * 4;
}

// BM consecutive floats of shared memory, four at a time where BM allows.
template <int BM>
__device__ __forceinline__ void load_rows(float* v, const float* p) {
  if constexpr (BM % 4 == 0) {
#pragma unroll
    for (int r = 0; r < BM; r += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + r);
      v[r] = q.x; v[r + 1] = q.y; v[r + 2] = q.z; v[r + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < BM; ++r) v[r] = p[r];
  }
}

// Start copying step k0's packed weight rows and their scales into one
// stage of shared memory: asynchronous copies where the layout allows,
// byte loads otherwise; zeros past the N edge.
__device__ __forceinline__ void stage_weights(
    unsigned char* ws, float* ss, const uint8_t* __restrict__ wp,
    const float* __restrict__ scales, int k0, int n, int group, int block_n,
    int block_k, int col0, bool vec, int tid, int nthreads) {
  const int tile_w = block_n / 2, half_n = n / 2;
  const int groups = block_k / group;
  for (int i = tid; i < groups * block_n; i += nthreads) {
    const int g = i / block_n, col = 2 * col0 + (i - g * block_n);
    if (col < n) {
      copy_async<4>(ss + i, scales + static_cast<size_t>(k0 / group + g) * n + col);
    } else {
      ss[i] = 0.f;
    }
  }
  if (vec) {  // 16-byte copies: half_n and tile_w are multiples of 16
    const int chunks = tile_w / 16;
    for (int i = tid; i < block_k * chunks; i += nthreads) {
      const int r = i / chunks, c = (i - r * chunks) * 16;
      unsigned char* dst = ws + r * tile_w + c;
      if (col0 + c < half_n) {
        copy_async<16>(dst, wp + static_cast<size_t>(k0 + r) * half_n + col0 + c);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    for (int i = tid; i < block_k * tile_w; i += nthreads) {
      const int r = i / tile_w, c = i - r * tile_w;
      ws[i] = col0 + c < half_n
                  ? wp[static_cast<size_t>(k0 + r) * half_n + col0 + c]
                  : 0;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreadsMax)
wq_gemm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ wp,
               const float* __restrict__ scales, float* __restrict__ out, int m,
               int n, int k, int group, int block_n, int block_k, bool vec) {
  // shared: two stages of [packed weight tile (block_k x block_n/2 bytes),
  // its scales (block_k/group x block_n)], which the final reduction reuses,
  // then x's tile transposed (block_k x BM)
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_w = block_n / 2;
  const int groups = block_k / group;
  const int w_bytes = padded_bytes(block_k * tile_w);
  const int stage = w_bytes + 4 * padded_floats(groups * block_n);
  float* xs = reinterpret_cast<float*>(
      smem + max(2 * stage, reduce_bytes(block_n)));
  const int tid = threadIdx.y * tile_w + threadIdx.x;
  const int nthreads = tile_w * kSlices;

  const int half_n = n / 2;
  const int col0 = blockIdx.x * tile_w;  // the tile's first packed column
  const int pair = col0 + threadIdx.x;   // this thread's packed column
  const int row0 = blockIdx.y * BM;
  const bool live = pair < half_n;
  // this thread's slice of each K step: rows lo..hi of the step
  const int lo = threadIdx.y * block_k / kSlices;
  const int hi = (threadIdx.y + 1) * block_k / kSlices;
  float acc[BM][2];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r][0] = acc[r][1] = 0.f;

  stage_weights(smem, reinterpret_cast<float*>(smem + w_bytes), wp, scales, 0,
                n, group, block_n, block_k, col0, vec, tid, nthreads);
  for (int k0 = 0, s = 0; k0 < k; k0 += block_k, s ^= 1) {
    // the next step's weights stream in while this step computes; the
    // barrier at the end of the previous step freed their stage
    unsigned char* next = smem + (s ^ 1) * stage;
    if (k0 + block_k < k) {
      stage_weights(next, reinterpret_cast<float*>(next + w_bytes), wp, scales,
                    k0 + block_k, n, group, block_n, block_k, col0, vec, tid,
                    nthreads);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");  // an empty group
    }
    for (int i = tid; i < BM * block_k; i += nthreads) {
      const int r = i / block_k, c = i - r * block_k;
      const int row = row0 + r;
      xs[c * BM + r] =
          row < m ? to_float(x[static_cast<size_t>(row) * k + k0 + c]) : 0.f;
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this step's copies
    __syncthreads();
    if (live) {
      const unsigned char* ws = smem + s * stage;
      const float* ss = reinterpret_cast<const float*>(ws + w_bytes);
      for (int kk = lo; kk < hi;) {
        const int g = kk / group;
        const int end = min(hi, (g + 1) * group);
        const float s0 = ss[g * block_n + 2 * threadIdx.x];
        const float s1 = ss[g * block_n + 2 * threadIdx.x + 1];
#pragma unroll 8
        for (; kk < end; ++kk) {
          const unsigned b = ws[kk * tile_w + threadIdx.x];
          const float w0 =
              __fmul_rn(static_cast<float>(static_cast<int>(b & 0xFu) - 8), s0);
          const float w1 =
              __fmul_rn(static_cast<float>(static_cast<int>((b >> 4) & 0xFu) - 8), s1);
          float xv[BM];
          load_rows<BM>(xv, xs + kk * BM);  // one address a warp: a broadcast
#pragma unroll
          for (int r = 0; r < BM; ++r) {
            acc[r][0] += xv[r] * w0;
            acc[r][1] += xv[r] * w1;
          }
        }
      }
    }
    __syncthreads();  // every thread is done with this stage and with xs
  }

  // add the slices' sums in slice order, kReduceRows rows at a time,
  // through the (now free) stage memory
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r0 = 0; r0 < BM; r0 += kReduceRows) {
    if (threadIdx.y > 0) {
#pragma unroll
      for (int r = r0; r < min(BM, r0 + kReduceRows); ++r) {
        float* d = red + (((threadIdx.y - 1) * kReduceRows + r - r0) * tile_w +
                          threadIdx.x) * 2;
        d[0] = acc[r][0];
        d[1] = acc[r][1];
      }
    }
    __syncthreads();
    if (threadIdx.y == 0 && live) {
#pragma unroll
      for (int r = r0; r < min(BM, r0 + kReduceRows); ++r) {
        float v0 = acc[r][0], v1 = acc[r][1];
        for (int j = 1; j < kSlices; ++j) {
          const float* p =
              red + (((j - 1) * kReduceRows + r - r0) * tile_w + threadIdx.x) * 2;
          v0 += p[0];
          v1 += p[1];
        }
        const int row = row0 + r;
        if (row < m) {
          float* o = out + static_cast<size_t>(row) * n + 2 * pair;
          o[0] = v0;
          o[1] = v1;
        }
      }
    }
    __syncthreads();
  }
}

// Shared memory of one block: two stages of weight and scale tiles (or the
// final reduction, if larger) and x's tile. Above 48 KB a kernel must be
// allowed it first.
inline size_t shared_bytes(int bm, int group, int block_n, int block_k) {
  const int stage = padded_bytes(block_k * (block_n / 2)) +
                    4 * padded_floats(block_k / group * block_n);
  return static_cast<size_t>(std::max(2 * stage, reduce_bytes(block_n))) +
         sizeof(float) * bm * block_k;
}

template <typename T, int BM>
void launch_rows(const void* x, const void* wp, const void* scales, void* out,
                 int m, int n, int k, int group, int block_n, int block_k,
                 cudaStream_t stream) {
  const int threads = block_n / 2;
  const dim3 grid(static_cast<unsigned>((n / 2 + threads - 1) / threads),
                  static_cast<unsigned>((m + BM - 1) / BM));
  const dim3 block(threads, kSlices);
  const size_t shared = shared_bytes(BM, group, block_n, block_k);
  if (shared > 48 * 1024) {
    cudaFuncSetAttribute(wq_gemm_kernel<T, BM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(shared));
  }
  const bool vec = (n / 2) % 16 == 0 && threads % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wp) % 16 == 0;
  wq_gemm_kernel<T, BM><<<grid, block, shared, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(wp),
      static_cast<const float*>(scales), static_cast<float*>(out), m, n, k,
      group, block_n, block_k, vec);
}

template <typename T>
int launch_typed(const void* x, const void* wp, const void* scales, void* out,
                 int m, int n, int k, int group, int block_m, int block_n,
                 int block_k, cudaStream_t stream) {
  while (block_m > 1 && block_m / 2 >= m) block_m /= 2;
  switch (block_m) {
    case 1: launch_rows<T, 1>(x, wp, scales, out, m, n, k, group, block_n, block_k, stream); break;
    case 2: launch_rows<T, 2>(x, wp, scales, out, m, n, k, group, block_n, block_k, stream); break;
    case 4: launch_rows<T, 4>(x, wp, scales, out, m, n, k, group, block_n, block_k, stream); break;
    case 8: launch_rows<T, 8>(x, wp, scales, out, m, n, k, group, block_n, block_k, stream); break;
    case 16: launch_rows<T, 16>(x, wp, scales, out, m, n, k, group, block_n, block_k, stream); break;
    case 32: launch_rows<T, 32>(x, wp, scales, out, m, n, k, group, block_n, block_k, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller has checked: x is (m, k) float32 (x_bf16 = 0) or bfloat16
// (x_bf16 = 1), wp (k, n/2) uint8, scales (k/group, n) float32, out (m, n)
// float32, all contiguous on the device; n is even, k a multiple of
// block_k, block_k of group; block_m is 1, 2, 4, 8, 16 or 32; block_n is
// even and at most 2048; shared_bytes() is at most 227 KB.
extern "C" int wq_gemm_launch(const void* x, const void* wp, const void* scales,
                              void* out, int m, int n, int k, int group,
                              int block_m, int block_n, int block_k, int x_bf16,
                              void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_typed<__nv_bfloat16>(x, wp, scales, out, m, n, k, group,
                                               block_m, block_n, block_k, s)
                : launch_typed<float>(x, wp, scales, out, m, n, k, group,
                                      block_m, block_n, block_k, s);
}
