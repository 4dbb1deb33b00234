// Any-bitwidth bit-serial GEMM for Hopper (sm_90a), by 1-bit composition,
// plain and with the §4.5 fused requantize epilogue.
//
//   A (s, M, W) x B (t, W, N) 32-bit words  ->  C (M, N) int32
//   C = sum_{p<s, q<t} 2^(p+q) * sum_w popcount(A_p[m, w] & B_q[w, n])
//   fused: C = clip(floor(max?(f32(C) * alpha[m] + beta[n], 0)), 0, qmax)
//
// Replaces the TPU kernels src/repro/kernels/bitserial.py:bitserial_gemm
// and :bitserial_fused (both built by _pallas_bitserial; bodies _kernel,
// _kernel_mask and _kernel_compact, the latter run at one-word K tiles for
// sgt; the fused epilogue is _store). The kernel body, its schedules and
// its epilogue are in bitserial_tile.cuh.
//
// Bound on this card: the function reads s*M*W*4 + t*W*N*4 bytes (and M + N
// floats of alpha and beta) and writes M*N*4; it does t*N AND+popcount
// steps for every non-zero word of A's s planes that the schedule visits
// (s*t*M*N*W when A has no zero word); the popcounts, 16 a clock on an SM
// against 64 for the AND, set the operation side. At the adjacency GEMM of
// the GNN path (s = 1, W = 72, ~10 % non-zero tiles) a call is launch
// latency and a few dependent loads a warp; at the dense 8-bit feature
// GEMMs (s = t = 8) the popcounts bound it. bitserial_tile.cuh says how the
// 'vpu' kernel meets both.
//
// Two compute modes, as the reference has: 'vpu' (*_launch) runs the
// popcounts on the CUDA cores (bitserial_tile.cuh); 'mxu' (*_mxu_launch)
// runs the same schedules on the tensor cores with the b1 mma.sync
// m16n8k256 .and.popc, a warp a 16-row strip, with same-weight plane pairs
// sharing an mma where K is at most 128 bits (bitserial_mma.cuh). Both
// return the same int32.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -Xcompiler -fPIC, linked with the other csrc/*.cu into one
//             shared library (plain C interface, loaded by ctypes). Never
//             with --use_fast_math: the epilogue must round as IEEE float32.

#include "bitserial_mma.cuh"
#include "bitserial_tile.cuh"

extern "C" int bitserial_gemm_launch(const void* a, const void* b, void* c,
                                     int s, int t, int m, int w, int n,
                                     int block_m, int block_n, int kw,
                                     int schedule, const void* occ,
                                     const void* idx, int idx_stride,
                                     const void* cnt, int steps,
                                     void* stream) {
  return launch_tile_kernel<false, false>(a, b, c, s, t, m, w, n, block_m,
                                          block_n, kw, schedule, occ, idx,
                                          idx_stride, cnt, steps, Epilogue{},
                                          stream);
}

// `alpha` is (m,) float32, padded with rows to block_m; `beta` is (n,)
// float32; qmax = 2^out_bits - 1.
extern "C" int bitserial_fused_launch(const void* a, const void* b, void* c,
                                      int s, int t, int m, int w, int n,
                                      int block_m, int block_n, int kw,
                                      int schedule, const void* occ,
                                      const void* idx, int idx_stride,
                                      const void* cnt, int steps,
                                      const void* alpha, const void* beta,
                                      float qmax, int relu, void* stream) {
  const Epilogue epi{static_cast<const float*>(alpha),
                     static_cast<const float*>(beta), qmax, relu};
  return launch_tile_kernel<false, true>(a, b, c, s, t, m, w, n, block_m,
                                         block_n, kw, schedule, occ, idx,
                                         idx_stride, cnt, steps, epi, stream);
}

// mode="mxu": the same arguments, on the tensor cores.
extern "C" int bitserial_gemm_mxu_launch(const void* a, const void* b, void* c,
                                         int s, int t, int m, int w, int n,
                                         int block_m, int block_n, int kw,
                                         int schedule, const void* occ,
                                         const void* idx, int idx_stride,
                                         const void* cnt, int steps,
                                         void* stream) {
  return launch_mma_kernel<false, false>(a, b, c, s, t, m, w, n, block_m,
                                         block_n, kw, schedule, occ, idx,
                                         idx_stride, cnt, steps, Epilogue{},
                                         stream);
}

extern "C" int bitserial_fused_mxu_launch(const void* a, const void* b,
                                          void* c, int s, int t, int m, int w,
                                          int n, int block_m, int block_n,
                                          int kw, int schedule,
                                          const void* occ, const void* idx,
                                          int idx_stride, const void* cnt,
                                          int steps, const void* alpha,
                                          const void* beta, float qmax,
                                          int relu, void* stream) {
  const Epilogue epi{static_cast<const float*>(alpha),
                     static_cast<const float*>(beta), qmax, relu};
  return launch_mma_kernel<false, true>(a, b, c, s, t, m, w, n, block_m,
                                        block_n, kw, schedule, occ, idx,
                                        idx_stride, cnt, steps, epi, stream);
}
