// 1-bit GEMM for Hopper (sm_90a) by AND + popcount (paper §3 Eq. 7).
//
//   A (M, W) x B (W, N) 32-bit words  ->  C (M, N) int32
//   C[m, n] = sum_w popcount(A[m, w] & B[w, n])
//
// Replaces the TPU kernel src/repro/kernels/bgemm.py:bgemm in both compute
// modes of _tile_product (bodies _kernel_plain, _kernel_mask,
// _kernel_compact, the latter run at one-word K tiles for sgt). 'vpu'
// (bgemm_launch) is the kernel of bitserial_tile.cuh at one plane each: a
// warp a row, the same walk and warp-wide skip of zero words, the same four
// schedules, 32 lanes over the columns, and no plane loops or shifts.
// 'mxu' (bgemm_mxu_launch) is the tensor-core core of
// bitserial_mma.cuh at one plane each: a warp a 16-row strip and up to 32
// columns, B staged in shared memory, A's runs of 8 words copied ahead by
// cp.async, one b1 mma.sync m16n8k256 .and.popc a fragment for each run
// that is not zero in every row, accumulated in place. It is what the
// port's reuse=False ablation (paper Fig. 9a) launches once per plane pair.
//
// Bound on this card: it reads M*W*4 + W*N*4 bytes and writes M*N*4, and
// does N AND+popcount steps for every non-zero word of A that the schedule
// visits. At the GNN shapes (the sparse adjacency, N = 128) both are far
// below a launch: a call is launch latency and a few dependent loads a warp.
//
// Built as bitserial.cu is, into the same shared library.

#include "bitserial_mma.cuh"
#include "bitserial_tile.cuh"

extern "C" int bgemm_launch(const void* a, const void* b, void* c, int m,
                            int w, int n, int block_m, int block_n, int kw,
                            int schedule, const void* occ, const void* idx,
                            int idx_stride, const void* cnt, int steps,
                            void* stream) {
  return launch_tile_kernel<true, false>(a, b, c, 1, 1, m, w, n, block_m,
                                         block_n, kw, schedule, occ, idx,
                                         idx_stride, cnt, steps, Epilogue{},
                                         stream);
}

// mode="mxu": the same arguments, on the tensor cores.
extern "C" int bgemm_mxu_launch(const void* a, const void* b, void* c, int m,
                                int w, int n, int block_m, int block_n, int kw,
                                int schedule, const void* occ, const void* idx,
                                int idx_stride, const void* cnt, int steps,
                                void* stream) {
  return launch_mma_kernel<true, false>(a, b, c, 1, 1, m, w, n, block_m,
                                        block_n, kw, schedule, occ, idx,
                                        idx_stride, cnt, steps, Epilogue{},
                                        stream);
}
