// Quantize (paper Eq. 2) and 3D-stacked bit compression (§4.2) for Hopper
// (sm_90a).
//
//   x (M, K) float32, scalar scale and zero  ->  (nbits, M, words) uint32
//   q = clip(floor((x - zero) / scale), 0, 2^nbits - 1), columns >= K are 0,
//   word w of plane i holds bit i of q[m, 32w .. 32w + 31], little-endian
//
// Replaces the TPU kernel src/repro/kernels/bitpack.py:bitpack (_kernel).
//
// Design: one warp per (row, 32-column word). Lane j loads x[row, 32w + j],
// so each warp reads one coalesced 128-byte line; it quantizes with
// __fsub_rn then __fdiv_rn (two IEEE roundings, as the reference: no
// reciprocal, no FMA), floors and clips. Plane i of the word is then one
// __ballot_sync of bit i of every lane's q: bit j of the ballot is lane j,
// the reference's little-endian order. Lane i stores plane i. `words` may
// exceed ceil(K / 32): those words see only columns >= K and are zero.
// scale and zero are read from device memory, so the call never waits for
// the host.
//
// Bound on this card: bytes. It reads 4*M*K bytes and writes
// 4*nbits*M*words; a handful of float and integer operations per element
// is far below the card's rate. At the Tensor API's shapes (M = 2304,
// K = 128) it moves about 1.5 MB, under a microsecond at 3.35 TB/s, so a
// call is bounded by launch latency.
//
// Built as bitserial.cu is, into the same shared library.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void bitpack_kernel(const float* __restrict__ x,
                               const float* __restrict__ scale,
                               const float* __restrict__ zero,
                               uint32_t* __restrict__ out, int m, int k,
                               int words, int nbits, float qmax) {
  const int lane = threadIdx.x & 31;
  const size_t warp =
      (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  // warp-uniform: a warp leaves whole, so every ballot below sees 32 lanes
  if (warp >= static_cast<size_t>(m) * words) return;
  const int row = static_cast<int>(warp / words);
  const int wd = static_cast<int>(warp - static_cast<size_t>(row) * words);
  const int col = wd * 32 + lane;
  uint32_t q = 0u;
  if (col < k) {
    const float v = floorf(__fdiv_rn(
        __fsub_rn(x[static_cast<size_t>(row) * k + col], *zero), *scale));
    q = static_cast<uint32_t>(fminf(fmaxf(v, 0.f), qmax));
  }
  uint32_t mine = 0u;
  for (int p = 0; p < nbits; ++p) {
    const uint32_t plane = __ballot_sync(0xffffffffu, (q >> p) & 1u);
    if (lane == p) mine = plane;
  }
  if (lane < nbits) {
    out[(static_cast<size_t>(lane) * m + row) * words + wd] = mine;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller has checked: x is (m, k) float32, scale and zero one float32 each
// on the device, out is (nbits, m, words) with words >= ceil(k / 32), and
// 1 <= nbits <= 8; qmax = 2^nbits - 1.
extern "C" int bitpack_launch(const void* x, const void* scale,
                              const void* zero, void* out, int m, int k,
                              int words, int nbits, float qmax,
                              void* stream) {
  const size_t threads = static_cast<size_t>(m) * words * 32;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  bitpack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(zero), static_cast<uint32_t*>(out), m, k,
      words, nbits, qmax);
  return static_cast<int>(cudaGetLastError());
}
