// Quantize (paper Eq. 2) and 3D-stacked bit compression (§4.2) for Hopper
// (sm_90a).
//
//   x (M, K) float32, scalar scale and zero  ->  (nbits, M, words) uint32
//   q = clip(floor((x - zero) / scale), 0, 2^nbits - 1), columns >= K are 0,
//   word w of plane i holds bit i of q[m, 32w .. 32w + 31], little-endian
//
// Replaces the TPU kernel src/repro/kernels/bitpack.py:bitpack (_kernel).
//
// What bounds it: bytes, and close behind them the instructions it
// issues. It reads 4*M*K bytes and writes 4*nbits*M*words; at a whole
// graph's features (ogbn-arxiv 169,343 x 128, 108 MB at 8 bits) it runs
// at about 80 % of the card's 3.35 TB/s. A warp spends about 110
// instructions on a (row, chunk) task, 75 of them packing it, which is 28
// a lane for each of its 4 elements: at ogbn-products' K = 100, where 7
// of a warp's 32 lanes lie past K, the issue slots and not the bytes set
// the time. At one batch's features (2304 x 128, 1.5 MB, L2-resident) the
// launch and one memory round trip do.
//
// Design.
// - Work is a (row, chunk) task: a chunk is 128 columns, 4 words of every
//   plane, and one warp's task. Lane l holds columns 4l .. 4l+3 of it: one
//   16-byte load (float4) where K is a multiple of 4 and x is 16-byte
//   aligned, so a warp reads 512 contiguous bytes; four 4-byte loads of
//   the same columns otherwise (a second instance of the kernel, chosen by
//   the launcher from K and the pointer). The word w of the chunk is then
//   lanes 8w .. 8w+7.
// - A tile is `rows` rows x `tc` chunks (tc a power of two, rows * tc <=
//   kTasks); each of a block's kWarps warps takes kUnroll of its tasks and
//   issues all their loads before it uses any: kUnroll x 16 bytes a
//   thread in flight, 16 KB a block. A thread's slots (row and column in
//   the tile) are the same in every tile; where a row is one chunk (K <=
//   128, every graph of the paper's Table 1) a kernel instance of its own
//   knows them at compile time (the launcher picks one of four: 16- or
//   4-byte loads, one chunk or more a row). The grid is sized to the SMs (their count
//   times the blocks an SM holds) and walks the tiles in a grid-stride
//   loop, 64-bit offsets. scale and zero are read once a thread, their
//   loads beside the first tile's.
// - Quantize: a = __fsub_rn(x, zero), then the IEEE quotient RN(a / scale)
//   (the reference's two roundings), floor and clip. The quotient is the
//   correction step of a division by a known reciprocal (Markstein): with
//   recip = RN(1 / scale) once a thread, q = RN(a * recip), r = a - scale
//   * q exact in one fma, RN(q + r * recip) = RN(a / scale), three float
//   operations where __fdiv_rn's subroutine takes about 15 and a branch.
//   It holds wherever nothing overflows or underflows; the kernel takes it
//   for 2^-100 <= |scale| <= 2^100 (one branch for the grid, __fdiv_rn
//   otherwise) and keeps q itself where |q| >= 2^24, past both clip ends.
//   floor and the conversion are one instruction (cvt.rmi), the clip two
//   integer min/max.
// - Words from 4-column lanes: a lane packs its four levels a byte each
//   (bit 8c + p: column c, plane p), then three __shfl_xor_sync exchanges
//   inside its 8-lane word group (xor 1, 2, 4) move all eight planes at
//   once: each swaps one bit of the lane index with one bit of the bit
//   index (a butterfly transpose, `exchange`). After them lane h of the
//   group holds one plane (`plane_of_lane`), and two delta swaps inside
//   the register put column 4h' + c of the word (lane h' of the group,
//   column c of the lane) at bit 4h' + c, the word's little-endian order.
//   Three shuffles and about 20 integer operations a lane for all planes,
//   where four ballots a plane and a bit interleave would take 32 ballots
//   at 8 bits.
// - Whole-sector stores: the tile's words are staged in shared memory,
//   plane by plane (kPlaneStride words apart, which keeps the 32 lanes of
//   a staging store on 32 banks), each plane's rows back to back. Where
//   the tile spans every word of a row, a plane's rows * words words are
//   contiguous in the output too, and the block writes them with 16-byte
//   stores (4-byte stores where words is not a multiple of 4), consecutive
//   threads on consecutive addresses. Words past ceil(K / 32) are zeros
//   written without reading x.
// scale and zero are read from device memory, so the call never waits for
// the host. Never built with --use_fast_math. Built as bitserial.cu is,
// into the same shared library.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                            // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kColsPerLane = 4;                      // one float4
constexpr int kLanesPerWord = 32 / kColsPerLane;     // 8
constexpr int kWordsPerChunk = 32 / kLanesPerWord;   // 4: a warp's 128 columns
constexpr int kUnroll = 4;                           // tasks a warp takes a tile
constexpr int kTasks = kWarps * kUnroll;             // (row, chunk) tasks a tile
constexpr int kMaxPlanes = 8;
// a plane's staged words: rows * tc * 4 <= kTasks * 4, plus 4 words of pad
constexpr int kPlaneStride = kTasks * kWordsPerChunk + 4;

// After the three exchanges of the transpose (below), lane h of a word
// group holds plane 4 * bit0(h) + 2 * bit2(h) + bit1(h).
__device__ __forceinline__ int plane_of_lane(int h) {
  return ((h & 1) << 2) | (((h >> 2) & 1) << 1) | ((h >> 1) & 1);
}

// One exchange of the transpose: bit kLaneBit of the lane index trades with
// bit kBit of the bit index (kMask: the bits whose index has it set). A lane
// keeps the bits whose index bit equals its lane bit and takes the others
// from lane h ^ (1 << kLaneBit), moved by 1 << kBit places: the partner
// rotates its word, left where its lane bit is set, else right, and the
// bits that wrap around land where the receiver does not read. The mask
// and the rotation depend on the lane alone, so they are set once.
template <int kLaneBit, int kBit, uint32_t kMask>
__device__ __forceinline__ uint32_t exchange(uint32_t x, int h) {
  const bool up = (h >> kLaneBit) & 1;
  const uint32_t keep = up ? kMask : ~kMask;
  const uint32_t send = __funnelshift_l(x, x, up ? 1 << kBit : 32 - (1 << kBit));
  const uint32_t got = __shfl_xor_sync(0xffffffffu, send, 1 << kLaneBit);
  return (x & keep) | (got & ~keep);
}

struct Args {
  const float* x;
  const float* scale;
  const float* zero;
  uint32_t* out;
  int m, k, words, nbits;
  float qmax;
  int log_tc;      // a tile's chunks: tc = 1 << log_tc
  int rows;        // a tile's rows
  int col_tiles;   // tiles across a row
  long long tiles;
};

struct Tile {
  const float* base;  // x at the tile's first row and column
  int r0;             // first row
  int col0;           // first column: 128 times the first chunk
  int rows;           // rows in the tile (the last row tile may have fewer)
  int twv;            // output words a row in the tile
};

__device__ __forceinline__ Tile tile_at(const Args& a, long long t) {
  const long long rt = a.col_tiles == 1 ? t : t / a.col_tiles;
  const int ct = static_cast<int>(t - rt * a.col_tiles);
  const int c0 = ct << a.log_tc;
  Tile g;
  g.r0 = static_cast<int>(rt * a.rows);
  g.col0 = c0 * 32 * kWordsPerChunk;
  g.rows = min(a.rows, a.m - g.r0);
  g.twv = min(kWordsPerChunk << a.log_tc, a.words - c0 * kWordsPerChunk);
  g.base = a.x + static_cast<size_t>(g.r0) * a.k + g.col0;
  return g;
}

// Slot u of warp i is task i + kWarps * u of the tile: its row, and its
// lane's first column from the tile's first (chunk * 128 + 4 * lane).
// kOne: a tile is one chunk wide (K <= 128), so the row is the task and
// the column 4 * lane, the same in every slot.
template <bool kOne>
__device__ __forceinline__ int slot_row(const Args& a, int warp, int u) {
  return kOne ? warp + kWarps * u : (warp + kWarps * u) >> a.log_tc;
}

template <bool kOne>
__device__ __forceinline__ int slot_col(const Args& a, int warp, int lane,
                                        int u) {
  const int chunk = kOne ? 0 : (warp + kWarps * u) & ((1 << a.log_tc) - 1);
  return chunk * 32 * kWordsPerChunk + kColsPerLane * lane;
}

// The mask of a lane's 4 levels (a byte each) that lie inside K, from the
// number of its columns inside K: 0 or at least 4 where K % 4 == 0.
template <bool kVec>
__device__ __forceinline__ uint32_t col_mask(int valid) {
  if (kVec) return valid > 0 ? ~0u : 0u;
  return valid >= kColsPerLane ? ~0u : (1u << (8 * max(valid, 0))) - 1u;
}

// The lanes' columns of the warp's kUnroll tasks of tile g; a slot past
// the tile, and columns >= K, load nothing (their levels are masked).
template <bool kVec, bool kOne>
__device__ __forceinline__ void load_tile(const Args& a, const Tile& g,
                                          int warp, int lane,
                                          float4 (&v)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int rr = slot_row<kOne>(a, warp, u);
    const int col = slot_col<kOne>(a, warp, lane, u);
    const float* src = g.base + rr * a.k + col;
    const bool row = rr < g.rows;
    if (kVec) {
      if (row && g.col0 + col < a.k) {
        v[u] = __ldg(reinterpret_cast<const float4*>(src));
      }
    } else {
      if (row && g.col0 + col < a.k) v[u].x = __ldg(src);
      if (row && g.col0 + col + 1 < a.k) v[u].y = __ldg(src + 1);
      if (row && g.col0 + col + 2 < a.k) v[u].z = __ldg(src + 2);
      if (row && g.col0 + col + 3 < a.k) v[u].w = __ldg(src + 3);
    }
  }
}

// The quantizer's constants, read once a thread.
struct Quant {
  float zero, scale;
  float recip;  // RN(1 / scale)
  unsigned qmax;
};

// floor(RN((x - zero) / scale)) clipped to [0, qmax]. kFast: the quotient
// as the reciprocal's correction step (Markstein): q = RN(a * recip),
// r = a - scale * q (exact, one fma), RN(q + r * recip) is RN(a / scale)
// wherever nothing overflows or underflows, which holds for
// 2^-100 <= |scale| <= 2^100 and |q| < 2^24; beyond 2^24 (and for +-inf,
// where r is NaN) q itself lies past both clip ends. Otherwise __fdiv_rn.
template <bool kFast>
__device__ __forceinline__ unsigned level(float x, const Quant& z) {
  const float a = __fsub_rn(x, z.zero);
  float v;
  if (kFast) {
    const float q = __fmul_rn(a, z.recip);
    const float r = __fmaf_rn(-z.scale, q, a);
    v = fabsf(q) < 0x1p24f ? __fmaf_rn(r, z.recip, q) : q;
  } else {
    v = __fdiv_rn(a, z.scale);
  }
  // floor and convert in one step, saturating: below 0 and NaN give 0
  return min(__float2uint_rd(v), z.qmax);
}

// Delta swap: exchange the bits at the positions of `mask` with those
// `shift` above them.
__device__ __forceinline__ uint32_t delta_swap(uint32_t x, uint32_t mask,
                                               int shift) {
  const uint32_t t = ((x >> shift) ^ x) & mask;
  return x ^ t ^ (t << shift);
}

// A task's word of one plane: lane h of word group w of the chunk returns
// plane plane_of_lane(h)'s word w, from the lane's 4 columns, those
// outside K masked by `mask`.
template <bool kFast>
__device__ __forceinline__ uint32_t chunk_word(const float4& v, uint32_t mask,
                                               int h, const Quant& z) {
  // bit 8c + p: plane p of column c; columns >= K are level 0
  uint32_t x = __byte_perm(
      __byte_perm(level<kFast>(v.x, z), level<kFast>(v.y, z), 0x0040),
      __byte_perm(level<kFast>(v.z, z), level<kFast>(v.w, z), 0x0040), 0x5410);
  x &= mask;
  // bit index (c1, c0, p2, p1, p0), lane (h2, h1, h0) -> bit index
  // (c1, c0, h0, h2, h1), lane (p1, p0, p2)
  x = exchange<0, 2, 0xF0F0F0F0u>(x, h);
  x = exchange<2, 1, 0xCCCCCCCCu>(x, h);
  x = exchange<1, 0, 0xAAAAAAAAu>(x, h);
  // -> (h2, h1, h0, c1, c0), the bit 4h + c of the word: swap bit-index
  // bits 4 and 1, then 3 and 0
  x = delta_swap(x, 0x0000CCCCu, 14);
  x = delta_swap(x, 0x00AA00AAu, 7);
  return x;
}

// Packs and stores tile g (its loads in v) and every gridDim.x-th after it.
template <bool kVec, bool kFast, bool kOne>
__device__ __forceinline__ void run(const Args& a, const Quant& z,
                                    uint32_t* stage, Tile g,
                                    float4 (&v)[kUnroll]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = lane & (kLanesPerWord - 1);  // lane in its word group
  uint32_t* my_stage = stage + plane_of_lane(h) * kPlaneStride;
  const bool my_plane = plane_of_lane(h) < a.nbits;
  // a full tile's 16-byte stores: thread i writes vector e of plane p, one
  // a thread at most (nbits * rows * twv / 4 <= 8 * kTasks = kThreads)
  const unsigned full4 = static_cast<unsigned>(a.rows * a.words) / 4;
  const unsigned full_p = threadIdx.x / max(full4, 1u);
  const unsigned full_e = threadIdx.x - full_p * full4;

  for (long long t = blockIdx.x;;) {
    // every slot is packed, so the four run side by side; only a real
    // task's words are staged
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = slot_row<kOne>(a, warp, u);
      const int col = slot_col<kOne>(a, warp, lane, u);
      const uint32_t x =
          chunk_word<kFast>(v[u], col_mask<kVec>(a.k - g.col0 - col), h, z);
      const int word = col / 32;  // of the tile's row: chunk * 4 + w
      if (my_plane && rr < g.rows && word < g.twv) {
        my_stage[rr * g.twv + word] = x;
      }
    }
    __syncthreads();
    // plane p's staged words: g.rows rows of g.twv words, back to back
    const unsigned run = g.rows * g.twv;
    if (a.col_tiles == 1 && (a.words & 3) == 0) {
      // the rows are back to back in the output too: one 16-byte store a
      // thread
      const unsigned run4 = run >> 2;
      const unsigned p = run4 == full4 ? full_p : threadIdx.x / run4;
      const unsigned e = run4 == full4 ? full_e : threadIdx.x - p * run4;
      if (p < static_cast<unsigned>(a.nbits)) {
        reinterpret_cast<uint4*>(
            a.out + (static_cast<size_t>(p) * a.m + g.r0) * a.words)[e] =
            reinterpret_cast<const uint4*>(stage + p * kPlaneStride)[e];
      }
    } else if (a.col_tiles == 1) {
      for (unsigned f = threadIdx.x; f < a.nbits * run; f += kThreads) {
        const unsigned p = f / run, e = f - p * run;
        a.out[(static_cast<size_t>(p) * a.m + g.r0) * a.words + e] =
            stage[p * kPlaneStride + e];
      }
    } else {
      // a row's words span several tiles: one segment a (plane, row)
      const int w0 = g.col0 / 32;
      for (unsigned f = threadIdx.x; f < a.nbits * run; f += kThreads) {
        const unsigned p = f / run, e = f - p * run;
        const unsigned rr = e / g.twv, ww = e - rr * g.twv;
        a.out[(static_cast<size_t>(p) * a.m + g.r0 + rr) * a.words + w0 + ww] =
            stage[p * kPlaneStride + e];
      }
    }
    __syncthreads();
    t += gridDim.x;
    if (t >= a.tiles) break;
    g = tile_at(a, t);
    load_tile<kVec, kOne>(a, g, warp, lane, v);
  }
}

// kOne: rows one chunk wide (K <= 128, every graph of the paper's Table
// 1), an instance of its own so that its registers do not follow the
// general path's.
template <bool kVec, bool kOne>
__global__ void __launch_bounds__(kThreads) bitpack_kernel(Args a) {
  __shared__ __align__(16) uint32_t stage[kMaxPlanes * kPlaneStride];
  if (blockIdx.x >= a.tiles) return;
  // the first tile's loads go out with scale's and zero's
  const Tile g = tile_at(a, blockIdx.x);
  float4 v[kUnroll];
  load_tile<kVec, kOne>(a, g, threadIdx.x >> 5, threadIdx.x & 31, v);
  Quant z;
  z.zero = __ldg(a.zero);
  z.scale = __ldg(a.scale);
  z.recip = __frcp_rn(z.scale);
  z.qmax = static_cast<unsigned>(a.qmax);
  // one branch for the grid: the fast quotient wherever it is exact
  if (fabsf(z.scale) >= 0x1p-100f && fabsf(z.scale) <= 0x1p100f) {
    run<kVec, true, kOne>(a, z, stage, g, v);
  } else {
    run<kVec, false, kOne>(a, z, stage, g, v);
  }
}

int sm_count(int dev) {
  static int counts[64] = {};
  if (dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return counts[dev];
}

template <bool kVec, bool kOne>
int launch(const Args& a, cudaStream_t stream) {
  static int per_sm[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  if (dev >= 0 && dev < 64 && per_sm[dev] > 0) {
    blocks = per_sm[dev];
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, bitpack_kernel<kVec, kOne>, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 0 && dev < 64) per_sm[dev] = blocks;
  }
  const long long resident = static_cast<long long>(sm_count(dev)) * blocks;
  const dim3 grid(static_cast<unsigned>(a.tiles < resident ? a.tiles : resident));
  bitpack_kernel<kVec, kOne><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
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
  Args a;
  a.x = static_cast<const float*>(x);
  a.scale = static_cast<const float*>(scale);
  a.zero = static_cast<const float*>(zero);
  a.out = static_cast<uint32_t*>(out);
  a.m = m;
  a.k = k;
  a.words = words;
  a.nbits = nbits;
  a.qmax = qmax;
  // chunks that hold output words
  const int chunks = (words + kWordsPerChunk - 1) / kWordsPerChunk;
  // a tile: the row's chunks up to kTasks, then as many rows as fill
  // kTasks, no more than the rows that spread M over the SMs
  int dev = 0;
  cudaGetDevice(&dev);
  a.log_tc = 0;
  while ((1 << a.log_tc) < chunks && (1 << a.log_tc) < kTasks) ++a.log_tc;
  const int spread = (m + sm_count(dev) - 1) / sm_count(dev);
  a.rows = kTasks >> a.log_tc;
  if (spread < a.rows) a.rows = spread > 0 ? spread : 1;
  a.col_tiles = (chunks + (1 << a.log_tc) - 1) >> a.log_tc;
  a.tiles = static_cast<long long>((m + a.rows - 1) / a.rows) * a.col_tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (k % kColsPerLane) == 0 &&
                   (reinterpret_cast<uintptr_t>(x) % 16) == 0;
  if (a.log_tc == 0) return vec ? launch<true, true>(a, s) : launch<false, true>(a, s);
  return vec ? launch<true, false>(a, s) : launch<false, false>(a, s);
}
