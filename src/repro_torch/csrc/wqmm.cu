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
// What bounds it: at decode (batch 1-8) the bytes of the packed weight and
// its scales (4 bits plus 1 bit of scale a weight at G = 32); at batch 128
// the tensor cores, three bf16 passes for float32 x (one for bf16 x).
//
// Design. The product runs transposed on the bf16 tensor cores
// (mma.sync m16n8k16, float32 accumulators): W^T is the A operand, with
// the output's N in the mma's 16 rows, and x^T the B operand, with x's
// rows in its 8 columns, so that decode at batch 1 wastes columns of B
// only. A block is 4 computing warps across N (256 output columns, 64 a
// warp: four m16 tiles) and one warp that only copies; a computing warp
// takes 8, 16 or 32 rows of x (one to four n8 tiles, picked by M), and
// each A fragment it dequantizes serves all of them.
// - The packed tile is staged k-major as it lies in device memory, 128
//   bytes a k row. A thread of lane (g, t) reads one 32-bit word from each
//   of rows 4t .. 4t+3 of a 16-row chunk, at bytes 4g .. 4g+3 of its
//   warp's 32: byte p of those words holds columns 2(4g + p) and +1, the
//   rows g and g+8 of m16 tile p, at four k. The mma's k order is the
//   chunk's own, permuted (its k 2t, 2t+1, 2t+8, 2t+9 are rows 4t .. 4t+3),
//   and x's B fragment takes the same permutation: row g of x at k 4t ..
//   4t+3, one 8-byte load. A row's 32-byte segments are swizzled by
//   (row / 4) % 4, so the four t of a warp hit four segments: no bank
//   conflict.
// - Dequantization is exact and free of int->float conversions: a prmt
//   gathers byte p of two words, a lop3 puts each nibble into the mantissa
//   of bf16 128.0 (0x4300), and one bf16x2 fma subtracts 136, two weights
//   a step. q - 8 in [-8, 7] is exact in bf16.
// - x in float32 is split, one stage ahead of its use, into three bf16
//   pieces, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid),
//   whose sum is x exactly (for |x| above 2^-110, where no piece is
//   subnormal); each piece is a B operand of the same mma, and the
//   products with q - 8 are exact. Two pieces would leave up to ~2^-17 |x|,
//   above the float32 bound K 2^-24 wherever K < 64. bf16 x takes one pass.
// - The scale comes after the group: the mma's accumulators sum
//   x (q - 8) over a group's k (the group's first mma starts them from
//   zero), then acc = fma(sum, scales[g, n], acc) in float32. That is the
//   reference's sum in another order, within the float32 bound (the
//   summation depth is about 3 G / 16 + K / G, not K). A group that is a
//   multiple of 16 is whole chunks (its own kernel instance); any other
//   group takes each 16-row chunk once per group it touches, with x's k
//   outside the group zeroed in the B fragment, and reads its scales from
//   device memory.
// - A ring of kStages stages of kStageK k rows (the packed tile, the
//   scales of the groups that end in the stage, x's rows). The copying
//   warp fills a stage with cp.async, 16-byte copies (byte or element
//   copies where a row is not a multiple of 16 bytes), once the computing
//   warps have released it (`empty` mbarrier), and the copies' completion
//   arrives on the stage's `full` mbarrier. So a computing warp never
//   issues a copy or waits at a block barrier for the copies; it waits
//   only for the data. Positions past M, N or the K slice are zeros, so a
//   padded group gives exactly 0.
// - Split of K inside a thread-block cluster: at decode, N / 256 blocks
//   are too few for the card's SMs (16 at N = 4096). The blocks of a
//   cluster of `split` (1..8, a power of two chosen from N, K and the SM
//   count, never from M) each take a slice of K, whole groups; their
//   float32 sums meet in distributed shared memory and are added in rank
//   order, each rank adding and storing its share of the tile. One
//   launch, no workspace, no atomics, the same result run to run.
// A row's result depends on (N, K, group, the card) alone: the order of
// its adds is the same whatever M is, and so is every mma that makes it.
//
// block_m, block_n and block_k name the reference's tiles: the wrapper pads
// K to block_k, and the kernel picks its own tiles from M. Never built with
// --use_fast_math. Built as bitserial.cu is, into the same shared library.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarpN = 64;                   // output columns a warp
constexpr int kWarpsN = 4;                   // warps across N in a block
constexpr int kBlockN = kWarpN * kWarpsN;    // output columns a block
constexpr int kRowBytes = kBlockN / 2;       // packed bytes a staged k row
constexpr int kChunk = 16;                   // k an mma
constexpr int kStageK = 64;                  // k rows a stage
constexpr int kStages = 4;                   // stages in the ring
constexpr int kScaleRows = kStageK / kChunk; // groups (G >= 16) ending in a stage
constexpr int kMaxSplit = 8;                 // blocks of a cluster
constexpr int kXPad = 16;                    // bf16 a staged x row is padded by
constexpr int kPieceRow = (kStageK + kXPad) * 2;  // bytes a bf16 x row: 160
constexpr int kSlotW = kStageK * kRowBytes;
constexpr int kSlotS = kScaleRows * kBlockN * 4;

// Shared memory of one block: the ring of stages (packed tile, scales, x's
// rows as they are in device memory), for float32 x two buffers of its
// three bf16 pieces (a stage's x is split one stage ahead of its use), and
// the ring's barriers. The split's final sums reuse the ring.
template <typename T, int MT>
struct Layout {
  static constexpr bool kF32 = std::is_same_v<T, float>;
  static constexpr int kConsumers = 32 * kWarpsN;  // the warps that compute
  static constexpr int kThreads = kConsumers + 32;  // and one that copies
  static constexpr int kRows = 8 * MT;  // rows of x a block
  static constexpr int kXRow = kF32 ? kStageK * 4 : kPieceRow;
  static constexpr int kSlot = kSlotW + kSlotS + kRows * kXRow;
  static constexpr int kPieces = 3 * kRows * kPieceRow;  // one buffer
  static constexpr int kReduce = 16 * MT * kConsumers * 4;
  static constexpr int kRing = kStages * kSlot > kReduce ? kStages * kSlot : kReduce;
  static constexpr int kBarriers = kRing + (kF32 ? 2 * kPieces : 0);
  static constexpr int kBytes = kBarriers + 2 * kStages * 8;
  // 16-byte copies a lane of the copying warp makes a stage
  static constexpr int kCopiesW = kStageK * (kRowBytes / 16) / 32;
  static constexpr int kCopiesS = kScaleRows * (kBlockN / 4) / 32;
  static constexpr int kXChunks = kStageK * sizeof(T) / 16;  // a row of x
  static constexpr int kCopiesX = kRows * kXChunks / 32;
  // blocks an SM keeps: three at decode (M <= 8), else two
  static constexpr int kMinBlocks = MT == 1 ? 3 : 2;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An asynchronous 16-byte copy into shared memory that writes zeros when
// `valid` is false (src-size 0 reads nothing).
__device__ __forceinline__ void copy16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// Two weights: nibbles at bits 0-3 and 16-19 of v -> bf16x2 of (q - 8).
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t v) {
  uint32_t biased, d;
  // (v & 0x000F000F) | 0x43004300: 128 + q in each half, one lop3
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"
      : "=r"(biased) : "r"(v), "n"(0x000F000F), "r"(0x43004300));
  // (128 + q) * 1 - 136, exact
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d) : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

// Dequantize the A fragments of a warp's four m16 tiles from the words of
// rows 4t .. 4t+3 (w[0..3]): tile p takes byte p of each word.
__device__ __forceinline__ void dequantize(const uint32_t (&w)[4],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const uint32_t sel = p | (p << 4) | ((4 + p) << 8) | ((4 + p) << 12);
    const uint32_t d01 = __byte_perm(w[0], w[1], sel);  // byte p, byte p, ...
    const uint32_t d23 = __byte_perm(w[2], w[3], sel);
    a[p][0] = nibbles_to_bf16x2(d01);       // row g (even column), k 4t, 4t+1
    a[p][1] = nibbles_to_bf16x2(d01 >> 4);  // row g+8 (odd column)
    a[p][2] = nibbles_to_bf16x2(d23);       // row g, k 4t+2, 4t+3
    a[p][3] = nibbles_to_bf16x2(d23 >> 4);
  }
}

// c += A B, or c = A B when kZero (the first product of a group).
template <bool kZero>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (kZero) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// x = hi + mid + lo, each piece bf16, for two floats at once.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float s0 = r0 - __low2float(m), s1 = r1 - __high2float(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(s0, s1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Arrive on `bar` once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// The computing warps' own barrier (id 1): the copying warp never waits on it.
template <int kCount>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kCount) : "memory");
}

// What a launch shares with every block.
template <typename T>
struct Args {
  const T* x;
  const uint8_t* wp;
  const float* scales;
  float* out;
  int m, n, k, group, split;
  int vec;  // 16-byte copies for: 1 the packed rows, 2 the scales, 4 x
};
constexpr int kVecW = 1, kVecS = 2, kVecX = 4;

// Which rows a stage's copies fill: k rows [r0, r1) of the K slice, and
// (G a multiple of 16) the scale rows of the groups g0 .. g1-1 that end in
// them, group g in slot row g % kScaleRows.
struct Stage {
  int r0, r1, g0, g1;
};

// The copying warp's copies of one stage into `slot`: the packed tile
// (kStageK rows, zeros past r1 or N), the scales of the groups that end in
// the stage, x's live rows (the rows past M were zeroed once). Element
// copies where a row is not a multiple of 16 bytes. Returns whether every
// copy was asynchronous.
template <typename T, int MT>
__device__ __forceinline__ bool load_stage(unsigned char* slot, const Args<T>& p,
                                           const Stage& st, int n0, int m0,
                                           int live, bool aligned, int lane) {
  using L = Layout<T, MT>;
  const int half_n = p.n / 2, col0 = n0 / 2;
  if (p.vec & kVecW) {
    // lane copies chunk lane % 8 of rows lane / 8 + 4 j
    const int c = lane & 7, col = col0 + 16 * c;
#pragma unroll
    for (int j = 0; j < L::kCopiesW; ++j) {
      const int r = (lane >> 3) + 4 * j;
      const bool ok = st.r0 + r < st.r1 && col < half_n;
      copy16(slot + r * kRowBytes + (((c >> 1) ^ ((r >> 2) & 3)) << 5) + ((c & 1) << 4),
             ok ? p.wp + static_cast<size_t>(st.r0 + r) * half_n + col : p.wp, ok);
    }
  } else {
    for (int i = lane; i < kStageK * kRowBytes; i += 32) {
      const int r = i / kRowBytes, b = i % kRowBytes, col = col0 + b;
      slot[r * kRowBytes + (((b >> 5) ^ ((r >> 2) & 3)) << 5) + (b & 31)] =
          st.r0 + r < st.r1 && col < half_n
              ? p.wp[static_cast<size_t>(st.r0 + r) * half_n + col] : 0;
    }
  }
  if (aligned) {
    float* ss = reinterpret_cast<float*>(slot + kSlotW);
    if (p.vec & kVecS) {
#pragma unroll
      for (int j = 0; j < L::kCopiesS; ++j) {
        const int i = lane + 32 * j;
        const int g = st.g0 + i / (kBlockN / 4), c = i % (kBlockN / 4), col = n0 + 4 * c;
        if (g < st.g1) {
          const bool ok = col < p.n;
          copy16(ss + (g % kScaleRows) * kBlockN + 4 * c,
                 ok ? p.scales + static_cast<size_t>(g) * p.n + col : p.scales, ok);
        }
      }
    } else {
      for (int i = lane; i < (st.g1 - st.g0) * kBlockN; i += 32) {
        const int g = st.g0 + i / kBlockN, c = i % kBlockN, col = n0 + c;
        ss[(g % kScaleRows) * kBlockN + c] =
            col < p.n ? p.scales[static_cast<size_t>(g) * p.n + col] : 0.f;
      }
    }
  }
  unsigned char* xs = slot + kSlotW + kSlotS;
  if (p.vec & kVecX) {
    constexpr int kPer = 16 / sizeof(T);  // elements a 16-byte copy
#pragma unroll
    for (int j = 0; j < L::kCopiesX; ++j) {
      const int i = lane + 32 * j;
      const int r = i / L::kXChunks, c = i % L::kXChunks;
      if (r < live) {
        const bool ok = st.r0 + c * kPer < st.r1;
        copy16(xs + r * L::kXRow + c * 16,
               ok ? p.x + static_cast<size_t>(m0 + r) * p.k + st.r0 + c * kPer : p.x, ok);
      }
    }
  } else {
    for (int i = lane; i < live * kStageK; i += 32) {
      const int r = i / kStageK, c = i % kStageK;
      reinterpret_cast<T*>(xs + r * L::kXRow)[c] =
          st.r0 + c < st.r1 ? p.x[static_cast<size_t>(m0 + r) * p.k + st.r0 + c] : T(0.f);
    }
  }
  return p.vec == (kVecW | kVecS | kVecX);
}

// The copying warp: stage j into slot j % kStages once the computing
// warps have released it, then arrive on its `full` barrier when the
// copies have landed.
template <typename T, int MT>
__device__ __forceinline__ void produce(unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, const Args<T>& p,
                                        int kb, int ke, int stages, int n0,
                                        int m0, int live, bool aligned, int lane) {
  using L = Layout<T, MT>;
  Stage st{kb, min(kb + kStageK, ke), 0, 0};
  int g_rem = 0;  // st.r0 % group
  if (aligned) {
    st.g0 = kb / p.group;
    st.g1 = min(st.g0 + (st.r1 - st.r0) / p.group, ke / p.group);
  }
#pragma unroll 1
  for (int j = 0; j < stages; ++j) {
    const int s = j % kStages;
    if (j >= kStages) mbar_wait(empty + s, (j / kStages - 1) & 1);
    if (load_stage<T, MT>(smem + s * L::kSlot, p, st, n0, m0, live, aligned, lane)) {
      mbar_arrive_copies(full + s);
    } else {  // element copies: plain stores, released by the arrive
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      mbar_arrive(full + s);
    }
    st.r0 = st.r1;
    st.r1 = min(st.r0 + kStageK, ke);
    if (aligned) {
      st.g0 = st.g1;
      g_rem = (g_rem + kStageK) % p.group;
      st.g1 = min(st.g0 + (g_rem + st.r1 - st.r0) / p.group, ke / p.group);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x's live rows of a stage (float32) -> its three bf16 pieces, by the
// computing warps.
template <int MT>
__device__ __forceinline__ void split_stage(const unsigned char* slot,
                                            unsigned char* pieces, int live) {
  using L = Layout<float, MT>;
  const float* xr = reinterpret_cast<const float*>(slot + kSlotW + kSlotS);
  for (int i = threadIdx.x; i < live * (kStageK / 4); i += L::kConsumers) {
    const int r = i / (kStageK / 4), c = i % (kStageK / 4);
    const float4 v = *reinterpret_cast<const float4*>(xr + r * kStageK + 4 * c);
    uint2 h, md, lo;
    split3(v.x, v.y, h.x, md.x, lo.x);
    split3(v.z, v.w, h.y, md.y, lo.y);
    unsigned char* d = pieces + r * kPieceRow + c * 8;
    *reinterpret_cast<uint2*>(d) = h;
    *reinterpret_cast<uint2*>(d + L::kRows * kPieceRow) = md;
    *reinterpret_cast<uint2*>(d + 2 * L::kRows * kPieceRow) = lo;
  }
}

template <typename T, int MT, bool kAligned>
__global__ void __launch_bounds__(Layout<T, MT>::kThreads, Layout<T, MT>::kMinBlocks)
wq_gemm_kernel(const Args<T> p) {
  using L = Layout<T, MT>;
  constexpr int kPiecesN = L::kF32 ? 3 : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* pieces = smem + L::kRing;  // two buffers (float32 x)
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarriers);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBlockN, m0 = blockIdx.y * L::kRows;

  // the block's K slice [kb, ke): whole groups (G a multiple of 16) or
  // whole 16-row chunks, split as evenly as the units allow
  constexpr bool aligned = kAligned;
  const int unit = aligned ? p.group : kChunk;
  const int units = (p.k + unit - 1) / unit;
  const int rank = blockIdx.z;
  const int kb = rank * units / p.split * unit;
  const int ke = min((rank + 1) * units / p.split * unit, p.k);
  const int stages = (ke - kb + kStageK - 1) / kStageK;

  // x's rows past M stay zero in every stage and in the pieces
  const int live = min(L::kRows, p.m - m0);
  for (int i = tid; i < (L::kRows - live) * L::kXRow / 4; i += L::kThreads) {
    const int r = live + i / (L::kXRow / 4), c = i % (L::kXRow / 4);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      reinterpret_cast<uint32_t*>(smem + s * L::kSlot + kSlotW + kSlotS +
                                  r * L::kXRow)[c] = 0u;
    }
  }
  if constexpr (L::kF32) {
    const int per = (L::kRows - live) * kPieceRow / 4;  // words a piece
    for (int i = tid; i < 6 * per; i += L::kThreads) {
      reinterpret_cast<uint32_t*>(pieces + ((i / per) * L::kRows + live) *
                                               kPieceRow)[i % per] = 0u;
    }
  }
  if (tid < kStages) {
    mbar_init(full + tid, 32);             // the copying warp's lanes
    mbar_init(empty + tid, L::kConsumers);  // every computing thread
  }
  __syncthreads();

  float acc[4][MT][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[q][mt][j] = 0.f;

  if (warp == kWarpsN) {
    produce<T, MT>(smem, full, empty, p, kb, ke, stages, n0, m0, live, aligned, lane);
  } else {
    const int warp_n = warp;
    float sum[4][MT][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) sum[q][mt][j] = 0.f;

    // acc += sum * scale over this thread's 8 columns (sa, sb)
    auto flush = [&](const float4 sa, const float4 sb) {
      const float s8[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[q][mt][0] = fmaf(sum[q][mt][0], s8[2 * q], acc[q][mt][0]);
          acc[q][mt][1] = fmaf(sum[q][mt][1], s8[2 * q], acc[q][mt][1]);
          acc[q][mt][2] = fmaf(sum[q][mt][2], s8[2 * q + 1], acc[q][mt][2]);
          acc[q][mt][3] = fmaf(sum[q][mt][3], s8[2 * q + 1], acc[q][mt][3]);
        }
    };
    // the chunk's products over the row tiles and x's pieces (a tile past M
    // multiplies zeros), x's k outside [lo, hi) zeroed where `masked`;
    // `zero` starts the sums
    auto products = [&](auto zero, const unsigned char* xb, int c, bool masked,
                        int k0, int lo, int hi, const uint32_t (&a)[4][4]) {
      uint32_t keep0 = ~0u, keep1 = ~0u;
      if (masked) {
        const int kk = k0 + 4 * t;
        keep0 = (kk >= lo && kk < hi ? 0x0000FFFFu : 0u) |
                (kk + 1 >= lo && kk + 1 < hi ? 0xFFFF0000u : 0u);
        keep1 = (kk + 2 >= lo && kk + 2 < hi ? 0x0000FFFFu : 0u) |
                (kk + 3 >= lo && kk + 3 < hi ? 0xFFFF0000u : 0u);
      }
      // piece by piece over every row tile, so that an accumulator's next
      // product is 4 MT mmas behind its last
#pragma unroll
      for (int piece = 0; piece < kPiecesN; ++piece) {
        uint2 b[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          b[mt] = *reinterpret_cast<const uint2*>(
              xb + piece * L::kRows * kPieceRow + (mt * 8 + g) * kPieceRow +
              (c * kChunk + 4 * t) * 2);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (decltype(zero)::value && piece == 0) {
              mma<true>(sum[q][mt], a[q], b[mt].x & keep0, b[mt].y & keep1);
            } else {
              mma<false>(sum[q][mt], a[q], b[mt].x & keep0, b[mt].y & keep1);
            }
          }
        }
      }
    };

    if constexpr (L::kF32) {  // stage 0's pieces before the loop
      if (stages > 0) {
        mbar_wait(full, 0);
        split_stage<MT>(smem, pieces, live);
      }
    }
    // the open group: its index, where it ends, whether its sums start fresh
    int gi = aligned ? kb / p.group : 0;
    int gend = aligned ? kb + p.group : 0;
    bool fresh = true;
#pragma unroll 1
    for (int s = 0; s < stages; ++s) {
      const int slot_i = s % kStages;
      if constexpr (L::kF32) {
        // stage s+1 landed (stage s did before); every computing thread is
        // done with stage s-1's pieces and has split stage s's
        if (s + 1 < stages) mbar_wait(full + (s + 1) % kStages, ((s + 1) / kStages) & 1);
        consumers_sync<L::kConsumers>();
        if (s + 1 < stages) {
          split_stage<MT>(smem + ((s + 1) % kStages) * L::kSlot,
                          pieces + ((s + 1) & 1) * L::kPieces, live);
        }
      } else {
        mbar_wait(full + slot_i, (s / kStages) & 1);
      }
      const unsigned char* slot = smem + slot_i * L::kSlot;
      const unsigned char* xb =
          L::kF32 ? pieces + (s & 1) * L::kPieces : slot + kSlotW + kSlotS;
      const unsigned char* wbase =
          slot + 4 * t * kRowBytes + ((warp_n ^ t) << 5) + 4 * g;
      const float* ss =
          reinterpret_cast<const float*>(slot + kSlotW) + warp_n * kWarpN + 8 * g;
      const int r0 = kb + s * kStageK, r1 = min(r0 + kStageK, ke);
      const int chunks = (r1 - r0 + kChunk - 1) / kChunk;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = *reinterpret_cast<const uint32_t*>(wbase + i * kRowBytes);
      }
#pragma unroll 2
      for (int c = 0; c < chunks; ++c) {
        uint32_t a[4][4];
        dequantize(w, a);
        if (c + 1 < chunks) {  // the next chunk's words, ahead of the mmas
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            w[i] = *reinterpret_cast<const uint32_t*>(
                wbase + ((c + 1) * kChunk + i) * kRowBytes);
          }
        }
        const int k0 = r0 + c * kChunk;
        if constexpr (kAligned) {  // the chunk lies in one group
          if (fresh) {
            products(std::true_type{}, xb, c, false, k0, 0, 0, a);
          } else {
            products(std::false_type{}, xb, c, false, k0, 0, 0, a);
          }
          fresh = k0 + kChunk == gend;
          if (fresh) {
            const float4* s4 = reinterpret_cast<const float4*>(
                ss + (gi % kScaleRows) * kBlockN);
            flush(s4[0], s4[1]);
            ++gi;
            gend += p.group;
          }
        } else {  // the chunk once per group it touches, x zeroed outside it
          const int end = min(k0 + kChunk, ke);
          for (int lo = k0; lo < end;) {
            const int gl = lo / p.group;
            const int ge = min((gl + 1) * p.group, ke);
            const int hi = min(ge, end);
            if (fresh) {
              products(std::true_type{}, xb, c, true, k0, lo, hi, a);
            } else {
              products(std::false_type{}, xb, c, true, k0, lo, hi, a);
            }
            fresh = hi == ge;
            if (fresh) {
              float s8[8];
              const int col = n0 + warp_n * kWarpN + 8 * g;
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                s8[j] = col + j < p.n
                            ? __ldg(p.scales + static_cast<size_t>(gl) * p.n + col + j)
                            : 0.f;
              }
              flush(make_float4(s8[0], s8[1], s8[2], s8[3]),
                    make_float4(s8[4], s8[5], s8[6], s8[7]));
            }
            lo = hi;
          }
        }
      }
      mbar_arrive(empty + slot_i);  // this thread is done with the slot
    }
  }

  // value j of tile (q, mt): row 2t + (j & 1) of the row tile, column
  // 2(4g + q) + (j >> 1) of the warp's 64
  const bool computes = warp < kWarpsN;
  const int row_base = m0 + 2 * t;
  const int col_base = n0 + warp * kWarpN + 8 * g;
  if (p.split == 1) {
    if (!computes) return;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_base + mt * 8 + r;
        if (row >= p.m) continue;
        float* o = p.out + static_cast<size_t>(row) * p.n;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = col_base + 2 * q;
          if (col < p.n) {
            *reinterpret_cast<float2*>(o + col) =
                make_float2(acc[q][mt][r], acc[q][mt][2 + r]);
          }
        }
      }
    return;
  }

  // the cluster's sums: each block's into its own shared memory, then rank
  // r adds its share of the values over ranks 0 .. split-1 in order
  constexpr int kValues = 16 * MT;
  __syncthreads();  // the ring is free: every copy landed, every stage used
  float* red = reinterpret_cast<float*>(smem);
  if (computes) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          red[((q * MT + mt) * 4 + j) * L::kConsumers + tid] = acc[q][mt][j];
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (computes) {
    for (int v = rank * kValues / p.split; v < (rank + 1) * kValues / p.split; ++v) {
      float* mine = red + v * L::kConsumers + tid;
      float total = *cluster.map_shared_rank(mine, 0);
      for (int j = 1; j < p.split; ++j) total += *cluster.map_shared_rank(mine, j);
      const int j = v & 3, mt = (v >> 2) % MT, q = (v >> 2) / MT;
      const int row = row_base + mt * 8 + (j & 1), col = col_base + 2 * q + (j >> 1);
      if (row < p.m && col < p.n) p.out[static_cast<size_t>(row) * p.n + col] = total;
    }
  }
  cluster.sync();  // no block leaves while a peer still reads its sums
}

// The cluster size: the fewest blocks (a power of two, at most kMaxSplit)
// that give the card's SMs a block each, while every block keeps at least
// one stage of K and the units allow it. From N, K and the SM count alone.
int choose_split(int n, int k, int group, int sms) {
  const int tiles = (n + kBlockN - 1) / kBlockN;
  const int unit = group % kChunk == 0 ? group : kChunk;
  const int units = (k + unit - 1) / unit;
  int split = 1;
  while (split < kMaxSplit && tiles * split < sms && 2 * split <= units &&
         k / (2 * split) >= kStageK) {
    split *= 2;
  }
  return split;
}

int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return counts[dev];
}

template <typename T, int MT, bool kAligned>
int launch_tiles(const Args<T>& p, cudaStream_t stream) {
  using L = Layout<T, MT>;
  auto kernel = wq_gemm_kernel<T, MT, kAligned>;
  const int bytes = L::kBytes;
  // allowed once a device, at its first launch (outside any graph capture)
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !allowed[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) allowed[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((p.n + kBlockN - 1) / kBlockN),
                     static_cast<unsigned>((p.m + L::kRows - 1) / L::kRows),
                     static_cast<unsigned>(p.split));
  cfg.blockDim = dim3(L::kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = static_cast<unsigned>(p.split);
  cfg.attrs = attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* wp, const void* scales, void* out, int m,
           int n, int k, int group, cudaStream_t stream) {
  Args<T> p{static_cast<const T*>(x), static_cast<const uint8_t*>(wp),
            static_cast<const float*>(scales), static_cast<float*>(out),
            m, n, k, group, choose_split(n, k, group, sm_count()), 0};
  auto aligned16 = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  if ((n / 2) % 16 == 0 && aligned16(wp)) p.vec |= kVecW;
  if (n % 4 == 0 && aligned16(scales)) p.vec |= kVecS;
  if ((static_cast<size_t>(k) * sizeof(T)) % 16 == 0 && aligned16(x)) p.vec |= kVecX;
  // a group of whole 16-row chunks, or any other
  if (group % kChunk == 0) {
    if (m <= 8) return launch_tiles<T, 1, true>(p, stream);
    if (m <= 16) return launch_tiles<T, 2, true>(p, stream);
    return launch_tiles<T, 4, true>(p, stream);
  }
  if (m <= 8) return launch_tiles<T, 1, false>(p, stream);
  if (m <= 16) return launch_tiles<T, 2, false>(p, stream);
  return launch_tiles<T, 4, false>(p, stream);
}

}  // namespace

// Launches on `stream` and returns the launch's CUDA error (0 on success).
// The caller has checked: x is (m, k) float32 (x_bf16 = 0) or bfloat16
// (x_bf16 = 1), wp (k, n/2) uint8, scales (k/group, n) float32, out (m, n)
// float32, all contiguous on the device; n is even and k a multiple of
// group. block_m, block_n and block_k are the reference's tiles, checked
// by the wrapper; the kernel's own tiles follow m.
extern "C" int wq_gemm_launch(const void* x, const void* wp, const void* scales,
                              void* out, int m, int n, int k, int group,
                              int block_m, int block_n, int block_k, int x_bf16,
                              void* stream) {
  (void)block_m;
  (void)block_n;
  (void)block_k;
  const auto s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(x, wp, scales, out, m, n, k, group, s)
                : launch<float>(x, wp, scales, out, m, n, k, group, s);
}
