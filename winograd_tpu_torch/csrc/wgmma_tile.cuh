// The Hopper tile: a 64 x 64 FP32-output GEMM tile computed by one
// 128-thread warpgroup with wgmma.mma_async (sm_90a), its weight tiles
// brought in by the Tensor Memory Accelerator (TMA) onto mbarriers:
// acc = A[p0.., k0:k1] x B[k0:k1, n0..], B (K, N) row-major in device memory
// (f32, or bf16 at the bf16w tier), A f32 from any of mma_tf32.cuh's A
// sources (RowMajorA, Im2colA<kStride>).
//
// Shared by csrc/pointwise.cu and csrc/direct.cu (one GEMM a launch, split
// K reduced inside a thread-block cluster, through wgmma_cluster.cuh),
// csrc/stage.cu, csrc/transition.cu and csrc/basic_stage.cu (their GEMM
// phases, through wgmma_phase.cuh) and csrc/winograd.cu (its per-position
// products, through wino_tf32.cuh). csrc/wgmma_s8.cuh, the int8 stage's s8
// tile, and the int8 cluster kernels reuse its mbarrier, TMA and
// descriptor wrappers. Every f32 and bf16w GEMM of the port runs on it.
//
// Arithmetic, the same as the mma.sync tiles' it replaced:
// * f32: 3xTF32. Every operand x is split as hi = tf32(x) (cvt.rna) and
//   lo = tf32(x - hi), and each k8 step accumulates a_lo*b_hi, a_hi*b_lo,
//   then a_hi*b_hi through wgmma m64n64k8 .tf32 (FP32-level error; the port's
//   1e-4 bar).
// * bf16w: each f32 activation is split as a_hi = bf16(a), a_lo = bf16(a -
//   a_hi), and each k16 step accumulates a_hi*b, then a_lo*b, through wgmma
//   m64n64k16 .bf16 (every product exact in f32).
// Each stage's products (32 of K) go to an accumulator of their own, which
// the CUDA cores then add to the tile's sum in FP32: wgmma's own sums over a
// long K drift (their error grew with the walk's length, past the 1e-4
// bar at a 2304-long walk on an H100), and this keeps the drift to one
// stage's. The sums run in another order than mma.sync's, so the bits
// differ from the mma.sync tiles'; the same inputs still give the same bits
// on every call.
//
// Operands. tf32 wgmma reads both operands K-major from shared memory or A
// from registers, and only 16-bit types transpose:
// * A (activations, already K-major) is staged f32 in shared memory by
//   mma_tf32.cuh's cp.async loader (rows padded to kLdA floats, so the
//   fragment loads hit 32 distinct banks), then split hi/lo into register
//   fragments (the m16n8k8 / m16n8k16 A layouts, warp w holding rows
//   16w..16w+15).
// * B arrives raw: TMA copies the (kBK x kBN) box of the weights' (N, K,
//   blocks) tensor map into the ring slot, zero past N and K. At f32 one
//   pass of the warpgroup splits it into b_hi and b_lo tiles, K-major with
//   the 128-byte swizzle (row n holds the stage's 32 k as 128 bytes; 16-byte
//   chunk j of row n sits at chunk j ^ (n % 8)), which the descriptors
//   read; the pass is needed for the split anyway, and no weight layout
//   changes anywhere. At bf16w TMA itself writes the box with the 128-byte
//   swizzle (row k holds 64 n as 128 bytes), and wgmma reads it as an
//   MN-major operand (the transpose bit), no pass at all.
// * Why TMA and not cp.async.bulk of rows: a bulk copy cannot swizzle (the
//   bf16 operand must be) and cannot zero-fill the ragged N and K edges;
//   the tensor map does both. The maps are encoded on the host for each
//   launch (encode_weights) and passed as __grid_constant__ parameters.
// * Shapes the maps cannot describe (N not a multiple of 4, of 8 for bf16,
//   or a pointer not 16-byte aligned: !kVec) take element loads into the
//   same slot layout (cp.async for f32, swizzled stores for bf16), zero past
//   N and k1.
//
// Pipeline: kStages slots, each B's box then A's rows. One thread issues
// each TMA (arrive.expect_tx on the slot's mbarrier); every thread issues
// its A copies (one cp.async group a stage) and waits on both before the
// stage's work; loads run kAhead stages ahead. A stage's products are
// issued together and committed, then waited for at once, or (kPipe, f32:
// pointwise.cu) only before the next stage's products are issued, so they
// run while the next stage's data is waited for and split into a second
// pair of split tiles: a warpgroup in a block, one or two blocks an SM at
// the served shapes, has no other warps to hide those latencies with. The
// stage kernel does without: its two blocks an SM would spill and lose
// occupancy with the second pair (measured slower on an H100). A caller may
// issue the first stages' weight loads of its next tile early (prefetch),
// e.g. before a grid barrier the weights do not depend on.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"
#include "mma_tf32.cuh"

namespace wt {
namespace wg {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 128;
constexpr int kStages = 4;     // the ring's slots
constexpr int kAhead = 3;      // stages of loads in flight ahead of the one multiplied
static_assert(kBM == tf32x3::kBM && kBK == tf32x3::kBK && kThreads == tf32x3::kThreads,
              "the A loader of mma_tf32.cuh stages this tile's A");

using Acc = float[32];

// Per weight type: A's row pitch in floats, the bytes of a slot's B box,
// and of one pair of f32 split tiles (b_hi, b_lo) past the ring.
template <class BT>
struct Geometry;
template <>
struct Geometry<float> {
  static constexpr int kLdA = tf32x3::kLdA;
  static constexpr int kBBytes = kBK * kBN * 4;
  static constexpr int kSplitBytes = 2 * kBN * 128;
};
template <>
struct Geometry<__nv_bfloat16> {
  static constexpr int kLdA = kBK + 8;  // float2 fragment loads on 32 banks
  static constexpr int kBBytes = kBK * kBN * 2;
  static constexpr int kSplitBytes = 0;
};

template <class BT>
constexpr int kStageBytes = Geometry<BT>::kBBytes + 4 * kBM * Geometry<BT>::kLdA;
static_assert(kStageBytes<float> % 1024 == 0 && kStageBytes<__nv_bfloat16> % 1024 == 0,
              "every slot's B box starts on the 128-byte swizzle's 1024-byte atom");

// Dynamic shared memory of the tile: the ring, the f32 split tiles (two
// pairs when kPipe), and room to align it to 1024 bytes.
template <class BT, bool kPipe = false>
constexpr size_t kSmemBytes = 1024 + static_cast<size_t>(kStages) * kStageBytes<BT> +
                              (kPipe ? 2 : 1) * Geometry<BT>::kSplitBytes;

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
}

// Orders this thread's generic-proxy shared-memory accesses before later
// async-proxy ones (TMA writes, wgmma reads) of the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The (kBN x kBK x 1) box at (n0, k0, blk) of a 3-D tensor map into dst,
// completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int n0, int k0, int blk) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(n0), "r"(k0), "r"(blk)
      : "memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units, 14 bits each).
__device__ __forceinline__ uint64_t desc128(const void* p, unsigned lbo, unsigned sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products' issue and wait.
__device__ __forceinline__ void fence_acc(Acc& d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WT_WGMMA_D                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WT_WGMMA_D_ARGS(d)                                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d = A (registers, m64 x k8 tf32) x B (descriptor, K-major, k8 x n64),
// plus d when `add` (else d's old value is dropped).
__device__ __forceinline__ void wgmma_tf32(Acc& d, const unsigned (&a)[4], uint64_t b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WT_WGMMA_D
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WT_WGMMA_D_ARGS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
}

// d = A (registers, m64 x k16 bf16) x B (descriptor, MN-major, k16 x n64),
// plus d when `add`.
__device__ __forceinline__ void wgmma_bf16(Acc& d, const unsigned (&a)[4], uint64_t b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WT_WGMMA_D
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WT_WGMMA_D_ARGS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
}

// acc += part, in FP32 on the CUDA cores (round to nearest), once the
// products that wrote part are waited for.
__device__ __forceinline__ void promote(Acc& acc, Acc& part) {
  fence_acc(part);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += part[i];
}

#undef WT_WGMMA_D
#undef WT_WGMMA_D_ARGS

// ---- the ring and the weights ---------------------------------------------

// A block's ring: its 1024-aligned slots, their mbarriers, and for each
// slot the parity of its next completion (bit s), the same in every
// thread.
struct Ring {
  char* base;
  uint64_t* bars;
  unsigned parity;
};

// The ring over dynamic shared memory `smem` (kSmemBytes) and kStages
// mbarriers `bars`; every thread calls it once, at the start.
__device__ __forceinline__ Ring make_ring(void* smem, uint64_t* bars) {
  const unsigned pad = (1024 - (smem_addr(smem) & 1023)) & 1023;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return Ring{static_cast<char*>(smem) + pad, bars, 0u};
}

// One product's weights: the tensor map of the (blocks, K, N) weights as
// (N, K, blocks) for the TMA loads (kVec), and this block's (K, N) matrix
// for the element loads (!kVec).
template <class BT>
struct Weights {
  const CUtensorMap* map;
  const BT* w;
  int N, K, blk;
};

// B[kb .. kb+31, n0 .. n0+63] into slot s.
template <bool kVec, class BT>
__device__ __forceinline__ void load_b(const Ring& r, int s, const Weights<BT>& b, int n0,
                                       int kb, int k1) {
  char* dst = r.base + s * kStageBytes<BT>;
  if (kVec) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(r.bars + s, Geometry<BT>::kBBytes);
      tma_load(dst, b.map, r.bars + s, n0, kb, b.blk);
    }
  } else if constexpr (std::is_same_v<BT, float>) {
    float* sb = reinterpret_cast<float*>(dst);
#pragma unroll 4
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int row = i / kBN, c = i % kBN;
      const bool ok = kb + row < k1 && n0 + c < b.N;
      cp_async4(sb + i, ok ? b.w + static_cast<size_t>(kb + row) * b.N + n0 + c : b.w, ok);
    }
  } else {
    // The TMA box's 128-byte swizzle: value c of row `row` at 16-byte chunk
    // (c / 8) ^ (row % 8).
    auto* sb = reinterpret_cast<unsigned short*>(dst);
    const auto* w = reinterpret_cast<const unsigned short*>(b.w);
#pragma unroll 4
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int row = i / kBN, c = i % kBN;
      const bool ok = kb + row < k1 && n0 + c < b.N;
      sb[row * kBN + (((c >> 3) ^ (row & 7)) << 3) + (c & 7)] =
          ok ? __ldg(w + static_cast<size_t>(kb + row) * b.N + n0 + c) : 0;
    }
  }
}

// The f32 pass: the slot's raw (kBK x kBN) B box into the K-major swizzled
// b_hi and b_lo tiles (split, the f32 tile's 16 KB past the ring). Thread
// unit u takes column n = u % 64 and k = 4 (u / 64) .. +3: column reads
// of one row hit 32 banks, and the eight 16-byte stores of a quarter-warp
// land in eight distinct chunks of their rows.
__device__ __forceinline__ void split_b(const float* raw, char* split) {
#pragma unroll
  for (int i = 0; i < kBK * kBN / 4 / kThreads; ++i) {
    const int u = threadIdx.x + i * kThreads;
    const int n = u % kBN, kq = u / kBN;
    uint4 hi, lo;
    tf32x3::split(raw[(4 * kq + 0) * kBN + n], hi.x, lo.x);
    tf32x3::split(raw[(4 * kq + 1) * kBN + n], hi.y, lo.y);
    tf32x3::split(raw[(4 * kq + 2) * kBN + n], hi.z, lo.z);
    tf32x3::split(raw[(4 * kq + 3) * kBN + n], hi.w, lo.w);
    const int off = n * 128 + ((kq ^ (n & 7)) << 4);
    *reinterpret_cast<uint4*>(split + off) = hi;
    *reinterpret_cast<uint4*>(split + kBN * 128 + off) = lo;
  }
}

// Issues and commits the products of one stage at f32 into part: A from
// the slot's rows, B from a pair of split tiles. The caller waits for them
// (finish) before it touches part or overwrites the split tiles.
__device__ __forceinline__ void mma_stage(const float* sa, const char* split, Acc& part) {
  constexpr int kLd = Geometry<float>::kLdA;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  unsigned ah[kBK / 8][4], al[kBK / 8][4];
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    const float* r0 = sa + (warp * 16 + g) * kLd + 8 * j + t;
    const float* r8 = r0 + 8 * kLd;
    tf32x3::split(r0[0], ah[j][0], al[j][0]);
    tf32x3::split(r8[0], ah[j][1], al[j][1]);
    tf32x3::split(r0[4], ah[j][2], al[j][2]);
    tf32x3::split(r8[4], ah[j][3], al[j][3]);
  }
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    // K-major, 128-byte swizzle: the 8-row groups of n 1024 bytes apart
    // (stride byte offset); k8 step j starts 32 bytes into each row.
    const uint64_t bh = desc128(split + 32 * j, 16, 1024);
    const uint64_t bl = desc128(split + kBN * 128 + 32 * j, 16, 1024);
    wgmma_tf32(part, al[j], bh, j > 0);
    wgmma_tf32(part, ah[j], bl, 1);
    wgmma_tf32(part, ah[j], bh, 1);
  }
  wgmma_commit();
}

// (hi, lo) bf16 pairs of two adjacent f32 values, the lower k in the lower
// 16 bits.
__device__ __forceinline__ void split2(float2 v, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v.x - __low2float(h), v.y - __high2float(h));
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// Issues and commits the products of one stage at bf16w into part: A split
// from the slot's rows, B the slot's swizzled box read MN-major. The caller
// waits for them (finish) before it touches part or refills the slot.
__device__ __forceinline__ void mma_stage(const float* sa, const unsigned short* sb, Acc& part) {
  constexpr int kLd = Geometry<__nv_bfloat16>::kLdA;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  unsigned ah[kBK / 16][4], al[kBK / 16][4];
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j) {
    const float* r0 = sa + (warp * 16 + g) * kLd + 16 * j + 2 * t;
    const float* r8 = r0 + 8 * kLd;
    split2(*reinterpret_cast<const float2*>(r0), ah[j][0], al[j][0]);
    split2(*reinterpret_cast<const float2*>(r8), ah[j][1], al[j][1]);
    split2(*reinterpret_cast<const float2*>(r0 + 8), ah[j][2], al[j][2]);
    split2(*reinterpret_cast<const float2*>(r8 + 8), ah[j][3], al[j][3]);
  }
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j) {
    // MN-major, 128-byte swizzle: the 8-row groups of k 1024 bytes apart
    // (stride byte offset); k16 step j starts 16 rows on. The leading
    // offset (between 64-wide groups of n) is unused at n64.
    const uint64_t b = desc128(sb + 16 * j * kBN, Geometry<__nv_bfloat16>::kBBytes, 1024);
    wgmma_bf16(part, ah[j], b, j > 0);
    wgmma_bf16(part, al[j], b, 1);
  }
  wgmma_commit();
}

// Waits for the stage's products in flight, if any, and adds them to acc.
__device__ __forceinline__ void finish(bool& pending, Acc& part, Acc& acc) {
  if (!pending) return;
  wgmma_wait_all();
  promote(acc, part);
  pending = false;
}

// The first weight loads of a tile (its first min(kAhead, steps) stages),
// issued ahead of it into an idle ring. Every thread calls it. Only the TMA
// route prefetches: !kVec issues nothing here.
template <bool kVec, class BT>
__device__ __forceinline__ void prefetch(const Ring& r, const Weights<BT>& b, int n0, int k0,
                                         int k1) {
  if (!kVec) return;
  fence_proxy_async();
  __syncthreads();
  const int steps = (k1 - k0 + kBK - 1) / kBK;
  for (int s = 0; s < kAhead && s < steps; ++s) load_b<true>(r, s, b, n0, k0 + s * kBK, k1);
}

// acc = A[p0.., k0:k1] x B[k0:k1, n0..] for the block's tile, over stages
// kBK deep (the last one shorter: A is zero past k1), A through the source
// `a` (kCg: written earlier in the launch), B through `b`; `prefetched`:
// prefetch() already issued this tile's first weight loads. kPipe (f32
// only; kSmemBytes<float, true>): a stage's products run while the next
// stage's data is waited for and split into the other pair of split tiles,
// and are waited for just before the next stage's products are issued;
// else each stage's products are waited for at once. Ends with every load
// consumed, every product added and a __syncthreads, so the ring is idle.
template <bool kVec, bool kCg, bool kPipe = false, class ASrc, class BT>
__device__ __forceinline__ void tile(const ASrc& a, const Weights<BT>& b, int p0, int n0, int k0,
                                     int k1, Ring& r, bool prefetched, Acc& acc) {
  using G = Geometry<BT>;
  constexpr bool kF32 = std::is_same_v<BT, float>;
  static_assert(kF32 || !kPipe, "the bf16 products read their slot: they are waited at once");
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const int steps = (k1 - k0 + kBK - 1) / kBK;
  const int pre = kVec && prefetched ? min(kAhead, steps) : 0;
  if (pre == 0) {  // earlier generic writes to the ring before this tile's TMA writes
    fence_proxy_async();
    __syncthreads();
  }
  const auto load = [&](int s, int kb, bool with_b) {
    tf32x3::load_a<kVec, kCg, ASrc, G::kLdA>(
        reinterpret_cast<float*>(r.base + s * kStageBytes<BT> + G::kBBytes), a, p0, kb, k1);
    if (with_b) load_b<kVec>(r, s, b, n0, kb, k1);
  };
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < steps) load(s, k0 + s * kBK, s >= pre);
    cp_async_commit();
  }
  char* split = r.base + kStages * kStageBytes<BT>;
  Acc part;  // a stage's products, before they join acc
  bool pending = false;
  for (int it = 0; it < steps; ++it) {
    const int s = it % kStages;
    cp_async_wait<kAhead - 1>();
    if (kVec) {
      mbar_wait(r.bars + s, (r.parity >> s) & 1u);
      r.parity ^= 1u << s;
    }
    fence_proxy_async();
    __syncthreads();  // stage `it` landed for all; slot (it - 1) is free: its B
                      // was split or its products waited for, its A is in registers
    const int next = it + kAhead;
    if (next < steps) load(next % kStages, k0 + next * kBK, true);
    cp_async_commit();
    char* st = r.base + s * kStageBytes<BT>;
    const float* sa = reinterpret_cast<const float*>(st + G::kBBytes);
    if constexpr (kF32) {
      // kPipe: this pair was last read by stage it - 2's products, waited
      // for before stage it - 1's were issued.
      char* pair = split + (kPipe ? (it & 1) * G::kSplitBytes : 0);
      split_b(reinterpret_cast<const float*>(st), pair);
      fence_proxy_async();
      __syncthreads();
      finish(pending, part, acc);
      mma_stage(sa, pair, part);
    } else {
      mma_stage(sa, reinterpret_cast<const unsigned short*>(st), part);
    }
    pending = true;
    if (!kPipe) finish(pending, part, acc);
  }
  finish(pending, part, acc);
  cp_async_wait<0>();
  __syncthreads();
}

// Calls f(row, col, value) for each of the thread's 32 accumulators, row
// and col relative to the tile's corner (the wgmma m64nNk f32 D layout).
template <class F>
__device__ __forceinline__ void for_each_acc(const Acc& acc, const F& f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4, c0 = lane % 4 * 2;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    f(r0, c0 + 8 * j, acc[4 * j]);
    f(r0, c0 + 8 * j + 1, acc[4 * j + 1]);
    f(r0 + 8, c0 + 8 * j, acc[4 * j + 2]);
    f(r0 + 8, c0 + 8 * j + 1, acc[4 * j + 3]);
  }
}

// ---- host side ---------------------------------------------------------------

// The tensor map of weights w (blocks, K, N) row-major for the TMA loads:
// dims (N, K, blocks), boxes of (kBN, kBK, 1); f32 unswizzled, bf16 with
// the 128-byte swizzle the bf16 products read. Needs N * sizeof(BT) a
// multiple of 16 and w 16-byte aligned (the kVec instantiations).
template <class BT>
inline cudaError_t encode_weights(CUtensorMap* map, const BT* w, int blocks, int K, int N) {
  constexpr bool kBf16 = std::is_same_v<BT, __nv_bfloat16>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(blocks)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(N) * sizeof(BT),
                                 static_cast<cuuint64_t>(K) * N * sizeof(BT)};
  const cuuint32_t box[3] = {kBN, kBK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
      const_cast<BT*>(w), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      kBf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wg
}  // namespace wt
