// The int8 Hopper tile: a 64 x 64 int32-output GEMM tile computed by one
// warpgroup with wgmma.mma_async m64n64k32 .s32.s8.s8 (sm_90a), two
// warpgroups a block each on a tile and a ring of its own:
//   acc = Aq[p0 .. p0+63, k0:k1] x Bt[n0 .. n0+63, k0:k1]^T,
// Aq a row-major (P, Kp) int8 matrix of activation rows quantized per row
// (gemm_int8.cuh's arithmetic) earlier in the launch (or any rows of such
// a matrix: tile_rows), Bt the k-contiguous (N, Kp) int8 weights. Used by
// csrc/stage_int8.cu, csrc/transition_int8.cu and csrc/basic_stage_int8.cu
// (their GEMM phases, through wgmma_s8_phase.cuh); csrc/winograd_int8.cu
// and wgmma_s8_cluster.cuh (csrc/pointwise_int8.cu's cluster path,
// csrc/direct_int8.cu) issue s8 wgmma on operands they stage themselves
// (weights byte-permuted K-major, no TMA); the int8 pointwise's one pass
// stays on mma_int8.cuh's mma.sync warp tile.
//
// Operands. s8 wgmma reads both operands K-major from shared memory, with
// the 128-byte swizzle here: a row holds 128 k as 128 bytes, its 16-byte
// chunk j at chunk j ^ (row % 8), eight rows a 1024-byte atom.
// * B: TMA copies the (kBK x kBN) box at (k0, n0, block) of the weights'
//   (Kp, N, blocks) tensor map into a ring slot, with that swizzle, zero
//   past N and Kp, completing on the slot's mbarrier.
// * A: 16-byte cp.async.cg copies of Aq's rows into the slot, at the
//   swizzled chunk, zero past P and Kp (Aq was written in the launch:
//   cp.async.cg reads it through L2).
// * kStages slots a warpgroup, loads kAhead stages ahead of the one
//   multiplied; the warpgroup's threads meet at a named barrier of their
//   own (bar.sync 1 + g, 128), never the block's, so the two warpgroups
//   walk their items apart.
// * The int32 sums are exact, so wgmma accumulates a tile's whole K in its
//   registers (no per-stage promotion as the f32 tile needs) and any split
//   of K adds up to the same bits.
//
// The row maxima that set the quantization's scales: a producing epilogue
// folds max |y| over the values it stores of a row into one word by
// atomicMax on the bits of |y| as an unsigned int (publish_row_max): exact,
// independent of order, and a NaN's bits sort above every finite value and
// inf, so a row with a NaN gets a NaN scale, as torch.amax gives the plain
// version.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_int8.cuh"
#include "wgmma_tile.cuh"

namespace wt {
namespace wgs8 {

constexpr int kBM = 64;        // rows of a tile: one warpgroup's
constexpr int kBN = 64;
constexpr int kBK = 128;       // k of a stage: one swizzled 128-byte row
constexpr int kWarpgroups = 2;  // a block's, each on tiles of its own
constexpr int kWgThreads = 128;
constexpr int kThreads = kWarpgroups * kWgThreads;
constexpr int kStages = 4;     // ring slots a warpgroup
constexpr int kAhead = 3;      // stages of loads in flight ahead of the one multiplied
constexpr int kABytes = kBM * kBK;
constexpr int kBBytes = kBN * kBK;
constexpr int kSlotBytes = kABytes + kBBytes;
constexpr int kRingBytes = kStages * kSlotBytes;
// Dynamic shared memory: both warpgroups' rings, and room to align them to
// the swizzle's 1024-byte atom.
constexpr size_t kSmemBytes = 1024 + static_cast<size_t>(kWarpgroups) * kRingBytes;
static_assert(kSlotBytes % 1024 == 0 && kAhead < kStages, "the ring's layout");

using Acc = int[32];

// ---- PTX wrappers ----------------------------------------------------------

#define WT_WGMMA_S32                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d = A (descriptor, K-major) x B (descriptor, K-major), m64n64k32 s8,
// plus d when `add`.
__device__ __forceinline__ void wgmma_s8(Acc& d, uint64_t a, uint64_t b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " WT_WGMMA_S32 ", %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "l"(a), "l"(b), "r"(add));
}

#undef WT_WGMMA_S32

__device__ __forceinline__ void fence_acc(Acc& d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Orders this thread's generic-proxy accesses of global memory with later
// async-proxy ones (TMA reads of weights written earlier in the launch).
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// ---- row maxima -------------------------------------------------------------

// The bits of |v| as an unsigned int: ordered as |v| for every non-NaN v,
// a NaN above them all.
__device__ __forceinline__ unsigned abs_bits(float v) { return __float_as_uint(v) & 0x7fffffffu; }

// The row scale from a published maximum (its bits).
__device__ __forceinline__ float scale_of_bits(unsigned m) {
  return scale_from_max(__uint_as_float(m));
}

// ---- the ring -----------------------------------------------------------------

// This thread's warpgroup, and its thread index within it.
__device__ __forceinline__ int wg_index() { return threadIdx.x / kWgThreads; }
__device__ __forceinline__ int wg_thread() { return threadIdx.x % kWgThreads; }

// The warpgroup's named barrier (1 + its index; 0 is __syncthreads').
__device__ __forceinline__ void wg_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg_index()), "n"(kWgThreads) : "memory");
}

// A warpgroup's ring: kStages 1024-aligned slots (A, then B), their
// mbarriers, and for each slot the parity of its next completion (bit s),
// the same in every thread of the warpgroup.
struct Ring {
  char* base;
  uint64_t* bars;
  unsigned parity;
};

// Every thread calls it once, at the start: its warpgroup's ring. smem
// holds kSmemBytes, bars kWarpgroups * kStages mbarriers.
__device__ __forceinline__ Ring make_ring(void* smem, uint64_t* bars) {
  const unsigned pad = (1024 - (smem_addr(smem) & 1023)) & 1023;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kWarpgroups * kStages; ++s) wg::mbar_init(bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return Ring{static_cast<char*>(smem) + pad + wg_index() * kRingBytes, bars + wg_index() * kStages,
              0u};
}

// The weights of one product: the (Kp, N, blocks) tensor map of the
// k-contiguous int8 weights and this product's block.
struct Weights {
  const CUtensorMap* map;
  int blk;
};

// B's box of stage kb into slot s by TMA, by the warpgroup's thread 0.
__device__ __forceinline__ void load_b(const Ring& r, int s, const Weights& w, int n0, int kb) {
  if (wg_thread() == 0) {
    wg::mbar_expect_tx(r.bars + s, kBBytes);
    wg::tma_load(r.base + s * kSlotBytes + kABytes, w.map, r.bars + s, kb, n0,
                 w.blk);  // coordinates (k, n, blk)
  }
}

// A's rows: row p of a row-major (P, Kp) int8 matrix aq.
struct RowsA {
  const int8_t* aq;
  int Kp;
  __device__ __forceinline__ const int8_t* row(int p) const {
    return aq + static_cast<size_t>(p) * Kp;
  }
};

// Stage kb of the tile into slot s: A's rows p0 .. p0+63 (a.row(p), four
// 16-byte copies a thread; a.aq stands in for the source of a copy that
// zero-fills) and, with_b, B's box.
template <class ARows>
__device__ __forceinline__ void load_stage(const Ring& r, int s, const ARows& a, int P, int Kp,
                                           const Weights& w, int p0, int n0, int kb,
                                           bool with_b) {
  char* sa = r.base + s * kSlotBytes;
#pragma unroll
  for (int i = 0; i < kABytes / 16 / kWgThreads; ++i) {
    const int idx = wg_thread() + i * kWgThreads;
    const int row = idx / 8, j = idx % 8, k = kb + 16 * j;
    const bool ok = p0 + row < P && k < Kp;
    cp_async16(sa + row * kBK + ((j ^ (row & 7)) << 4), ok ? a.row(p0 + row) + k : a.aq, ok);
  }
  if (with_b) load_b(r, s, w, n0, kb);
}

// The B boxes of a tile's first kAhead stages, issued into the warpgroup's
// idle ring ahead of the tile (prefetched = true in tile()): the weights
// do not wait for the activation. Leaves each slot's A region to the
// caller's generic use until the tile starts.
__device__ __forceinline__ void prefetch_b(const Ring& r, const Weights& w, int n0, int k0,
                                           int k1) {
  wg::fence_proxy_async();
  wg_sync();  // the previous tile's readers of the ring are done
  const int steps = (k1 - k0 + kBK - 1) / kBK;
  for (int s = 0; s < kAhead && s < steps; ++s) load_b(r, s, w, n0, k0 + s * kBK);
}

// Issues one stage's products and waits for them: the slot's A by its B
// box, four k32 steps; `add`: keep d's sum.
__device__ __forceinline__ void mma_stage(const Ring& r, int s, Acc& acc, bool add) {
  const char* sa = r.base + s * kSlotBytes;
  const char* sb = sa + kABytes;
  wg::wgmma_fence();
#pragma unroll
  for (int j = 0; j < kBK / 32; ++j)
    wgmma_s8(acc, wg::desc128(sa + 32 * j, 16, 1024), wg::desc128(sb + 32 * j, 16, 1024),
             add || j > 0);
  wg::wgmma_commit();
  wg::wgmma_wait_all();
  fence_acc(acc);
}

// acc = A[p0.., k0:k1] x Bt[n0.., k0:k1]^T for the warpgroup's tile (A's
// rows a.row(p) of Kp int8 each, written before; `prefetched`: prefetch_b
// issued its first B boxes). kGroups: each stage is one quantization group
// of kBK channels (k0 = 0), whose int32 products fin(stage, acc) takes
// after the stage (acc restarts each stage); else acc sums the whole
// range. Every thread of the warpgroup calls it; it ends with every load
// consumed, a warpgroup barrier and the ring idle.
template <bool kGroups, class ARows, class Fin>
__device__ __forceinline__ void tile_rows(const ARows& a, int P, int Kp, const Weights& w, int p0,
                                          int n0, int k0, int k1, Ring& r, bool prefetched,
                                          Acc& acc, const Fin& fin) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0;
  const int steps = (k1 - k0 + kBK - 1) / kBK;
  wg::fence_proxy_async();
  wg_sync();  // earlier generic writes to the ring before this tile's copies
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < steps) load_stage(r, s, a, P, Kp, w, p0, n0, k0 + s * kBK, !prefetched);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    const int s = it % kStages;
    cp_async_wait<kAhead - 1>();
    wg::mbar_wait(r.bars + s, (r.parity >> s) & 1u);
    r.parity ^= 1u << s;
    wg::fence_proxy_async();
    wg_sync();  // stage it landed for all; slot (it - 1)'s products are done
    const int next = it + kAhead;
    if (next < steps) load_stage(r, next % kStages, a, P, Kp, w, p0, n0, k0 + next * kBK, true);
    cp_async_commit();
    mma_stage(r, s, acc, !kGroups && it > 0);
    if (kGroups) fin(it, acc);
  }
  cp_async_wait<0>();
  wg_sync();
}

// tile_rows on the rows of a row-major (P, Kp) int8 matrix aq.
template <bool kGroups, class Fin>
__device__ __forceinline__ void tile(const int8_t* aq, int P, int Kp, const Weights& w, int p0,
                                     int n0, int k0, int k1, Ring& r, bool prefetched, Acc& acc,
                                     const Fin& fin) {
  tile_rows<kGroups>(RowsA{aq, Kp}, P, Kp, w, p0, n0, k0, k1, r, prefetched, acc, fin);
}

// The B boxes of the first kAhead stages of tile_pair's walk (the first
// product's s1 stages, then the second's) into the warpgroup's idle ring.
__device__ __forceinline__ void prefetch_pair(const Ring& r, const Weights& w1, int K1,
                                              const Weights& w2, int K2, int n0) {
  wg::fence_proxy_async();
  wg_sync();  // the previous tile's readers of the ring are done
  const int s1 = (K1 + kBK - 1) / kBK, steps = s1 + (K2 + kBK - 1) / kBK;
  for (int s = 0; s < kAhead && s < steps; ++s)
    load_b(r, s, s < s1 ? w1 : w2, n0, s < s1 ? s * kBK : (s - s1) * kBK);
}

// Two products of one output tile in one walk of the ring: acc1 = A1[p0..,
// 0:K1] x Bt1[n0.., 0:K1]^T, then acc2 = A2[p0.., 0:K2] x Bt2[n0..,
// 0:K2]^T, the second's stages loaded while the first's are multiplied.
// wait2() runs once in the warpgroup before the first of A2's rows is
// loaded (its rows may be written by other blocks: ready()).
// prefetched: prefetch_pair issued the first B boxes. Ends as tile() does.
template <class A1, class A2, class Wait>
__device__ __forceinline__ void tile_pair(const A1& a1, int K1, const Weights& w1, const A2& a2,
                                          int K2, const Weights& w2, int P, int p0, int n0,
                                          Ring& r, bool prefetched, Acc& acc1, Acc& acc2,
                                          const Wait& wait2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc1[i] = acc2[i] = 0;
  const int s1 = (K1 + kBK - 1) / kBK, steps = s1 + (K2 + kBK - 1) / kBK;
  bool waited = false;
  const auto load = [&](int g, bool with_b) {
    if (g < s1) {
      load_stage(r, g % kStages, a1, P, K1, w1, p0, n0, g * kBK, with_b);
      return;
    }
    if (!waited) {
      wait2();
      waited = true;
    }
    load_stage(r, g % kStages, a2, P, K2, w2, p0, n0, (g - s1) * kBK, with_b);
  };
  wg::fence_proxy_async();
  wg_sync();  // earlier generic writes to the ring before this tile's copies
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < steps) load(s, !prefetched);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    const int s = it % kStages;
    cp_async_wait<kAhead - 1>();
    wg::mbar_wait(r.bars + s, (r.parity >> s) & 1u);
    r.parity ^= 1u << s;
    wg::fence_proxy_async();
    wg_sync();  // stage it landed for all; slot (it - 1)'s products are done
    if (it + kAhead < steps) load(it + kAhead, true);
    cp_async_commit();
    if (it < s1)
      mma_stage(r, s, acc1, it > 0);
    else
      mma_stage(r, s, acc2, it > s1);
  }
  cp_async_wait<0>();
  wg_sync();
}

// Calls f(row, col, acc index) for the thread's accumulators: row and col
// relative to the tile's corner, acc index 4j + 2h + e (the wgmma m64nNk
// D layout: rows r0 and r0 + 8, r0 = 16 warp + lane / 4).
template <class F>
__device__ __forceinline__ void for_each_acc(const F& f) {
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4, c0 = lane % 4 * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) f(r0 + 8 * h, c0 + 8 * j + e, 4 * j + 2 * h + e);
}

// The max of m over the four lanes that hold one accumulator row, then one
// atomicMax of it into mx[p] where p is a row of the map (m of 0 adds
// nothing and is skipped). Every lane of the warp calls it.
__device__ __forceinline__ void publish_row_max(unsigned m, unsigned* mx, int p, int P) {
  m = max(m, __shfl_xor_sync(0xffffffffu, m, 1));
  m = max(m, __shfl_xor_sync(0xffffffffu, m, 2));
  if (mx != nullptr && threadIdx.x % 4 == 0 && p < P && m != 0u) atomicMax(mx + p, m);
}

// ---- host side ---------------------------------------------------------------

// The tensor map of k-contiguous int8 weights bt (blocks, N, Kp): dims
// (Kp, N, blocks), boxes of (kBK, kBN, 1) with the 128-byte swizzle, zero
// past Kp and N. Needs Kp a multiple of 16 and bt 16-byte aligned.
inline cudaError_t encode_kmajor(CUtensorMap* map, const int8_t* bt, int blocks, int N, int Kp) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Kp), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(blocks)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Kp),
                                 static_cast<cuuint64_t>(N) * static_cast<cuuint64_t>(Kp)};
  const cuuint32_t box[3] = {kBK, kBN, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<int8_t*>(bt), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wgs8
}  // namespace wt
