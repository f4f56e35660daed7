// The heads' GEMVs (P <= 8 rows: the FC at N = 1 or 8 images) as one
// launch, the K splits of a column tile the blocks of one thread-block
// cluster: what csrc/pointwise.cu (f32, bf16w) and csrc/pointwise_int8.cu
// (int8) share of them.
//
// Bound on the H100: the weights' bytes (8.2 MB at f32 for 2048 -> 1000,
// 2.45 us at 3.35 TB/s; 2 MB at int8). Streaming them needs many bytes in
// flight on every SM, which one block's loads through registers do not
// give. So a block owns a column tile of kCols columns and a range of K,
// and one warp's lanes ask for its whole weight slab at the start: one 1D
// bulk copy (cp.async.bulk, no tensor map: the rows are read unswizzled)
// a row segment, onto the mbarrier of its stage, kStages stages of about
// kStageBytes, all in flight at once (64 KB a block at the R-50 head).
// A bulk copy moves whole 16-byte units from 16-byte-aligned addresses, so
// a row's segment is widened to the 16-byte units that hold it and lands
// at that offset in a row of kPitch bytes (the widened units stay inside
// the weights when their bytes K N e are a multiple of 16 and the weights
// 16-byte aligned; an int8 row of N = 1000 starts 8 bytes into a unit on
// every other row). Shapes outside that (kVec false) read the weights by
// element loads instead, through the same walk.
//
// The K splits of a column tile are the blocks of one cluster (dims (1, S,
// 1), S a power of two, at most kClusterMax = 16: every GEMV kernel has the
// non-portable opt-in, which lets a launch pass 8 blocks and changes
// nothing for one of 8 or fewer): each block pushes its partial sums (P x kCols)
// through distributed shared memory to the blocks that own them, a share
// each, and after one cluster barrier block r adds its share's partials in
// rank order 0, 1, ..., S-1 and applies the epilogue once. No workspace,
// no counter, no memset, no atomics, and the fixed order gives the same
// bits on every call.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cluster.cuh"
#include "wgmma_tile.cuh"

namespace wt {
namespace gemv {

constexpr int kMaxP = 8;            // rows the GEMVs' registers and shared arrays hold
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;          // slots of the ring, each with its mbarrier
constexpr int kStageBytes = 16384;  // weight bytes of a full stage
constexpr int kClusterMax = 16;
constexpr int kStep = 32;           // every split but the last is a multiple of this

// `bytes` from global src into this block's shared dst, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A block's weight slab: rows k0 .. k1-1 of columns n0 .. n0+kCols-1 of
// a row-major (K, N) matrix of kElem-byte elements, in stages of kRows
// rows through the ring's slots. A stage's copies are asked for by
// kIssuers threads, a row each, every kSpread-th thread of the block, the
// stages in flight by different threads where the block has enough: a
// warp's copies are issued one after another, so one warp asking for a
// stage's rows, or for a whole slab's, holds them back (the f32 head at
// K = 512 took 10% longer with a stage's 32 rows asked for by one warp
// than by two).
template <int kCols, int kElem>
struct Slab {
  static constexpr int kRowBytes = kCols * kElem;
  static constexpr int kPitch = kRowBytes + 32;  // room to widen both ends to 16 bytes
  static constexpr int kRows = kStageBytes / kRowBytes;
  static constexpr int kSlotBytes = kRows * kPitch;
  static constexpr size_t kSmemBytes = static_cast<size_t>(kStages) * kSlotBytes;
  static constexpr int kIssuers = kRows < kThreads ? kRows : kThreads;
  static constexpr int kSpread =
      kThreads / (kStages * kIssuers) > 1 ? kThreads / (kStages * kIssuers) : 1;
  static constexpr int kIssueGroups = kThreads / (kSpread * kIssuers);
  static_assert(kThreads % (kSpread * kIssuers) == 0 && kIssueGroups <= kStages,
                "the issuing groups tile the block");

  const unsigned char* w;
  unsigned char* ring;
  uint64_t* bars;
  int N, n0, k0, k1;

  __device__ __forceinline__ int stages() const { return (k1 - k0 + kRows - 1) / kRows; }

  // The byte of w where row k's segment starts.
  __device__ __forceinline__ size_t start(int k) const {
    return (static_cast<size_t>(k) * N + n0) * kElem;
  }

  // Row r of stage s (row k = k0 + s kRows + r) in its slot.
  __device__ __forceinline__ const unsigned char* row(int s, int r) const {
    const int k = k0 + s * kRows + r;
    return ring + (s % kStages) * kSlotBytes + r * kPitch + (start(k) & 15);
  }

  // True for the threads that ask for stage s.
  __device__ __forceinline__ bool issues(int s) const {
    const int t = threadIdx.x;
    return t % kSpread == 0 && t / kSpread / kIssuers == s % kIssueGroups;
  }

  // Every thread, once: the mbarriers (an arrival an issuing thread), then
  // the first kStages stages asked for.
  __device__ __forceinline__ void begin() const {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int s = 0; s < kStages; ++s) wg::mbar_init(bars + s, kIssuers);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    for (int s = 0; s < kStages && s < stages(); ++s)
      if (issues(s)) issue(s);
  }

  // An issuing thread: its rows i, i + kIssuers, ... of stage s into their
  // slot, arriving with the bytes it asks for.
  __device__ __forceinline__ void issue(int s) const {
    const int i = threadIdx.x / kSpread % kIssuers;
    const int ncols = min(kCols, N - n0);
    const int r0 = k0 + s * kRows, rows = min(kRows, k1 - r0);
    uint64_t* bar = bars + s % kStages;
    unsigned bytes = 0;
    for (int r = i; r < rows; r += kIssuers) {
      const size_t a = start(r0 + r);
      bytes += static_cast<unsigned>(((a + ncols * kElem + 15) & ~size_t{15}) - (a & ~size_t{15}));
    }
    wg::mbar_expect_tx(bar, bytes);
    unsigned char* slot = ring + (s % kStages) * kSlotBytes;
    for (int r = i; r < rows; r += kIssuers) {
      const size_t a = start(r0 + r), lo = a & ~size_t{15};
      const size_t hi = (a + ncols * kElem + 15) & ~size_t{15};
      bulk_load(slot + r * kPitch, w + lo, static_cast<unsigned>(hi - lo), bar);
    }
  }

  // Waits for stage s's bytes.
  __device__ __forceinline__ void wait(int s) const {
    wg::mbar_wait(bars + s % kStages, (s / kStages) & 1);
  }

  // After every thread has read stage s (behind a __syncthreads): its slot
  // takes stage s + kStages.
  __device__ __forceinline__ void refill(int s) const {
    if (issues(s + kStages)) {
      wg::fence_proxy_async();  // the slot's reads before the copies' writes
      issue(s + kStages);
    }
  }
};

// The walk of a block's K range k0 .. k1, after slab.begin() where kVec:
// stage(kc, len) stages x's rows kc .. kc+len-1 (kXChunk of them at a time,
// a multiple of the slab's stage rows), consume(s, r0, rows) multiplies
// stage s's rows r0 .. r0+rows-1 (kVec: in the slab's slot; else read from
// the weights by the caller).
template <bool kVec, int kXChunk, class S, class StageX, class Consume>
__device__ __forceinline__ void walk(const S& slab, StageX&& stage, Consume&& consume) {
  static_assert(kXChunk % S::kRows == 0, "an x chunk is whole stages");
  const int stages = slab.stages();
  for (int s = 0; s < stages; ++s) {
    const int r0 = slab.k0 + s * S::kRows;
    if ((s * S::kRows) % kXChunk == 0) {
      __syncthreads();  // every thread is done with the last chunk
      stage(r0, min(kXChunk, slab.k1 - r0));
      __syncthreads();
    }
    if (kVec) slab.wait(s);
    consume(s, r0, min(S::kRows, slab.k1 - r0));
    if (kVec && s + kStages < stages) {
      __syncthreads();
      slab.refill(s);
    }
  }
}

// The cluster's split sums. Of the tile's `count` sums, block r owns those
// from r * per on (per = count / splits, rounded up); each block pushes its
// partial of sum i into its owner's `recv` at split * per + i % per
// (remote stores), and after one cluster barrier each owner adds its sums'
// partials from its own shared memory in rank order 0, 1, ...: no block
// reads another's shared memory after the barrier, so none waits at a
// second one. recv: at least per * splits words in every block.
__device__ __forceinline__ int share(int count, int splits) {
  return (count + splits - 1) / splits;
}

template <class T>
__device__ __forceinline__ void push(T* recv, int i, int per, int split, T v) {
  unsigned u;
  if constexpr (std::is_same_v<T, float>)
    u = __float_as_uint(v);
  else
    u = static_cast<unsigned>(v);
  store_rank_u32(smem_addr(recv + split * per + i % per), i / per, u);
}

template <class T>
__device__ __forceinline__ T gather(const T* recv, int j, int per, int splits) {
  T s = recv[j];
  for (int q = 1; q < splits; ++q) s += recv[q * per + j];
  return s;
}

// ---- host side ---------------------------------------------------------------

// True when the host's plan fits: P in 1 .. kMaxP, `splits` a power of two
// of at most kClusterMax, K in `splits` ranges of `chunk` (the last one shorter,
// each but the last a multiple of kStep).
inline bool plan_fits(int P, int K, int N, int splits, int chunk) {
  return P > 0 && P <= kMaxP && K > 0 && N > 0 && splits > 0 && splits <= kClusterMax &&
         (splits & (splits - 1)) == 0 && chunk > 0 &&
         static_cast<long long>(chunk) * splits >= K &&
         static_cast<long long>(chunk) * (splits - 1) < K &&
         (splits == 1 || chunk % kStep == 0);
}

// True when the slab's rows may arrive by bulk copies: the (K, N) weights
// of kElem-byte elements 16-byte aligned, N a multiple of 4 and their bytes
// a multiple of 16 (so every row's widened segment lies inside them).
inline bool bulk_rows(const void* w, int K, int N, int kElem) {
  return reinterpret_cast<uintptr_t>(w) % 16 == 0 && N % 4 == 0 &&
         static_cast<long long>(K) * N * kElem % 16 == 0;
}

// The launch of kKernel(a) on grid (tiles, splits) in clusters of (1,
// splits, 1) with `smem` bytes of dynamic shared memory; the kernel's
// attributes (its dynamic shared memory limit and the non-portable
// cluster opt-in) are set once per device. clusters:
// where not null, instead of launching, the clusters of that shape the
// device holds at once (cudaOccupancyMaxActiveClusters).
template <auto kKernel, class Args>
cudaError_t launch(const Args& a, int tiles, int splits, size_t smem, cudaStream_t s,
                   int* clusters = nullptr) {
  static bool done[64] = {};
  constexpr auto kernel = kKernel;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters != nullptr) return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace gemv
}  // namespace wt
