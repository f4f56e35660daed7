// Split-K f32 products with a folded BN (+ ReLU) epilogue, for the per-layer
// kernels whose output tiles are fewer than the card's SMs (csrc/direct.cu,
// and csrc/pointwise.cu's GEMV): out[P, N] = BN(A[P, K] x w[K, N]).
//
// K is cut into `splits` ranges of `chunk` by the host's plan, one block per
// (tile, split). With one split the block applies the epilogue itself. With
// several, each block writes its f32 partial tile to the workspace (splits x
// P x N) and counts itself in at its tile's counter (at the workspace's
// start, zeroed by the C entry's cudaMemsetAsync before the launch); the last
// block of a tile to arrive adds the partials in split order 0, 1, ...,
// S-1 and applies BN and ReLU once. Which block is last varies; the order of
// the sum does not, so the same inputs give the same bits on every call.
// Nothing is allocated and nothing copied to or from the host, so the launch
// can be captured in a CUDA graph.
//
// The MMA path (mma_kernel) multiplies 64 x 64 tiles of mma_tf32.cuh, with A
// from any of its sources; pointwise.cu's GEMV reuses the reduction. The
// kernel takes the weights' element type: f32 weights run tf32x3's 3xTF32
// tile, bf16 weights (the bf16w tier) mma_bf16w.cuh's tile (wt::mma_tile),
// the plan and the reduction the same.
//
// The persistent kernels' GEMM phases (csrc/stage.cu, transition.cu,
// basic_stage.cu) run on wgmma_phase.cuh; they take the host-side check of
// a phase's plan (phase_fits) and its split step (kSplitStep) from here.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"
#include "grid_sync.cuh"
#include "mma_bf16w.cuh"
#include "mma_tf32.cuh"

namespace wt {
namespace splitk {

namespace tc = tf32x3;

constexpr int kSplitStep = tc::kBK;  // every split but the last is a multiple of this
static_assert(tc::kBM == tc::kBN, "the plans name one MMA tile width");

// One product's operands, plan and workspace; BT: the weights' element
// type (float, or __nv_bfloat16 at bf16w).
template <class BT>
struct GemmArgs {
  const float* x;
  const BT* w;
  const float* scale;
  const float* bias;
  float* out;
  unsigned int* counters;  // one per output tile
  float* part;             // splits x P x N
  int P, K, N, relu, splits, chunk;
};
using Args = GemmArgs<float>;

template <class A>
__device__ __forceinline__ float bn(const A& a, int n, float acc) {
  const float y = acc * a.scale[n] + a.bias[n];
  return a.relu ? wt::relu(y) : y;
}

// After this block wrote its partial sums: true for the last block of
// `tile` to arrive, which then sees every other block's partials.
template <class A>
__device__ __forceinline__ bool arrive_last(const A& a, int tile) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.counters + tile, 1u) == a.splits - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

__device__ __forceinline__ void load_cg(const float* p, float& v) { v = __ldcg(p); }
__device__ __forceinline__ void load_cg(const float* p, float4& v) {
  v = __ldcg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void add(float& s, float v) { s += v; }
__device__ __forceinline__ void add(float4& s, const float4& v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}
template <class A>
__device__ __forceinline__ void store_bn(const A& a, size_t at, int n, float v) {
  a.out[at] = bn(a, n, v);
}
template <class A>
__device__ __forceinline__ void store_bn(const A& a, size_t at, int n, const float4& v) {
  *reinterpret_cast<float4*>(a.out + at) =
      make_float4(bn(a, n, v.x), bn(a, n + 1, v.y), bn(a, n + 2, v.z), bn(a, n + 3, v.w));
}

// out = BN(part[0] + part[1] + ... + part[splits - 1]) over the block's
// positions: kPer positions a thread, position i at row i / cols and
// column (i % cols) * width of the tile at (p0, n0), `width` = 1 or 4
// adjacent columns (T = float or float4). The loads of kUnroll splits for
// all kPer positions are in flight together; each element still adds its
// splits one by one in split order.
template <class T, int kPer, int kUnroll, int kThreadsPerBlock, class A>
__device__ __forceinline__ void reduce_splits(const A& a, int p0, int n0, int positions,
                                              int cols, int width) {
  const size_t pn = static_cast<size_t>(a.P) * a.N;
  for (int base = threadIdx.x; base < positions; base += kPer * kThreadsPerBlock) {
    size_t at[kPer];
    int col[kPer];
    bool ok[kPer];
    T s[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = base + j * kThreadsPerBlock;
      const int p = p0 + i / cols;
      col[j] = n0 + i % cols * width;
      ok[j] = i < positions && p < a.P && col[j] < a.N;
      at[j] = static_cast<size_t>(p) * a.N + col[j];
      if (ok[j]) load_cg(a.part + at[j], s[j]);
    }
    for (int k = 1; k < a.splits; k += kUnroll) {
      T v[kUnroll][kPer];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          if (ok[j] && k + u < a.splits) load_cg(a.part + (k + u) * pn + at[j], v[u][j]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          if (ok[j] && k + u < a.splits) add(s[j], v[u][j]);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (ok[j]) store_bn(a, at[j], col[j], s[j]);
  }
}

// One block per (output tile, split): grid (tiles, splits). A from `src`
// (an A source of mma_tf32.cuh), B = a.w; kVec: 16-byte copies (for bf16
// weights N a multiple of 8), and N % 4 == 0 for the float4 reduction.
template <bool kVec, class ASrc, class BT>
__global__ void __launch_bounds__(tc::kThreads) mma_kernel(GemmArgs<BT> a, ASrc src) {
  extern __shared__ __align__(16) float smem[];
  const int tiles_n = (a.N + tc::kBN - 1) / tc::kBN;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int p0 = tile / tiles_n * tc::kBM, n0 = tile % tiles_n * tc::kBN;
  const int k0 = split * a.chunk, k1 = min(a.K, k0 + a.chunk);
  tc::Acc acc;
  mma_tile<kVec, false>(src, a.w, a.N, p0, n0, k0, k1, smem, acc);

  if (a.splits == 1) {
    tc::for_each_acc(acc, [&](int r, int c, float v) {
      if (p0 + r < a.P && n0 + c < a.N)
        a.out[static_cast<size_t>(p0 + r) * a.N + n0 + c] = bn(a, n0 + c, v);
    });
    return;
  }
  float* part = a.part + static_cast<size_t>(split) * a.P * a.N;
  tc::for_each_acc(acc, [&](int r, int c, float v) {
    if (p0 + r < a.P && n0 + c < a.N) part[static_cast<size_t>(p0 + r) * a.N + n0 + c] = v;
  });
  if (!arrive_last(a, tile)) return;
  if (kVec)  // N % 4 == 0: four adjacent columns a load
    reduce_splits<float4, 8, 1, tc::kThreads>(a, p0, n0, tc::kBM * tc::kBN / 4, tc::kBN / 4, 4);
  else
    reduce_splits<float, 8, 1, tc::kThreads>(a, p0, n0, tc::kBM * tc::kBN, tc::kBN, 1);
}

// Host side. True when a persistent kernel's phase of the host's plan fits:
// K in `splits` ranges of `chunk`, the last one shorter, chunk a multiple
// of the tile's k step when splits > 1.
inline bool phase_fits(const GemmPhase& g) {
  return g.P > 0 && g.K > 0 && g.N > 0 && g.splits > 0 && g.chunk > 0 &&
         static_cast<long long>(g.chunk) * g.splits >= g.K &&
         static_cast<long long>(g.chunk) * (g.splits - 1) < g.K &&
         (g.splits == 1 || g.chunk % kSplitStep == 0);
}

// True when a per-layer kernel's plan fits: K in `splits` ranges of `chunk`, the
// last one shorter, chunk a multiple of kSplitStep when splits > 1; past one
// split, `tiles` counters from word 0 of ws and the splits x P x N partials
// from word `part` (a multiple of 4), within ws_words.
inline bool plan_fits(int P, int K, int N, int tiles, int splits, int chunk, long long ws_words,
                      long long part) {
  if (P <= 0 || K <= 0 || N <= 0 || splits <= 0 || chunk <= 0 ||
      static_cast<long long>(chunk) * splits < K ||
      static_cast<long long>(chunk) * (splits - 1) >= K ||
      (splits > 1 && chunk % kSplitStep != 0))
    return false;
  return splits == 1 || (part >= tiles && part % 4 == 0 &&
                         ws_words >= part + static_cast<long long>(splits) * P * N);
}

// Points a.counters and a.part into ws (past one split) and zeroes the
// counters on stream s.
template <class BT>
inline cudaError_t bind_workspace(GemmArgs<BT>& a, float* ws, long long part, int tiles,
                                  cudaStream_t s) {
  if (a.splits == 1) return cudaSuccess;
  a.counters = reinterpret_cast<unsigned int*>(ws);
  a.part = ws + part;
  return cudaMemsetAsync(a.counters, 0, sizeof(unsigned int) * tiles, s);
}

// Launches mma_kernel<kVec, ASrc, BT> on grid (tiles, splits), setting its
// dynamic shared memory limit once per device.
template <bool kVec, class ASrc, class BT>
cudaError_t launch_mma(const GemmArgs<BT>& a, const ASrc& src, int tiles, cudaStream_t s) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(&mma_kernel<kVec, ASrc, BT>),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kTileSmemBytes<BT>));
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  mma_kernel<kVec, ASrc, BT>
      <<<dim3(tiles, a.splits), tc::kThreads, kTileSmemBytes<BT>, s>>>(a, src);
  return cudaGetLastError();
}

}  // namespace splitk
}  // namespace wt
