// Split-K f32 products through device memory with a folded BN (+ ReLU)
// epilogue, for csrc/pointwise.cu's GEMV (P <= 8 rows, the heads):
// out[P, N] = BN(x[P, K] x w[K, N]).
//
// K is cut into `splits` ranges of `chunk` by the host's plan, one block per
// (column tile, split). With one split the block applies the epilogue
// itself. With several, each block writes its f32 partial sums to the
// workspace (splits x P x N) and counts itself in at its tile's counter (at
// the workspace's start, zeroed by the C entry's cudaMemsetAsync before the
// launch); the last block of a tile to arrive adds the partials in split
// order 0, 1, ..., S-1 and applies BN and ReLU once. Which block is last
// varies; the order of the sum does not, so the same inputs give the same
// bits on every call. Nothing is allocated and nothing copied to or from
// the host, so the launch can be captured in a CUDA graph. The weights'
// element type is float, or __nv_bfloat16 at the bf16w tier.
//
// The per-layer GEMMs over more rows run as one launch with their K splits
// reduced inside a thread-block cluster (wgmma_cluster.cuh: csrc/
// pointwise.cu's MMA path, csrc/direct.cu) and need none of this. The
// persistent kernels' GEMM phases (csrc/stage.cu, transition.cu,
// basic_stage.cu) run on wgmma_phase.cuh; they take the host-side check of
// a phase's plan (phase_fits) and its split step (kSplitStep) from here.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"
#include "grid_sync.cuh"
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

// Host side. True when a persistent kernel's phase of the host's plan fits:
// K in `splits` ranges of `chunk`, the last one shorter, chunk a multiple
// of the tile's k step when splits > 1.
inline bool phase_fits(const GemmPhase& g) {
  return g.P > 0 && g.K > 0 && g.N > 0 && g.splits > 0 && g.chunk > 0 &&
         static_cast<long long>(g.chunk) * g.splits >= g.K &&
         static_cast<long long>(g.chunk) * (g.splits - 1) < g.K &&
         (g.splits == 1 || g.chunk % kSplitStep == 0);
}

// True when the GEMV's plan fits: K in `splits` ranges of `chunk`, the
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

}  // namespace splitk
}  // namespace wt
