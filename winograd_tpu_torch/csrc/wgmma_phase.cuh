// A GEMM phase of a persistent cooperative kernel on csrc/wgmma_tile.cuh's
// tiles: the phase's work items, (K split, 64 x 64 output tile) pairs, are
// dealt to the grid's blocks; each item runs one wgmma tile (weights by TMA
// where kVec) and hands its outputs to the phase's epilogue, or past one
// split writes its partial tile to the workspace, and after a grid barrier
// (grid_sync.cuh) the blocks add the splits in split order 0, 1, ... and
// apply the epilogue, each element once: the result does not depend on
// timing. A block may issue the weight loads of its first item of the next
// phase before it waits at the barrier that ends a phase (prefetch_phase):
// the weights do not depend on the activations, so the ring's cold fill
// overlaps the wait.
//
// Shared by csrc/stage.cu (its reduce, direct mid and expand),
// csrc/basic_stage.cu (its two 3x3 convs a block) and csrc/transition.cu
// (its reduce, strided mid and expand with the projection). The phase's
// plan (wt::GemmPhase: P, K, N and K in `splits` ranges of `chunk`, each a
// whole number of the tile's kBK stages but the last) comes from the host
// and is checked there (phase_fits).
#pragma once

#include <cuda_runtime.h>

#include "grid_sync.cuh"
#include "wgmma_tile.cuh"

namespace wt {
namespace wgphase {

constexpr int kSplitStep = wg::kBK;  // every split but the last is a multiple of this

// Host side. True when a phase of the host's plan fits: K in `splits`
// ranges of `chunk`, the last one shorter, chunk a multiple of the tile's
// k step when splits > 1.
inline bool phase_fits(const GemmPhase& g) {
  return g.P > 0 && g.K > 0 && g.N > 0 && g.splits > 0 && g.chunk > 0 &&
         static_cast<long long>(g.chunk) * g.splits >= g.K &&
         static_cast<long long>(g.chunk) * (g.splits - 1) < g.K &&
         (g.splits == 1 || g.chunk % kSplitStep == 0);
}

// An item of a phase: its split's K range and its output tile's corner.
struct Item {
  int split, p0, n0, k0, k1;
};

__device__ __forceinline__ Item item_of(const GemmPhase& g, int item) {
  const int tiles_n = (g.N + wg::kBN - 1) / wg::kBN;
  const int tiles = (g.P + wg::kBM - 1) / wg::kBM * tiles_n;
  const int split = item / tiles, t = item - split * tiles;
  const int k0 = split * g.chunk;
  return Item{split, t / tiles_n * wg::kBM, t % tiles_n * wg::kBN, k0, min(g.K, k0 + g.chunk)};
}

__device__ __forceinline__ int items_of(const GemmPhase& g) {
  return (g.P + wg::kBM - 1) / wg::kBM * ((g.N + wg::kBN - 1) / wg::kBN) * g.splits;
}

// This block's items of the product C = A x B of phase g: each output
// through epi(p, n, acc) at one split, else its partial tile into part
// (splits x P x N). A from the source `a` (mma_tf32.cuh's, written earlier
// in the launch or not: read through L2). `prefetched`: the first item's
// weight loads are in flight (prefetch_phase); cleared.
template <bool kVec, class ASrc, class BT, class Epilogue>
__device__ __forceinline__ void phase_items(const GemmPhase& g, const ASrc& a,
                                            const wg::Weights<BT>& b, const Epilogue& epi,
                                            float* part, wg::Ring& ring, bool& prefetched) {
  for (int item = blockIdx.x; item < items_of(g); item += gridDim.x) {
    const Item it = item_of(g, item);
    wg::Acc acc;
    wg::tile<kVec, true>(a, b, it.p0, it.n0, it.k0, it.k1, ring, prefetched, acc);
    prefetched = false;
    float* sp = part + static_cast<size_t>(it.split) * g.P * g.N;
    wg::for_each_acc(acc, [&](int r, int c, float v) {
      const int p = it.p0 + r, n = it.n0 + c;
      if (p >= g.P || n >= g.N) return;
      if (g.splits == 1)
        epi(p, n, v);
      else
        sp[static_cast<size_t>(p) * g.N + n] = v;
    });
  }
}

// Issues the weight loads of this block's first item of phase g into the
// idle ring; true when it did (the TMA route and an item to run).
template <bool kVec, class BT>
__device__ __forceinline__ bool prefetch_phase(const GemmPhase& g, const wg::Weights<BT>& b,
                                               const wg::Ring& ring) {
  if (!kVec || static_cast<int>(blockIdx.x) >= items_of(g)) return false;
  const Item it = item_of(g, blockIdx.x);
  wg::prefetch<true>(ring, b, it.n0, it.k0, it.k1);
  return true;
}

// Past one split: after a grid barrier, the blocks add the splits' partial
// sums in split order 0, 1, ... and apply epi, each element once. The
// caller places the barrier that ends the phase.
template <class Epilogue>
__device__ __forceinline__ void reduce_phase(const GemmPhase& g, const Epilogue& epi,
                                             const float* part, unsigned int* bar) {
  if (g.splits == 1) return;
  grid_sync(bar);
  const size_t pn = static_cast<size_t>(g.P) * g.N;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < pn;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = __ldcg(part + i);
    for (int k = 1; k < g.splits; k += 8) {  // eight splits' loads in flight
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = k + u < g.splits ? __ldcg(part + (k + u) * pn + i) : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k + u < g.splits) s += v[u];
    }
    epi(static_cast<int>(i / g.N), static_cast<int>(i % g.N), s);
  }
}

}  // namespace wgphase
}  // namespace wt
