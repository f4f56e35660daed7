// What the persistent stage and transition kernels share: a grid-wide
// barrier, loaders that read data produced earlier in the same launch, and
// a GEMM phase that walks its output tiles (and K splits) over all blocks.
//
// The kernels are launched with cudaLaunchCooperativeKernel, which refuses a
// grid that the card cannot hold resident at once, so every block reaches
// every barrier. The barrier is two counters in device memory, zeroed by the
// C entry on the launch's stream (cudaMemsetAsync) before each launch:
// bar[0] counts the blocks that arrived, bar[1] is the generation. The last
// block to arrive resets the count and bumps the generation; the others spin
// on it. The fences before arriving and after leaving make every block's
// writes before the barrier visible to every block after it (the same
// protocol as cooperative_groups' grid sync, which needs no -rdc here).
//
// Data written during the launch (activations, scratch, K-split partial
// sums) is read with ld.global.cg (__ldcg): it bypasses the SM's L1, which
// is not coherent across SMs and could hold a line from before a barrier.
#pragma once

#include <cuda_runtime.h>

#include "gemm.cuh"

namespace wt {

__device__ __forceinline__ void grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// The stride-1 pad-1 3x3 im2col matrix of an (N, H, W, C) map written
// earlier in the launch, k = (3r + s) * C + c.
struct Im2colCg {
  const float* x;
  int H, W, C;
  __device__ __forceinline__ float operator()(int p, int k) const {
    const int rs = k / C;
    const int c = k - rs * C;
    const int r = rs / 3;
    const int s = rs - 3 * r;
    const int hw = H * W;
    const int n = p / hw;
    const int q = p - n * hw;
    const int y = q / W + r - 1;
    const int xx = q % W + s - 1;
    if (y < 0 || y >= H || xx < 0 || xx >= W) return 0.f;
    return __ldcg(x + (static_cast<size_t>(n * H + y) * W + xx) * C + c);
  }
};

struct CgLoad {
  __device__ __forceinline__ float operator()(const float* p) const { return __ldcg(p); }
};

// out[p, n] = relu(acc * scale[n] + bias[n] + res[p, n]); res may be out
// (each element is read only by the thread that overwrites it).
struct ResidualEpilogue {
  const float* __restrict__ scale;
  const float* __restrict__ bias;
  const float* res;
  float* out;
  int N;
  __device__ __forceinline__ void operator()(int p, int n, float acc) const {
    const size_t i = static_cast<size_t>(p) * N + n;
    out[i] = fmaxf(acc * scale[n] + bias[n] + __ldcg(res + i), 0.f);
  }
};

// Partial sums of one K split into part[p, n].
struct PartialEpilogue {
  float* part;
  int N;
  __device__ __forceinline__ void operator()(int p, int n, float acc) const {
    part[static_cast<size_t>(p) * N + n] = acc;
  }
};

// Shape and K split of one GEMM phase, fixed by the host.
struct GemmPhase {
  int P, K, N;
  int splits;  // K ranges, each a multiple of kBK except the last
  int chunk;   // K per split
};

// C = A x B over the whole phase, every output through `epi`. Work items
// are (split, tile) pairs dealt round-robin to the blocks. With splits > 1
// each item writes its partial sums to `part` (splits x P x N floats); after
// a barrier the blocks add the splits in a fixed order (so the result does
// not depend on timing) and apply `epi`. The caller places the barrier that
// ends the phase.
template <class ALoad, class Epilogue>
__device__ __forceinline__ void gemm_phase(const GemmPhase& g, const ALoad& a,
                                           const float* __restrict__ b,
                                           const Epilogue& epi, float* part,
                                           unsigned int* bar, float* smem) {
  const int tiles_p = (g.P + kBM - 1) / kBM;
  const int tiles_n = (g.N + kBN - 1) / kBN;
  const int tiles = tiles_p * tiles_n;
  for (int item = blockIdx.x; item < tiles * g.splits; item += gridDim.x) {
    const int split = item / tiles;
    const int t = item - split * tiles;
    const int p0 = (t / tiles_n) * kBM;
    const int n0 = (t % tiles_n) * kBN;
    if (g.splits == 1) {
      gemm_tile(a, b, g.P, g.K, g.N, p0, n0, 0, g.K, smem, epi);
    } else {
      const int k0 = split * g.chunk;
      const int k1 = min(g.K, k0 + g.chunk);
      gemm_tile(a, b, g.P, g.K, g.N, p0, n0, k0, k1, smem,
                PartialEpilogue{part + static_cast<size_t>(split) * g.P * g.N, g.N});
    }
  }
  if (g.splits == 1) return;
  grid_sync(bar);
  const size_t pn = static_cast<size_t>(g.P) * g.N;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < pn; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = __ldcg(part + i);
    for (int k = 1; k < g.splits; ++k) s += __ldcg(part + k * pn + i);
    epi(static_cast<int>(i / g.N), static_cast<int>(i % g.N), s);
  }
}

}  // namespace wt

// Host side: `want` K splits of at least 128 of K each (at most `cap`),
// each but the last a multiple of `step`, the tile's k per stage; one
// split when fewer than two are wanted or possible.
inline wt::GemmPhase split_k(int P, int K, int N, int want, int step = wt::kBK,
                             int cap = 16) {
  int splits = want < K / 128 ? want : K / 128;
  splits = splits < cap ? splits : cap;
  if (splits < 2) return wt::GemmPhase{P, K, N, 1, K};
  int chunk = (K + splits - 1) / splits;
  chunk = (chunk + step - 1) / step * step;
  return wt::GemmPhase{P, K, N, (K + chunk - 1) / chunk, chunk};
}

// The K split of a phase: one with fewer output tiles than the grid has
// blocks splits K so that about one item lands on each block.
inline wt::GemmPhase plan_phase(int P, int K, int N, int grid, int step = wt::kBK,
                                int cap = 16) {
  const int tiles = ((P + wt::kBM - 1) / wt::kBM) * ((N + wt::kBN - 1) / wt::kBN);
  return split_k(P, K, N, grid / tiles, step, cap);
}

// Workspace parts start at multiples of this many floats (256 bytes).
constexpr size_t kWorkspaceAlign = 64;

inline size_t workspace_round_up(size_t floats) {
  return (floats + kWorkspaceAlign - 1) / kWorkspaceAlign * kWorkspaceAlign;
}

inline size_t phase_partial_floats(const wt::GemmPhase& g) {
  return g.splits > 1 ? static_cast<size_t>(g.splits) * g.P * g.N : 0;
}

// Blocks of `kernel` (`threads` threads, `smem` bytes of dynamic shared
// memory) that the current device holds resident at once, at most
// `max_per_sm` an SM; 0 on error.
inline int cooperative_grid(const void* kernel, size_t smem, int threads = wt::kGemmThreads,
                            int max_per_sm = 1 << 30) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
      cudaSuccess)
    return 0;
  return (per_sm < max_per_sm ? per_sm : max_per_sm) * sms;
}
