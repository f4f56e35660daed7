// What the persistent cooperative kernels share: a grid-wide barrier, a
// loader and epilogues that read data produced earlier in the same launch,
// the shape and K split of a GEMM phase that walks its output tiles (and K
// splits) over all blocks (wgmma_phase.cuh's and wgmma_s8_phase.cuh's
// phases), and the host side's workspace and grid helpers.
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

#include "common.cuh"

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

struct CgLoad {
  __device__ __forceinline__ float operator()(const float* p) const { return __ldcg(p); }
};

// y = acc * scale[n] + bias[n] (+ ReLU) into out[p, n] (row stride N).
struct BnEpilogue {
  const float* __restrict__ scale;
  const float* __restrict__ bias;
  float* out;
  int N;
  int relu;
  __device__ __forceinline__ void operator()(int p, int n, float acc) const {
    float y = acc * scale[n] + bias[n];
    if (relu) y = wt::relu(y);
    out[static_cast<size_t>(p) * N + n] = y;
  }
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
    out[i] = wt::relu(acc * scale[n] + bias[n] + __ldcg(res + i));
  }
};

// Shape and K split of one GEMM phase, fixed by the host.
struct GemmPhase {
  int P, K, N;
  int splits;  // K ranges, each a multiple of the tile's k step except the last
  int chunk;   // K per split
};

}  // namespace wt

// Host side: `want` K splits of at least 128 of K each (at most `cap`),
// each but the last a multiple of `step`, the tile's k per stage; one
// split when fewer than two are wanted or possible.
inline wt::GemmPhase split_k(int P, int K, int N, int want, int step, int cap = 16) {
  int splits = want < K / 128 ? want : K / 128;
  splits = splits < cap ? splits : cap;
  if (splits < 2) return wt::GemmPhase{P, K, N, 1, K};
  int chunk = (K + splits - 1) / splits;
  chunk = (chunk + step - 1) / step * step;
  return wt::GemmPhase{P, K, N, (K + chunk - 1) / chunk, chunk};
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
inline int cooperative_grid(const void* kernel, size_t smem, int threads,
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
