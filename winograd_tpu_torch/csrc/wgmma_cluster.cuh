// One GEMM with folded BN (+ ReLU) as one launch of wgmma_tile.cuh's tiles,
// the K splits of an output tile the blocks of one thread-block cluster:
// out[P, N] = BN(A[P, K] x w[K, N]), A from any of mma_tf32.cuh's A sources
// (RowMajorA: csrc/pointwise.cu's MMA path; Im2colA: csrc/direct.cu's
// implicit pad-1 stride-1 im2col), w f32 or bf16 (the bf16w tier).
//
// One block per (output tile, split), grid (tiles, splits), cluster dims
// (1, splits, 1), at most kMax: kClusterPortable (8, csrc/pointwise.cu) or
// kClusterMax (16, csrc/direct.cu: past 8 a non-portable cluster, which an
// H100 schedules within one GPC; the instantiation that allows it is apart,
// since allowing it slowed the 1x1s' portable clusters 3-9%). Each
// block walks its range of K on the 64 x 64 wgmma tile (3xTF32, or two bf16
// passes; weights by TMA onto mbarriers on the kVec route, A by cp.async)
// and leaves its partial tile in its idle ring. After a cluster barrier,
// block r adds rows r * 64 / splits .. of every block's partial through
// distributed shared memory, in rank order 0, 1, ..., and applies BN and
// ReLU. No partial reaches device memory: no workspace, no counter, no
// memset before the launch, and the sum's fixed order gives the same bits
// on every call. One split is a cluster of one, whose block applies the
// epilogue to its accumulators.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cluster.cuh"
#include "common.cuh"
#include "mma_tf32.cuh"
#include "wgmma_tile.cuh"

namespace wt {
namespace wgc {

constexpr int kClusterMax = 16;      // K splits of a tile: the blocks of one cluster
constexpr int kClusterPortable = 8;  // the most a cluster holds without the non-portable opt-in
constexpr int kLdRed = wg::kBN + 8;  // floats a row of a partial tile in shared memory
// The f32 tiles overlap a stage's products with the next stage's split
// (wgmma_tile.cuh, kPipe); the bf16 products read their slot, so they wait.
template <class BT>
constexpr bool kPipe = std::is_same_v<BT, float>;

// The product's weights, epilogue and plan; map: w as a (N, K, 1) tensor
// map (kVec). BT: the weights' element type (float, or __nv_bfloat16).
template <class BT>
struct Args {
  CUtensorMap map;
  const BT* w;
  const float* scale;
  const float* bias;
  float* out;
  int P, K, N, relu, splits, chunk;
};

template <class BT>
__device__ __forceinline__ float bn(const Args<BT>& a, int n, float acc) {
  const float y = acc * a.scale[n] + a.bias[n];
  return a.relu ? wt::relu(y) : y;
}

// kVec: the TMA weight loads and 16-byte A copies (the A source's four
// floats from a k that is a multiple of 4 lie in one row of memory, N a
// multiple of 4 (8 for bf16), operands 16-byte aligned); kMax: the most
// splits, the blocks of a cluster.
template <bool kVec, int kMax, class ASrc, class BT>
__global__ void __launch_bounds__(wg::kThreads)
    cluster_gemm(const __grid_constant__ Args<BT> a, const ASrc src) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[wg::kStages];
  wg::Ring ring = wg::make_ring(smem, bars);
  const int tiles_n = (a.N + wg::kBN - 1) / wg::kBN;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int p0 = tile / tiles_n * wg::kBM, n0 = tile % tiles_n * wg::kBN;
  const int k0 = split * a.chunk, k1 = min(a.K, k0 + a.chunk);
  wg::Acc acc;
  wg::tile<kVec, false, kPipe<BT>>(src, wg::Weights<BT>{&a.map, a.w, a.N, a.K, 0}, p0, n0, k0, k1,
                                   ring, false, acc);
  if (a.splits == 1) {
    wg::for_each_acc(acc, [&](int r, int c, float v) {
      if (p0 + r < a.P && n0 + c < a.N)
        a.out[static_cast<size_t>(p0 + r) * a.N + n0 + c] = bn(a, n0 + c, v);
    });
    return;
  }
  // The ring is idle: it holds this block's partial tile for the cluster.
  float* red = reinterpret_cast<float*>(ring.base);
  wg::for_each_acc(acc, [&](int r, int c, float v) { red[r * kLdRed + c] = v; });
  cluster_sync();
  const int rows = (wg::kBM + a.splits - 1) / a.splits;
  const int r0 = split * rows, r1 = min(wg::kBM, r0 + rows);
  const unsigned base = wt::smem_addr(red);
  for (int i = threadIdx.x; i < (r1 - r0) * wg::kBN; i += wg::kThreads) {
    const int r = r0 + i / wg::kBN, c = i % wg::kBN;
    if (p0 + r >= a.P || n0 + c >= a.N) continue;
    const unsigned at = base + 4u * (r * kLdRed + c);
    float v[kMax];
#pragma unroll
    for (int q = 0; q < kMax; ++q) v[q] = q < a.splits ? load_rank(at, q) : 0.f;
    float s = v[0];
#pragma unroll
    for (int q = 1; q < kMax; ++q)
      if (q < a.splits) s += v[q];
    a.out[static_cast<size_t>(p0 + r) * a.N + n0 + c] = bn(a, n0 + c, s);
  }
  cluster_sync();  // no block leaves while another reads its partial
}

// ---- host side ---------------------------------------------------------------

// True when the host's plan fits: K in `splits` ranges of `chunk`, the last
// one shorter, each but the last whole stages of the tile, at most kMax
// splits.
inline bool plan_fits(int P, int K, int N, int splits, int chunk, int kMax) {
  return P > 0 && K > 0 && N > 0 && splits > 0 && splits <= kMax && chunk > 0 &&
         static_cast<long long>(chunk) * splits >= K &&
         static_cast<long long>(chunk) * (splits - 1) < K &&
         (splits == 1 || chunk % wg::kBK == 0);
}

// Launches cluster_gemm<kVec, kMax, ASrc, BT> on grid (tiles, splits) in
// clusters of (1, splits, 1), setting its dynamic shared memory limit (and,
// past a portable cluster, allowing non-portable sizes) once per device.
template <bool kVec, int kMax, class ASrc, class BT>
cudaError_t launch(const Args<BT>& a, const ASrc& src, int tiles, cudaStream_t s) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(cluster_gemm<kVec, kMax, ASrc, BT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(wg::kSmemBytes<BT, kPipe<BT>>));
    if (e != cudaSuccess) return e;
    if (kMax > kClusterPortable)
      e = cudaFuncSetAttribute(cluster_gemm<kVec, kMax, ASrc, BT>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, a.splits);
  cfg.blockDim = dim3(wg::kThreads);
  cfg.dynamicSmemBytes = wg::kSmemBytes<BT, kPipe<BT>>;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, cluster_gemm<kVec, kMax, ASrc, BT>, a, src);
  return e != cudaSuccess ? e : cudaGetLastError();
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Checks the plan (at most kMax splits) and launches one product on 64 x 64
// tiles: the kVec route (the weights' TMA map encoded here) where the A
// source moves 16-byte copies (a_vec: for RowMajorA K % 4 == 0, for Im2colA
// C % 4 == 0, and A 16-byte aligned), N is a multiple of 4 (8 for bf16) and
// w and out are 16-byte aligned; else the element route.
template <int kMax, class ASrc, class BT>
cudaError_t run(Args<BT>& a, const ASrc& src, bool a_vec, cudaStream_t s) {
  static_assert(kMax == kClusterPortable || kMax == kClusterMax, "a cluster of 8 or of 16");
  if (!plan_fits(a.P, a.K, a.N, a.splits, a.chunk, kMax)) return cudaErrorInvalidValue;
  const int tiles = (a.P + wg::kBM - 1) / wg::kBM * ((a.N + wg::kBN - 1) / wg::kBN);
  constexpr int kVecN = std::is_same_v<BT, float> ? 4 : 8;
  if (a_vec && a.N % kVecN == 0 && aligned16(a.w) && aligned16(a.out)) {
    const cudaError_t e = wg::encode_weights(&a.map, a.w, 1, a.K, a.N);
    return e != cudaSuccess ? e : launch<true, kMax>(a, src, tiles, s);
  }
  return launch<false, kMax>(a, src, tiles, s);
}

}  // namespace wgc
}  // namespace wt
