// One output tile of C[P, N] = A[P, K] x B[K, N] in FP32 FFMA with FP32
// accumulation, handed to an epilogue functor; gemm_bn_tile is the tile with
// the folded-BN epilogue y = C * scale[n] + bias[n] (+ ReLU).
//
// Run by the persistent basic-stage kernel (csrc/basic_stage.cu, through
// grid_sync.cuh's gemm_phase), which walks a list of tiles and splits K
// across blocks; the port's other f32 GEMMs run on mma_tf32.cuh's
// tensor-core tile. The A operand comes through a loader functor
// `float a(int p, int k)`; B is a row-major (K, N) weight matrix. The caller
// names the tile (p0, n0), the K range [k_begin, k_end) and the shared
// memory (kGemmSmemFloats floats, 16-byte aligned).
//
// Tile: 64 x 64 outputs per block of 256 threads, 4 x 4 per thread, K in
// steps of 16 staged in shared memory. A is stored k-major so each thread
// reads its 4 rows and 4 columns as two float4 loads per k step (one
// shared-memory load per 8 FMAs). Ragged P, K and N are zero-filled at the
// loads and masked at the store.
#pragma once

#include <cuda_runtime.h>

namespace wt {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kGemmThreads = 256;
constexpr int kGemmSmemFloats = kBK * (kBM + 4) + kBK * kBN;

// y = acc * scale[n] + bias[n] (+ ReLU) into out[p, n] (row stride N).
struct BnEpilogue {
  const float* __restrict__ scale;
  const float* __restrict__ bias;
  float* out;
  int N;
  int relu;
  __device__ __forceinline__ void operator()(int p, int n, float acc) const {
    float y = acc * scale[n] + bias[n];
    if (relu) y = fmaxf(y, 0.f);
    out[static_cast<size_t>(p) * N + n] = y;
  }
};

template <class ALoad, class Epilogue>
__device__ __forceinline__ void gemm_tile(const ALoad& a_at,
                                          const float* __restrict__ b, int P,
                                          int K, int N, int p0, int n0,
                                          int k_begin, int k_end, float* smem,
                                          const Epilogue& epi) {
  float(*As)[kBM + 4] = reinterpret_cast<float(*)[kBM + 4]>(smem);
  float(*Bs)[kBN] = reinterpret_cast<float(*)[kBN]>(smem + kBK * (kBM + 4));
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    // A tile (64 rows x 16 k): neighbouring threads take neighbouring k.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tid / 16 + 16 * i;
      const int kk = tid % 16;
      const int p = p0 + r;
      const int k = k0 + kk;
      As[kk][r] = (p < P && k < k_end) ? a_at(p, k) : 0.f;
    }
    // B tile (16 k x 64 columns): neighbouring threads take neighbouring n.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = tid / 64 + 4 * i;
      const int c = tid % 64;
      const int k = k0 + kk;
      const int n = n0 + c;
      Bs[kk][c] = (k < k_end && n < N) ? b[static_cast<size_t>(k) * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float a[4] = {av.x, av.y, av.z, av.w};
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx * 4 + j;
    if (n >= N) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + ty * 4 + i;
      if (p < P) epi(p, n, acc[i][j]);
    }
  }
}

template <class ALoad>
__device__ __forceinline__ void gemm_bn_tile(
    const ALoad& a_at, const float* __restrict__ b,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ out, int P, int K, int N, int relu, int p0, int n0,
    float* smem) {
  gemm_tile(a_at, b, P, K, N, p0, n0, 0, K, smem,
            BnEpilogue{scale, bias, out, N, relu});
}

}  // namespace wt
