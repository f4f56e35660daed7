// One output tile of C[P, N] = A[P, K] x B[K, N] with the folded-BN epilogue
// y = C * scale[n] + bias[n] (+ ReLU), in FP32 FFMA with FP32 accumulation.
//
// Shared by the pointwise kernel (A is the activation matrix) and the direct
// 3x3 kernel (A is the implicit im2col matrix, gathered on the fly into
// shared memory). The A operand comes through a loader functor
// `float a(int p, int k)`; B is a row-major (K, N) weight matrix.
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

struct RowMajorA {
  const float* __restrict__ x;
  int ld;
  __device__ __forceinline__ float operator()(int p, int k) const {
    return x[static_cast<size_t>(p) * ld + k];
  }
};

template <class ALoad>
__device__ __forceinline__ void gemm_bn_tile(
    const ALoad& a_at, const float* __restrict__ b,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ out, int P, int K, int N, int relu) {
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int p0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int ty = tid / 16;
  const int tx = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A tile (64 rows x 16 k): neighbouring threads take neighbouring k.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tid / 16 + 16 * i;
      const int kk = tid % 16;
      const int p = p0 + r;
      const int k = k0 + kk;
      As[kk][r] = (p < P && k < K) ? a_at(p, k) : 0.f;
    }
    // B tile (16 k x 64 columns): neighbouring threads take neighbouring n.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = tid / 64 + 4 * i;
      const int c = tid % 64;
      const int k = k0 + kk;
      const int n = n0 + c;
      Bs[kk][c] = (k < K && n < N) ? b[static_cast<size_t>(k) * N + n] : 0.f;
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
    const float s = scale[n];
    const float t = bias[n];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + ty * 4 + i;
      if (p >= P) continue;
      float y = acc[i][j] * s + t;
      if (relu) y = fmaxf(y, 0.f);
      out[static_cast<size_t>(p) * N + n] = y;
    }
  }
}

}  // namespace wt
