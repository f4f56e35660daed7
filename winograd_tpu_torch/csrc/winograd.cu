// Fused 3x3 conv (stride 1, pad 1) + folded BN (+ ReLU) by Winograd F(m,3),
// m = 2 or 4, in one launch:
//   V = Bt d Bt^T per (m+2)^2 input tile and channel,
//   M[p] = V[p] U[p] per tile position p (a (tiles, Cin) x (Cin, Cout) product),
//   Y = At M At^T, then y = Y * scale + bias (+ ReLU), stored clipped at the
//   right and bottom edges when m does not divide the map.
//
// Replaces: winograd_tpu/kernels/winograd.py::_winograd_kernel and
// ::_winograd_kernel_p64 (conv3x3_bn_winograd_pallas). The p64 variant packs
// two 64-channel tile columns into the TPU's 128 lanes; on Hopper the same
// kernel serves every channel count, so one kernel covers both. On the
// served ResNet-50 path it runs the projection block's 3x3 and the conv2_x
// identity blocks at 56x56x64, and the conv3_x identity blocks at 28x28x128,
// all F(2,3).
//
// Bound on the H100: F(2,3) does 16 products of (tiles x Cin x Cout) per
// 4 outputs; at 56x56x64 that is 103 MFLOP on 1.9 MB, at 28x28x128 103 MFLOP
// on 1.9 MB: both bound by the FP32 FFMA rate (and far from it, see below).
//
// Design: one block of 8 x 16 threads owns 8 tiles x COB output channels for
// every tile position, so the whole Winograd chain for those outputs stays
// on chip. Input channels are consumed in stages of 8: the block gathers
// its tiles with zero padding (the left/top pad of 1 and the right/bottom
// overhang), applies Bt d Bt^T in registers with the constant matrices
// folded in at compile time, and stages V and the matching slice of U in
// shared memory. Each thread then accumulates, in registers, all (m+2)^2
// positions of one tile for CPT output channels (F(2,3): 16 x 4, F(4,3):
// 36 x 2 accumulators), applies At M At^T in registers, and stores with
// the BN epilogue. All arithmetic is FP32 FFMA with FP32 accumulation,
// which holds 1e-4 for F(4,3) too. The inner loop issues one shared-memory
// load per CPT FMAs, so it runs well below the FFMA peak; a wgmma/3xTF32
// product per position is later work.

#include "common.cuh"

namespace {

constexpr int kTT = 8;   // tiles per block (threadIdx.y)
constexpr int kTX = 16;  // output-channel groups per block (threadIdx.x)
constexpr int kCK = 8;   // input channels per shared-memory stage

template <int M>
struct Wino;

template <>
struct Wino<2> {
  static constexpr int CPT = 4;  // output channels per thread
  __host__ __device__ static constexpr float bt(int i, int k) {
    constexpr float m[4][4] = {
        {1, 0, -1, 0}, {0, 1, 1, 0}, {0, -1, 1, 0}, {0, 1, 0, -1}};
    return m[i][k];
  }
  __host__ __device__ static constexpr float at(int i, int k) {
    constexpr float m[2][4] = {{1, 1, 1, 0}, {0, 1, -1, -1}};
    return m[i][k];
  }
};

template <>
struct Wino<4> {
  static constexpr int CPT = 2;
  __host__ __device__ static constexpr float bt(int i, int k) {
    constexpr float m[6][6] = {
        {4, 0, -5, 0, 1, 0},  {0, -4, -4, 1, 1, 0}, {0, 4, -4, -1, 1, 0},
        {0, -2, -1, 2, 1, 0}, {0, 2, -1, -2, 1, 0}, {0, 4, 0, -5, 0, 1}};
    return m[i][k];
  }
  __host__ __device__ static constexpr float at(int i, int k) {
    constexpr float m[4][6] = {{1, 1, 1, 1, 1, 0},
                               {0, 1, -1, 2, -2, 0},
                               {0, 1, 1, 4, 4, 0},
                               {0, 1, -1, 8, -8, 1}};
    return m[i][k];
  }
};

// out = T in T^T for a constant R x C matrix T (C = M + 2), zero terms
// skipped at compile time. `T(i, k)` is Wino<M>::bt or ::at.
template <int M, int R, bool kInverse>
__device__ __forceinline__ void sandwich(const float (&in)[M + 2][M + 2],
                                         float (&out)[R][R]) {
  constexpr int A = M + 2;
  float t[R][A];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < A; ++j) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < A; ++k) {
        const float c = kInverse ? Wino<M>::at(i, k) : Wino<M>::bt(i, k);
        if (c != 0.f) s = fmaf(c, in[k][j], s);
      }
      t[i][j] = s;
    }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < A; ++k) {
        const float c = kInverse ? Wino<M>::at(j, k) : Wino<M>::bt(j, k);
        if (c != 0.f) s = fmaf(c, t[i][k], s);
      }
      out[i][j] = s;
    }
}

template <int M>
__global__ void __launch_bounds__(kTT * kTX) winograd_kernel(
    const float* __restrict__ x, const float* __restrict__ u,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ out, int N, int H, int W, int Cin, int Cout,
    int relu) {
  constexpr int A = M + 2;
  constexpr int A2 = A * A;
  constexpr int CPT = Wino<M>::CPT;
  constexpr int COB = kTX * CPT;
  __shared__ float Vs[A2][kCK][kTT];
  __shared__ __align__(16) float Us[A2][kCK][COB];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int th = (H + M - 1) / M;
  const int tw = (W + M - 1) / M;
  const int nt = N * th * tw;
  const int t0 = blockIdx.x * kTT;
  const int co0 = blockIdx.y * COB;

  float acc[A2][CPT];
#pragma unroll
  for (int p = 0; p < A2; ++p)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[p][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += kCK) {
    // Input transform: one thread per (tile, channel) of the stage.
    if (tid < kTT * kCK) {
      const int lt = tid / kCK;
      const int lc = tid % kCK;
      const int g = t0 + lt;
      const int c = c0 + lc;
      float d[A][A];
      const bool live = g < nt && c < Cin;
      int n = 0, y0 = 0, x0 = 0;
      if (live) {
        n = g / (th * tw);
        const int r = g - n * th * tw;
        y0 = (r / tw) * M - 1;
        x0 = (r % tw) * M - 1;
      }
#pragma unroll
      for (int i = 0; i < A; ++i)
#pragma unroll
        for (int j = 0; j < A; ++j) {
          const int yy = y0 + i;
          const int xx = x0 + j;
          d[i][j] = (live && yy >= 0 && yy < H && xx >= 0 && xx < W)
                        ? x[(static_cast<size_t>(n * H + yy) * W + xx) * Cin + c]
                        : 0.f;
        }
      float v[A][A];
      sandwich<M, A, false>(d, v);
#pragma unroll
      for (int i = 0; i < A; ++i)
#pragma unroll
        for (int j = 0; j < A; ++j) Vs[i * A + j][lc][lt] = v[i][j];
    }
    // The stage's slice of U[a^2, Cin, Cout]; neighbouring threads take
    // neighbouring output channels.
    for (int idx = tid; idx < A2 * kCK * COB; idx += kTT * kTX) {
      const int p = idx / (kCK * COB);
      const int rem = idx - p * (kCK * COB);
      const int c = rem / COB;
      const int co = rem - c * COB;
      const int ci = c0 + c;
      const int coo = co0 + co;
      Us[p][c][co] = (ci < Cin && coo < Cout)
                         ? u[(static_cast<size_t>(p) * Cin + ci) * Cout + coo]
                         : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kCK; ++c) {
#pragma unroll
      for (int p = 0; p < A2; ++p) {
        const float v = Vs[p][c][ty];
        if constexpr (CPT == 4) {
          const float4 w = *reinterpret_cast<const float4*>(&Us[p][c][tx * 4]);
          acc[p][0] = fmaf(v, w.x, acc[p][0]);
          acc[p][1] = fmaf(v, w.y, acc[p][1]);
          acc[p][2] = fmaf(v, w.z, acc[p][2]);
          acc[p][3] = fmaf(v, w.w, acc[p][3]);
        } else {
          const float2 w = *reinterpret_cast<const float2*>(&Us[p][c][tx * 2]);
          acc[p][0] = fmaf(v, w.x, acc[p][0]);
          acc[p][1] = fmaf(v, w.y, acc[p][1]);
        }
      }
    }
    __syncthreads();
  }

  const int g = t0 + ty;
  if (g >= nt) return;
  const int n = g / (th * tw);
  const int r = g - n * th * tw;
  const int oy0 = (r / tw) * M;
  const int ox0 = (r % tw) * M;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int co = co0 + tx * CPT + j;
    if (co >= Cout) continue;
    float mm[A][A];
#pragma unroll
    for (int p = 0; p < A2; ++p) mm[p / A][p % A] = acc[p][j];
    float y[M][M];
    sandwich<M, M, true>(mm, y);
    const float s = scale[co];
    const float b = bias[co];
#pragma unroll
    for (int oi = 0; oi < M; ++oi)
#pragma unroll
      for (int oj = 0; oj < M; ++oj) {
        const int oy = oy0 + oi;
        const int ox = ox0 + oj;
        if (oy < H && ox < W) {
          float val = y[oi][oj] * s + b;
          if (relu) val = fmaxf(val, 0.f);
          out[(static_cast<size_t>(n * H + oy) * W + ox) * Cout + co] = val;
        }
      }
  }
}

template <int M>
int launch(const float* x, const float* u, const float* scale,
           const float* bias, float* out, int N, int H, int W, int Cin,
           int Cout, int relu, cudaStream_t stream) {
  constexpr int COB = kTX * Wino<M>::CPT;
  const int nt = N * ((H + M - 1) / M) * ((W + M - 1) / M);
  const dim3 grid((nt + kTT - 1) / kTT, (Cout + COB - 1) / COB);
  const dim3 block(kTX, kTT);
  winograd_kernel<M><<<grid, block, 0, stream>>>(x, u, scale, bias, out, N,
                                                 H, W, Cin, Cout, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int winograd_conv3x3_bn(const float* x, const float* u,
                                   const float* scale, const float* bias,
                                   float* out, int N, int H, int W, int Cin,
                                   int Cout, int m, int relu, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (m == 2) return launch<2>(x, u, scale, bias, out, N, H, W, Cin, Cout, relu, s);
  if (m == 4) return launch<4>(x, u, scale, bias, out, N, H, W, Cin, Cout, relu, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
