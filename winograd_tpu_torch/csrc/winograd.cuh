// The Winograd F(m,3) matrices (Wino<M>, m = 2 or 4), the sandwich T in T^T
// of their nonzero entries, and the FP64 tile body of the F(2,3) routes
// that must match a float64 plain version to the bit.
//
// wino_tile: one work item computes TT tiles x kWinoTX * CPT output
// channels of a 3x3 conv (stride 1, pad 1) + folded BN (+ ReLU), for every
// tile position, with the whole Winograd chain on chip:
//   V = Bt d Bt^T per (m+2)^2 input tile and channel,
//   M[p] = V[p] U[p] per tile position p,
//   Y = At M At^T, then y = Y * scale + bias (+ ReLU), stored clipped at the
//   right and bottom edges when m does not divide the map.
// The transforms, the products and their sums run in FP64 (TA = double)
// and each output is rounded to float once, before a BN whose multiply and
// add round separately. That makes the result independent of the order of
// the sums (to a last-bit tie in FP64), so a plain version computing the
// same algebra in float64 matches it to the bit; the int8 tier needs that,
// because its next layer's quantization turns any last-bit difference into
// a whole quantization step. CPT = 2 output channels per thread (the FP64
// accumulators' registers).
//
// Used by csrc/winograd.cu's F(2,3) on bf16 filters (TT = 8, 128 threads
// per block) and by the int8 stage's winograd2 mid-layer
// (csrc/stage_int8.cu, TT = 16, 256 threads). Thread `tid` of the item
// takes tile tid / kWinoTX and output channels (tid % kWinoTX) * CPT ..
// + CPT. Input channels are consumed in stages of kWinoCK: the input
// transform runs one thread per (tile, channel) of the stage, in registers
// with the constant matrices folded in at compile time, and stages V and
// the matching slice of U in shared memory (wino_smem_bytes, 16-byte
// aligned). The input is read through the functor `Load` (`float ld(const
// float* p)`), so a kernel that produced it in the same launch can bypass
// L1. The filter U (float or __nv_bfloat16) is widened to float as it is
// staged. The f32 Winograd (csrc/wino_tf32.cuh) shares only the matrices
// and the sandwich.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

namespace wt {

constexpr int kWinoTX = 16;  // output-channel groups per item
constexpr int kWinoCK = 8;   // input channels per shared-memory stage

template <int M>
struct Wino;

template <>
struct Wino<2> {
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

// Shared memory of wino_tile with arithmetic type TA and CPT channels per
// thread: V in TA, the U stage in float.
template <int M, int TT, class TA, int CPT>
__host__ __device__ constexpr int wino_smem_bytes() {
  return (M + 2) * (M + 2) * kWinoCK * (TT * static_cast<int>(sizeof(TA)) + 4 * kWinoTX * CPT);
}

__device__ __forceinline__ float mul_add(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mul_add(double a, double b, double c) { return fma(a, b, c); }

// out = T in T^T for a constant R x C matrix T (C = M + 2), zero terms
// skipped at compile time. `T(i, k)` is Wino<M>::bt or ::at.
template <int M, int R, bool kInverse, class T>
__device__ __forceinline__ void sandwich(const T (&in)[M + 2][M + 2], T (&out)[R][R]) {
  constexpr int A = M + 2;
  T t[R][A];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < A; ++j) {
      T s = 0;
#pragma unroll
      for (int k = 0; k < A; ++k) {
        const float c = kInverse ? Wino<M>::at(i, k) : Wino<M>::bt(i, k);
        if (c != 0.f) s = mul_add(T(c), in[k][j], s);
      }
      t[i][j] = s;
    }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      T s = 0;
#pragma unroll
      for (int k = 0; k < A; ++k) {
        const float c = kInverse ? Wino<M>::at(j, k) : Wino<M>::bt(j, k);
        if (c != 0.f) s = mul_add(T(c), t[i][k], s);
      }
      out[i][j] = s;
    }
}

struct PlainLoad {
  __device__ __forceinline__ float operator()(const float* p) const { return *p; }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// wino_tile's default observer of its outputs: none.
struct NoRowMax {
  static constexpr bool kOn = false;
  __device__ __forceinline__ void operator()(int, int, unsigned) const {}
};

// Tiles t0 .. t0 + TT - 1 (row-major over N x ceil(H/M) x ceil(W/M)) and
// output channels co0 .. co0 + COB - 1 (COB = kWinoTX * CPT), by threads
// 0 .. TT * kWinoTX - 1; smem holds wino_smem_bytes<M, TT, TA, CPT>().
// An observer with kOn (the int8 stage's) is called once per output pixel
// by the pixel's thread tx = 0 as obs(pixel, co0, m), m the bits of the
// largest |value| the item stored at that pixel (as an unsigned int, a
// NaN above every number); the arithmetic is the same either way.
template <int M, int TT, class Load, class TU, class TA, int CPT, class Obs = NoRowMax>
__device__ __forceinline__ void wino_tile(
    const Load& ld, const float* x, const TU* __restrict__ u,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* out, int N, int H, int W, int Cin, int Cout, int relu, int t0,
    int co0, int tid, float* smem, const Obs& obs = Obs{}) {
  static_assert(std::is_same<TA, double>::value && CPT == 2, "the FP64 routes' tile");
  constexpr int A = M + 2;
  constexpr int A2 = A * A;
  constexpr int COB = kWinoTX * CPT;
  TA(*Vs)[kWinoCK][TT] = reinterpret_cast<TA(*)[kWinoCK][TT]>(smem);
  float(*Us)[kWinoCK][COB] = reinterpret_cast<float(*)[kWinoCK][COB]>(
      reinterpret_cast<char*>(smem) + sizeof(TA) * A2 * kWinoCK * TT);

  const int tx = tid % kWinoTX;
  const int ty = tid / kWinoTX;
  const int th = (H + M - 1) / M;
  const int tw = (W + M - 1) / M;
  const int nt = N * th * tw;

  TA acc[A2][CPT];
#pragma unroll
  for (int p = 0; p < A2; ++p)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[p][j] = 0;

  for (int c0 = 0; c0 < Cin; c0 += kWinoCK) {
    // Input transform: one thread per (tile, channel) of the stage.
    if (tid < TT * kWinoCK) {
      const int lt = tid / kWinoCK;
      const int lc = tid % kWinoCK;
      const int g = t0 + lt;
      const int c = c0 + lc;
      TA d[A][A];
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
                        ? ld(&x[(static_cast<size_t>(n * H + yy) * W + xx) * Cin + c])
                        : 0.f;
        }
      TA v[A][A];
      sandwich<M, A, false>(d, v);
#pragma unroll
      for (int i = 0; i < A; ++i)
#pragma unroll
        for (int j = 0; j < A; ++j) Vs[i * A + j][lc][lt] = v[i][j];
    }
    // The stage's slice of U[a^2, Cin, Cout]; neighbouring threads take
    // neighbouring output channels.
    for (int idx = tid; idx < A2 * kWinoCK * COB; idx += TT * kWinoTX) {
      const int p = idx / (kWinoCK * COB);
      const int rem = idx - p * (kWinoCK * COB);
      const int c = rem / COB;
      const int co = rem - c * COB;
      const int ci = c0 + c;
      const int coo = co0 + co;
      Us[p][c][co] = (ci < Cin && coo < Cout)
                         ? to_float(u[(static_cast<size_t>(p) * Cin + ci) * Cout + coo])
                         : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kWinoCK; ++c) {
#pragma unroll
      for (int p = 0; p < A2; ++p) {
        const TA v = Vs[p][c][ty];
        const float2 w = *reinterpret_cast<const float2*>(&Us[p][c][tx * 2]);
        acc[p][0] = mul_add(v, TA(w.x), acc[p][0]);
        acc[p][1] = mul_add(v, TA(w.y), acc[p][1]);
      }
    }
    __syncthreads();
  }

  const int g = t0 + ty;
  if (!Obs::kOn && g >= nt) return;
  const bool live = g < nt;  // the observer's lanes all reach its shuffles
  const int n = g / (th * tw);
  const int r = g - n * th * tw;
  const int oy0 = (r / tw) * M;
  const int ox0 = (r % tw) * M;
  unsigned amax[M][M];
#pragma unroll
  for (int oi = 0; oi < M; ++oi)
#pragma unroll
    for (int oj = 0; oj < M; ++oj) amax[oi][oj] = 0u;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int co = co0 + tx * CPT + j;
    if (co >= Cout) continue;
    TA mm[A][A];
#pragma unroll
    for (int p = 0; p < A2; ++p) mm[p / A][p % A] = acc[p][j];
    TA y[M][M];
    sandwich<M, M, true>(mm, y);
    const float s = scale[co];
    const float b = bias[co];
#pragma unroll
    for (int oi = 0; oi < M; ++oi)
#pragma unroll
      for (int oj = 0; oj < M; ++oj) {
        const int oy = oy0 + oi;
        const int ox = ox0 + oj;
        if (live && oy < H && ox < W) {
          float val = __fadd_rn(__fmul_rn(static_cast<float>(y[oi][oj]), s), b);
          if (relu) val = wt::relu(val);
          out[(static_cast<size_t>(n * H + oy) * W + ox) * Cout + co] = val;
          if (Obs::kOn) amax[oi][oj] = max(amax[oi][oj], __float_as_uint(val) & 0x7fffffffu);
        }
      }
  }
  if constexpr (Obs::kOn) {
#pragma unroll
    for (int oi = 0; oi < M; ++oi)
#pragma unroll
      for (int oj = 0; oj < M; ++oj) {
        unsigned m = amax[oi][oj];
#pragma unroll
        for (int o = 1; o < kWinoTX; o <<= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
        const int oy = oy0 + oi, ox = ox0 + oj;
        if (tx == 0 && live && oy < H && ox < W) obs((n * H + oy) * W + ox, co0, m);
      }
  }
}

}  // namespace wt
