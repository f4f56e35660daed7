// The f32 A operand of the 64 x 64 GEMM tiles in 3xTF32 (wgmma_tile.cuh's
// wgmma tile, and through it every f32 and bf16w GEMM of the port): the A
// sources, which name for a row p and a k the address of A[p, k] or "zero"
// (RowMajorA: a (P, K) matrix; Im2colA: the implicit im2col of a pad-1 3x3
// at stride 1 or 2, zero where the window leaves the map), the cp.async
// loader that stages a tile's 64 rows of a 32-deep stage into shared
// memory, and the hi/lo split of 3xTF32.
//
// 3xTF32: every operand x is split as hi = tf32(x) (cvt.rna, 10 explicit
// mantissa bits) and lo = tf32(x - hi), and each k step accumulates
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in f32. The dropped a_lo*b_lo term and
// the two roundings of the split leave about 2^-21 relative error per
// product, FP32 level, where one TF32 product (2^-11) misses the port's
// 1e-4 bar.
//
// Geometry: 64 x 64 tiles of 128 threads, K in stages of kBK = 32 floats; A
// rows padded to kLdA = 36 floats in shared memory, so the fragment loads of
// a warp hit 32 distinct banks. kVec selects 16-byte copies (K a multiple of
// 4, A 16-byte aligned; the A source's four floats from a k that is a
// multiple of 4 lie in one row of memory) or 4-byte ones (any shape); both
// zero-fill past k1 and where the A source says zero. The 16-byte copies
// bypass L1 (cp.async.cg); the 4-byte cp.async exists only through L1, so
// an A written earlier in the same launch (kCg: a persistent kernel's
// activation, behind a grid barrier) takes 4-byte __ldcg loads stored to
// shared memory instead.
#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace wt {
namespace tf32x3 {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 128;
constexpr int kLdA = kBK + 4;

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// A row-major (P, K) matrix as an A source: at(p, k) is the address of
// A[p, k], or null past P; base() a global address of A for the zero-filling
// copies, which read nothing. (The caller keeps k < K.)
struct RowMajorA {
  const float* __restrict__ a;
  int P, K;
  __device__ __forceinline__ const float* base() const { return a; }
  __device__ __forceinline__ const float* at(int p, int k) const {
    return p < P ? a + static_cast<size_t>(p) * K + k : nullptr;
  }
};

// The pad-1 3x3 im2col rows of an (N, H, W, C) map at stride kStride as an
// A source: row p = (n, oy, ox) of the (N, ceil(H / kStride), ceil(W /
// kStride)) output and k = (3r + s) * C + c take the input value at
// (kStride oy + r - 1, kStride ox + s - 1); at(p, k) is its address, or null
// past P or where the window leaves the map (stride 2 is the transition's
// SAME 3x3). A brace-initialised Im2colA{...} is the stride-1 source.
template <int kStride = 1>
struct Im2colA {
  const float* __restrict__ x;
  int H, W, C, P;
  __device__ __forceinline__ const float* base() const { return x; }
  __device__ __forceinline__ const float* at(int p, int k) const {
    if (p >= P) return nullptr;
    const int rs = k / C;
    const int c = k - rs * C;
    const int ho = (H + kStride - 1) / kStride, wo = (W + kStride - 1) / kStride;
    const int hw = ho * wo;
    const int n = p / hw;
    const int q = p - n * hw;
    const int y = q / wo * kStride + rs / 3 - 1;
    const int xx = q % wo * kStride + rs % 3 - 1;
    if (y < 0 || y >= H || xx < 0 || xx >= W) return nullptr;
    return x + (static_cast<size_t>(n * H + y) * W + xx) * C + c;
  }
};
Im2colA(const float*, int, int, int, int) -> Im2colA<1>;

template <class ASrc>
__device__ __forceinline__ const float* a_source(const ASrc& a, int p, int k, int k1) {
  return k < k1 ? a.at(p, k) : nullptr;
}

// A[p0 .. p0+63, kb .. kb+31] into the stage's A rows, kLd floats apart;
// kCg: A was written earlier in the launch (4-byte loads through L2 only).
template <bool kVec, bool kCg, class ASrc, int kLd = kLdA>
__device__ __forceinline__ void load_a(float* sa, const ASrc& a, int p0, int kb, int k1) {
  const int tid = threadIdx.x;
  if (kVec) {
#pragma unroll
    for (int i = 0; i < kBM * kBK / 4 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (kBK / 4), c = idx % (kBK / 4) * 4;
      const float* src = a_source(a, p0 + r, kb + c, k1);
      cp_async16(sa + r * kLd + c, src ? src : a.base(), src != nullptr);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kBK, c = idx % kBK;
      const float* src = a_source(a, p0 + r, kb + c, k1);
      if (kCg)
        sa[r * kLd + c] = src ? __ldcg(src) : 0.f;
      else
        cp_async4(sa + r * kLd + c, src ? src : a.base(), src != nullptr);
    }
  }
}

}  // namespace tf32x3
}  // namespace wt
