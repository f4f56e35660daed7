// A 64 x 64 FP32 GEMM tile on the tensor cores in 3xTF32, fed by a ring of
// cp.async stages: acc = A[p0.., k0:k1] x B[k0:k1, n0..] with B (K, N)
// row-major in device memory and A given by a source that names, for a row
// p and a k, the address of A[p, k] or "zero" (RowMajorA: a (P, K) matrix;
// Im2colA: the implicit im2col of a pad-1 3x3 at stride 1 or 2, zero where
// the window leaves the map).
//
// 3xTF32: every operand x is split as hi = tf32(x) (cvt.rna, 10 explicit
// mantissa bits) and lo = tf32(x - hi), and each k step accumulates
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in f32 through
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32. The dropped a_lo*b_lo term
// and the two roundings of the split leave about 2^-21 relative error per
// product, FP32 level, where one TF32 product (2^-11) misses the port's
// 1e-4 bar.
//
// Tile: 128 threads, four warps of 32 x 32 outputs (2 m16 x 4 n8
// fragments, 32 f32 accumulators a thread); K in steps of kBK = 32 floats,
// kStages stages in dynamic shared memory (kSmemBytes, above the 48 KB of
// static shared memory: the kernel needs cudaFuncSetAttribute). A rows are
// padded to 36 floats and B rows to 72, so the fragment loads of a warp hit
// 32 distinct banks. kVec selects 16-byte copies (K and N multiples of 4,
// operands 16-byte aligned; the A source's four floats from a k that is a
// multiple of 4 lie in one row of memory) or 4-byte ones (any shape); both
// zero-fill past N and k1 and where the A source says zero. The 16-byte
// copies bypass L1 (cp.async.cg); the 4-byte cp.async exists only through
// L1, so an A written earlier in the same launch (kCg: a persistent
// kernel's activation, behind a grid barrier) takes 4-byte __ldcg loads
// stored to shared memory instead.
//
// Used by csrc/direct.cu (through splitk_tf32.cuh's split-K kernel). The
// bf16w tile (mma_bf16w.cuh) and the wgmma tile (wgmma_tile.cuh, also the
// Winograd products of wino_tf32.cuh, whose A is V = Bt d Bt^T read from
// the workspace its V phase wrote) take its A sources and A loader.
#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace wt {
namespace tf32x3 {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kStages = 4;
constexpr int kThreads = 128;
constexpr int kLdA = kBK + 4;
constexpr int kLdB = kBN + 8;
constexpr int kStageFloats = kBM * kLdA + kBK * kLdB;
constexpr size_t kSmemBytes = sizeof(float) * kStages * kStageFloats;

using Acc = float[2][4][4];

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

// B[kb .. kb+31, n0 .. n0+63] into the stage's B rows.
template <bool kVec>
__device__ __forceinline__ void load_b(float* sb, const float* __restrict__ b, int N, int n0,
                                       int kb, int k1) {
  const int tid = threadIdx.x;
  if (kVec) {
#pragma unroll
    for (int i = 0; i < kBK * kBN / 4 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (kBN / 4), c = idx % (kBN / 4) * 4;
      const bool ok = kb + r < k1 && n0 + c < N;
      cp_async16(sb + r * kLdB + c, ok ? b + static_cast<size_t>(kb + r) * N + n0 + c : b, ok);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kBK * kBN / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kBN, c = idx % kBN;
      const bool ok = kb + r < k1 && n0 + c < N;
      cp_async4(sb + r * kLdB + c, ok ? b + static_cast<size_t>(kb + r) * N + n0 + c : b, ok);
    }
  }
}

// The warp (wm, wn) multiplies its 32 x 32 outputs over one stage.
__device__ __forceinline__ void mma_stage(const float* sa, const float* sb, Acc& acc, int wm,
                                          int wn) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 8) {
    unsigned ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float* r0 = sa + (wm * 32 + mi * 16 + g) * kLdA + kk + t;
      const float* r8 = r0 + 8 * kLdA;
      split(r0[0], ah[mi][0], al[mi][0]);
      split(r8[0], ah[mi][1], al[mi][1]);
      split(r0[4], ah[mi][2], al[mi][2]);
      split(r8[4], ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const float* c0 = sb + (kk + t) * kLdB + wn * 32 + ni * 8 + g;
      split(c0[0], bh[ni][0], bl[ni][0]);
      split(c0[4 * kLdB], bh[ni][1], bl[ni][1]);
    }
    // One pass of the three over all eight fragments before the next: the
    // products of a pass land in eight independent accumulators and
    // pipeline; each accumulator still sums lo*hi, hi*lo, hi*hi in order.
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], al[mi], bh[ni]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], ah[mi], bl[ni]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], ah[mi], bh[ni]);
  }
}

// acc = A[p0.., k0:k1] x B[k0:k1, n0..] for the block's 64 x 64 tile, A
// through the source `a` (kCg: written earlier in the launch), over stages
// kBK deep (the last one shorter) on a ring of kStages; smem: kSmemBytes,
// 16-byte aligned. Ends with every copy landed and a __syncthreads, so the
// caller may reuse the ring.
template <bool kVec, bool kCg, class ASrc>
__device__ __forceinline__ void tile(const ASrc& a, const float* __restrict__ b, int N, int p0,
                                     int n0, int k0, int k1, float* smem, Acc& acc) {
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // Stage kb's A and B rows into the ring slot at st (the 4-byte kCg loads
  // of A are plain shared stores, visible after the next __syncthreads).
  const auto load = [&](float* st, int kb) {
    load_a<kVec, kCg>(st, a, p0, kb, k1);
    load_b<kVec>(st + kBM * kLdA, b, N, n0, kb, k1);
  };
  const int steps = (k1 - k0 + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(smem + s * kStageFloats, k0 + s * kBK);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `it` landed for all; slot (it - 1) is free
    const int next = it + kStages - 1;
    if (next < steps) load(smem + (next % kStages) * kStageFloats, k0 + next * kBK);
    cp_async_commit();
    const float* st = smem + (it % kStages) * kStageFloats;
    mma_stage(st, st + kBM * kLdA, acc, wm, wn);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Calls f(row, col, value) for each of the thread's 32 accumulators, with
// row and col relative to the tile's corner.
template <class F>
__device__ __forceinline__ void for_each_acc(const Acc& acc, const F& f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp / 2 * 32 + lane / 4, c0 = warp % 2 * 32 + lane % 4 * 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(r0 + mi * 16 + e / 2 * 8, c0 + ni * 8 + e % 2, acc[mi][ni][e]);
}

}  // namespace tf32x3
}  // namespace wt
