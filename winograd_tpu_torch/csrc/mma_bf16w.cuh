// The bf16w tile: mma_tf32.cuh's 64 x 64 FP32-output GEMM tile with B held
// in bf16, for the bf16w serving tier (the JAX package's
// kernels/direct.py::split_dot "bf16w"): acc = A[p0.., k0:k1] x B[k0:k1,
// n0..], B (K, N) row-major bf16 weights in device memory, A f32 from any
// of mma_tf32.cuh's A sources (RowMajorA, Im2colA<kStride>).
//
// Arithmetic: each f32 activation a is split as a_hi = bf16(a) and a_lo =
// bf16(a - a_hi) (__float2bfloat16_rn: round to nearest even, as
// jnp.astype and torch.to round), and each k16 step accumulates a_hi * b,
// then a_lo * b, in f32 through mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32.
// A product of two bf16 values is exact in f32, so the error is the f32
// sum's and the split's (~2^-17 relative per product); the weights' own
// bf16 rounding, done offline, sets the tier's error. Two bf16 passes a
// k16 step, where 3xTF32 takes six m16n8k8 passes.
//
// The interface is tf32x3::tile's: the same geometry (128 threads, four
// warps of 32 x 32 outputs, kBK = 32 a stage, a ring of kStages cp.async
// stages), the same A sources and kCg rule, and the same accumulator
// layout (the m16n8k16 and m16n8k8 f32 fragments place C alike), so
// tf32x3::for_each_acc and the epilogues carry over. What differs:
// * B is bf16 in the ring: a stage's B is 32 rows of 64 values padded to
//   kLdB = 72 (144 bytes, so the eight rows an ldmatrix phase reads fall
//   in eight distinct 16-byte bank groups), half the f32 tile's bytes. kVec
//   copies 16 bytes (8 values; N a multiple of 8, B 16-byte aligned);
//   otherwise each value is loaded alone, zero past N and k1, never a copy
//   past a row.
// * The m16n8k16 B fragment pairs two consecutive k of one column in a
//   register, and the ring holds k rows of n-contiguous values: one
//   ldmatrix.x4.trans gives a warp the fragments of two n8 blocks.
// * A stays f32 in the ring, rows padded to kLdA = 40 floats, so a
//   half-warp's 8-byte loads of a fragment's k pair hit 32 distinct banks;
//   the hi/lo split happens as the fragments are formed.
//
// wt::mma_tile picks the tile by the element type of B (float: 3xTF32,
// __nv_bfloat16: this one) and wt::kTileSmemBytes<BT> its ring's bytes, so
// splitk_tf32.cuh's split-K kernel and gemm_phase run either tier
// (csrc/direct.cu, basic_stage.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "mma_tf32.cuh"

namespace wt {
namespace bf16w {

using tf32x3::kBK;
using tf32x3::kBM;
using tf32x3::kBN;
using tf32x3::kStages;
using tf32x3::kThreads;
using Acc = tf32x3::Acc;

constexpr int kLdA = kBK + 8;  // floats a staged A row
constexpr int kLdB = kBN + 8;  // bf16 values a staged B row
constexpr int kStageABytes = static_cast<int>(sizeof(float)) * kBM * kLdA;
constexpr int kStageBytes = kStageABytes + 2 * kBK * kLdB;
constexpr size_t kSmemBytes = static_cast<size_t>(kStages) * kStageBytes;
static_assert(kStageABytes % 16 == 0 && kStageBytes % 16 == 0, "16-byte aligned stage parts");

// (hi, lo) bf16 pairs of two adjacent f32 values, the lower k in the lower
// 16 bits as the mma fragment wants.
__device__ __forceinline__ void split2(float2 v, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v.x - __low2float(h), v.y - __high2float(h));
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 b16 matrices from shared memory, transposed: lanes 8j..8j+7
// name the eight rows of matrix j, and d[j] holds matrix j's elements
// (2 (lane % 4), lane / 4) and (2 (lane % 4) + 1, lane / 4).
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&d)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem_addr(row)));
}

// B[kb .. kb+31, n0 .. n0+63] (bf16) into the stage's B rows.
template <bool kVec>
__device__ __forceinline__ void load_b(unsigned short* sb, const unsigned short* __restrict__ b,
                                       int N, int n0, int kb, int k1) {
  const int tid = threadIdx.x;
  if (kVec) {
#pragma unroll
    for (int i = 0; i < kBK * kBN / 8 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (kBN / 8), c = idx % (kBN / 8) * 8;
      const bool ok = kb + r < k1 && n0 + c < N;
      cp_async16(sb + r * kLdB + c, ok ? b + static_cast<size_t>(kb + r) * N + n0 + c : b, ok);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kBK * kBN / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kBN, c = idx % kBN;
      const bool ok = kb + r < k1 && n0 + c < N;
      sb[r * kLdB + c] = ok ? __ldg(b + static_cast<size_t>(kb + r) * N + n0 + c) : 0;
    }
  }
}

// The warp (wm, wn) multiplies its 32 x 32 outputs over one stage.
__device__ __forceinline__ void mma_stage(const float* sa, const unsigned short* sb, Acc& acc,
                                          int wm, int wn) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // This lane's row of the ldmatrix: matrix lane / 8 is (k half, n8 block)
  // = (j % 2, j / 2) of an n8 pair, its row lane % 8.
  const int j = lane / 8;
  const unsigned short* brow = sb + ((j % 2) * 8 + lane % 8) * kLdB + wn * 32 + (j / 2) * 8;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    unsigned ah[2][4], al[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float* r0 = sa + (wm * 32 + mi * 16 + g) * kLdA + kk + 2 * t;
      const float* r8 = r0 + 8 * kLdA;
      split2(*reinterpret_cast<const float2*>(r0), ah[mi][0], al[mi][0]);
      split2(*reinterpret_cast<const float2*>(r8), ah[mi][1], al[mi][1]);
      split2(*reinterpret_cast<const float2*>(r0 + 8), ah[mi][2], al[mi][2]);
      split2(*reinterpret_cast<const float2*>(r8 + 8), ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      unsigned d[4];
      ldmatrix_x4_trans(d, brow + kk * kLdB + np * 16);
      b[2 * np][0] = d[0];
      b[2 * np][1] = d[1];
      b[2 * np + 1][0] = d[2];
      b[2 * np + 1][1] = d[3];
    }
    // a_hi * b over all eight fragments, then a_lo * b: each accumulator
    // adds its hi product, then its lo product.
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], ah[mi], b[ni]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], al[mi], b[ni]);
  }
}

// tf32x3::tile with bf16 B: acc = A[p0.., k0:k1] x B[k0:k1, n0..] for the
// block's 64 x 64 tile; smem: kSmemBytes, 16-byte aligned. kVec: A's
// 16-byte copies (K a multiple of 4, A 16-byte aligned) and B's (N a
// multiple of 8, B 16-byte aligned). Ends with every copy landed and a
// __syncthreads, so the caller may reuse the ring.
template <bool kVec, bool kCg, class ASrc>
__device__ __forceinline__ void tile(const ASrc& a, const __nv_bfloat16* __restrict__ b, int N,
                                     int p0, int n0, int k0, int k1, float* smem, Acc& acc) {
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  char* ring = reinterpret_cast<char*>(smem);
  const auto* bu = reinterpret_cast<const unsigned short*>(b);
  const auto load = [&](char* st, int kb) {
    tf32x3::load_a<kVec, kCg, ASrc, kLdA>(reinterpret_cast<float*>(st), a, p0, kb, k1);
    load_b<kVec>(reinterpret_cast<unsigned short*>(st + kStageABytes), bu, N, n0, kb, k1);
  };
  const int steps = (k1 - k0 + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(ring + s * kStageBytes, k0 + s * kBK);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `it` landed for all; slot (it - 1) is free
    const int next = it + kStages - 1;
    if (next < steps) load(ring + (next % kStages) * kStageBytes, k0 + next * kBK);
    cp_async_commit();
    const char* st = ring + (it % kStages) * kStageBytes;
    mma_stage(reinterpret_cast<const float*>(st),
              reinterpret_cast<const unsigned short*>(st + kStageABytes), acc, wm, wn);
  }
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace bf16w

// The tile of a B element type: f32 weights on tf32x3's 3xTF32 tile, bf16
// weights on the bf16w tile; both leave the same accumulators.
template <bool kVec, bool kCg, class ASrc>
__device__ __forceinline__ void mma_tile(const ASrc& a, const float* __restrict__ b, int N,
                                         int p0, int n0, int k0, int k1, float* smem,
                                         tf32x3::Acc& acc) {
  tf32x3::tile<kVec, kCg>(a, b, N, p0, n0, k0, k1, smem, acc);
}

template <bool kVec, bool kCg, class ASrc>
__device__ __forceinline__ void mma_tile(const ASrc& a, const __nv_bfloat16* __restrict__ b,
                                         int N, int p0, int n0, int k0, int k1, float* smem,
                                         tf32x3::Acc& acc) {
  bf16w::tile<kVec, kCg>(a, b, N, p0, n0, k0, k1, smem, acc);
}

// Dynamic shared memory of mma_tile's ring for B elements of type BT.
template <class BT>
constexpr size_t kTileSmemBytes = tf32x3::kSmemBytes;
template <>
constexpr size_t kTileSmemBytes<__nv_bfloat16> = bf16w::kSmemBytes;

}  // namespace wt
