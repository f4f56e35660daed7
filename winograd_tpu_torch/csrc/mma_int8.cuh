// The int8 tier's mma.sync pieces, on the int8 tensor cores: the s8
// m16n8k32 warp tile of csrc/pointwise_int8.cu's one pass (64 x 64 tiles, 8
// warps of 32 x 16 outputs, each k step of 32 one
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32 per 16 x 8 fragment, operands in
// shared memory rows of `ld` bytes), and the byte work the int8 kernels
// share: quantizing four values into a word, reading four weight rows of
// four columns (rows4) and turning them k-contiguous (transpose4: the
// layout of __dp4a's and mma.sync's B, and of the cluster kernels' K-major
// wgmma operand), and the weight transpose items of csrc/stage_int8.cu's
// first phase (Transpose).
//
// The arithmetic is gemm_int8.cuh's (per-row scale s = max|row| / 127 by
// IEEE division, 1 for a zero row; q = clamp(rint(a / s), -127, 127); the
// product summed exactly in int32; the epilogue's multiplies and adds
// rounded one by one), so a kernel built on it agrees with the plain twins
// of kernels/quantized.py to the bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_int8.cuh"

namespace wt {
namespace s8mma {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kThreads = 256;
constexpr int kKAlign = 32;  // K of the quantized operands is padded to this

using Acc = int[2][2][4];

__device__ __forceinline__ void mma(int (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// Four values quantized by scale s, packed four k to a word.
__device__ __forceinline__ unsigned quantize4(const float4& v, float s) {
  return static_cast<unsigned>(
      pack4(quantize(v.x, s), quantize(v.y, s), quantize(v.z, s), quantize(v.w, s)));
}

// Four rows' words (word i: columns c = 0..3 of row i, one byte each) as
// four columns' words (word c: rows i = 0..3 of column c): the k-contiguous
// layout of __dp4a's and mma.sync's B operand.
__device__ __forceinline__ void transpose4(const unsigned (&r)[4], unsigned (&c)[4]) {
  const unsigned t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[2], r[3], 0x5140);
  const unsigned t2 = __byte_perm(r[0], r[1], 0x7362), t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

// Rows k .. k+3 of a row-major (K, N) int8 matrix w at columns n .. n+3,
// one word a row, zero past K and N; kVec: N % 4 == 0 and w 4-byte aligned.
template <bool kVec>
__device__ __forceinline__ void rows4(const int8_t* __restrict__ w, int K, int N, int k, int n,
                                      unsigned (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int8_t* row = w + static_cast<size_t>(k + i) * N + n;
    r[i] = 0u;
    if (k + i >= K) continue;
    if (kVec) {
      if (n < N) r[i] = __ldg(reinterpret_cast<const unsigned*>(row));
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (n + c < N)
          r[i] |= static_cast<unsigned>(static_cast<uint8_t>(__ldg(row + c))) << (8 * c);
    }
  }
}

// mma.sync's m16n8k32 fragments from shared memory (rows of ld bytes, k
// from byte ks): A of rows r0 .. r0+15, B of columns (k-contiguous rows of
// sb) n0 .. n0+7.
__device__ __forceinline__ void frag_a(const int8_t* sa, int ld, int r0, int ks, unsigned (&a)[4]) {
  const int lane = threadIdx.x % 32;
  const int8_t* r = sa + (r0 + lane / 4) * ld + ks + 4 * (lane % 4);
  a[0] = ld32(r);
  a[1] = ld32(r + 8 * ld);
  a[2] = ld32(r + 16);
  a[3] = ld32(r + 8 * ld + 16);
}

__device__ __forceinline__ void frag_b(const int8_t* sb, int ld, int n0, int ks, unsigned (&b)[2]) {
  const int lane = threadIdx.x % 32;
  const int8_t* c = sb + (n0 + lane / 4) * ld + ks + 4 * (lane % 4);
  b[0] = ld32(c);
  b[1] = ld32(c + 16);
}

// The transpose of (K, N) int8 weights b into bt (N, Kp), k-contiguous, zero
// for K <= k < Kp, cut into items of sixteen k: of four columns each, one
// 4-byte load a k, where N % 4 == 0 and b is 4-byte aligned (vec), else of
// one column.
struct Transpose {
  const int8_t* __restrict__ b;
  int K, N, Kp;
  int8_t* bt;
  __device__ __forceinline__ bool vec() const {
    return N % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 4 == 0;
  }
  __device__ __forceinline__ long long items() const {
    return static_cast<long long>(Kp / 16) * (vec() ? N / 4 : N);
  }
  __device__ __forceinline__ void item(long long i) const {
    if (vec()) {
      const int n4s = N / 4;
      const int kg = static_cast<int>(i / n4s), n4 = static_cast<int>(i % n4s);
      unsigned w[4][4] = {};  // [column][word]
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int k = kg * 16 + j;
        const unsigned v =
            k < K ? __ldg(reinterpret_cast<const unsigned*>(b + static_cast<size_t>(k) * N) + n4)
                  : 0u;
#pragma unroll
        for (int c = 0; c < 4; ++c) w[c][j / 4] |= ((v >> (8 * c)) & 0xffu) << (8 * (j % 4));
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<uint4*>(bt + static_cast<size_t>(4 * n4 + c) * Kp + kg * 16) =
            make_uint4(w[c][0], w[c][1], w[c][2], w[c][3]);
      return;
    }
    const int kg = static_cast<int>(i / N), n = static_cast<int>(i % N);
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int k = kg * 16 + j;
      const unsigned v =
          k < K ? static_cast<unsigned char>(__ldg(b + static_cast<size_t>(k) * N + n)) : 0u;
      w[j / 4] |= v << (8 * (j % 4));
    }
    *reinterpret_cast<uint4*>(bt + static_cast<size_t>(n) * Kp + kg * 16) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// The warp (wm, wn) multiplies its 32 x 16 outputs over the 32 k from byte
// ks of the rows of sa and sb (shared memory, rows of ld bytes).
__device__ __forceinline__ void mma_k32(const int8_t* sa, const int8_t* sb, int ld, int ks,
                                        Acc& acc, int wm, int wn) {
  unsigned a[2][4], b[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) frag_a(sa, ld, wm * 32 + mi * 16, ks, a[mi]);
#pragma unroll
  for (int ni = 0; ni < 2; ++ni) frag_b(sb, ld, wn * 16 + ni * 8, ks, b[ni]);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) mma(acc[mi][ni], a[mi], b[ni]);
}

// The row and column, relative to the tile's corner, of this thread's
// accumulator acc[mi][ni][e].
__device__ __forceinline__ int acc_row(int mi, int e) {
  return threadIdx.x / 32 / 4 * 32 + threadIdx.x % 32 / 4 + mi * 16 + e / 2 * 8;
}
__device__ __forceinline__ int acc_col(int ni, int e) {
  return threadIdx.x / 32 % 4 * 16 + threadIdx.x % 4 * 2 + ni * 8 + e % 2;
}

// Calls f(row, col, value) for each of the thread's 16 accumulators.
template <class F>
__device__ __forceinline__ void for_each_acc(const Acc& acc, const F& f) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) f(acc_row(mi, e), acc_col(ni, e), acc[mi][ni][e]);
}

}  // namespace s8mma
}  // namespace wt
