// The int8 GEMM tile of the quantized serving tier, and the phase walker the
// persistent int8 kernels run it with.
//
// What every int8 layer computes (winograd_tpu/kernels/quantized.py::_qdot):
// each row of the f32 activation matrix A gets its own symmetric scale,
//   s_x[p] = max_k |A[p, k]| / 127   (1 where the row is all zero),
//   q[p, k] = clamp(rint(A[p, k] / s_x[p]), -127, 127)   (IEEE division,
//   round half to even; never built with --use_fast_math),
// the product q x B (B int8, (K, N) row-major, quantized offline per column
// with scale s_w[n]) is summed exactly in int32, and the epilogue sees
//   float(acc) * (s_x[p] * s_w[n]),
// then applies the folded BN and the rest. Because the int32 sum is exact,
// a K split adds its partial sums in any order and the f32 epilogue runs
// once per element after the sum. The epilogue rounds each multiply and add
// on its own (dequant, bn_rn: no FMA contraction), in the order of the plain
// version (kernels/quantized.py), so the two agree to the bit.
//
// Tile: 64 x 64 outputs per block of 256 threads, 4 x 4 per thread, K in
// steps of 64 staged in shared memory. A is quantized as it is loaded
// (through a loader functor `float a(int p, int k)`, zero past the ragged
// edge), both operands are packed four k to a 32-bit word, and each thread
// runs 16 __dp4a (four int8 MACs into int32) per word pair. The tile's row
// scales live in shared memory: the persistent kernels compute them in a
// sub-phase of their own behind a grid barrier (row_scales_phase), then
// copy the tile's rows.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_sync.cuh"

namespace wt {

constexpr int kBK8 = 64;              // k per shared-memory stage
constexpr int kW8 = kBK8 / 4;         // packed words per stage
constexpr int kInt8SmemBytes = 4 * (2 * kW8 * kBM + kBM);

__device__ __forceinline__ float scale_from_max(float m) {
  const float s = m / 127.f;
  return s == 0.f ? 1.f : s;
}

__device__ __forceinline__ int quantize(float v, float s) {
  const int q = static_cast<int>(rintf(v / s));
  return min(127, max(-127, q));
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// The scale of row p over k in [k0, k0 + klen), by one warp.
template <class ALoad>
__device__ __forceinline__ float warp_row_scale(const ALoad& a, int p, int k0, int klen) {
  float m = 0.f;
  for (int k = threadIdx.x % 32; k < klen; k += 32) m = fmaxf(m, fabsf(a(p, k0 + k)));
  return scale_from_max(warp_max(m));
}

// Every row's scale over k in [g * klen, (g + 1) * klen) into
// out[p * groups + g], for g < groups, rows dealt to all warps of the grid.
// The caller places the barrier after it.
template <class ALoad>
__device__ __forceinline__ void row_scales_phase(const ALoad& a, int P, int klen,
                                                 int groups, float* out) {
  const int warps = gridDim.x * (kGemmThreads / 32);
  for (int item = blockIdx.x * (kGemmThreads / 32) + threadIdx.x / 32; item < P * groups;
       item += warps) {
    const int p = item / groups;
    const int g = item - p * groups;
    const float s = warp_row_scale(a, p, g * klen, klen);
    if (threadIdx.x % 32 == 0) out[item] = s;
  }
}

__device__ __forceinline__ int pack4(int q0, int q1, int q2, int q3) {
  return (q0 & 0xff) | ((q1 & 0xff) << 8) | ((q2 & 0xff) << 16) |
         (static_cast<int>(static_cast<unsigned>(q3 & 0xff) << 24));
}

// acc = q(A[p0.., k0:k1]) x B[k0:k1, n0..] for the 64 x 64 tile, with the
// tile's row scales in sx[64] (shared memory). smem: kInt8SmemBytes - 256
// bytes, 16-byte aligned.
template <class ALoad>
__device__ __forceinline__ void int8_tile(const ALoad& a_at, const int8_t* __restrict__ b,
                                          const float* sx, int P, int N, int p0, int n0,
                                          int k0, int k1, int* smem, int (&acc)[4][4]) {
  int(*As)[kBM] = reinterpret_cast<int(*)[kBM]>(smem);
  int(*Bs)[kBN] = reinterpret_cast<int(*)[kBN]>(smem + kW8 * kBM);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int kk = k0; kk < k1; kk += kBK8) {
    {  // A: thread takes row tid / 4 and the 16 k of words (tid % 4) * 4 ...
      const int r = tid / 4;
      const int p = p0 + r;
      const float s = sx[r];
#pragma unroll
      for (int wv = 0; wv < 4; ++wv) {
        const int w = (tid % 4) * 4 + wv;
        int q[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = kk + 4 * w + e;
          q[e] = (p < P && k < k1) ? quantize(a_at(p, k), s) : 0;
        }
        As[w][r] = pack4(q[0], q[1], q[2], q[3]);
      }
    }
    {  // B: thread takes column tid % 64 and words (tid / 64) * 4 ...
      const int c = tid % 64;
      const int n = n0 + c;
#pragma unroll
      for (int wv = 0; wv < 4; ++wv) {
        const int w = (tid / 64) * 4 + wv;
        int q[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = kk + 4 * w + e;
          q[e] = (n < N && k < k1) ? static_cast<int>(b[static_cast<size_t>(k) * N + n]) : 0;
        }
        Bs[w][c] = pack4(q[0], q[1], q[2], q[3]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kW8; ++w) {
      const int4 av = *reinterpret_cast<const int4*>(&As[w][ty * 4]);
      const int4 bv = *reinterpret_cast<const int4*>(&Bs[w][tx * 4]);
      const int aa[4] = {av.x, av.y, av.z, av.w};
      const int bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(aa[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// float(acc) * (s_x * s_w), each product rounded.
__device__ __forceinline__ float dequant(int acc, float sx, float sw) {
  return __fmul_rn(static_cast<float>(acc), __fmul_rn(sx, sw));
}

// y * scale + bias with the multiply and the add rounded separately.
__device__ __forceinline__ float bn_rn(float y, float scale, float bias) {
  return __fadd_rn(__fmul_rn(y, scale), bias);
}

// y = float(acc) * (s_x * s_w[n]) * scale[n] + bias[n] (+ ReLU) into
// out[p, n] (row stride N).
struct Int8BnEpilogue {
  const float* __restrict__ sw;
  const float* __restrict__ scale;
  const float* __restrict__ bias;
  float* out;
  int N;
  int relu;
  __device__ __forceinline__ void operator()(int p, int n, int acc, float sx) const {
    float y = bn_rn(dequant(acc, sx, sw[n]), scale[n], bias[n]);
    if (relu) y = fmaxf(y, 0.f);
    out[static_cast<size_t>(p) * N + n] = y;
  }
};

// out[p, n] = relu(deq * scale[n] + bias[n] + res[p, n]), deq the
// dequantized product, each multiply and add rounded on its own; res may be
// out (each element is read only by the thread that overwrites it).
struct ResidualInt8Epilogue {
  const float* __restrict__ sw;
  const float* __restrict__ scale;
  const float* __restrict__ bias;
  const float* res;
  float* out;
  int N;
  __device__ __forceinline__ void store(int p, int n, float deq) const {
    const size_t i = static_cast<size_t>(p) * N + n;
    out[i] = fmaxf(__fadd_rn(bn_rn(deq, scale[n], bias[n]), __ldcg(res + i)), 0.f);
  }
  __device__ __forceinline__ void operator()(int p, int n, int acc, float sx) const {
    store(p, n, dequant(acc, sx, sw[n]));
  }
};

// The tile's row scales, computed earlier in the launch, into sx[64].
__device__ __forceinline__ void load_tile_scales(const float* scales, int stride, int P,
                                                 int p0, float* sx) {
  __syncthreads();  // the previous tile's epilogue may still read sx
  if (threadIdx.x < kBM) {
    const int p = p0 + threadIdx.x;
    sx[threadIdx.x] = p < P ? __ldcg(scales + static_cast<size_t>(p) * stride) : 1.f;
  }
  __syncthreads();
}

// C = q(A) x B over a whole phase of a persistent kernel, every output
// through `epi(p, n, acc, s_x)`; the row scales (scales[p]) were written by
// a row_scales_phase before a barrier. Work items are (split, tile) pairs
// dealt round-robin to the blocks; with splits > 1 each item writes its
// int32 partial sums to `part` (splits x P x N), and after a barrier the
// blocks add them (exact in any order) and apply `epi`. The caller places
// the barrier that ends the phase.
template <class ALoad, class Epilogue>
__device__ __forceinline__ void int8_gemm_phase(const GemmPhase& g, const ALoad& a,
                                                const int8_t* __restrict__ b,
                                                const float* scales, const Epilogue& epi,
                                                int* part, unsigned int* bar, int* smem) {
  float* sx = reinterpret_cast<float*>(smem + 2 * kW8 * kBM);
  const int tiles_p = (g.P + kBM - 1) / kBM;
  const int tiles_n = (g.N + kBN - 1) / kBN;
  const int tiles = tiles_p * tiles_n;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int item = blockIdx.x; item < tiles * g.splits; item += gridDim.x) {
    const int split = item / tiles;
    const int t = item - split * tiles;
    const int p0 = (t / tiles_n) * kBM;
    const int n0 = (t % tiles_n) * kBN;
    const int k0 = split * g.chunk;
    const int k1 = min(g.K, k0 + g.chunk);
    load_tile_scales(scales, 1, g.P, p0, sx);
    int acc[4][4];
    int8_tile(a, b, sx, g.P, g.N, p0, n0, k0, k1, smem, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + ty * 4 + i;
      if (p >= g.P) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (n >= g.N) continue;
        if (g.splits == 1)
          epi(p, n, acc[i][j], sx[ty * 4 + i]);
        else
          part[(static_cast<size_t>(split) * g.P + p) * g.N + n] = acc[i][j];
      }
    }
  }
  if (g.splits == 1) return;
  grid_sync(bar);
  const size_t pn = static_cast<size_t>(g.P) * g.N;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < pn;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    int s = __ldcg(part + i);
    for (int k = 1; k < g.splits; ++k) s += __ldcg(part + k * pn + i);
    const int p = static_cast<int>(i / g.N);
    epi(p, static_cast<int>(i % g.N), s, __ldcg(scales + p));
  }
}

}  // namespace wt
