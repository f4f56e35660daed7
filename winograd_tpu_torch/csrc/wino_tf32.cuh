// Winograd F(m,3), m = 2 or 4: a 3x3 conv (stride 1, pad 1) + folded BN
// (+ ReLU) with its products on the tensor cores (wgmma_tile.cuh's tiles),
// as one phase of a persistent cooperative kernel:
//   V[q] = (Bt d Bt^T)[q] for each of the a^2 = (m+2)^2 tile positions q,
//   M[q] = V[q] U[q], a (tiles x Cin) x (Cin x Cout) product per position,
//   Y = At M At^T, then y = Y * scale + bias (+ ReLU), stored clipped at the
//   right and bottom edges when m does not divide the map.
//
// Shared by csrc/winograd.cu (the per-layer Winograd: f32, F(2,3) and
// F(4,3), and the bf16w F(2,3)) and csrc/stage.cu (the F(2,3) mid-layer of
// the f32 and the bf16w bottleneck stage). The products are wgmma_tile.cuh's
// tile, one warpgroup's m64n64k8 3xTF32 (f32 U) or m64n64k16 bf16 (bf16 U,
// V split hi/lo), each stage's products added in FP32, U[q] by TMA as boxes
// of the filters' tensor map (element loads where the map cannot describe
// them), V by cp.async (the stage's mid took 0.4-2.9% less time on it than
// on mma.sync tiles, PERF.md). The V phase and the inverse stay FP32.
//
// Three steps, two grid barriers (grid_sync.cuh):
// * V phase: the grid writes V = Bt d Bt^T once, one (tile, channel) a
//   thread, to a workspace v[q][tile][c] (a^2 x T x Kp floats, Kp = Cin
//   rounded up to 4 and zero past Cin, so every row of V[q] moves in
//   16-byte copies).
// * Products: work items (position, Cin split, tile block, Cout block)
//   dealt to the grid's blocks. A tile block is the MMA tile's 64 rows
//   (Winograd tiles), a Cout block its 64 columns, a split a Cin range of
//   `chunk`. Each product is one tile (above) with A = V[q] (row-major,
//   by cp.async.cg: V was written in the launch) and B = U[q]; the item
//   writes its partial M[q] (64 x 64 floats) to part[(split * a^2 + q),
//   tile, cout]. The host's plan picks splits and chunk so that the items
//   fill the card (kernels/winograd.py::winograd_plan, for csrc/winograd.cu
//   and for csrc/stage.cu's mid alike).
// * Inverse: the whole grid applies At M At^T, one (tile, cout) a thread:
//   it adds each position's splits in split order 0, 1, ... (calls repeat
//   to the bit), transforms in FP32 and applies BN (+ ReLU).
// Computing each item's V[q] rows into the MMA ring from the map instead
// (no V workspace, one barrier fewer) was slower at every served shape on
// an H100, most at N=8: those loads cannot be issued ahead like cp.async.
#pragma once

#include <cuda_runtime.h>

#include "grid_sync.cuh"
#include "mma_tf32.cuh"
#include "wgmma_tile.cuh"
#include "winograd.cuh"

namespace wt {
namespace winotc {

namespace tc = tf32x3;

// One conv: the (N, H, W, C) input map, Cout, and its Winograd tiles
// (th down, tw across, T = N * th * tw in all).
struct Conv {
  int N, H, W, C, Cout, th, tw, T;
};

template <int M>
__host__ __device__ inline Conv make_conv(int N, int H, int W, int C, int Cout) {
  const int th = (H + M - 1) / M, tw = (W + M - 1) / M;
  return Conv{N, H, W, C, Cout, th, tw, N * th * tw};
}

// How the products are cut into work items: one tile position an item,
// Cin in `splits` ranges of `chunk`.
struct Cut {
  int splits, chunk;
};

// Floats of a row of V: Cin rounded up to 4.
__host__ __device__ inline int v_row(const Conv& cv) { return (cv.C + 3) / 4 * 4; }

// v[q][t][c] = (Bt d Bt^T)[q] of tile t and channel c (zero for c >= C),
// one (tile, channel) a thread of the grid; kCg: x was written earlier in
// the launch. The caller places the barrier.
template <int M, bool kCg>
__device__ __forceinline__ void transform(const Conv& cv, const float* x, float* v) {
  constexpr int A = M + 2, A2 = A * A;
  const int kp = v_row(cv);
  const size_t tk = static_cast<size_t>(cv.T) * kp;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < tk;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int t = static_cast<int>(i / kp), c = static_cast<int>(i % kp);
    const int n = t / (cv.th * cv.tw), r = t - n * cv.th * cv.tw;
    const int y0 = r / cv.tw * M - 1, x0 = r % cv.tw * M - 1;
    float d[A][A], vq[A][A];
#pragma unroll
    for (int k = 0; k < A; ++k)
#pragma unroll
      for (int l = 0; l < A; ++l) {
        const int y = y0 + k, xx = x0 + l;
        const float* p = x + (static_cast<size_t>(n * cv.H + y) * cv.W + xx) * cv.C + c;
        d[k][l] = c < cv.C && y >= 0 && y < cv.H && xx >= 0 && xx < cv.W
                      ? (kCg ? __ldcg(p) : __ldg(p))
                      : 0.f;
      }
    sandwich<M, A, false>(d, vq);
#pragma unroll
    for (int q = 0; q < A2; ++q) v[q * tk + i] = vq[q / A][q % A];
  }
}

// The products' U: its tensor map (the (blocks, C, Cout) filters as (Cout,
// C, blocks), wgmma_tile.cuh::encode_weights) and the block of this conv's
// position 0; the ring over the kernel's dynamic shared memory.
struct Tc {
  const CUtensorMap* map;
  int blk0;
  wg::Ring* ring;
};

// One work item: position q of tile block tb and Cout block cb over Cin
// range [k0, k1), A from V, partial M into part; U f32 or bf16 (UT).
// kVec: Cout a multiple of 4 (of 8 for bf16 U) and u 16-byte aligned
// (TMA loads of U, 16-byte copies of V).
template <int M, bool kVec, class UT>
__device__ __forceinline__ void item(const Conv& cv, const float* v, const UT* __restrict__ u,
                                     float* part, int q, int split, int k0, int k1, int tb,
                                     int cb, const Tc& tcu) {
  constexpr int A2 = (M + 2) * (M + 2);
  const int p0 = tb * tc::kBM, n0 = cb * tc::kBN;
  const size_t tk = static_cast<size_t>(cv.T) * v_row(cv);
  const size_t tco = static_cast<size_t>(cv.T) * cv.Cout;
  float* pq = part + (static_cast<size_t>(split) * A2 + q) * tco;
  wg::Acc acc;
  wg::tile<kVec, true>(tc::RowMajorA{v + q * tk, cv.T, v_row(cv)},
                       wg::Weights<UT>{tcu.map, u + static_cast<size_t>(q) * cv.C * cv.Cout,
                                       cv.Cout, cv.C, tcu.blk0 + q},
                       p0, n0, k0, k1, *tcu.ring, false, acc);
  wg::for_each_acc(acc, [&](int r, int c, float val) {
    const int t = p0 + r, co = n0 + c;
    if (t < cv.T && co < cv.Cout) pq[static_cast<size_t>(t) * cv.Cout + co] = val;
  });
}

// out = BN(At M At^T) (+ ReLU) over the whole map, M the sum of part's
// splits in split order; one (tile, cout) a thread of the grid.
template <int M>
__device__ __forceinline__ void inverse(const Conv& cv, int splits, const float* part,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ bias, float* out, int relu) {
  constexpr int A = M + 2, A2 = A * A;
  const size_t tco = static_cast<size_t>(cv.T) * cv.Cout;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < tco;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float mm[A][A];
#pragma unroll
    for (int q = 0; q < A2; ++q) mm[q / A][q % A] = __ldcg(part + q * tco + i);
    for (int s = 1; s < splits; ++s) {
      float v[A2];
#pragma unroll
      for (int q = 0; q < A2; ++q) v[q] = __ldcg(part + (static_cast<size_t>(s) * A2 + q) * tco + i);
#pragma unroll
      for (int q = 0; q < A2; ++q) mm[q / A][q % A] += v[q];
    }
    float y[M][M];
    sandwich<M, M, true>(mm, y);
    const int t = static_cast<int>(i / cv.Cout), co = static_cast<int>(i % cv.Cout);
    const int n = t / (cv.th * cv.tw), r = t - n * cv.th * cv.tw;
    const int oy0 = r / cv.tw * M, ox0 = r % cv.tw * M;
    const float s = scale[co], b = bias[co];
#pragma unroll
    for (int oi = 0; oi < M; ++oi)
#pragma unroll
      for (int oj = 0; oj < M; ++oj)
        if (oy0 + oi < cv.H && ox0 + oj < cv.W) {
          float val = y[oi][oj] * s + b;
          if (relu) val = wt::relu(val);
          out[(static_cast<size_t>(n * cv.H + oy0 + oi) * cv.W + ox0 + oj) * cv.Cout + co] = val;
        }
  }
}

__host__ __device__ inline int items_of(const Conv& cv, int a2, const Cut& cut) {
  return a2 * cut.splits * ((cv.T + tc::kBM - 1) / tc::kBM) * ((cv.Cout + tc::kBN - 1) / tc::kBN);
}

// out = BN(conv3x3(x, U)) (+ ReLU) through the V phase, the items and the
// inverse, two grid barriers apart; U (a^2, C, Cout) row-major per
// position; v holds a^2 * T * v_row floats, part cut.splits * a^2 * T *
// Cout; tcu's ring over wg::kSmemBytes<UT> of shared memory; kCg: x was
// written earlier in the launch. The caller places the barrier that ends
// the phase.
template <int M, bool kVec, bool kCg, class UT>
__device__ __forceinline__ void phase(const Conv& cv, const Cut& cut, const float* x,
                                      const UT* __restrict__ u,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ bias, float* out, int relu,
                                      float* v, float* part, unsigned int* bar, const Tc& tcu) {
  constexpr int A2 = (M + 2) * (M + 2);
  transform<M, kCg>(cv, x, v);
  grid_sync(bar);
  const int tbs = (cv.T + tc::kBM - 1) / tc::kBM, cbs = (cv.Cout + tc::kBN - 1) / tc::kBN;
  const int items = items_of(cv, A2, cut);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int rest = it;
    const int cb = rest % cbs;
    rest /= cbs;
    const int tb = rest % tbs;
    rest /= tbs;
    const int split = rest % cut.splits, q = rest / cut.splits;
    const int k0 = split * cut.chunk, k1 = min(cv.C, k0 + cut.chunk);
    item<M, kVec>(cv, v, u, part, q, split, k0, k1, tb, cb, tcu);
  }
  grid_sync(bar);
  inverse<M>(cv, cut.splits, part, scale, bias, out, relu);
}

// Host side: floats of V and of the partial M.
inline size_t v_floats(const Conv& cv, int a2) {
  return static_cast<size_t>(a2) * cv.T * v_row(cv);
}

inline size_t part_floats(const Conv& cv, int a2, const Cut& cut) {
  return static_cast<size_t>(cut.splits) * a2 * cv.T * cv.Cout;
}

// True when a cut fits: Cin in `splits` ranges of `chunk`, the last one
// shorter, chunk a multiple of tc::kBK past one split.
inline bool cut_fits(const Conv& cv, const Cut& c) {
  return c.splits >= 1 && c.chunk >= 1 &&
         static_cast<long long>(c.chunk) * c.splits >= cv.C &&
         static_cast<long long>(c.chunk) * (c.splits - 1) < cv.C &&
         (c.splits == 1 || c.chunk % tc::kBK == 0);
}

}  // namespace winotc
}  // namespace wt
