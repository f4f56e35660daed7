// The stride-2 ResNet transition block over all N images in one persistent
// launch:
//   h1  = relu(x @ w_reduce * s1 + b1)                       (reduce GEMM)
//   h2  = relu(im2col_s2(h1) @ w9 * s2 + b2)                 (stride-2 3x3)
//   out = relu([h2 | x[:, ::2, ::2]] @ wep + bep)            (expand + skip)
// where wep = [w_expand * s3; w_proj * sp] and bep = b3 + bp fold the expand
// and projection BNs offline (kernels/transition.py::fuse_transition_weights).
// The 3x3 uses SAME padding for stride 2: output (oy, ox) takes taps
// (2 oy + r - 1, 2 ox + s - 1), zero outside the map, ho = ceil(H / 2).
//
// Replaces: winograd_tpu/kernels/transition.py::_transition_kernel and
// ::_transition_kernel_resident (transition_block_fused_pallas). The two TPU
// bodies differ only in which loop is outer (image or output tile); here
// every phase runs over all N images' rows and reads each weight once per
// launch, so one kernel covers both. On the served ResNet-50 path it runs
// the three transitions 56->28 (256->128->512), 28->14 (512->256->1024) and
// 14->7 (1024->512->2048).
//
// Bound on the H100: ~0.75 GFLOP per transition at N=1 (5.96 GFLOP for
// 14->7 at N=8), as three TF32 passes at 495 TFLOP/s, against x, out and the
// weights read once (6.3 / 8.4 / 25.3 MB at N=1; 7.6 us for the last at
// 3.35 TB/s): bytes at N=1, operations at N=8. At N=1 the phases are small
// (8 to 98 output tiles), so filling the card, not the rate, is the work.
//
// Design: csrc/stage.cu's, a persistent cooperative kernel of at most
// kMaxBlocksPerSm 128-thread blocks an SM whose three GEMM phases are
// wgmma_phase.cuh's (shared with the stage) on wgmma_tile.cuh's 64 x 64
// tiles: one warpgroup's wgmma.mma_async in 3xTF32 (each stage's products
// added in FP32), the weight tiles by TMA onto mbarriers, A by cp.async, a
// 4-deep ring (85 KB of dynamic shared memory at f32), the phases separated
// by grid barriers; h1 and h2 live in a device workspace that fits the L2.
// The A operands are gathered by the tile's cp.async copies and never
// materialised: the reduce reads x's rows (RowMajorA), the mid the strided
// im2col of h1 (mma_tf32.cuh's Im2colA at stride 2), the expand the rows
// of [h2 | x[:, ::2, ::2]] (ConcatSkipA). The weights do not depend on the
// activations, so a block issues the TMA loads of its first item of the
// next phase before it waits at the barrier that ends a phase. Where a
// phase has fewer tiles than the grid has blocks, or an item would walk a
// long K, it splits K and adds the splits in a fixed order behind a grid
// barrier, so the result does not depend on timing. The grid and each
// phase's split are the host's plan (kernels/transition.py::
// transition_plan); this entry checks it against the geometry compiled
// here, works out the workspace from it and refuses a plan that does not
// fit.
//
// The bf16w tier (transition_block_bf16w: w_reduce, w9 and the fused wep
// in bf16, BN and bep f32; the JAX kernel at precision="bf16w") is the same
// kernel and plan on the bf16 tiles: the f32 A split hi/lo into two bf16
// wgmma m64n64k16 passes on the weights read straight from TMA's swizzled
// boxes, half the weight bytes (12.6 MB for 14->7, not 25.3).

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma_tile.cuh"
#include "wgmma_phase.cuh"

namespace {

namespace tc = wt::tf32x3;
namespace wg = wt::wg;
namespace ph = wt::wgphase;

constexpr int kMaxBlocksPerSm = 2;  // blocks an SM in the cooperative grid, at most

// BT: the weights' element type, float or __nv_bfloat16 (bf16w). The maps
// (kVec): w_reduce, w9 and wep as (N, K, 1) for the TMA loads.
template <class BT>
struct TransitionArgs {
  CUtensorMap map_r, map_m, map_e;
  const float* x;
  const BT* wr;
  const float* s1;
  const float* b1;
  const BT* w9;
  const float* s2;
  const float* b2;
  const BT* wep;
  const float* bep;
  float* out;
  float* h1;
  float* h2;
  float* part;
  unsigned int* bar;
  int N, H, W, Cin, Cmid, Cout;
  wt::GemmPhase reduce, mid, expand;
};

// [h2 | x[:, ::2, ::2]] as an A source of mma_tf32.cuh: at output row
// p = (n, oy, ox), k < Cmid is h2's value, the rest the block input's at
// (2 oy, 2 ox). Cmid and Cin are multiples of 4 on the 16-byte path, so a
// copy of four k never straddles the two.
struct ConcatSkipA {
  const float* h2;
  const float* __restrict__ x;
  int H, W, Cin, Cmid, Ho, Wo, P;
  __device__ __forceinline__ const float* base() const { return h2; }
  __device__ __forceinline__ const float* at(int p, int k) const {
    if (p >= P) return nullptr;
    if (k < Cmid) return h2 + static_cast<size_t>(p) * Cmid + k;
    const int hwo = Ho * Wo;
    const int n = p / hwo;
    const int q = p - n * hwo;
    return x + (static_cast<size_t>(n * H + 2 * (q / Wo)) * W + 2 * (q % Wo)) * Cin +
           (k - Cmid);
  }
};

struct BiasReluEpilogue {
  const float* __restrict__ bias;
  float* out;
  int N;
  __device__ __forceinline__ void operator()(int p, int n, float acc) const {
    out[static_cast<size_t>(p) * N + n] = wt::relu(acc + bias[n]);
  }
};

// kVec: Cin, Cmid and Cout multiples of 4 (of 8 for bf16 weights), every
// operand 16-byte aligned (the TMA maps and 16-byte A copies).
template <bool kVec, class BT>
__global__ void __launch_bounds__(wg::kThreads, kMaxBlocksPerSm)
    transition_kernel(const __grid_constant__ TransitionArgs<BT> a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bars[2 * wg::kStages];
  wg::Ring ring = wg::make_ring(smem, bars);
  const int ho = (a.H + 1) / 2, wo = (a.W + 1) / 2;
  const int P1 = a.N * a.H * a.W, P2 = a.N * ho * wo;
  const wg::Weights<BT> wr{&a.map_r, a.wr, a.Cmid, a.Cin, 0};
  const wg::Weights<BT> wm{&a.map_m, a.w9, a.Cmid, 9 * a.Cmid, 0};
  const wg::Weights<BT> we{&a.map_e, a.wep, a.Cout, a.Cmid + a.Cin, 0};
  bool pre = false;
  const wt::BnEpilogue e1{a.s1, a.b1, a.h1, a.Cmid, 1};
  ph::phase_items<kVec>(a.reduce, tc::RowMajorA{a.x, P1, a.Cin}, wr, e1, a.part, ring, pre);
  pre = ph::prefetch_phase<kVec>(a.mid, wm, ring);
  ph::reduce_phase(a.reduce, e1, a.part, a.bar);
  wt::grid_sync(a.bar);
  const wt::BnEpilogue e2{a.s2, a.b2, a.h2, a.Cmid, 1};
  ph::phase_items<kVec>(a.mid, tc::Im2colA<2>{a.h1, a.H, a.W, a.Cmid, P2}, wm, e2, a.part, ring,
                        pre);
  pre = ph::prefetch_phase<kVec>(a.expand, we, ring);
  ph::reduce_phase(a.mid, e2, a.part, a.bar);
  wt::grid_sync(a.bar);
  const BiasReluEpilogue e3{a.bep, a.out, a.Cout};
  ph::phase_items<kVec>(a.expand, ConcatSkipA{a.h2, a.x, a.H, a.W, a.Cin, a.Cmid, ho, wo, P2},
                        we, e3, a.part, ring, pre);
  ph::reduce_phase(a.expand, e3, a.part, a.bar);
}

template <class BT>
const void* kernel_of(bool vec) {
  return vec ? reinterpret_cast<const void*>(&transition_kernel<true, BT>)
             : reinterpret_cast<const void*>(&transition_kernel<false, BT>);
}

// Blocks of the instantiation that the current device holds resident at
// once, at most kMaxBlocksPerSm an SM (the dynamic shared memory limit
// raised once per device); 0 on error.
template <class BT>
int resident_blocks(bool vec) {
  static int cache[64][2] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev][vec] == 0) {
    const void* kernel = kernel_of<BT>(vec);
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(wg::kSmemBytes<BT>)) != cudaSuccess)
      return 0;
    cache[dev][vec] = cooperative_grid(kernel, wg::kSmemBytes<BT>, wg::kThreads, kMaxBlocksPerSm);
  }
  return cache[dev][vec];
}

struct Plan {
  wt::GemmPhase reduce, mid, expand;
  size_t h1, h2, part, total;  // workspace offsets and size, in floats
};

// The plan's phases and the workspace's layout: the grid barrier's two
// counters, h1, h2, then the largest phase's partial sums.
int make_plan(int N, int H, int W, int Cin, int Cmid, int Cout, int blocks, int rs, int rc,
              int ms, int mc, int es, int ec, Plan* pl) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cmid <= 0 || Cout <= 0 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int P1 = N * H * W;
  const int P2 = N * ((H + 1) / 2) * ((W + 1) / 2);
  pl->reduce = wt::GemmPhase{P1, Cin, Cmid, rs, rc};
  pl->mid = wt::GemmPhase{P2, 9 * Cmid, Cmid, ms, mc};
  pl->expand = wt::GemmPhase{P2, Cmid + Cin, Cout, es, ec};
  if (!ph::phase_fits(pl->reduce) || !ph::phase_fits(pl->mid) || !ph::phase_fits(pl->expand))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t part = phase_partial_floats(pl->reduce);
  if (phase_partial_floats(pl->mid) > part) part = phase_partial_floats(pl->mid);
  if (phase_partial_floats(pl->expand) > part) part = phase_partial_floats(pl->expand);
  pl->h1 = kWorkspaceAlign;  // the barrier's two counters sit at the front
  pl->h2 = pl->h1 + workspace_round_up(static_cast<size_t>(P1) * Cmid);
  pl->part = pl->h2 + workspace_round_up(static_cast<size_t>(P2) * Cmid);
  pl->total = pl->part + part;
  return 0;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <class BT>
int transition(const float* x, const BT* wr, const float* s1, const float* b1, const BT* w9,
               const float* s2, const float* b2, const BT* wep, const float* bep, float* out,
               float* ws, long long ws_floats, int N, int H, int W, int Cin, int Cmid, int Cout,
               int blocks, int rs, int rc, int ms, int mc, int es, int ec, void* stream) {
  Plan pl;
  const int err = make_plan(N, H, W, Cin, Cmid, Cout, blocks, rs, rc, ms, mc, es, ec, &pl);
  if (err != 0) return err;
  if (ws_floats < static_cast<long long>(pl.total))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kVecChannels = std::is_same_v<BT, float> ? 4 : 8;
  const bool vec = Cin % 4 == 0 && Cmid % kVecChannels == 0 && Cout % kVecChannels == 0 &&
                   aligned16(x) && aligned16(wr) && aligned16(w9) && aligned16(wep) &&
                   aligned16(ws);
  const int resident = resident_blocks<BT>(vec);
  if (resident <= 0 || blocks > resident) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto s = static_cast<cudaStream_t>(stream);
  unsigned int* bar = reinterpret_cast<unsigned int*>(ws);
  TransitionArgs<BT> a{{}, {}, {}, x, wr, s1, b1, w9, s2, b2, wep, bep, out,
                       ws + pl.h1, ws + pl.h2, ws + pl.part, bar, N, H, W, Cin, Cmid, Cout,
                       pl.reduce, pl.mid, pl.expand};
  if (vec) {
    cudaError_t e = wg::encode_weights(&a.map_r, wr, 1, Cin, Cmid);
    if (e == cudaSuccess) e = wg::encode_weights(&a.map_m, w9, 1, 9 * Cmid, Cmid);
    if (e == cudaSuccess) e = wg::encode_weights(&a.map_e, wep, 1, Cmid + Cin, Cout);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaError_t e = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel_of<BT>(vec), dim3(blocks), dim3(wg::kThreads), args,
                                  wg::kSmemBytes<BT>, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of workspace transition_block needs for this shape under the plan
// (blocks, then (splits, chunk) of the reduce, the mid and the expand), into
// *floats; returns a CUDA error code.
extern "C" int transition_block_workspace(int N, int H, int W, int Cin, int Cmid, int Cout,
                                          int blocks, int rs, int rc, int ms, int mc, int es,
                                          int ec, long long* floats) {
  Plan pl;
  const int err = make_plan(N, H, W, Cin, Cmid, Cout, blocks, rs, rc, ms, mc, es, ec, &pl);
  if (err == 0) *floats = static_cast<long long>(pl.total);
  return err;
}

// The host's plan (kernels/transition.py::transition_plan): a cooperative
// grid of `blocks` blocks, at most as many as the device holds resident
// (kMaxBlocksPerSm an SM), and each phase's K split; ws: ws_floats floats
// laid out as transition_block_workspace says.
extern "C" int transition_block(const float* x, const float* wr, const float* s1,
                                const float* b1, const float* w9, const float* s2,
                                const float* b2, const float* wep, const float* bep, float* out,
                                float* ws, long long ws_floats, int N, int H, int W, int Cin,
                                int Cmid, int Cout, int blocks, int rs, int rc, int ms, int mc,
                                int es, int ec, void* stream) {
  return transition(x, wr, s1, b1, w9, s2, b2, wep, bep, out, ws, ws_floats, N, H, W, Cin, Cmid,
                    Cout, blocks, rs, rc, ms, mc, es, ec, stream);
}

// The bf16w tier: wr, w9 and wep bf16, the rest as transition_block.
extern "C" int transition_block_bf16w(const float* x, const __nv_bfloat16* wr, const float* s1,
                                      const float* b1, const __nv_bfloat16* w9, const float* s2,
                                      const float* b2, const __nv_bfloat16* wep, const float* bep,
                                      float* out, float* ws, long long ws_floats, int N, int H,
                                      int W, int Cin, int Cmid, int Cout, int blocks, int rs,
                                      int rc, int ms, int mc, int es, int ec, void* stream) {
  return transition(x, wr, s1, b1, w9, s2, b2, wep, bep, out, ws, ws_floats, N, H, W, Cin, Cmid,
                    Cout, blocks, rs, rc, ms, mc, es, ec, stream);
}
