// B identity basic blocks (ResNet-18/34) over all N images in one
// persistent launch: per block b,
//   h1  = relu(conv3x3(act, w9_a[b]) * s_a[b] + b_a[b])
//   out = relu(conv3x3(h1, w9_b[b]) * s_b[b] + b_b[b] + act)
// with both 3x3s stride 1, SAME zero padding, as implicit GEMMs over the
// im2col matrix (K = 9 * C, k = (3r + s) * C + c), and act = x for block 0
// and out afterwards (updated in place: each residual element is read only
// by the thread that overwrites it, and the conv reads h1).
//
// Replaces: winograd_tpu/kernels/basic_stage.py::_basic_stage_kernel
// (basic_stage_fused_pallas). On the served ResNet-34 path it runs
// conv5_x's two identity blocks at 7x7x512 (ResNet-18: one).
//
// Bound on the H100: at N=1 and B=2 the 4 convs are 2 * 49 * 4608 * 512
// FLOPs each, 0.925 GFLOP, 5.6 us as three TF32 passes at 495 TFLOP/s; the
// f32 weights, 2 * 2 * 9.4 MB read once, take 11.3 us at 3.35 TB/s: bound
// by bytes at N=1, by operations at N=8 (45 us against 11.8).
//
// Design: the TPU kernel keeps the activation in VMEM across both convs and
// all blocks while Pallas streams each block's weights. Here it is
// csrc/stage.cu's persistent cooperative kernel of at most kMaxBlocksPerSm
// 128-thread blocks an SM, and each conv is one of its GEMM phases
// (wgmma_phase.cuh, shared with the stage and csrc/transition.cu: the
// stage's direct mid is this conv at 14x14): wgmma_tile.cuh's 64 x 64
// tiles, one warpgroup's wgmma.mma_async in 3xTF32 (each stage's products
// added in FP32), the weight tiles by TMA onto mbarriers from the stacked
// (B, 9C, C) weights' tensor map, and A the implicit im2col of act or h1
// (mma_tf32.cuh's Im2colA, gathered by the tile's cp.async copies and
// never materialised), a 4-deep ring (85 KB of dynamic shared memory at
// f32), with a grid barrier between convs; h1 lives in a device workspace
// that stays in L2. The weights do not depend on the activations, so a
// block issues the TMA loads of its first item of the next conv before it
// waits at the barrier that ends a conv. At N=1 the map has 49 rows against
// a (4608, 512) weight, 8 output tiles for a grid of 264 blocks, so each
// conv splits K as the host's plan says (kernels/basic_stage.py::
// basic_stage_plan, in whole stages of the tile) and adds the splits'
// partial sums in a fixed order after a barrier (deterministic, no
// atomics): most blocks stream a slice of the weights instead of idling.
// This entry checks the plan against the geometry compiled here and
// refuses one that does not fit.
//
// The bf16w tier (basic_stage_bf16w: w9_a and w9_b bf16, BN f32; the JAX
// kernel at precision="bf16w") is the same kernel and plan on the bf16
// tiles: the f32 im2col split hi/lo into two bf16 wgmma m64n64k16 passes
// on the weights read straight from TMA's swizzled boxes, half the weight
// bytes (4.7 MB a conv at 7x7x512, not 9.4).

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma_phase.cuh"
#include "wgmma_tile.cuh"

namespace {

namespace tc = wt::tf32x3;
namespace wg = wt::wg;
namespace ph = wt::wgphase;

constexpr int kMaxBlocksPerSm = 2;  // blocks an SM in the cooperative grid, at most

// BT: the weights' element type, float or __nv_bfloat16 (bf16w). The maps
// (kVec): w9_a and w9_b as (C, 9C, B) for the TMA loads.
template <class BT>
struct BasicStageArgs {
  CUtensorMap map_a, map_b;
  const float* x;
  float* out;
  const BT* wa;  // (B, 9*C, C)
  const float* sa;  // (B, 1, C)
  const float* ba;
  const BT* wb;
  const float* sb;
  const float* bb;
  float* h1;
  float* part;
  unsigned int* bar;
  int N, H, W, C, B;
  wt::GemmPhase conv;
};

// kVec: C a multiple of 4 (of 8 for bf16 weights), every operand 16-byte
// aligned (the TMA maps and 16-byte A copies).
template <bool kVec, class BT>
__global__ void __launch_bounds__(wg::kThreads, kMaxBlocksPerSm)
    basic_stage_kernel(const __grid_constant__ BasicStageArgs<BT> a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bars[wg::kStages];
  wg::Ring ring = wg::make_ring(smem, bars);
  const int c = a.C;
  const int P = a.N * a.H * a.W;
  const size_t per = static_cast<size_t>(9) * c * c;  // a block's weights
  bool pre = false;
  for (int blk = 0; blk < a.B; ++blk) {
    const float* act = blk == 0 ? a.x : a.out;
    const size_t bc = static_cast<size_t>(blk) * c;
    const wg::Weights<BT> wa{&a.map_a, a.wa + blk * per, c, 9 * c, blk};
    const wg::Weights<BT> wb{&a.map_b, a.wb + blk * per, c, 9 * c, blk};

    const wt::BnEpilogue e1{a.sa + bc, a.ba + bc, a.h1, c, 1};
    ph::phase_items<kVec>(a.conv, tc::Im2colA{act, a.H, a.W, c, P}, wa, e1, a.part, ring, pre);
    pre = ph::prefetch_phase<kVec>(a.conv, wb, ring);
    ph::reduce_phase(a.conv, e1, a.part, a.bar);
    wt::grid_sync(a.bar);

    const wt::ResidualEpilogue e2{a.sb + bc, a.bb + bc, act, a.out, c};
    ph::phase_items<kVec>(a.conv, tc::Im2colA{a.h1, a.H, a.W, c, P}, wb, e2, a.part, ring, pre);
    if (blk + 1 < a.B)
      pre = ph::prefetch_phase<kVec>(
          a.conv, wg::Weights<BT>{&a.map_a, a.wa + (blk + 1) * per, c, 9 * c, blk + 1}, ring);
    ph::reduce_phase(a.conv, e2, a.part, a.bar);
    if (blk + 1 < a.B) wt::grid_sync(a.bar);
  }
}

template <class BT>
const void* kernel_of(bool vec) {
  return vec ? reinterpret_cast<const void*>(&basic_stage_kernel<true, BT>)
             : reinterpret_cast<const void*>(&basic_stage_kernel<false, BT>);
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
  wt::GemmPhase conv;
  size_t h1, part, total;  // workspace offsets and size, in floats
};

// The conv's split (both convs of every block share it) and the
// workspace's layout: the grid barrier's two counters, h1, then the
// split's partial sums.
int make_plan(int N, int H, int W, int C, int blocks, int splits, int chunk, Plan* pl) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = N * H * W;
  pl->conv = wt::GemmPhase{P, 9 * C, C, splits, chunk};
  if (!ph::phase_fits(pl->conv)) return static_cast<int>(cudaErrorInvalidValue);
  pl->h1 = kWorkspaceAlign;  // the barrier's two counters sit at the front
  pl->part = pl->h1 + workspace_round_up(static_cast<size_t>(P) * C);
  pl->total = pl->part + phase_partial_floats(pl->conv);
  return 0;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <class BT>
int stage(const float* x, const BT* wa, const float* sa, const float* ba, const BT* wb,
          const float* sb, const float* bb, float* out, float* ws, long long ws_floats, int N,
          int H, int W, int C, int B, int blocks, int splits, int chunk, void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  const int err = make_plan(N, H, W, C, blocks, splits, chunk, &pl);
  if (err != 0) return err;
  if (ws_floats < static_cast<long long>(pl.total))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kVecChannels = std::is_same_v<BT, float> ? 4 : 8;
  const bool vec = C % kVecChannels == 0 && aligned16(x) && aligned16(out) && aligned16(wa) &&
                   aligned16(wb) && aligned16(ws);
  const int resident = resident_blocks<BT>(vec);
  if (resident <= 0 || blocks > resident) return static_cast<int>(cudaErrorInvalidConfiguration);
  BasicStageArgs<BT> a{{}, {}, x, out, wa, sa, ba, wb, sb, bb, ws + pl.h1, ws + pl.part,
                       reinterpret_cast<unsigned int*>(ws), N, H, W, C, B, pl.conv};
  if (vec) {
    cudaError_t e = wg::encode_weights(&a.map_a, wa, B, 9 * C, C);
    if (e == cudaSuccess) e = wg::encode_weights(&a.map_b, wb, B, 9 * C, C);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(a.bar, 0, 2 * sizeof(unsigned int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel_of<BT>(vec), dim3(blocks), dim3(wg::kThreads), args,
                                  wg::kSmemBytes<BT>, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of workspace basic_stage and basic_stage_bf16w need for this shape
// under the plan (blocks, then the convs' splits and chunk), into *floats;
// returns a CUDA error code.
extern "C" int basic_stage_workspace(int N, int H, int W, int C, int blocks, int splits,
                                     int chunk, long long* floats) {
  Plan pl;
  const int err = make_plan(N, H, W, C, blocks, splits, chunk, &pl);
  if (err == 0) *floats = static_cast<long long>(pl.total);
  return err;
}

// The host's plan (kernels/basic_stage.py::basic_stage_plan): a cooperative
// grid of `blocks` blocks, at most as many as the device holds resident
// (kMaxBlocksPerSm an SM), and the convs' K split; ws: ws_floats floats
// laid out as basic_stage_workspace says.
extern "C" int basic_stage(const float* x, const float* wa, const float* sa, const float* ba,
                           const float* wb, const float* sb, const float* bb, float* out,
                           float* ws, long long ws_floats, int N, int H, int W, int C, int B,
                           int blocks, int splits, int chunk, void* stream) {
  return stage(x, wa, sa, ba, wb, sb, bb, out, ws, ws_floats, N, H, W, C, B, blocks, splits,
               chunk, stream);
}

// The bf16w tier: wa and wb bf16, the rest (plan and workspace) as
// basic_stage.
extern "C" int basic_stage_bf16w(const float* x, const __nv_bfloat16* wa, const float* sa,
                                 const float* ba, const __nv_bfloat16* wb, const float* sb,
                                 const float* bb, float* out, float* ws, long long ws_floats,
                                 int N, int H, int W, int C, int B, int blocks, int splits,
                                 int chunk, void* stream) {
  return stage(x, wa, sa, ba, wb, sb, bb, out, ws, ws_floats, N, H, W, C, B, blocks, splits,
               chunk, stream);
}
