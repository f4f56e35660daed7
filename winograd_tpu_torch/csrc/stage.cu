// B identity bottleneck blocks over all N images in one persistent launch:
// per block b,
//   h1  = relu(act @ w_reduce[b] * s1 + b1)                (reduce GEMM)
//   h2  = relu(conv3x3(h1) * s2 + b2)                      (direct or F(2,3))
//   out = relu(h2 @ w_expand[b] * s3 + b3 + act)           (expand GEMM)
// with act = x for block 0 and out afterwards (updated in place: each
// residual element is read only by the thread that overwrites it).
//
// Replaces: winograd_tpu/kernels/stage.py::_stage_kernel and
// ::_stage_kernel_resident (resnet_stage_fused_pallas), and
// winograd_tpu/kernels/block.py::_block_kernel and ::_block_kernel_winograd
// (bottleneck_block_fused_pallas), which are this kernel at B = 1. The
// resident TPU layout differs from the streaming one only in what stays in
// VMEM; here every phase already runs over all N*H*W rows and reads each
// block's weights once per launch, so one kernel covers both. On the served
// ResNet-50 path it runs conv2_x (2 blocks, 56x56, 256/64, F(2,3) mid),
// conv3_x (3 blocks, 28x28, 512/128, F(2,3)) and conv4_x (5 blocks, 14x14,
// 1024/256, direct).
//
// Bound on the H100: the products (2*H*W*(2*Cio*Cmid + 9*Cmid^2) FLOPs per
// block, fewer with F(2,3)) as three TF32 passes at 495 TFLOP/s against x,
// out and the weights read once at 3.35 TB/s: 2.2 GFLOP on 24 MB for
// conv4_x at N=1 (13 us against 7 us), 17.6 GFLOP at N=8 (0.11 ms):
// operations; at N=1 the phases are small (16 to 196 MMA tiles), so filling
// the card, not the rate, is the work.
//
// Design: the TPU keeps the activation in VMEM across blocks; an SM's 228 KB
// cannot hold it (conv2_x is 3.2 MB per image), so the Hopper counterpart is
// a persistent cooperative kernel whose grid is the host's plan (at most
// kMaxBlocksPerSm 128-thread blocks an SM, and no more than the card holds
// resident). Each phase deals its work items to all blocks, and a grid
// barrier (grid_sync.cuh) separates phases and blocks; h1 and h2 live in a
// device workspace that fits the 50 MB L2 (12.8 MB at N=8 conv2_x). The
// GEMM phases (reduce, the direct mid on an implicit im2col of h1, expand
// with its residual) are wgmma_phase.cuh's, shared with csrc/transition.cu,
// on wgmma_tile.cuh's 64 x 64 tiles: one warpgroup's
// wgmma.mma_async in 3xTF32, the weight tiles by TMA onto mbarriers, A by
// cp.async, a 4-deep ring. A phase splits K over items where it has fewer
// tiles than the grid has blocks or an item would walk a long K, and the
// splits are added in order behind a grid barrier (deterministic). The
// grid and every phase's split are the host's plan
// (kernels/stage.py::stage_plan), checked here against the geometry.
//
// The weights do not depend on the activations, so a block issues the TMA
// loads of its first item's weight tiles for the next phase before it
// waits at the barrier that ends a phase; the ring's cold fill then
// overlaps the wait. Why the split sums go through device memory and not a
// thread-block cluster (as csrc/pointwise.cu's do): a launch has one
// cluster shape, the three phases want different splits (and the F(2,3)
// mid none), and an item of the persistent walk is not the rank of a
// fixed cluster; the grid barrier is already there.
//
// The F(2,3) mid (conv2_x, conv3_x) is wino_tf32.cuh's phase, the
// per-layer Winograd's, on the same wgmma tiles (its filters by TMA, the
// (16 B, Cmid, Cmid) u2 stack's map): V written
// once, then items of one position, Cin range and 64 x 64 block of tiles
// and channels, then the grid applies At M At^T and BN, two barriers
// apart; its Cin split is the host's (kernels/winograd.py::winograd_plan
// for Cmid, passed in by kernels/stage.py). So a block is three phases,
// each one item walk plus its split reduction (the Winograd mid also its
// V phase), and four to seven grid barriers. One dynamic shared buffer
// (the wgmma ring and split tiles, 85 KB at f32) serves every phase.
//
// The bf16w tier (resnet_stage_bf16w: w_reduce, the mid's w9 or u2 and
// w_expand in bf16, BN f32; the JAX kernel at precision="bf16w") is the
// same kernel on the bf16 tiles: every GEMM phase splits its f32 A hi/lo
// into two bf16 wgmma passes on the bf16 weights (read straight from the
// TMA's swizzled boxes), the F(2,3) mid's products the same way, half the
// weight bytes (conv5_x streams 8.9 MB a block, not 17.8); the V phase, the
// inverse and the epilogues stay FP32.

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "grid_sync.cuh"
#include "wgmma_phase.cuh"
#include "wgmma_tile.cuh"
#include "wino_tf32.cuh"

namespace {

namespace tc = wt::tf32x3;
namespace wg = wt::wg;
namespace wtc = wt::winotc;
namespace ph = wt::wgphase;

constexpr int kMaxBlocksPerSm = 2;  // blocks an SM in the cooperative grid, at most

// BT: the weights' element type, float or __nv_bfloat16 (bf16w). The maps
// (kVec): w_reduce, the direct mid's w9 and w_expand as (N, K, blocks), and
// the F(2,3) mid's u2 as (Cmid, Cmid, 16 * blocks).
template <class BT>
struct StageArgs {
  CUtensorMap map_r, map_m, map_e, map_u;
  const float* x;
  float* out;
  const BT* wr;
  const float* s1;
  const float* b1;
  const BT* wm;  // (B, 9*Cmid, Cmid) direct or (B, 16, Cmid, Cmid) F(2,3)
  const float* s2;
  const float* b2;
  const BT* we;
  const float* s3;
  const float* b3;
  float* h1;
  float* h2;
  float* v;  // the F(2,3) mid's V
  float* part;
  unsigned int* bar;
  int N, H, W, Cio, Cmid, B, wino;
  wt::GemmPhase reduce, mid, expand;
  wtc::Conv wconv;  // the F(2,3) mid's geometry and cut
  wtc::Cut wcut;
};

// kVec: Cio and Cmid multiples of 4 (of 8 for bf16 weights), every operand
// 16-byte aligned (the TMA maps and 16-byte A copies).
template <bool kVec, class BT>
__global__ void __launch_bounds__(wg::kThreads, kMaxBlocksPerSm)
    stage_kernel(const __grid_constant__ StageArgs<BT> a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bars[wg::kStages];
  wg::Ring ring = wg::make_ring(smem, bars);
  const int cio = a.Cio, cmid = a.Cmid;
  const int P = a.N * a.H * a.W;
  bool pre = false;
  for (int blk = 0; blk < a.B; ++blk) {
    const float* act = blk == 0 ? a.x : a.out;
    const size_t bm = static_cast<size_t>(blk) * cmid, bo = static_cast<size_t>(blk) * cio;
    const wg::Weights<BT> wr{&a.map_r, a.wr + bm * cio, cmid, cio, blk};
    const wg::Weights<BT> wm{&a.map_m, a.wm + bm * 9 * cmid, cmid, 9 * cmid, blk};
    const wg::Weights<BT> we{&a.map_e, a.we + bm * cio, cio, cmid, blk};

    const wt::BnEpilogue e1{a.s1 + bm, a.b1 + bm, a.h1, cmid, 1};
    ph::phase_items<kVec>(a.reduce, tc::RowMajorA{act, P, cio}, wr, e1, a.part, ring, pre);
    if (!a.wino) pre = ph::prefetch_phase<kVec>(a.mid, wm, ring);
    ph::reduce_phase(a.reduce, e1, a.part, a.bar);
    wt::grid_sync(a.bar);

    const wt::BnEpilogue e2{a.s2 + bm, a.b2 + bm, a.h2, cmid, 1};
    if (a.wino)
      wtc::phase<2, kVec, true>(a.wconv, a.wcut, a.h1, a.wm + bm * 16 * cmid, a.s2 + bm,
                                a.b2 + bm, a.h2, 1, a.v, a.part, a.bar,
                                wtc::Tc{&a.map_u, blk * 16, &ring});
    else
      ph::phase_items<kVec>(a.mid, tc::Im2colA{a.h1, a.H, a.W, cmid, P}, wm, e2, a.part, ring,
                            pre);
    pre = ph::prefetch_phase<kVec>(a.expand, we, ring);
    if (!a.wino) ph::reduce_phase(a.mid, e2, a.part, a.bar);
    wt::grid_sync(a.bar);

    const wt::ResidualEpilogue e3{a.s3 + bo, a.b3 + bo, act, a.out, cio};
    ph::phase_items<kVec>(a.expand, tc::RowMajorA{a.h2, P, cmid}, we, e3, a.part, ring, pre);
    if (blk + 1 < a.B)
      pre = ph::prefetch_phase<kVec>(
          a.reduce, wg::Weights<BT>{&a.map_r, a.wr + (bm + cmid) * cio, cmid, cio, blk + 1}, ring);
    ph::reduce_phase(a.expand, e3, a.part, a.bar);
    if (blk + 1 < a.B) wt::grid_sync(a.bar);
  }
}

template <class BT>
const void* kernel_of(bool vec) {
  return vec ? reinterpret_cast<const void*>(&stage_kernel<true, BT>)
             : reinterpret_cast<const void*>(&stage_kernel<false, BT>);
}

// Dynamic shared memory: the wgmma ring, every phase's.
template <class BT>
constexpr size_t kSmem = wg::kSmemBytes<BT>;

// Blocks of the instantiation the current device holds resident, at most
// kMaxBlocksPerSm an SM (the dynamic shared memory limit raised once per
// device); 0 on error.
template <class BT>
int resident_blocks(bool vec) {
  static int cache[64][2] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev][vec] == 0) {
    const void* kernel = kernel_of<BT>(vec);
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmem<BT>)) != cudaSuccess)
      return 0;
    cache[dev][vec] = cooperative_grid(kernel, kSmem<BT>, wg::kThreads, kMaxBlocksPerSm);
  }
  return cache[dev][vec];
}

struct Plan {
  int grid;
  wt::GemmPhase reduce, mid, expand;
  wtc::Conv wconv;
  wtc::Cut wcut;
  size_t h1, h2, v, part, total;  // workspace offsets and size, in floats
};

// The host's plan: `grid` blocks; phases[0..5] the (splits, chunk) of the
// reduce, the direct mid (read when !wino) and the expand; wcut the F(2,3)
// mid's cut (read when wino), which must fit (wino_tf32.cuh::cut_fits).
int make_plan(int N, int H, int W, int Cio, int Cmid, int wino, wtc::Cut wcut, int grid,
              const int* phases, Plan* pl) {
  if (N <= 0 || H <= 0 || W <= 0 || Cio <= 0 || Cmid <= 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  pl->wconv = wtc::make_conv<2>(N, H, W, Cmid, Cmid);
  pl->wcut = wcut;
  if (wino && !wtc::cut_fits(pl->wconv, wcut)) return static_cast<int>(cudaErrorInvalidValue);
  pl->grid = grid;
  const int P = N * H * W;
  pl->reduce = wt::GemmPhase{P, Cio, Cmid, phases[0], phases[1]};
  pl->mid = wino ? wt::GemmPhase{P, 9 * Cmid, Cmid, 1, 9 * Cmid}
                 : wt::GemmPhase{P, 9 * Cmid, Cmid, phases[2], phases[3]};
  pl->expand = wt::GemmPhase{P, Cmid, Cio, phases[4], phases[5]};
  if (!ph::phase_fits(pl->reduce) || !ph::phase_fits(pl->mid) || !ph::phase_fits(pl->expand))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t part = phase_partial_floats(pl->reduce);
  if (phase_partial_floats(pl->expand) > part) part = phase_partial_floats(pl->expand);
  const size_t mid = wino ? wtc::part_floats(pl->wconv, 16, pl->wcut)
                          : phase_partial_floats(pl->mid);
  if (mid > part) part = mid;
  pl->h1 = kWorkspaceAlign;  // the barrier's two counters sit at the front
  pl->h2 = pl->h1 + workspace_round_up(static_cast<size_t>(P) * Cmid);
  pl->v = pl->h2 + workspace_round_up(static_cast<size_t>(P) * Cmid);
  pl->part = pl->v + (wino ? workspace_round_up(wtc::v_floats(pl->wconv, 16)) : 0);
  pl->total = pl->part + part;
  return 0;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <class BT>
int stage(const float* x, const BT* wr, const float* s1, const float* b1, const BT* wm,
          const float* s2, const float* b2, const BT* we, const float* s3, const float* b3,
          float* out, float* ws, long long ws_floats, int N, int H, int W, int Cio, int Cmid,
          int B, int wino, int wsplits, int wchunk, int grid, const int* phases,
          void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kVecChannels = std::is_same_v<BT, float> ? 4 : 8;
  const bool vec = Cio % kVecChannels == 0 && Cmid % kVecChannels == 0 && aligned16(x) &&
                   aligned16(out) && aligned16(wr) && aligned16(wm) && aligned16(we) &&
                   aligned16(ws);
  Plan pl;
  int err = make_plan(N, H, W, Cio, Cmid, wino, wtc::Cut{wsplits, wchunk}, grid, phases, &pl);
  if (err != 0) return err;
  const int resident = resident_blocks<BT>(vec);
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (grid > resident || ws_floats < static_cast<long long>(pl.total))
    return static_cast<int>(cudaErrorInvalidValue);
  StageArgs<BT> a{};
  if (vec) {
    cudaError_t e = wg::encode_weights(&a.map_r, wr, B, Cio, Cmid);
    if (e == cudaSuccess && !wino) e = wg::encode_weights(&a.map_m, wm, B, 9 * Cmid, Cmid);
    if (e == cudaSuccess && wino) e = wg::encode_weights(&a.map_u, wm, 16 * B, Cmid, Cmid);
    if (e == cudaSuccess) e = wg::encode_weights(&a.map_e, we, B, Cmid, Cio);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  unsigned int* bar = reinterpret_cast<unsigned int*>(ws);
  cudaError_t e = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  a.x = x;
  a.out = out;
  a.wr = wr;
  a.s1 = s1;
  a.b1 = b1;
  a.wm = wm;
  a.s2 = s2;
  a.b2 = b2;
  a.we = we;
  a.s3 = s3;
  a.b3 = b3;
  a.h1 = ws + pl.h1;
  a.h2 = ws + pl.h2;
  a.v = ws + pl.v;
  a.part = ws + pl.part;
  a.bar = bar;
  a.N = N;
  a.H = H;
  a.W = W;
  a.Cio = Cio;
  a.Cmid = Cmid;
  a.B = B;
  a.wino = wino;
  a.reduce = pl.reduce;
  a.mid = pl.mid;
  a.expand = pl.expand;
  a.wconv = pl.wconv;
  a.wcut = pl.wcut;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel_of<BT>(vec), dim3(pl.grid), dim3(wg::kThreads), args,
                                  kSmem<BT>, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Blocks an SM the kernel's cooperative grid takes at most (the host's plan,
// kernels/stage.py::STAGE_BLOCKS_PER_SM, checks against it).
extern "C" int resnet_stage_blocks_per_sm() { return kMaxBlocksPerSm; }

// Floats of workspace resnet_stage (and resnet_stage_bf16w) needs for this
// shape, F(2,3) cut (wsplits Cin ranges of wchunk) and plan (grid blocks,
// phases[0..5] the reduce's, the direct mid's and the expand's splits and
// chunk), into *floats; returns a CUDA error code.
extern "C" int resnet_stage_workspace(int N, int H, int W, int Cio, int Cmid, int wino,
                                      int wsplits, int wchunk, int grid, const int* phases,
                                      long long* floats) {
  Plan pl;
  const int err =
      make_plan(N, H, W, Cio, Cmid, wino, wtc::Cut{wsplits, wchunk}, grid, phases, &pl);
  if (err != 0) return err;
  *floats = static_cast<long long>(pl.total);
  return 0;
}

extern "C" int resnet_stage(const float* x, const float* wr, const float* s1,
                            const float* b1, const float* wm, const float* s2,
                            const float* b2, const float* we, const float* s3,
                            const float* b3, float* out, float* ws,
                            long long ws_floats, int N, int H, int W, int Cio,
                            int Cmid, int B, int wino, int wsplits, int wchunk, int grid,
                            const int* phases, void* stream) {
  return stage(x, wr, s1, b1, wm, s2, b2, we, s3, b3, out, ws, ws_floats, N, H, W, Cio, Cmid, B,
               wino, wsplits, wchunk, grid, phases, stream);
}

// The bf16w tier: wr, wm and we bf16, the rest as resnet_stage.
extern "C" int resnet_stage_bf16w(const float* x, const __nv_bfloat16* wr, const float* s1,
                                  const float* b1, const __nv_bfloat16* wm, const float* s2,
                                  const float* b2, const __nv_bfloat16* we, const float* s3,
                                  const float* b3, float* out, float* ws, long long ws_floats,
                                  int N, int H, int W, int Cio, int Cmid, int B, int wino,
                                  int wsplits, int wchunk, int grid, const int* phases,
                                  void* stream) {
  return stage(x, wr, s1, b1, wm, s2, b2, we, s3, b3, out, ws, ws_floats, N, H, W, Cio, Cmid, B,
               wino, wsplits, wchunk, grid, phases, stream);
}
