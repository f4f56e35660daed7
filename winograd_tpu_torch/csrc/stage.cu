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
// a persistent cooperative kernel whose grid is what the card holds
// resident (at most kMaxBlocksPerSm 128-thread blocks an SM). Each phase
// deals its work items to all blocks, and a grid barrier (grid_sync.cuh)
// separates phases and blocks; h1 and h2 live in a device workspace that
// fits the 50 MB L2 (12.8 MB at N=8 conv2_x). The GEMM phases (reduce, the
// direct mid on an implicit im2col of h1, expand with its residual) are
// splitk_tf32.cuh's gemm_phase: 64 x 64 3xTF32 mma.sync tiles on a 4-deep
// cp.async ring (mma_tf32.cuh), K split over blocks where a phase has
// fewer tiles than the grid has blocks or an item would walk more than
// kMaxWalk of K, the splits added in order behind a grid barrier
// (deterministic). The F(2,3) mid is wino_tf32.cuh's phase, the per-layer
// Winograd's: V written once, then items of one position, Cin range and
// 64 x 64 block of tiles and channels on the same tiles, then the grid
// applies At M At^T and BN, two barriers apart; its Cin split is the
// host's (kernels/winograd.py::winograd_plan for Cmid, passed in by
// kernels/stage.py), whose grid of two blocks an SM is kMaxBlocksPerSm's. So a block is three
// phases, each one item walk plus its split reduction (the Winograd mid
// also its V phase), and four to seven grid barriers. One dynamic shared
// buffer (the MMA ring, 72 KB) serves every phase.
//
// The bf16w tier (resnet_stage_bf16w: w_reduce, the mid's w9 or u2 and
// w_expand in bf16, BN f32; the JAX kernel at precision="bf16w") is the
// same kernel on mma_bf16w.cuh's tile (wt::mma_tile by the weights' type):
// every GEMM phase and the F(2,3) mid's products split their f32 A hi/lo
// into two bf16 m16n8k16 passes on the bf16 weights, half the weight bytes
// (conv5_x streams 8.9 MB a block, not 17.8) and a third of the
// tensor-core instructions; the V phase, the inverse and the epilogues
// stay FP32. The ring takes 58 KB.

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "splitk_tf32.cuh"
#include "wino_tf32.cuh"

namespace {

namespace tc = wt::tf32x3;
namespace sk = wt::splitk;
namespace wtc = wt::winotc;

constexpr int kMaxBlocksPerSm = 2;  // blocks an SM in the cooperative grid, at most
constexpr int kMaxWalk = 512;       // K a GEMM item walks, at most

// BT: the weights' element type, float or __nv_bfloat16 (bf16w).
template <class BT>
struct StageArgs {
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
// 16-byte aligned.
template <bool kVec, class BT>
__global__ void __launch_bounds__(tc::kThreads, kMaxBlocksPerSm) stage_kernel(StageArgs<BT> a) {
  extern __shared__ __align__(16) float smem[];
  const int cio = a.Cio, cmid = a.Cmid;
  const int P = a.N * a.H * a.W;
  for (int blk = 0; blk < a.B; ++blk) {
    const float* act = blk == 0 ? a.x : a.out;
    const size_t bm = static_cast<size_t>(blk) * cmid, bo = static_cast<size_t>(blk) * cio;

    sk::gemm_phase<kVec, true>(a.reduce, tc::RowMajorA{act, P, cio}, a.wr + bm * cio,
                               wt::BnEpilogue{a.s1 + bm, a.b1 + bm, a.h1, cmid, 1}, a.part,
                               a.bar, smem);
    wt::grid_sync(a.bar);

    if (a.wino)
      wtc::phase<2, kVec, true>(a.wconv, a.wcut, a.h1, a.wm + bm * 16 * cmid, a.s2 + bm,
                                a.b2 + bm, a.h2, 1, a.v, a.part, a.bar, smem);
    else
      sk::gemm_phase<kVec, true>(a.mid, tc::Im2colA{a.h1, a.H, a.W, cmid, P},
                                 a.wm + bm * 9 * cmid,
                                 wt::BnEpilogue{a.s2 + bm, a.b2 + bm, a.h2, cmid, 1}, a.part,
                                 a.bar, smem);
    wt::grid_sync(a.bar);

    sk::gemm_phase<kVec, true>(
        a.expand, tc::RowMajorA{a.h2, P, cmid}, a.we + bm * cio,
        wt::ResidualEpilogue{a.s3 + bo, a.b3 + bo, act, a.out, cio}, a.part, a.bar, smem);
    if (blk + 1 < a.B) wt::grid_sync(a.bar);
  }
}

template <class BT>
const void* kernel_of(bool vec) {
  return vec ? reinterpret_cast<const void*>(&stage_kernel<true, BT>)
             : reinterpret_cast<const void*>(&stage_kernel<false, BT>);
}

// Blocks of the instantiation in the cooperative grid: what the current
// device holds resident, at most kMaxBlocksPerSm an SM (the dynamic shared
// memory limit raised once per device); 0 on error.
template <class BT>
int grid_size(bool vec) {
  static int cache[64][2] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev][vec] == 0) {
    const void* kernel = kernel_of<BT>(vec);
    constexpr size_t smem = wt::kTileSmemBytes<BT>;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess)
      return 0;
    cache[dev][vec] = cooperative_grid(kernel, smem, tc::kThreads, kMaxBlocksPerSm);
  }
  return cache[dev][vec];
}

// The K split of a GEMM phase: about one item a block, and K cut further
// until no item walks more than kMaxWalk of it (an item's walk is latency
// bound, so items beyond one a block still pay; kernels/direct.py's rule).
wt::GemmPhase tf32_phase(int P, int K, int N, int grid) {
  const int tiles = ((P + tc::kBM - 1) / tc::kBM) * ((N + tc::kBN - 1) / tc::kBN);
  const int walk = (K + kMaxWalk - 1) / kMaxWalk;
  return split_k(P, K, N, grid / tiles > walk ? grid / tiles : walk, tc::kBK);
}

struct Plan {
  int grid;
  wt::GemmPhase reduce, mid, expand;
  wtc::Conv wconv;
  wtc::Cut wcut;
  size_t h1, h2, v, part, total;  // workspace offsets and size, in floats
};

// vec: the kVec instantiation of the BT kernel (the instantiations have
// the same plan but may hold different grids); wcut: the F(2,3) mid's cut
// (read when wino), which must fit (wino_tf32.cuh::cut_fits).
template <class BT>
int make_plan(int N, int H, int W, int Cio, int Cmid, int wino, wtc::Cut wcut, bool vec,
              Plan* pl) {
  if (N <= 0 || H <= 0 || W <= 0 || Cio <= 0 || Cmid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  pl->wconv = wtc::make_conv<2>(N, H, W, Cmid, Cmid);
  pl->wcut = wcut;
  if (wino && !wtc::cut_fits(pl->wconv, wcut)) return static_cast<int>(cudaErrorInvalidValue);
  pl->grid = grid_size<BT>(vec);
  if (pl->grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int P = N * H * W;
  pl->reduce = tf32_phase(P, Cio, Cmid, pl->grid);
  pl->mid = wino ? split_k(P, 9 * Cmid, Cmid, 1, tc::kBK)
               : tf32_phase(P, 9 * Cmid, Cmid, pl->grid);
  pl->expand = tf32_phase(P, Cmid, Cio, pl->grid);
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
int workspace(int N, int H, int W, int Cio, int Cmid, int wino, int wsplits, int wchunk,
              long long* floats) {
  long long most = 0;
  for (const bool vec : {true, false}) {
    Plan pl;
    const int err = make_plan<BT>(N, H, W, Cio, Cmid, wino, wtc::Cut{wsplits, wchunk}, vec, &pl);
    if (err != 0) return err;
    if (static_cast<long long>(pl.total) > most) most = static_cast<long long>(pl.total);
  }
  *floats = most;
  return 0;
}

template <class BT>
int stage(const float* x, const BT* wr, const float* s1, const float* b1, const BT* wm,
          const float* s2, const float* b2, const BT* we, const float* s3, const float* b3,
          float* out, float* ws, long long ws_floats, int N, int H, int W, int Cio, int Cmid,
          int B, int wino, int wsplits, int wchunk, void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kVecChannels = std::is_same_v<BT, float> ? 4 : 8;
  const bool vec = Cio % kVecChannels == 0 && Cmid % kVecChannels == 0 && aligned16(x) &&
                   aligned16(out) && aligned16(wr) && aligned16(wm) && aligned16(we) &&
                   aligned16(ws);
  Plan pl;
  const int err = make_plan<BT>(N, H, W, Cio, Cmid, wino, wtc::Cut{wsplits, wchunk}, vec, &pl);
  if (err != 0) return err;
  if (ws_floats < static_cast<long long>(pl.total))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  unsigned int* bar = reinterpret_cast<unsigned int*>(ws);
  cudaError_t e = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  StageArgs<BT> a{x,  out, wr, s1, b1, wm, s2, b2, we, s3, b3,
                  ws + pl.h1, ws + pl.h2, ws + pl.v, ws + pl.part, bar,
                  N,  H,   W,  Cio, Cmid, B, wino, pl.reduce, pl.mid, pl.expand, pl.wconv, pl.wcut};
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel_of<BT>(vec), dim3(pl.grid), dim3(tc::kThreads), args,
                                  wt::kTileSmemBytes<BT>, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of workspace resnet_stage (bf16w = 0) or resnet_stage_bf16w (1)
// needs for this shape and F(2,3) cut (wsplits Cin ranges of wchunk) on
// the current device (into *floats); returns a CUDA error code. A kernel's
// two instantiations' plans differ at most in their grid, so the larger
// workspace is given.
extern "C" int resnet_stage_workspace(int N, int H, int W, int Cio, int Cmid, int wino,
                                      int wsplits, int wchunk, int bf16w, long long* floats) {
  return bf16w ? workspace<__nv_bfloat16>(N, H, W, Cio, Cmid, wino, wsplits, wchunk, floats)
               : workspace<float>(N, H, W, Cio, Cmid, wino, wsplits, wchunk, floats);
}

extern "C" int resnet_stage(const float* x, const float* wr, const float* s1,
                            const float* b1, const float* wm, const float* s2,
                            const float* b2, const float* we, const float* s3,
                            const float* b3, float* out, float* ws,
                            long long ws_floats, int N, int H, int W, int Cio,
                            int Cmid, int B, int wino, int wsplits, int wchunk,
                            void* stream) {
  return stage(x, wr, s1, b1, wm, s2, b2, we, s3, b3, out, ws, ws_floats, N, H, W, Cio, Cmid, B,
               wino, wsplits, wchunk, stream);
}

// The bf16w tier: wr, wm and we bf16, the rest as resnet_stage.
extern "C" int resnet_stage_bf16w(const float* x, const __nv_bfloat16* wr, const float* s1,
                                  const float* b1, const __nv_bfloat16* wm, const float* s2,
                                  const float* b2, const __nv_bfloat16* we, const float* s3,
                                  const float* b3, float* out, float* ws, long long ws_floats,
                                  int N, int H, int W, int Cio, int Cmid, int B, int wino,
                                  int wsplits, int wchunk, void* stream) {
  return stage(x, wr, s1, b1, wm, s2, b2, we, s3, b3, out, ws, ws_floats, N, H, W, Cio, Cmid, B,
               wino, wsplits, wchunk, stream);
}
