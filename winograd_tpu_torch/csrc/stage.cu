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
// Bound on the H100: at N=1 the FLOPs (2*H*W*(2*Cio*Cmid + 9*Cmid^2) per
// block, fewer with F(2,3)) against x, out and the weights read once: 0.64
// GFLOP on 7.2 MB for conv2_x, 2.2 GFLOP on 24 MB for conv4_x; all bound by
// the FP32 FFMA rate (67 TFLOP/s).
//
// Design: the TPU keeps the activation in VMEM across blocks; an SM's 228 KB
// cannot hold it (conv2_x is 3.2 MB per image), so the Hopper counterpart is
// a persistent cooperative kernel whose grid is what the card holds
// resident. Each phase walks its output tiles over all blocks, and a grid
// barrier (grid_sync.cuh) separates phases and blocks; h1 and h2 live in a
// device workspace that fits the 50 MB L2 (12.8 MB at N=8 conv2_x). The
// GEMM phases use the 64 x 64 FFMA tile of gemm.cuh; a phase with fewer
// tiles than the grid has blocks splits K and adds the splits in a fixed
// order after a barrier (deterministic, no atomics). The F(2,3) mid-layer is the Winograd tile
// body of winograd.cuh at 16 tiles x 64 channels per item. One dynamic
// shared buffer is carved per phase. FP32 FFMA throughout (the 1e-4 bar).

#include "common.cuh"
#include "gemm.cuh"
#include "grid_sync.cuh"
#include "winograd.cuh"

namespace {

constexpr int kWinoTiles = 16;  // Winograd tiles per item (256 threads)
constexpr size_t kSmemBytes =
    sizeof(float) * (wt::wino_smem_floats<2, kWinoTiles>() > wt::kGemmSmemFloats
                         ? wt::wino_smem_floats<2, kWinoTiles>()
                         : wt::kGemmSmemFloats);

struct StageArgs {
  const float* x;
  float* out;
  const float* wr;
  const float* s1;
  const float* b1;
  const float* wm;  // (B, 9*Cmid, Cmid) direct or (B, 16, Cmid, Cmid) F(2,3)
  const float* s2;
  const float* b2;
  const float* we;
  const float* s3;
  const float* b3;
  float* h1;
  float* h2;
  float* part;
  unsigned int* bar;
  int N, H, W, Cio, Cmid, B, wino;
  wt::GemmPhase reduce, mid, expand;
};

__global__ void __launch_bounds__(wt::kGemmThreads) stage_kernel(StageArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int cio = a.Cio, cmid = a.Cmid;
  const int th = (a.H + 1) / 2, tw = (a.W + 1) / 2;
  const int wino_items = ((a.N * th * tw + kWinoTiles - 1) / kWinoTiles) *
                         ((cmid + wt::wino_cob<2>() - 1) / wt::wino_cob<2>());
  for (int blk = 0; blk < a.B; ++blk) {
    const float* act = blk == 0 ? a.x : a.out;
    const float* s1 = a.s1 + static_cast<size_t>(blk) * cmid;
    const float* b1 = a.b1 + static_cast<size_t>(blk) * cmid;
    const float* s2 = a.s2 + static_cast<size_t>(blk) * cmid;
    const float* b2 = a.b2 + static_cast<size_t>(blk) * cmid;

    wt::gemm_phase(a.reduce, wt::RowsCg{act, cio},
                   a.wr + static_cast<size_t>(blk) * cio * cmid,
                   wt::BnEpilogue{s1, b1, a.h1, cmid, 1}, a.part, a.bar, smem);
    wt::grid_sync(a.bar);

    if (a.wino) {
      const float* u2 = a.wm + static_cast<size_t>(blk) * 16 * cmid * cmid;
      const int cgroups = (cmid + wt::wino_cob<2>() - 1) / wt::wino_cob<2>();
      for (int item = blockIdx.x; item < wino_items; item += gridDim.x) {
        wt::wino_tile<2, kWinoTiles>(
            wt::CgLoad{}, a.h1, u2, s2, b2, a.h2, a.N, a.H, a.W, cmid, cmid, 1,
            (item / cgroups) * kWinoTiles, (item % cgroups) * wt::wino_cob<2>(),
            threadIdx.x, smem);
      }
    } else {
      wt::gemm_phase(a.mid, wt::Im2colCg{a.h1, a.H, a.W, cmid},
                     a.wm + static_cast<size_t>(blk) * 9 * cmid * cmid,
                     wt::BnEpilogue{s2, b2, a.h2, cmid, 1}, a.part, a.bar, smem);
    }
    wt::grid_sync(a.bar);

    wt::gemm_phase(a.expand, wt::RowsCg{a.h2, cmid},
                   a.we + static_cast<size_t>(blk) * cmid * cio,
                   wt::ResidualEpilogue{a.s3 + static_cast<size_t>(blk) * cio,
                                    a.b3 + static_cast<size_t>(blk) * cio, act,
                                    a.out, cio},
                   a.part, a.bar, smem);
    if (blk + 1 < a.B) wt::grid_sync(a.bar);
  }
}

int grid_size() {
  static int cache[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0) cache[dev] = cooperative_grid(reinterpret_cast<const void*>(stage_kernel), kSmemBytes);
  return cache[dev];
}

struct Plan {
  int grid;
  wt::GemmPhase reduce, mid, expand;
  size_t h1, h2, part, total;  // workspace offsets and size, in floats
};

int make_plan(int N, int H, int W, int Cio, int Cmid, int wino, Plan* pl) {
  if (N <= 0 || H <= 0 || W <= 0 || Cio <= 0 || Cmid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  pl->grid = grid_size();
  if (pl->grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int P = N * H * W;
  pl->reduce = plan_phase(P, Cio, Cmid, pl->grid);
  pl->mid = plan_phase(P, 9 * Cmid, Cmid, wino ? 0 : pl->grid);
  pl->expand = plan_phase(P, Cmid, Cio, pl->grid);
  size_t part = phase_partial_floats(pl->reduce);
  if (phase_partial_floats(pl->mid) > part) part = phase_partial_floats(pl->mid);
  if (phase_partial_floats(pl->expand) > part) part = phase_partial_floats(pl->expand);
  pl->h1 = kWorkspaceAlign;  // the barrier's two counters sit at the front
  pl->h2 = pl->h1 + workspace_round_up(static_cast<size_t>(P) * Cmid);
  pl->part = pl->h2 + workspace_round_up(static_cast<size_t>(P) * Cmid);
  pl->total = pl->part + part;
  return 0;
}

}  // namespace

// Floats of workspace resnet_stage needs for this shape on the current
// device (into *floats); returns a CUDA error code.
extern "C" int resnet_stage_workspace(int N, int H, int W, int Cio, int Cmid,
                                      int wino, long long* floats) {
  Plan pl;
  const int err = make_plan(N, H, W, Cio, Cmid, wino, &pl);
  if (err == 0) *floats = static_cast<long long>(pl.total);
  return err;
}

extern "C" int resnet_stage(const float* x, const float* wr, const float* s1,
                            const float* b1, const float* wm, const float* s2,
                            const float* b2, const float* we, const float* s3,
                            const float* b3, float* out, float* ws,
                            long long ws_floats, int N, int H, int W, int Cio,
                            int Cmid, int B, int wino, void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  const int err = make_plan(N, H, W, Cio, Cmid, wino, &pl);
  if (err != 0) return err;
  if (ws_floats < static_cast<long long>(pl.total))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  unsigned int* bar = reinterpret_cast<unsigned int*>(ws);
  cudaError_t e = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  StageArgs a{x,  out, wr, s1, b1, wm, s2, b2, we, s3, b3,
              ws + pl.h1, ws + pl.h2, ws + pl.part, bar,
              N,  H,   W,  Cio, Cmid, B, wino, pl.reduce, pl.mid, pl.expand};
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(stage_kernel),
                                  dim3(pl.grid), dim3(wt::kGemmThreads), args,
                                  kSmemBytes, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
