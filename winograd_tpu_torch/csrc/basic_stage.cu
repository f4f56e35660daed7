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
// Bound on the H100: at N=1 and B=2, 4 convs of 2 * 49 * 4608 * 512 FLOPs,
// 0.925 GFLOP, take 13.8 us at the 67 TFLOP/s FP32 rate; the f32 weights,
// 2 * 2 * 9.4 MB read once, take 11.3 us at 3.35 TB/s: bound by operations,
// near the ridge.
//
// Design: the TPU kernel keeps the activation in VMEM across both convs and
// all blocks while Pallas streams each block's weights. Here it is the
// persistent cooperative kernel of csrc/stage.cu: each conv is a phase
// walked over all blocks of the grid on gemm.cuh's 64 x 64 FP32 FFMA tile,
// with the im2col matrix gathered into shared memory as the tile is loaded
// (grid_sync.cuh's Im2colCg), and a grid barrier between phases; h1 lives
// in a device workspace that stays in L2. At N=1 the map has 49 rows
// against a (4608, 512) weight, 8 output tiles for a grid of hundreds of
// blocks, so each phase splits K into up to 36 ranges of 128 and adds the
// partial sums in a fixed order after a barrier (deterministic, no
// atomics): most blocks stream a slice of the weights instead of idling.
// FP32 FFMA with FP32 sums (the JAX kernel's bf16x3 products are within
// its 1e-4 bar of these).

#include "common.cuh"
#include "gemm.cuh"
#include "grid_sync.cuh"

namespace {

constexpr int kMaxSplits = 36;  // 4608 / 128: the 7x7x512 conv at N=1
constexpr size_t kSmemBytes = sizeof(float) * wt::kGemmSmemFloats;

struct BasicStageArgs {
  const float* x;
  float* out;
  const float* wa;  // (B, 9*C, C)
  const float* sa;  // (B, 1, C)
  const float* ba;
  const float* wb;
  const float* sb;
  const float* bb;
  float* h1;
  float* part;
  unsigned int* bar;
  int N, H, W, C, B;
  wt::GemmPhase conv;
};

__global__ void __launch_bounds__(wt::kGemmThreads) basic_stage_kernel(BasicStageArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int c = a.C;
  for (int blk = 0; blk < a.B; ++blk) {
    const float* act = blk == 0 ? a.x : a.out;
    const size_t bw = static_cast<size_t>(blk) * 9 * c * c;
    const size_t bc = static_cast<size_t>(blk) * c;

    wt::gemm_phase(a.conv, wt::Im2colCg{act, a.H, a.W, c}, a.wa + bw,
                   wt::BnEpilogue{a.sa + bc, a.ba + bc, a.h1, c, 1}, a.part, a.bar, smem);
    wt::grid_sync(a.bar);

    wt::gemm_phase(a.conv, wt::Im2colCg{a.h1, a.H, a.W, c}, a.wb + bw,
                   wt::ResidualEpilogue{a.sb + bc, a.bb + bc, act, a.out, c}, a.part, a.bar,
                   smem);
    if (blk + 1 < a.B) wt::grid_sync(a.bar);
  }
}

int grid_size() {
  static int cache[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0)
    cache[dev] = cooperative_grid(reinterpret_cast<const void*>(basic_stage_kernel), kSmemBytes);
  return cache[dev];
}

struct Plan {
  int grid;
  wt::GemmPhase conv;
  size_t h1, part, total;  // workspace offsets and size, in floats
};

int make_plan(int N, int H, int W, int C, Plan* pl) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  pl->grid = grid_size();
  if (pl->grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int P = N * H * W;
  pl->conv = plan_phase(P, 9 * C, C, pl->grid, wt::kBK, kMaxSplits);
  pl->h1 = kWorkspaceAlign;  // the barrier's two counters sit at the front
  pl->part = pl->h1 + workspace_round_up(static_cast<size_t>(P) * C);
  pl->total = pl->part + phase_partial_floats(pl->conv);
  return 0;
}

}  // namespace

// Floats of workspace basic_stage needs for this shape on the current
// device (into *floats); returns a CUDA error code.
extern "C" int basic_stage_workspace(int N, int H, int W, int C, long long* floats) {
  Plan pl;
  const int err = make_plan(N, H, W, C, &pl);
  if (err == 0) *floats = static_cast<long long>(pl.total);
  return err;
}

extern "C" int basic_stage(const float* x, const float* wa, const float* sa, const float* ba,
                           const float* wb, const float* sb, const float* bb, float* out,
                           float* ws, long long ws_floats, int N, int H, int W, int C, int B,
                           void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  const int err = make_plan(N, H, W, C, &pl);
  if (err != 0) return err;
  if (ws_floats < static_cast<long long>(pl.total))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  unsigned int* bar = reinterpret_cast<unsigned int*>(ws);
  cudaError_t e = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  BasicStageArgs a{x, out, wa, sa, ba, wb, sb, bb, ws + pl.h1, ws + pl.part, bar,
                   N, H, W, C, B, pl.conv};
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(basic_stage_kernel),
                                  dim3(pl.grid), dim3(wt::kGemmThreads), args, kSmemBytes, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
