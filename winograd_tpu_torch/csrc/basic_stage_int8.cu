// B int8 identity basic blocks (ResNet-18/34) over all N images in one
// persistent launch: per block b, with qdot(A, W) the int8 product of
// gemm_int8.cuh (per-row dynamic activation scale, int8 weights with
// per-column scales, exact int32 sum, dequantized in f32) and im2col the
// stride-1 SAME 3x3 patch matrix (K = 9 * C, zero padding included in each
// row's scale),
//   h1  = relu(qdot(im2col(act), w9_a_q[b]) * s_a[b] + b_a[b])
//   out = relu(qdot(im2col(h1), w9_b_q[b]) * s_b[b] + b_b[b] + act)
// with act = x for block 0 and out afterwards (updated in place: each
// residual element is read only by the thread that overwrites it).
//
// Replaces: winograd_tpu/kernels/basic_stage.py::_basic_stage_int8_kernel
// (basic_stage_int8_pallas). On the int8 ResNet-34 path it runs conv5_x's
// two identity blocks at 7x7x512 (ResNet-18: one).
//
// Bound on the H100: at N=1 and B=2 the 0.46 G int8 MACs take 0.47 us at
// 1979 TOPS and the quantization and epilogues ~1 us at the FP32 rate; the
// int8 weights, 4 * 2.4 MB read once, take 2.8 us at 3.35 TB/s: bound by
// bytes.
//
// Design: the persistent cooperative kernel of csrc/basic_stage.cu on the
// int8 tile of gemm_int8.cuh, with stage_int8.cu's direct-mid recipe. A
// row's scale needs its whole 9 * C window before a GEMM can quantize it,
// and that window was written by many blocks in the previous phase; so each
// conv is preceded by a scale sub-phase (one warp per im2col row, zero
// padding included) that writes the scales to the workspace, and a grid
// barrier. The GEMM phases split K over int32 partial sums (up to 36 ranges
// at N=1, where the 49-row map has 8 output tiles); the sum is exact, so
// the f32 epilogue runs once per element after it, as
// acc * (s_x * s_w) * s + b (+ act), each multiply and add rounded on its
// own in the plain version's order, so the two agree to the bit.

#include "common.cuh"
#include "gemm_int8.cuh"
#include "grid_sync.cuh"

namespace {

constexpr int kMaxSplits = 36;  // 4608 / 128: the 7x7x512 conv at N=1

struct BasicStageInt8Args {
  const float* x;
  float* out;
  const int8_t* wa;  // (B, 9*C, C) int8
  const float* swa;  // (B, 1, C) weight scales
  const float* sa;   // (B, 1, C) folded BN
  const float* ba;
  const int8_t* wb;
  const float* swb;
  const float* sb;
  const float* bb;
  float* h1;
  float* sx;  // row scales, P
  int* part;
  unsigned int* bar;
  int N, H, W, C, B;
  wt::GemmPhase conv;
};

__global__ void __launch_bounds__(wt::kGemmThreads) basic_stage_int8_kernel(BasicStageInt8Args a) {
  __shared__ __align__(16) int smem[wt::kInt8SmemBytes / 4];
  const int c = a.C;
  const int P = a.N * a.H * a.W;
  for (int blk = 0; blk < a.B; ++blk) {
    const float* act = blk == 0 ? a.x : a.out;
    const size_t bw = static_cast<size_t>(blk) * 9 * c * c;
    const size_t bc = static_cast<size_t>(blk) * c;

    const wt::Im2colCg cola{act, a.H, a.W, c};
    wt::row_scales_phase(cola, P, 9 * c, 1, a.sx);
    wt::grid_sync(a.bar);
    wt::int8_gemm_phase(a.conv, cola, a.wa + bw, a.sx,
                        wt::Int8BnEpilogue{a.swa + bc, a.sa + bc, a.ba + bc, a.h1, c, 1},
                        a.part, a.bar, smem);
    wt::grid_sync(a.bar);

    const wt::Im2colCg colb{a.h1, a.H, a.W, c};
    wt::row_scales_phase(colb, P, 9 * c, 1, a.sx);
    wt::grid_sync(a.bar);
    wt::int8_gemm_phase(a.conv, colb, a.wb + bw, a.sx,
                        wt::ResidualInt8Epilogue{a.swb + bc, a.sb + bc, a.bb + bc, act, a.out, c},
                        a.part, a.bar, smem);
    if (blk + 1 < a.B) wt::grid_sync(a.bar);
  }
}

int grid_size() {
  static int cache[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0)
    cache[dev] = cooperative_grid(reinterpret_cast<const void*>(basic_stage_int8_kernel), 0);
  return cache[dev];
}

struct Plan {
  int grid;
  wt::GemmPhase conv;
  size_t h1, sx, part, total;  // workspace offsets and size, in 4-byte words
};

int make_plan(int N, int H, int W, int C, Plan* pl) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || (9 * C) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  pl->grid = grid_size();
  if (pl->grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int P = N * H * W;
  pl->conv = plan_phase(P, 9 * C, C, pl->grid, wt::kBK8, kMaxSplits);
  pl->h1 = kWorkspaceAlign;  // the barrier's two counters sit at the front
  pl->sx = pl->h1 + workspace_round_up(static_cast<size_t>(P) * C);
  pl->part = pl->sx + workspace_round_up(static_cast<size_t>(P));
  pl->total = pl->part + phase_partial_floats(pl->conv);
  return 0;
}

}  // namespace

// 4-byte words of workspace basic_stage_int8 needs for this shape on the
// current device (into *words); returns a CUDA error code.
extern "C" int basic_stage_int8_workspace(int N, int H, int W, int C, long long* words) {
  Plan pl;
  const int err = make_plan(N, H, W, C, &pl);
  if (err == 0) *words = static_cast<long long>(pl.total);
  return err;
}

extern "C" int basic_stage_int8(const float* x, const int8_t* wa, const float* swa,
                                const float* sa, const float* ba, const int8_t* wb,
                                const float* swb, const float* sb, const float* bb, float* out,
                                float* ws, long long ws_words, int N, int H, int W, int C, int B,
                                void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  const int err = make_plan(N, H, W, C, &pl);
  if (err != 0) return err;
  if (ws_words < static_cast<long long>(pl.total)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  unsigned int* bar = reinterpret_cast<unsigned int*>(ws);
  cudaError_t e = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  BasicStageInt8Args a{x,  out, wa, swa, sa, ba, wb, swb, sb, bb,
                       ws + pl.h1, ws + pl.sx, reinterpret_cast<int*>(ws + pl.part), bar,
                       N,  H,   W,  C,   B,  pl.conv};
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(basic_stage_int8_kernel),
                                  dim3(pl.grid), dim3(wt::kGemmThreads), args, 0, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
