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
// Bound on the H100: ~0.75 GFLOP per transition at N=1 against 6.3 / 8.4 /
// 25.3 MB (x, out and the weights read once); bound by the FP32 FFMA rate
// (67 TFLOP/s), the last one nearly by its 25 MB of weights (7.6 us).
//
// Design: the persistent cooperative kernel of csrc/stage.cu with three
// GEMM phases separated by grid barriers; h1 and h2 live in a device
// workspace that fits the L2. The strided im2col tile and the projection operand
// x[::2, ::2] are gathered by the A loaders of the 64 x 64 FFMA tile
// (gemm.cuh) and never materialised. Phases with fewer tiles than the grid
// has blocks split K and add the splits in a fixed order after a barrier.

#include "common.cuh"
#include "gemm.cuh"
#include "grid_sync.cuh"

namespace {

constexpr size_t kSmemBytes = sizeof(float) * wt::kGemmSmemFloats;

struct TransitionArgs {
  const float* x;
  const float* wr;
  const float* s1;
  const float* b1;
  const float* w9;
  const float* s2;
  const float* b2;
  const float* wep;
  const float* bep;
  float* out;
  float* h1;
  float* h2;
  float* part;
  unsigned int* bar;
  int N, H, W, Cin, Cmid, Cout;
  wt::GemmPhase reduce, mid, expand;
};

// [h2 | x[:, ::2, ::2]] at output rows p = (n, oy, ox): k < Cmid reads h2,
// the rest the block input at (2 oy, 2 ox).
struct ConcatSkipA {
  const float* h2;
  const float* __restrict__ x;
  int H, W, Cin, Cmid, Ho, Wo;
  __device__ __forceinline__ float operator()(int p, int k) const {
    if (k < Cmid) return __ldcg(h2 + static_cast<size_t>(p) * Cmid + k);
    const int hwo = Ho * Wo;
    const int n = p / hwo;
    const int q = p - n * hwo;
    return x[(static_cast<size_t>(n * H + 2 * (q / Wo)) * W + 2 * (q % Wo)) * Cin +
             (k - Cmid)];
  }
};

struct BiasReluEpilogue {
  const float* __restrict__ bias;
  float* out;
  int N;
  __device__ __forceinline__ void operator()(int p, int n, float acc) const {
    out[static_cast<size_t>(p) * N + n] = fmaxf(acc + bias[n], 0.f);
  }
};

__global__ void __launch_bounds__(wt::kGemmThreads) transition_kernel(TransitionArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int ho = (a.H + 1) / 2, wo = (a.W + 1) / 2;
  wt::gemm_phase(a.reduce, wt::RowsCg{a.x, a.Cin}, a.wr,
                 wt::BnEpilogue{a.s1, a.b1, a.h1, a.Cmid, 1}, a.part, a.bar, smem);
  wt::grid_sync(a.bar);
  wt::gemm_phase(a.mid, wt::Im2colS2Cg{a.h1, a.H, a.W, a.Cmid, ho, wo}, a.w9,
                 wt::BnEpilogue{a.s2, a.b2, a.h2, a.Cmid, 1}, a.part, a.bar, smem);
  wt::grid_sync(a.bar);
  wt::gemm_phase(a.expand, ConcatSkipA{a.h2, a.x, a.H, a.W, a.Cin, a.Cmid, ho, wo},
                 a.wep, BiasReluEpilogue{a.bep, a.out, a.Cout}, a.part, a.bar, smem);
}

int grid_size() {
  static int cache[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0)
    cache[dev] = cooperative_grid(reinterpret_cast<const void*>(transition_kernel), kSmemBytes);
  return cache[dev];
}

struct Plan {
  int grid;
  wt::GemmPhase reduce, mid, expand;
  size_t h1, h2, part, total;  // workspace offsets and size, in floats
};

int make_plan(int N, int H, int W, int Cin, int Cmid, int Cout, Plan* pl) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cmid <= 0 || Cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  pl->grid = grid_size();
  if (pl->grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int P1 = N * H * W;
  const int P2 = N * ((H + 1) / 2) * ((W + 1) / 2);
  pl->reduce = plan_phase(P1, Cin, Cmid, pl->grid);
  pl->mid = plan_phase(P2, 9 * Cmid, Cmid, pl->grid);
  pl->expand = plan_phase(P2, Cmid + Cin, Cout, pl->grid);
  size_t part = phase_partial_floats(pl->reduce);
  if (phase_partial_floats(pl->mid) > part) part = phase_partial_floats(pl->mid);
  if (phase_partial_floats(pl->expand) > part) part = phase_partial_floats(pl->expand);
  pl->h1 = kWorkspaceAlign;  // the barrier's two counters sit at the front
  pl->h2 = pl->h1 + workspace_round_up(static_cast<size_t>(P1) * Cmid);
  pl->part = pl->h2 + workspace_round_up(static_cast<size_t>(P2) * Cmid);
  pl->total = pl->part + part;
  return 0;
}

}  // namespace

// Floats of workspace transition_block needs for this shape on the current
// device (into *floats); returns a CUDA error code.
extern "C" int transition_block_workspace(int N, int H, int W, int Cin, int Cmid,
                                          int Cout, long long* floats) {
  Plan pl;
  const int err = make_plan(N, H, W, Cin, Cmid, Cout, &pl);
  if (err == 0) *floats = static_cast<long long>(pl.total);
  return err;
}

extern "C" int transition_block(const float* x, const float* wr, const float* s1,
                                const float* b1, const float* w9, const float* s2,
                                const float* b2, const float* wep,
                                const float* bep, float* out, float* ws,
                                long long ws_floats, int N, int H, int W,
                                int Cin, int Cmid, int Cout, void* stream) {
  Plan pl;
  const int err = make_plan(N, H, W, Cin, Cmid, Cout, &pl);
  if (err != 0) return err;
  if (ws_floats < static_cast<long long>(pl.total))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  unsigned int* bar = reinterpret_cast<unsigned int*>(ws);
  cudaError_t e = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  TransitionArgs a{x,  wr, s1, b1, w9, s2, b2, wep, bep, out,
                   ws + pl.h1, ws + pl.h2, ws + pl.part, bar,
                   N,  H,  W,  Cin, Cmid, Cout, pl.reduce, pl.mid, pl.expand};
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(transition_kernel),
                                  dim3(pl.grid), dim3(wt::kGemmThreads), args,
                                  kSmemBytes, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
