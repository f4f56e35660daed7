// The int8 stride-2 ResNet transition block over all N images in one
// persistent launch, with qdot the int8 product of gemm_int8.cuh (per-row
// dynamic activation scale, int8 weights with per-column scales, exact
// int32 sum, dequantized in f32):
//   h1   = relu(qdot(x, w_reduce) * s1 + b1)                  (full resolution)
//   h2   = relu(qdot(im2col_s2(h1), w9_mid) * s2 + b2)        (stride-2 3x3)
//   out  = relu(qdot(h2, w_expand) * s3 + b3
//               + qdot(x[:, ::2, ::2], w_proj) * sp + bp)
// The 3x3 uses SAME padding for stride 2: output (oy, ox) takes taps
// (2 oy + r - 1, 2 ox + s - 1), zero outside the map, ho = ceil(H / 2). The
// expand and projection sides are quantized separately (h2 rows over Cmid,
// subsampled x rows over Cin), each dequantized with its own BN, then added.
//
// Replaces: winograd_tpu/kernels/quantized.py::_transition_int8_kernel and
// ::_transition_int8_kernel_resident (transition_block_int8_pallas). The two
// TPU bodies differ only in which loop is outer; here every phase runs over
// all N images' rows and reads each weight once per launch, so one kernel
// covers both. On the int8 ResNet-50 path it runs the transitions 56->28
// (256->128->512), 28->14 (512->256->1024) and 14->7 (1024->512->2048).
//
// Bound on the H100: ~0.37 G int8 MACs per transition at N=1 (0.4 us at
// 1979 TOPS) against x and out in f32 and the int8 weights read once
// (5.2 / 3.9 / 7.2 MB, 1.2-2.2 us): bound by bytes.
//
// Design: the persistent cooperative kernel of csrc/transition.cu with the
// int8 tile of gemm_int8.cuh. Each int8 GEMM phase is preceded by a scale
// sub-phase (one warp per row, over the whole row; the strided im2col rows
// over their 9*Cmid window, zero padding included) and a grid barrier; the
// projection rows' scales are found beside the expand rows'. The f32 kernel
// (csrc/transition.cu) fuses expand and projection into one GEMM over
// [h2 | xs]; that cannot carry over, because the two halves have different
// row scales. The
// last phase runs both products per output tile, each into its own int32
// accumulator, and one epilogue adds the two dequantized, BN-scaled halves
// (each multiply and add rounded on its own, in the plain version's order,
// so that the two agree to the bit).
// Where that phase has fewer tiles than the grid has blocks, each product is
// split over K separately (int32 partial sums, one slot per split) and the
// slots are added after a barrier.

#include "common.cuh"
#include "gemm_int8.cuh"
#include "grid_sync.cuh"

namespace {

constexpr size_t kSmemBytes = wt::kInt8SmemBytes;

// The projection operand x[:, ::2, ::2] at output rows p = (n, oy, ox).
struct SubsampleA {
  const float* __restrict__ x;
  int H, W, C, Ho, Wo;
  __device__ __forceinline__ float operator()(int p, int k) const {
    const int hwo = Ho * Wo;
    const int n = p / hwo;
    const int q = p - n * hwo;
    return x[(static_cast<size_t>(n * H + 2 * (q / Wo)) * W + 2 * (q % Wo)) * C + k];
  }
};

struct TransitionInt8Args {
  const float* x;
  float* out;
  const int8_t* wr;
  const float* swr;
  const float* s1;
  const float* b1;
  const int8_t* w9;
  const float* sw9;
  const float* s2;
  const float* b2;
  const int8_t* we;
  const float* swe;
  const float* s3;
  const float* b3;
  const int8_t* wp;
  const float* swp;
  const float* sp;
  const float* bp;
  float* h1;
  float* h2;
  float* sx;  // row scales: max(P1, 2 * P2); h2's then xs's in the last phase
  int* part;
  unsigned int* bar;
  int N, H, W, Cin, Cmid, Cout;
  wt::GemmPhase reduce, mid, expand, proj;  // expand/proj: K splits of the last phase
};

// out = relu(dequant(a1) * s3 + b3 + dequant(a2) * sp + bp).
__device__ __forceinline__ void dual_epilogue(const TransitionInt8Args& a, int p, int n,
                                              int a1, float sh, int a2, float sxs) {
  const float h3 = wt::bn_rn(wt::dequant(a1, sh, a.swe[n]), a.s3[n], a.b3[n]);
  const float sk = wt::bn_rn(wt::dequant(a2, sxs, a.swp[n]), a.sp[n], a.bp[n]);
  a.out[static_cast<size_t>(p) * a.Cout + n] = fmaxf(__fadd_rn(h3, sk), 0.f);
}

__device__ void expand_and_project(const TransitionInt8Args& a, int* smem) {
  float* sxs = reinterpret_cast<float*>(smem + 2 * wt::kW8 * wt::kBM);
  const int ho = (a.H + 1) / 2, wo = (a.W + 1) / 2;
  const int P = a.N * ho * wo;
  const float* sh_ws = a.sx;
  const float* sxs_ws = a.sx + P;
  const wt::RowsCg h2{a.h2, a.Cmid};
  const SubsampleA xs{a.x, a.H, a.W, a.Cin, ho, wo};
  const int tiles_n = (a.Cout + wt::kBN - 1) / wt::kBN;
  const int tiles = ((P + wt::kBM - 1) / wt::kBM) * tiles_n;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int slots = a.expand.splits + a.proj.splits;
  const bool split = slots > 2;
  for (int item = blockIdx.x; item < tiles * (split ? slots : 1); item += gridDim.x) {
    const int slot = item / tiles;
    const int t = item - slot * tiles;
    const int p0 = (t / tiles_n) * wt::kBM;
    const int n0 = (t % tiles_n) * wt::kBN;
    int acc[4][4];
    if (split) {
      const bool e = slot < a.expand.splits;
      const wt::GemmPhase& g = e ? a.expand : a.proj;
      const int k0 = (e ? slot : slot - a.expand.splits) * g.chunk;
      const int k1 = min(g.K, k0 + g.chunk);
      wt::load_tile_scales(e ? sh_ws : sxs_ws, 1, P, p0, sxs);
      if (e)
        wt::int8_tile(h2, a.we, sxs, P, a.Cout, p0, n0, k0, k1, smem, acc);
      else
        wt::int8_tile(xs, a.wp, sxs, P, a.Cout, p0, n0, k0, k1, smem, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tx * 4 + j;
          if (p < P && n < a.Cout)
            a.part[(static_cast<size_t>(slot) * P + p) * a.Cout + n] = acc[i][j];
        }
      }
      continue;
    }
    wt::load_tile_scales(sh_ws, 1, P, p0, sxs);
    wt::int8_tile(h2, a.we, sxs, P, a.Cout, p0, n0, 0, a.Cmid, smem, acc);
    float sh[4];
    int acc_e[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sh[i] = sxs[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_e[i][j] = acc[i][j];
    }
    wt::load_tile_scales(sxs_ws, 1, P, p0, sxs);
    wt::int8_tile(xs, a.wp, sxs, P, a.Cout, p0, n0, 0, a.Cin, smem, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (p < P && n < a.Cout)
          dual_epilogue(a, p, n, acc_e[i][j], sh[i], acc[i][j], sxs[ty * 4 + i]);
      }
    }
  }
  if (!split) return;
  wt::grid_sync(a.bar);
  const size_t pn = static_cast<size_t>(P) * a.Cout;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < pn;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    int a1 = 0, a2 = 0;
    for (int k = 0; k < a.expand.splits; ++k) a1 += __ldcg(a.part + k * pn + i);
    for (int k = a.expand.splits; k < slots; ++k) a2 += __ldcg(a.part + k * pn + i);
    const int p = static_cast<int>(i / a.Cout);
    dual_epilogue(a, p, static_cast<int>(i % a.Cout), a1, __ldcg(sh_ws + p), a2,
                  __ldcg(sxs_ws + p));
  }
}

__global__ void __launch_bounds__(wt::kGemmThreads) transition_int8_kernel(TransitionInt8Args a) {
  extern __shared__ __align__(16) int smem[];
  const int ho = (a.H + 1) / 2, wo = (a.W + 1) / 2;
  const int P1 = a.N * a.H * a.W;
  const int P2 = a.N * ho * wo;
  const wt::RowsCg x{a.x, a.Cin};
  wt::row_scales_phase(x, P1, a.Cin, 1, a.sx);
  wt::grid_sync(a.bar);
  wt::int8_gemm_phase(a.reduce, x, a.wr, a.sx,
                      wt::Int8BnEpilogue{a.swr, a.s1, a.b1, a.h1, a.Cmid, 1}, a.part, a.bar,
                      smem);
  wt::grid_sync(a.bar);
  const wt::Im2colS2Cg col{a.h1, a.H, a.W, a.Cmid, ho, wo};
  wt::row_scales_phase(col, P2, 9 * a.Cmid, 1, a.sx);
  wt::grid_sync(a.bar);
  wt::int8_gemm_phase(a.mid, col, a.w9, a.sx,
                      wt::Int8BnEpilogue{a.sw9, a.s2, a.b2, a.h2, a.Cmid, 1}, a.part, a.bar,
                      smem);
  wt::grid_sync(a.bar);
  wt::row_scales_phase(wt::RowsCg{a.h2, a.Cmid}, P2, a.Cmid, 1, a.sx);
  wt::row_scales_phase(SubsampleA{a.x, a.H, a.W, a.Cin, ho, wo}, P2, a.Cin, 1, a.sx + P2);
  wt::grid_sync(a.bar);
  expand_and_project(a, smem);
}

int grid_size() {
  static int cache[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0)
    cache[dev] =
        cooperative_grid(reinterpret_cast<const void*>(transition_int8_kernel), kSmemBytes);
  return cache[dev];
}

struct Plan {
  int grid;
  wt::GemmPhase reduce, mid, expand, proj;
  size_t h1, h2, sx, part, total;  // workspace offsets and size, in 4-byte words
};

int make_plan(int N, int H, int W, int Cin, int Cmid, int Cout, Plan* pl) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cmid <= 0 || Cout <= 0 || Cin % 4 != 0 ||
      Cmid % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  pl->grid = grid_size();
  if (pl->grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int P1 = N * H * W;
  const int P2 = N * ((H + 1) / 2) * ((W + 1) / 2);
  pl->reduce = plan_phase(P1, Cin, Cmid, pl->grid, wt::kBK8);
  pl->mid = plan_phase(P2, 9 * Cmid, Cmid, pl->grid, wt::kBK8);
  // The last phase: about one item per block, its splits shared between
  // the two products in proportion to their K.
  const int tiles = ((P2 + wt::kBM - 1) / wt::kBM) * ((Cout + wt::kBN - 1) / wt::kBN);
  const int slots = pl->grid / tiles;
  const int want_e = (slots * Cmid + (Cmid + Cin) / 2) / (Cmid + Cin);
  pl->expand = split_k(P2, Cmid, Cout, want_e, wt::kBK8);
  pl->proj = split_k(P2, Cin, Cout, slots - pl->expand.splits, wt::kBK8);
  size_t part = phase_partial_floats(pl->reduce);
  if (phase_partial_floats(pl->mid) > part) part = phase_partial_floats(pl->mid);
  const int fin = pl->expand.splits + pl->proj.splits;
  if (fin > 2 && static_cast<size_t>(fin) * P2 * Cout > part)
    part = static_cast<size_t>(fin) * P2 * Cout;
  const size_t rows = P1 > 2 * P2 ? P1 : 2 * P2;
  pl->h1 = kWorkspaceAlign;  // the barrier's two counters sit at the front
  pl->h2 = pl->h1 + workspace_round_up(static_cast<size_t>(P1) * Cmid);
  pl->sx = pl->h2 + workspace_round_up(static_cast<size_t>(P2) * Cmid);
  pl->part = pl->sx + workspace_round_up(rows);
  pl->total = pl->part + part;
  return 0;
}

}  // namespace

// 4-byte words of workspace transition_block_int8 needs for this shape on
// the current device (into *words); returns a CUDA error code.
extern "C" int transition_block_int8_workspace(int N, int H, int W, int Cin, int Cmid,
                                               int Cout, long long* words) {
  Plan pl;
  const int err = make_plan(N, H, W, Cin, Cmid, Cout, &pl);
  if (err == 0) *words = static_cast<long long>(pl.total);
  return err;
}

extern "C" int transition_block_int8(
    const float* x, const int8_t* wr, const float* swr, const float* s1, const float* b1,
    const int8_t* w9, const float* sw9, const float* s2, const float* b2, const int8_t* we,
    const float* swe, const float* s3, const float* b3, const int8_t* wp, const float* swp,
    const float* sp, const float* bp, float* out, float* ws, long long ws_words, int N, int H,
    int W, int Cin, int Cmid, int Cout, void* stream) {
  Plan pl;
  const int err = make_plan(N, H, W, Cin, Cmid, Cout, &pl);
  if (err != 0) return err;
  if (ws_words < static_cast<long long>(pl.total))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  unsigned int* bar = reinterpret_cast<unsigned int*>(ws);
  cudaError_t e = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  TransitionInt8Args a{x,   out, wr,  swr, s1,  b1,  w9,  sw9, s2,  b2,
                       we,  swe, s3,  b3,  wp,  swp, sp,  bp,
                       ws + pl.h1, ws + pl.h2, ws + pl.sx,
                       reinterpret_cast<int*>(ws + pl.part), bar,
                       N,   H,   W,   Cin, Cmid, Cout,
                       pl.reduce, pl.mid, pl.expand, pl.proj};
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(transition_int8_kernel),
                                  dim3(pl.grid), dim3(wt::kGemmThreads), args, kSmemBytes, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
