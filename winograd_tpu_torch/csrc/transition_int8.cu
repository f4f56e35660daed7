// The int8 stride-2 ResNet transition block over all N images in one
// persistent launch, with qdot the int8 product of mma_int8.cuh (per-row
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
// Design: csrc/stage_int8.cu's phases on mma_int8.cuh (mma.sync s8 x s8 ->
// s32 on 64 x 64 tiles, cp.async stages, K split over exact int32 partial
// sums). A row's scale needs the max over the whole row, which the phase
// before produces across blocks, so each product is preceded by a quantize
// phase and a grid barrier, and each row is quantized once:
// 0. The four weight matrices are written k-contiguous (reduce, 3x3 mid,
//    expand, projection: mma.sync's B operand), beside the quantization of
//    x's rows over Cin.
// 1. The reduce (x's int8 rows by the reduce weights) into h1, f32.
// 2. Each strided im2col row of h1 is quantized over its 9 * Cmid window,
//    zero padding included (mma_int8.cuh's Im2colRows at stride 2).
// 3. The mid product into h2.
// 4. h2's rows are quantized over Cmid. x[:, ::2, ::2]'s rows are x's own
//    rows, already quantized over Cin in phase 0: their int8 values and
//    scales are gathered, not quantized again.
// 5. Both products of each output tile, each into its own int32
//    accumulators (or split over K into separate slots, added after a
//    barrier), and one epilogue adds the two dequantized, BN-scaled halves
//    (each multiply and add rounded on its own, in the plain version's
//    order) and applies the ReLU.
// Int32 sums are exact and the epilogues round as the plain twin does, so
// the kernel equals kernels/quantized.py::transition_block_int8_plain to the
// bit. The grid and every phase's K split are the host's plan
// (kernels/quantized.py::transition_int8_plan); this entry checks it against
// the geometry compiled here, works out the workspace's layout from it, and
// refuses a plan that does not fit.

#include <stdint.h>

#include "common.cuh"
#include "mma_int8.cuh"

namespace {

namespace s8 = wt::s8mma;

constexpr int kBlocksPerSm = 2;
constexpr int kSplitStep = s8::kBK;

struct Split {
  int splits, chunk;  // K as `splits` ranges of `chunk`, the last one shorter
};

struct TransitionInt8Args {
  const float* x;
  float* out;
  const int8_t* wr;  // (Cin, Cmid)
  const float* swr;
  const float* s1;
  const float* b1;
  const int8_t* w9;  // (9 Cmid, Cmid)
  const float* sw9;
  const float* s2;
  const float* b2;
  const int8_t* we;  // (Cmid, Cout)
  const float* swe;
  const float* s3;
  const float* b3;
  const int8_t* wp;  // (Cin, Cout)
  const float* swp;
  const float* sp;
  const float* bp;
  float* h1;         // (P1, Cmid)
  float* h2;         // (P2, Cmid)
  float* sxx;        // P1 row scales of x
  float* sxm;        // P2 row scales of the strided im2col of h1
  float* sxe;        // P2 row scales of h2
  float* sxp;        // P2 row scales of x[:, ::2, ::2] (gathered from sxx)
  int8_t* aqx;       // (P1, kpr) x's rows, quantized
  int8_t* aqm;       // (P2, kpm) the im2col rows of h1
  int8_t* aqe;       // (P2, kpe) h2's rows
  int8_t* aqp;       // (P2, kpr) x[:, ::2, ::2]'s rows (gathered from aqx)
  int8_t* btr;       // (Cmid, kpr) weights, k-contiguous
  int8_t* btm;       // (Cmid, kpm)
  int8_t* bte;       // (Cout, kpe)
  int8_t* btp;       // (Cout, kpr)
  int* part;         // int32 partial sums
  unsigned int* bar;
  int N, H, W, Cin, Cmid, Cout, kpr, kpm, kpe;
  Split reduce, mid, expand, proj;
};

// out = relu(dequant(a1) * s3 + b3 + dequant(a2) * sp + bp).
__device__ __forceinline__ void dual_epilogue(const TransitionInt8Args& a, int p, int n,
                                              int a1, float sh, int a2, float sxs) {
  const float h3 = wt::bn_rn(wt::dequant(a1, sh, a.swe[n]), a.s3[n], a.b3[n]);
  const float sk = wt::bn_rn(wt::dequant(a2, sxs, a.swp[n]), a.sp[n], a.bp[n]);
  a.out[static_cast<size_t>(p) * a.Cout + n] = wt::relu(__fadd_rn(h3, sk));
}

// Phase 4's gather: x[:, ::2, ::2]'s quantized rows and scales from x's.
__device__ void gather_subsampled_rows(const TransitionInt8Args& a, int ho, int wo) {
  const int P2 = a.N * ho * wo;
  const int v16 = a.kpr / 16;  // 16-byte pieces a row
  const long long items = static_cast<long long>(P2) * v16;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < items;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int p = static_cast<int>(i / v16);
    const int v = static_cast<int>(i - static_cast<long long>(p) * v16);
    const int n = p / (ho * wo), q = p - n * ho * wo;
    const int src = (n * a.H + 2 * (q / wo)) * a.W + 2 * (q % wo);
    const uint4* from = reinterpret_cast<const uint4*>(a.aqx + static_cast<size_t>(src) * a.kpr);
    reinterpret_cast<uint4*>(a.aqp + static_cast<size_t>(p) * a.kpr)[v] = __ldcg(from + v);
    if (v == 0) a.sxp[p] = __ldcg(a.sxx + src);
  }
}

// Phase 5: out over (P2, Cout) tiles. With one K range each, a work item is
// a tile and holds both products' accumulators; otherwise items are (slot,
// tile) pairs, slots 0 .. expand.splits - 1 the expand's K ranges and the
// rest the projection's, each writing int32 partials; after a barrier each
// element adds its expand slots and its projection slots apart, in slot
// order, and runs the epilogue.
__device__ void expand_and_project(const TransitionInt8Args& a, int P, int8_t* smem) {
  const int tiles_n = (a.Cout + s8::kBN - 1) / s8::kBN;
  const int tiles = (P + s8::kBM - 1) / s8::kBM * tiles_n;
  const int se = a.expand.splits, slots = se + a.proj.splits;
  if (slots == 2) {
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int p0 = t / tiles_n * s8::kBM, n0 = t % tiles_n * s8::kBN;
      s8::Acc ae, ap;
      s8::tile(a.aqe, a.bte, P, a.Cout, a.kpe, p0, n0, 0, a.kpe, smem, ae);
      s8::tile(a.aqp, a.btp, P, a.Cout, a.kpr, p0, n0, 0, a.kpr, smem, ap);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = p0 + s8::acc_row(mi, e), n = n0 + s8::acc_col(ni, e);
            if (p < P && n < a.Cout)
              dual_epilogue(a, p, n, ae[mi][ni][e], __ldcg(a.sxe + p), ap[mi][ni][e],
                            __ldcg(a.sxp + p));
          }
    }
    return;
  }
  const size_t pn = static_cast<size_t>(P) * a.Cout;
  for (int item = blockIdx.x; item < tiles * slots; item += gridDim.x) {
    const int slot = item / tiles, t = item - slot * tiles;
    const int p0 = t / tiles_n * s8::kBM, n0 = t % tiles_n * s8::kBN;
    const bool e = slot < se;
    const int kp = e ? a.kpe : a.kpr;
    const int k0 = (e ? slot : slot - se) * (e ? a.expand.chunk : a.proj.chunk);
    const int k1 = min(kp, k0 + (e ? a.expand.chunk : a.proj.chunk));
    s8::Acc acc;
    s8::tile(e ? a.aqe : a.aqp, e ? a.bte : a.btp, P, a.Cout, kp, p0, n0, k0, k1, smem, acc);
    int* sp = a.part + slot * pn;
    s8::for_each_acc(acc, [&](int r, int c, int v) {
      const int p = p0 + r, n = n0 + c;
      if (p < P && n < a.Cout) sp[static_cast<size_t>(p) * a.Cout + n] = v;
    });
  }
  wt::grid_sync(a.bar);
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < pn;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    int a1 = 0, a2 = 0;
    for (int k = 0; k < se; ++k) a1 += __ldcg(a.part + k * pn + i);
    for (int k = se; k < slots; ++k) a2 += __ldcg(a.part + k * pn + i);
    const int p = static_cast<int>(i / a.Cout);
    dual_epilogue(a, p, static_cast<int>(i % a.Cout), a1, __ldcg(a.sxe + p), a2,
                  __ldcg(a.sxp + p));
  }
}

__global__ void __launch_bounds__(s8::kThreads, kBlocksPerSm)
    transition_int8_kernel(TransitionInt8Args a) {
  __shared__ __align__(16) int8_t smem[s8::kSmemBytes];
  __shared__ float red[s8::kThreads / 32];
  const int ho = (a.H + 1) / 2, wo = (a.W + 1) / 2;
  const int P1 = a.N * a.H * a.W, P2 = a.N * ho * wo;

  // 0. The four weight matrices k-contiguous, their items dealt to the grid
  // in one walk; x's rows quantized.
  {
    const s8::Transpose tr = {a.wr, a.Cin, a.Cmid, a.kpr, a.btr};
    const s8::Transpose tm = {a.w9, 9 * a.Cmid, a.Cmid, a.kpm, a.btm};
    const s8::Transpose te = {a.we, a.Cmid, a.Cout, a.kpe, a.bte};
    const s8::Transpose tp = {a.wp, a.Cin, a.Cout, a.kpr, a.btp};
    const long long e0 = tr.items(), e1 = e0 + tm.items(), e2 = e1 + te.items();
    const long long total = e2 + tp.items();
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
         i += static_cast<long long>(gridDim.x) * blockDim.x) {
      if (i < e0)
        tr.item(i);
      else if (i < e1)
        tm.item(i - e0);
      else if (i < e2)
        te.item(i - e1);
      else
        tp.item(i - e2);
    }
  }
  s8::quantize_rows_phase(s8::RowsCg4{a.x, a.Cin}, P1, a.Cin, a.kpr, a.aqx, a.sxx, red);
  wt::grid_sync(a.bar);
  // 1. The reduce.
  s8::gemm_phase(a.aqx, a.btr, a.sxx, P1, a.Cmid, a.kpr, a.reduce.splits, a.reduce.chunk,
                 wt::Int8BnEpilogue{a.swr, a.s1, a.b1, a.h1, a.Cmid, 1}, a.part, a.bar, smem);
  wt::grid_sync(a.bar);
  // 2. The strided im2col rows of h1.
  s8::quantize_rows_phase(s8::Im2colRows<true, true, 2>{a.h1, a.H, a.W, a.Cmid / 4}, P2,
                          9 * a.Cmid, a.kpm, a.aqm, a.sxm, red);
  wt::grid_sync(a.bar);
  // 3. The mid.
  s8::gemm_phase(a.aqm, a.btm, a.sxm, P2, a.Cmid, a.kpm, a.mid.splits, a.mid.chunk,
                 wt::Int8BnEpilogue{a.sw9, a.s2, a.b2, a.h2, a.Cmid, 1}, a.part, a.bar, smem);
  wt::grid_sync(a.bar);
  // 4. h2's rows; the projection's rows gathered.
  s8::quantize_rows_phase(s8::RowsCg4{a.h2, a.Cmid}, P2, a.Cmid, a.kpe, a.aqe, a.sxe, red);
  gather_subsampled_rows(a, ho, wo);
  wt::grid_sync(a.bar);
  // 5. Expand and projection.
  expand_and_project(a, P2, smem);
}

// Blocks of the kernel the current device holds resident at once (a
// cooperative grid may not be larger), at most kBlocksPerSm an SM; 0 on
// error.
int resident_blocks() {
  static int cache[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0)
    cache[dev] = cooperative_grid(reinterpret_cast<const void*>(transition_int8_kernel), 0,
                                  s8::kThreads, kBlocksPerSm);
  return cache[dev];
}

int round_k(int k) { return (k + s8::kKAlign - 1) / s8::kKAlign * s8::kKAlign; }

// 4-byte words holding `bytes` bytes, rounded up to the workspace's step.
size_t words_of(size_t bytes) { return workspace_round_up((bytes + 3) / 4); }

// K as `s` fits K in ranges the phases walk: every index in one range, each
// range but the last a multiple of the staging step.
bool fits(const Split& s, int K) {
  return s.splits >= 1 && s.chunk >= 1 && static_cast<long long>(s.chunk) * s.splits >= K &&
         static_cast<long long>(s.chunk) * (s.splits - 1) < K &&
         (s.splits == 1 || s.chunk % kSplitStep == 0);
}

struct Layout {
  int kpr, kpm, kpe;
  // workspace offsets and size, in 4-byte words
  size_t h1, h2, sx, aqx, aqm, aqe, aqp, btr, btm, bte, btp, part, total;
};

// The workspace of a checked plan: the grid barrier's two counters at word
// 0, then h1, h2, the row scales (x's, the im2col's, h2's, the projection's),
// the quantized rows, the transposed weights and the int32 partial sums of
// the phase that splits most; 0 if the shape or the plan does not fit.
int make_layout(int N, int H, int W, int Cin, int Cmid, int Cout, int blocks, const Split* sp,
                Layout* l) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cmid <= 0 || Cout <= 0 || Cin % 4 != 0 ||
      Cmid % 4 != 0 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  l->kpr = round_k(Cin);
  l->kpm = round_k(9 * Cmid);
  l->kpe = round_k(Cmid);
  if (!fits(sp[0], l->kpr) || !fits(sp[1], l->kpm) || !fits(sp[2], l->kpe) ||
      !fits(sp[3], l->kpr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t P1 = static_cast<size_t>(N) * H * W;
  const size_t P2 = static_cast<size_t>(N) * ((H + 1) / 2) * ((W + 1) / 2);
  size_t part = 0;
  if (sp[0].splits > 1) part = sp[0].splits * P1 * Cmid;
  if (sp[1].splits > 1 && sp[1].splits * P2 * Cmid > part) part = sp[1].splits * P2 * Cmid;
  const size_t slots = sp[2].splits + sp[3].splits;
  if (slots > 2 && slots * P2 * Cout > part) part = slots * P2 * Cout;
  l->h1 = kWorkspaceAlign;
  l->h2 = l->h1 + workspace_round_up(P1 * Cmid);
  l->sx = l->h2 + workspace_round_up(P2 * Cmid);
  l->aqx = l->sx + workspace_round_up(P1 + 3 * P2);
  l->aqm = l->aqx + words_of(P1 * l->kpr);
  l->aqe = l->aqm + words_of(P2 * l->kpm);
  l->aqp = l->aqe + words_of(P2 * l->kpe);
  l->btr = l->aqp + words_of(P2 * l->kpr);
  l->btm = l->btr + words_of(static_cast<size_t>(Cmid) * l->kpr);
  l->bte = l->btm + words_of(static_cast<size_t>(Cmid) * l->kpm);
  l->btp = l->bte + words_of(static_cast<size_t>(Cout) * l->kpe);
  l->part = l->btp + words_of(static_cast<size_t>(Cout) * l->kpr);
  l->total = l->part + part;
  return 0;
}

}  // namespace

// 4-byte words of workspace transition_block_int8 needs for this shape and
// plan (into *words); returns a CUDA error code.
extern "C" int transition_block_int8_workspace(int N, int H, int W, int Cin, int Cmid,
                                               int Cout, int blocks, int rs, int rc, int ms,
                                               int mc, int es, int ec, int ps, int pc,
                                               long long* words) {
  const Split sp[4] = {{rs, rc}, {ms, mc}, {es, ec}, {ps, pc}};
  Layout l;
  const int err = make_layout(N, H, W, Cin, Cmid, Cout, blocks, sp, &l);
  if (err == 0) *words = static_cast<long long>(l.total);
  return err;
}

// The host's plan (kernels/quantized.py::transition_int8_plan): a
// cooperative grid of `blocks` blocks, at most as many as the device holds
// resident; the K splits (splits, chunk) of the reduce (rs, rc, over Cin
// padded to s8::kKAlign), the mid (ms, mc, over 9 Cmid padded), and the last
// phase's expand (es, ec, over Cmid padded) and projection (ps, pc, over Cin
// padded): each range but the last a multiple of kSplitStep. Cin and Cmid
// multiples of 4 (the wrapper pads other counts with zero channels); x
// 16-byte aligned; ws at least transition_block_int8_workspace's words.
extern "C" int transition_block_int8(
    const float* x, const int8_t* wr, const float* swr, const float* s1, const float* b1,
    const int8_t* w9, const float* sw9, const float* s2, const float* b2, const int8_t* we,
    const float* swe, const float* s3, const float* b3, const int8_t* wp, const float* swp,
    const float* sp, const float* bp, float* out, float* ws, long long ws_words, int N, int H,
    int W, int Cin, int Cmid, int Cout, int blocks, int rs, int rc, int ms, int mc, int es,
    int ec, int ps, int pc, void* stream) {
  const Split plan[4] = {{rs, rc}, {ms, mc}, {es, ec}, {ps, pc}};
  Layout l;
  const int err = make_layout(N, H, W, Cin, Cmid, Cout, blocks, plan, &l);
  if (err != 0) return err;
  if (ws_words < static_cast<long long>(l.total) || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int resident = resident_blocks();
  if (resident <= 0 || blocks > resident) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto s = static_cast<cudaStream_t>(stream);
  unsigned int* bar = reinterpret_cast<unsigned int*>(ws);
  cudaError_t e = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t P1 = static_cast<size_t>(N) * H * W;
  const size_t P2 = static_cast<size_t>(N) * ((H + 1) / 2) * ((W + 1) / 2);
  float* sx = ws + l.sx;
  const auto i8 = [&](size_t at) { return reinterpret_cast<int8_t*>(ws + at); };
  TransitionInt8Args a{x,  out, wr, swr, s1, b1, w9, sw9, s2, b2, we, swe, s3, b3, wp, swp,
                       sp, bp,  ws + l.h1, ws + l.h2, sx, sx + P1, sx + P1 + P2,
                       sx + P1 + 2 * P2, i8(l.aqx), i8(l.aqm), i8(l.aqe), i8(l.aqp),
                       i8(l.btr), i8(l.btm), i8(l.bte), i8(l.btp),
                       reinterpret_cast<int*>(ws + l.part), bar,
                       N, H, W, Cin, Cmid, Cout, l.kpr, l.kpm, l.kpe,
                       plan[0], plan[1], plan[2], plan[3]};
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(transition_int8_kernel),
                                  dim3(blocks), dim3(s8::kThreads), args, 0, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
