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
// (5.2 / 3.9 / 7.2 MB, 1.2-2.2 us): bound by bytes. At N=1 what a launch
// costs is its phases' fixed latency and its grid barriers.
//
// Design: csrc/stage_int8.cu's folded phases (wgmma_s8_phase.cuh) on
// wgmma_s8.cuh's s8 wgmma m64n64k32 tiles, two warpgroups a block each on
// items of its own, the weights by TMA from k-contiguous (N, Kp) copies
// made once per weight tensor, at its first launch (quantized.py::
// transition_int8_kmajor; s8 wgmma reads both operands K-major and TMA
// cannot transpose bytes), so no phase of the launch transposes weights and
// no phase only quantizes:
// 1. The reduce: each block takes the maxima of its share of x's rows (a
//    warp a row) and quantizes the share into aqx (scales sxx); each item
//    waits for its row block's counter. Its epilogue writes h1 and
//    publishes h1's pixel maxima (mx1).
// 2. The mid: a block's share of the strided im2col rows of h1 is
//    quantized with each row's max the max of its nine taps' pixel maxima
//    (0 for a tap outside the map, as the padding gives); its epilogue
//    writes h2 and publishes h2's row maxima (mx2).
// 3. The expand and the projection: a block's share of h2's rows is
//    quantized from mx2 into aqe; the projection's rows are x's own
//    quantized rows, read from aqx at their source pixel (2 oy, 2 ox) with
//    their scales sxx (no gather, no quantization). An item (one K range
//    each) walks the projection's stages, which wait for nothing, then the
//    expand's (their rows after its row block's counter) in one pass of the
//    ring (wgmma_s8.cuh::tile_pair), each into int32 accumulators of its
//    own, and one epilogue adds the two dequantized, BN-scaled halves
//    (each multiply and add rounded on its own, in the plain version's
//    order) and applies the ReLU. Split, its items (slot, tile) write int32
//    partials, added after a grid barrier, expand slots and projection
//    slots apart.
// Each phase's first weight boxes are issued before the grid barrier ahead
// of it. Grid barriers: two (reduce | mid | expand and projection), plus
// one for each phase that splits K; the row blocks' counters, the row
// maxima and the barrier are zeroed by one memset at launch. Int32 sums are
// exact and every rounding is the plain twin's, so the kernel equals
// kernels/quantized.py::transition_block_int8_plain to the bit. The grid
// and every phase's K split are the host's plan (kernels/quantized.py::
// transition_int8_plan); this entry checks it against the geometry compiled
// here, works out the workspace's layout from it, and refuses a plan that
// does not fit.

#include <cuda.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma_s8.cuh"
#include "wgmma_s8_phase.cuh"

namespace {

namespace q8 = wt::wgs8;
namespace ph = wt::s8phase;

constexpr int kBlocksPerSm = 1;
constexpr int kSplitCap = 16;
constexpr int kKAlign = 32;  // K of the quantized rows and the k-contiguous weights padded to this

struct TransitionInt8Args {
  CUtensorMap map_r, map_m, map_e, map_p;  // k-contiguous (N, Kp) weights
  const float* x;
  float* out;
  const float* swr;
  const float* s1;
  const float* b1;
  const float* sw9;
  const float* s2;
  const float* b2;
  const float* swe;
  const float* s3;
  const float* b3;
  const float* swp;
  const float* sp;
  const float* bp;
  float* h1;      // (P1, Cmid)
  float* h2;      // (P2, Cmid)
  float* sxx;     // P1 row scales of x
  float* sxm;     // P2 row scales of the strided im2col of h1
  float* sxe;     // P2 row scales of h2
  unsigned* mx1;  // P1 pixel maxima of h1
  unsigned* mx2;  // P2 row maxima of h2
  unsigned* cnt;  // the row blocks' counters: the reduce's, the mid's, the expand's
  int8_t* aqx;    // (P1, kpr) x's rows, quantized
  int8_t* aqm;    // (P2, kpm) the im2col rows of h1
  int8_t* aqe;    // (P2, kpe) h2's rows
  int* part;      // int32 partial sums
  unsigned int* bar;
  int N, H, W, Cin, Cmid, Cout, kpr, kpm, kpe, rb1;
  wt::GemmPhase reduce, mid, expand, proj;
};

// The projection's A rows: row p = (n, oy, ox) of the output is x's row at
// (n, 2 oy, 2 ox), quantized in the reduce.
struct StridedRowsA {
  const int8_t* aq;
  int Kp, H, W, ho, wo;
  __device__ __forceinline__ int src(int p) const {
    const int n = p / (ho * wo), q = p - n * (ho * wo);
    return (n * H + 2 * (q / wo)) * W + 2 * (q % wo);
  }
  __device__ __forceinline__ const int8_t* row(int p) const {
    return aq + static_cast<size_t>(src(p)) * Kp;
  }
};

// out = relu(dequant(a1) * s3 + b3 + dequant(a2) * sp + bp), its
// operands through restricted pointers: the per-column loads of a tile's
// epilogue are not held behind its stores.
struct DualEpi {
  const float* __restrict__ swe;
  const float* __restrict__ s3;
  const float* __restrict__ b3;
  const float* __restrict__ swp;
  const float* __restrict__ sp;
  const float* __restrict__ bp;
  float* __restrict__ out;
  int Cout;
  __device__ __forceinline__ void operator()(int p, int n, int a1, float sh, int a2,
                                             float sxs) const {
    const float h3 = wt::bn_rn(wt::dequant(a1, sh, swe[n]), s3[n], b3[n]);
    const float sk = wt::bn_rn(wt::dequant(a2, sxs, swp[n]), sp[n], bp[n]);
    out[static_cast<size_t>(p) * Cout + n] = wt::relu(__fadd_rn(h3, sk));
  }
};

// The last phase's items: (slot, tile) pairs over its (P2, Cout) tiles,
// slots 0 .. proj.splits - 1 the projection's K ranges, the rest the
// expand's; with one range each, an item is a tile and runs both.
struct DualItem {
  bool proj;
  int slot, rb, p0, n0, k0, k1;
};

__device__ __forceinline__ DualItem dual_item(const TransitionInt8Args& a, int item) {
  const int tiles_n = (a.Cout + q8::kBN - 1) / q8::kBN;
  const int tiles = (a.proj.P + q8::kBM - 1) / q8::kBM * tiles_n;
  const int slot = item / tiles, t = item - slot * tiles;
  const bool proj = slot < a.proj.splits;
  const wt::GemmPhase& g = proj ? a.proj : a.expand;
  const int k0 = (proj ? slot : slot - a.proj.splits) * g.chunk;
  return DualItem{proj, slot, t / tiles_n, t / tiles_n * q8::kBM, t % tiles_n * q8::kBN, k0,
                  min(g.K, k0 + g.chunk)};
}

// The last phase's items: its tiles where one K range each fuses the two
// products into one item, else its tiles by slots.
__device__ __forceinline__ bool dual_fused(const TransitionInt8Args& a) {
  return a.proj.splits + a.expand.splits == 2;
}
__device__ __forceinline__ int dual_items(const TransitionInt8Args& a) {
  const int tiles = (a.proj.P + q8::kBM - 1) / q8::kBM * ((a.Cout + q8::kBN - 1) / q8::kBN);
  return dual_fused(a) ? tiles : tiles * (a.proj.splits + a.expand.splits);
}

// The first item's weight boxes of the last phase: its projection's, then
// its expand's (one walk of both: tile_pair), or its slot's.
__device__ __forceinline__ void prefetch_dual(const TransitionInt8Args& a, const q8::Weights& we,
                                              const q8::Weights& wp, q8::Ring& ring) {
  const int first = blockIdx.x * q8::kWarpgroups + q8::wg_index();
  if (first >= dual_items(a)) return;
  const DualItem it = dual_item(a, first);
  if (dual_fused(a))
    q8::prefetch_pair(ring, wp, a.kpr, we, a.kpe, it.n0);
  else
    q8::prefetch_b(ring, it.proj ? wp : we, it.n0, it.k0, it.k1);
}

// Phase 3: h2's share quantized, then the items (dual_item); we, wp the
// expand's and the projection's weights.
__device__ void expand_and_project(const TransitionInt8Args& a, const q8::Weights& we,
                                   const q8::Weights& wp, q8::Ring& ring, float* scratch) {
  const int P = a.expand.P;
  const int ho = (a.H + 1) / 2, wo = (a.W + 1) / 2;
  const StridedRowsA xs{a.aqx, a.kpr, a.H, a.W, ho, wo};
  unsigned* cnt = a.cnt + a.rb1 + (P + q8::kBM - 1) / q8::kBM;  // after the reduce's and the mid's
  ph::quantize_share(ph::RowsSrc{a.h2, a.Cmid, a.Cmid, a.mx2, 1}, P, a.kpe, a.kpe, a.aqe, a.sxe,
                     cnt, scratch);
  const int items = dual_items(a);
  const int first = blockIdx.x * q8::kWarpgroups + q8::wg_index();
  const int step = gridDim.x * q8::kWarpgroups;
  const DualEpi epi{a.swe, a.s3, a.b3, a.swp, a.sp, a.bp, a.out, a.Cout};
  if (dual_fused(a)) {
    const int r0 = threadIdx.x / 32 % 4 * 16 + threadIdx.x % 32 / 4;  // its rows r0, r0 + 8
    for (int item = first; item < items; item += step) {
      const DualItem it = dual_item(a, item);
      if (item != first) q8::prefetch_pair(ring, wp, a.kpr, we, a.kpe, it.n0);
      q8::Acc ap, ae;
      q8::tile_pair(xs, a.kpr, wp, q8::RowsA{a.aqe, a.kpe}, a.kpe, we, P, it.p0, it.n0, ring,
                    true, ap, ae, [&] { ph::ready(cnt, it.rb, P); });
      float sh[2], sxs[2];  // the two rows' scales, h2's and x's, loaded once
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = min(P - 1, it.p0 + r0 + 8 * h);
        sh[h] = __ldcg(a.sxe + p);
        sxs[h] = __ldcg(a.sxx + xs.src(p));
      }
      q8::for_each_acc([&](int r, int c, int i) {
        const int p = it.p0 + r, n = it.n0 + c;
        const bool h0 = r == r0;
        if (p < P && n < a.Cout)
          epi(p, n, ae[i], h0 ? sh[0] : sh[1], ap[i], h0 ? sxs[0] : sxs[1]);
      });
    }
    return;
  }
  const size_t pn = static_cast<size_t>(P) * a.Cout;
  for (int item = first; item < items; item += step) {
    const DualItem it = dual_item(a, item);
    if (item != first)
      q8::prefetch_b(ring, it.proj ? wp : we, it.n0, it.k0, it.k1);
    q8::Acc acc;
    if (it.proj) {
      q8::tile_rows<false>(xs, P, a.kpr, wp, it.p0, it.n0, it.k0, it.k1, ring, true, acc,
                           ph::NoFin{});
    } else {
      ph::ready(cnt, it.rb, P);
      q8::tile<false>(a.aqe, P, a.kpe, we, it.p0, it.n0, it.k0, it.k1, ring, true, acc,
                      ph::NoFin{});
    }
    int* sp = a.part + static_cast<size_t>(it.slot) * pn;
    q8::for_each_acc([&](int r, int c, int i) {
      const int p = it.p0 + r, n = it.n0 + c;
      if (p < P && n < a.Cout) sp[static_cast<size_t>(p) * a.Cout + n] = acc[i];
    });
  }
  wt::grid_sync(a.bar);
  const int ps = a.proj.splits, slots = ps + a.expand.splits;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < pn;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    int a1 = 0, a2 = 0;
    for (int k = 0; k < ps; ++k) a2 += __ldcg(a.part + k * pn + i);
    for (int k = ps; k < slots; ++k) a1 += __ldcg(a.part + k * pn + i);
    const int p = static_cast<int>(i / a.Cout);
    epi(p, static_cast<int>(i % a.Cout), a1, __ldcg(a.sxe + p), a2, __ldcg(a.sxx + xs.src(p)));
  }
}

__global__ void __launch_bounds__(q8::kThreads, kBlocksPerSm)
    transition_int8_kernel(const __grid_constant__ TransitionInt8Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bars[q8::kWarpgroups * q8::kStages];
  q8::Ring ring = q8::make_ring(smem, bars);
  float* scratch = reinterpret_cast<float*>(ring.base - q8::wg_index() * q8::kRingBytes);
  const q8::Weights wr{&a.map_r, 0}, wm{&a.map_m, 0}, we{&a.map_e, 0}, wp{&a.map_p, 0};

  // 1. The reduce, on x's rows quantized by their own maxima.
  ph::gemm_phase(a.reduce, ph::XRowsSrc{a.x, a.Cin, a.Cin}, a.kpr, wr,
                 ph::BnEpi{a.swr, a.s1, a.b1, a.h1, a.Cmid}, a.mx1, a.aqx, a.sxx, a.cnt, a.part,
                 a.bar, ring, scratch);
  ph::prefetch_phase(a.mid, wm, ring);
  wt::grid_sync(a.bar);
  // 2. The mid, on the strided im2col rows of h1.
  ph::gemm_phase(a.mid, ph::Im2colSrc<2, true>{a.h1, a.H, a.W, a.Cmid, a.mx1}, a.kpm, wm,
                 ph::BnEpi{a.sw9, a.s2, a.b2, a.h2, a.Cmid}, a.mx2, a.aqm, a.sxm, a.cnt + a.rb1,
                 a.part, a.bar, ring, scratch, true);
  prefetch_dual(a, we, wp, ring);
  wt::grid_sync(a.bar);
  // 3. Expand and projection.
  expand_and_project(a, we, wp, ring, scratch);
}

// Blocks of the kernel the current device holds resident at once (a
// cooperative grid may not be larger), at most kBlocksPerSm an SM (its
// dynamic shared memory limit raised once per device); 0 on error.
int resident_blocks() {
  static int cache[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0) {
    const void* kernel = reinterpret_cast<const void*>(transition_int8_kernel);
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q8::kSmemBytes)) != cudaSuccess)
      return 0;
    cache[dev] = cooperative_grid(kernel, q8::kSmemBytes, q8::kThreads, kBlocksPerSm);
  }
  return cache[dev];
}

int round_k(int k) { return (k + kKAlign - 1) / kKAlign * kKAlign; }

// 4-byte words holding `bytes` bytes, rounded up to the workspace's step.
size_t words_of(size_t bytes) { return workspace_round_up((bytes + 3) / 4); }

// K (padded) in `splits` ranges of `chunk`, the last one shorter, chunk a
// whole number of the tile's stages past one split.
bool fits(const wt::GemmPhase& g) {
  if (g.splits == 1) return g.chunk == g.K;
  return g.splits > 1 && g.splits <= kSplitCap && g.chunk % q8::kBK == 0 &&
         static_cast<long long>(g.chunk) * g.splits >= g.K &&
         static_cast<long long>(g.chunk) * (g.splits - 1) < g.K;
}

struct Layout {
  int kpr, kpm, kpe, rb1, rb2;
  wt::GemmPhase reduce, mid, expand, proj;
  // workspace offsets and size, in 4-byte words (the barrier, the counters
  // and the row maxima first: one memset of `zeroed` words zeroes them)
  size_t cnt, mx1, mx2, zeroed, h1, h2, sx, aqx, aqm, aqe, part, total;
};

// The workspace of a checked plan: the grid barrier's two counters at word
// 0, the row blocks' counters (the reduce's over P1, the mid's and the
// expand's over P2), h1's pixel maxima and h2's row maxima, then h1, h2, the
// row scales (x's, the im2col's, h2's), the quantized rows and the int32
// partial sums of the phase that splits most; an error if the shape or the
// plan does not fit.
int make_layout(int N, int H, int W, int Cin, int Cmid, int Cout, const int* sp, Layout* l) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cmid <= 0 || Cout <= 0 || Cin % 4 != 0 ||
      Cmid % 4 != 0 || H >= (1 << 15) || W >= (1 << 15))
    return static_cast<int>(cudaErrorInvalidValue);
  l->kpr = round_k(Cin);
  l->kpm = round_k(9 * Cmid);
  l->kpe = round_k(Cmid);
  const size_t P1 = static_cast<size_t>(N) * H * W;
  const size_t P2 = static_cast<size_t>(N) * ((H + 1) / 2) * ((W + 1) / 2);
  const int p1 = static_cast<int>(P1), p2 = static_cast<int>(P2);
  l->reduce = wt::GemmPhase{p1, l->kpr, Cmid, sp[0], sp[1]};
  l->mid = wt::GemmPhase{p2, l->kpm, Cmid, sp[2], sp[3]};
  l->expand = wt::GemmPhase{p2, l->kpe, Cout, sp[4], sp[5]};
  l->proj = wt::GemmPhase{p2, l->kpr, Cout, sp[6], sp[7]};
  if (!fits(l->reduce) || !fits(l->mid) || !fits(l->expand) || !fits(l->proj))
    return static_cast<int>(cudaErrorInvalidValue);
  l->rb1 = (p1 + q8::kBM - 1) / q8::kBM;
  l->rb2 = (p2 + q8::kBM - 1) / q8::kBM;
  size_t part = phase_partial_floats(l->reduce);
  if (phase_partial_floats(l->mid) > part) part = phase_partial_floats(l->mid);
  const size_t slots = sp[4] + sp[6];
  if (slots > 2 && slots * P2 * Cout > part) part = slots * P2 * Cout;
  l->cnt = 2;
  l->mx1 = l->cnt + l->rb1 + 2 * static_cast<size_t>(l->rb2);
  l->mx2 = l->mx1 + P1;
  l->zeroed = l->mx2 + P2;
  l->h1 = workspace_round_up(l->zeroed);
  l->h2 = l->h1 + workspace_round_up(P1 * Cmid);
  l->sx = l->h2 + workspace_round_up(P2 * Cmid);
  l->aqx = l->sx + workspace_round_up(P1 + 2 * P2);
  l->aqm = l->aqx + words_of(P1 * l->kpr);
  l->aqe = l->aqm + words_of(P2 * l->kpm);
  l->part = l->aqe + words_of(P2 * l->kpe);
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
  const int sp[8] = {rs, rc, ms, mc, es, ec, ps, pc};
  Layout l;
  const int err = blocks > 0 ? make_layout(N, H, W, Cin, Cmid, Cout, sp, &l)
                             : static_cast<int>(cudaErrorInvalidValue);
  if (err == 0) *words = static_cast<long long>(l.total);
  return err;
}

// Blocks an SM the cooperative grid takes at most (the host's plan,
// kernels/quantized.py::TRANSITION_INT8_BLOCKS_PER_SM, checks against it).
extern "C" int transition_block_int8_blocks_per_sm() { return kBlocksPerSm; }

// The host's plan (kernels/quantized.py::transition_int8_plan): a
// cooperative grid of `blocks` blocks, at most as many as the device holds
// resident; the K splits (splits, chunk) of the reduce (rs, rc, over Cin
// padded to kKAlign), the mid (ms, mc, over 9 Cmid padded), and the last
// phase's expand (es, ec, over Cmid padded) and projection (ps, pc, over Cin
// padded): each range but the last a whole number of the tile's kBK-byte
// stages. wr_t, w9_t, we_t, wp_t: the k-contiguous int8 weights, (Cmid,
// kpr), (Cmid, kpm), (Cout, kpe), (Cout, kpr), zero past K, 16-byte
// aligned. Cin and Cmid multiples of 4 (the wrapper pads other counts with
// zero channels); x 16-byte aligned; ws at least
// transition_block_int8_workspace's words, 16-byte aligned.
extern "C" int transition_block_int8(
    const float* x, const int8_t* wr_t, const float* swr, const float* s1, const float* b1,
    const int8_t* w9_t, const float* sw9, const float* s2, const float* b2, const int8_t* we_t,
    const float* swe, const float* s3, const float* b3, const int8_t* wp_t, const float* swp,
    const float* sp, const float* bp, float* out, float* ws, long long ws_words, int N, int H,
    int W, int Cin, int Cmid, int Cout, int blocks, int rs, int rc, int ms, int mc, int es,
    int ec, int ps, int pc, void* stream) {
  const int plan[8] = {rs, rc, ms, mc, es, ec, ps, pc};
  Layout l;
  const int err = make_layout(N, H, W, Cin, Cmid, Cout, plan, &l);
  if (err != 0) return err;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (blocks <= 0 || ws_words < static_cast<long long>(l.total) || !aligned(x) || !aligned(ws) ||
      !aligned(wr_t) || !aligned(w9_t) || !aligned(we_t) || !aligned(wp_t))
    return static_cast<int>(cudaErrorInvalidValue);
  const int resident = resident_blocks();
  if (resident <= 0 || blocks > resident) return static_cast<int>(cudaErrorInvalidConfiguration);
  TransitionInt8Args a{};
  cudaError_t e = q8::encode_kmajor(&a.map_r, wr_t, 1, Cmid, l.kpr);
  if (e == cudaSuccess) e = q8::encode_kmajor(&a.map_m, w9_t, 1, Cmid, l.kpm);
  if (e == cudaSuccess) e = q8::encode_kmajor(&a.map_e, we_t, 1, Cout, l.kpe);
  if (e == cudaSuccess) e = q8::encode_kmajor(&a.map_p, wp_t, 1, Cout, l.kpr);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto s = static_cast<cudaStream_t>(stream);
  unsigned int* bar = reinterpret_cast<unsigned int*>(ws);
  // The barrier, the row blocks' counters and the row maxima in one memset.
  e = cudaMemsetAsync(bar, 0, l.zeroed * 4, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t P1 = static_cast<size_t>(N) * H * W;
  const size_t P2 = static_cast<size_t>(N) * ((H + 1) / 2) * ((W + 1) / 2);
  const auto i8 = [&](size_t at) { return reinterpret_cast<int8_t*>(ws + at); };
  a.x = x;
  a.out = out;
  a.swr = swr;
  a.s1 = s1;
  a.b1 = b1;
  a.sw9 = sw9;
  a.s2 = s2;
  a.b2 = b2;
  a.swe = swe;
  a.s3 = s3;
  a.b3 = b3;
  a.swp = swp;
  a.sp = sp;
  a.bp = bp;
  a.h1 = ws + l.h1;
  a.h2 = ws + l.h2;
  a.sxx = ws + l.sx;
  a.sxm = a.sxx + P1;
  a.sxe = a.sxm + P2;
  a.mx1 = reinterpret_cast<unsigned*>(ws + l.mx1);
  a.mx2 = reinterpret_cast<unsigned*>(ws + l.mx2);
  a.cnt = reinterpret_cast<unsigned*>(ws + l.cnt);
  a.aqx = i8(l.aqx);
  a.aqm = i8(l.aqm);
  a.aqe = i8(l.aqe);
  a.part = reinterpret_cast<int*>(ws + l.part);
  a.bar = bar;
  a.N = N;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cmid = Cmid;
  a.Cout = Cout;
  a.kpr = l.kpr;
  a.kpm = l.kpm;
  a.kpe = l.kpe;
  a.rb1 = l.rb1;
  a.reduce = l.reduce;
  a.mid = l.mid;
  a.expand = l.expand;
  a.proj = l.proj;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(transition_int8_kernel),
                                  dim3(blocks), dim3(q8::kThreads), args, q8::kSmemBytes, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
