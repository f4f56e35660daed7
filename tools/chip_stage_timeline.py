#!/usr/bin/env python3
"""Where the persistent kernels' time goes, phase by phase, on one CUDA card.

    python3 tools/chip_stage_timeline.py [--root DIR]
        [--kernel stage|stage_int8|transition_int8|transition|transition_bf16w|basic_stage|
                  basic_stage_int8|winograd_int8|winograd|both]
        [--variant as_is,one_pass,no_mma]

Run from the repository root on a machine with a CUDA card and nvcc. It
builds a copy of DIR's winograd_tpu_torch/csrc/stage.cu (the f32 stage),
of its stage_int8.cu, of its transition_int8.cu, of its transition.cu (the
f32 transition, and its bf16w instantiation for --kernel transition_bf16w,
bf16 weights), of its basic_stage.cu and basic_stage_int8.cu and of its
winograd_int8.cu
(default: this checkout's; DIR may be an unpacked `git archive` of another
commit under build/) in which thread 0 of block 0 reads %globaltimer once
before the first phase and again after every grid barrier of the kernel
body (the barriers inside a phase, before its K-split sum or its
Winograd inverse, are not stamped), and
calls DIR's resnet_stage_fused, resnet_stage_int8, transition_block_int8,
transition_block_fused, basic_stage_fused, basic_stage_int8 and
conv3x3_bn_winograd_int8
wrappers on those libraries at the served shapes ("both" is the two
stages). Each
line gives the kernel's stamped span and the spans between stamps in
microseconds (a phase's span is its slowest block's work plus the barrier)
and the wrapper's device time a call replayed from a CUDA graph (graph_us).
The f32 stage's spans are, per block, reduce, mid, expand (the last
block's expand is not stamped: the kernel ends there); the int8 stage's
are its first phase (the weight transposes, x's row maxima), then per
block the reduce, the mid and the expand, each with its split sum (its
quantization folded into the phase before; the last block's expand is not
stamped). The int8 transition's copy, since its s8 wgmma phases, stamps
every block (thread 0, a slot per event): its start, then for the reduce
and the mid its share of the rows quantized, its first item's products and
its items done, each grid barrier passed, the last phase's share quantized
and first products, and its end; the line gives, over the blocks, the
median and the largest of each step (TRANSITION_INT8_STEPS), and the eager
milliseconds its wrapper spends at a weight's first launch making the
weights' k-contiguous copies (kmajor_first_ms). In its
mma.sync layout (--root an older checkout) its copy ends in one more
barrier and stamp, so its spans are all six phases: the weight transposes
with x's quantization, the reduce, the strided im2col's quantization, the
mid, h2's quantization with the projection rows' gather, and expand with
projection (where that last phase splits K, its products and its sum of
the slots apart: seven spans). The f32 transition's copy ends the same
way: its spans are the reduce, the mid and the expand with the projection,
each with its split sum. The f32 basic stage's copy gets a barrier and a
stamp after each block's second conv: per block, the first conv with its
split sum, the second with its split sum (and, before the next block, one
barrier alone). The int8 basic stage's copy, since its folded s8 wgmma
phases, x's pixel maxima first, then the same: per block, the first conv
(its rows quantized from the published maxima, its products and its split
sum), the second, and before the next block one barrier alone; in its mma.sync
layout (--root an older checkout) per block the quantize phase (block 0's
with the weight transposes), the first conv with its split sum, the second
quantize, the second conv with its split sum (and, before the next block,
one barrier alone). The int8 Winograd's copy in its grid-barrier
layout (before its items became thread-block clusters) ends the same way:
the position items, then the inverse; in its cluster layout every block's
thread 0 stamps its start, V and the first weights staged, the rows
quantized, the products, M stored, the cluster barrier and its end, and the
line gives the launch's span (first start to last end) and, over the
blocks, the median and the largest of each step (microseconds). The f32 Winograd's (--kernel
winograd: csrc/winograd.cu with a stamped copy of csrc/wino_tf32.cuh, at
f32 and bf16w) spans are its V phase, its position items and its inverse.
First, the grid barrier alone
(grid_sync.cuh, 256 threads a block): its cost per crossing at one and two
blocks an SM. The card's name and power limit come first.

--variant builds the f32 stage, transition and basic stage (TF32_KERNELS) and
the int8 transition once per named variant of their tensor-core tiles
(the GEMM phases' csrc/wgmma_tile.cuh and the int8 phases' csrc/wgmma_s8.cuh,
edited in a copy of the sources) and stamps each:
"as_is" the committed tiles; "one_pass" only the hi*hi pass of the 3xTF32
tiles' three passes (TF32 accuracy, so its lines report the error but do not
fail; the int8 transition as_is); "no_mma" none of their products (the
rings, the fragment splits the compiler keeps, the epilogues and barriers
alone; its output is not the kernel's). What a phase loses between the
variants is what its products cost.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
SHAPES = {  # (N, H, W, Cio, Cmid, blocks, mid): the served stages, conv4_x at N=8
    # (and the int8 conv2_x at N=8)
    "stage": [(1, 56, 56, 256, 64, 2, "winograd2"), (1, 28, 28, 512, 128, 3, "winograd2"),
              (1, 14, 14, 1024, 256, 5, "direct"), (8, 14, 14, 1024, 256, 5, "direct")],
    "stage_int8": [(1, 56, 56, 256, 64, 2, "winograd2"), (1, 28, 28, 512, 128, 3, "winograd2"),
                   (1, 14, 14, 1024, 256, 5, "direct"), (1, 7, 7, 2048, 512, 2, "direct"),
                   (8, 14, 14, 1024, 256, 5, "direct"), (8, 56, 56, 256, 64, 2, "winograd2")],
}
# (N, H, W, Cin, Cmid, Cout): the served transitions at N=1 and N=8.
TRANSITION_SHAPES = [(n, hw, hw, cin, cin // 2, 2 * cin) for n in (1, 8)
                     for hw, cin in ((56, 256), (28, 512), (14, 1024))]
# (N, H, W, C, blocks): ResNet-34's conv5_x run at N=1, 8 and 32, ResNet-18's;
# both basic stages.
BASIC_STAGE_SHAPES = [(1, 7, 7, 512, 2), (8, 7, 7, 512, 2), (32, 7, 7, 512, 2), (1, 7, 7, 512, 1)]
# (N, H, W, Cin, Cout, relu): the served int8 Winograds at N=1 and N=8.
WINOGRAD_INT8_SHAPES = [(1, 28, 28, 128, 128, True), (1, 14, 14, 256, 256, True),
                        (8, 28, 28, 128, 128, True), (8, 14, 14, 256, 256, True)]
# (N, H, W, Cin, Cout, precision): the served f32 and bf16w Winograds at N=1
# and N=8 (ResNet-34's identity 3x3s, ResNet-50's projection 3x3).
WINOGRAD_SHAPES = [(n, hw, hw, c, c, precision) for precision in ("f32", "bf16w")
                   for n in (1, 8) for hw, c in ((56, 64), (28, 128), (14, 256))]
# Per kernel source: the last include, after which the stamp buffer goes,
# the head of the phases, before which the first stamp goes (or a tuple of
# heads, the first one the source has: another commit's layout), and the
# kernel's last statement, after which a barrier and a stamp go (None: not
# stamped).
LAYOUT = {
    "stage": ('#include "wino_tf32.cuh"\n',
              "  for (int blk = 0; blk < a.B; ++blk) {\n    const float* act", None),
    "stage_int8": ('#include "winograd.cuh"\n',
                   ("  // The first phase: every block's weights",  # since the s8 wgmma phases
                    "  for (int blk = 0; blk < a.B; ++blk) {\n    const float* act"), None),
    "transition_int8": (('#include "wgmma_s8_phase.cuh"\n',  # since the s8 wgmma phases
                         '#include "mma_int8.cuh"\n'),
                        ("  // 1. The reduce, on x's rows", "  // 0. The four weight matrices"),
                        ("  expand_and_project(a, we, wp, ring, scratch);\n",
                         "  expand_and_project(a, P2, smem);\n")),
    "transition": (('#include "wgmma_phase.cuh"\n',  # since splitk_tf32.cuh went
                    '#include "splitk_tf32.cuh"\n'),
                   ("  ph::phase_items<kVec>(a.reduce,",  # since the wgmma phases
                    "  sk::gemm_phase<kVec, true>(a.reduce,"),
                   ("  ph::reduce_phase(a.expand, e3, a.part, a.bar);\n",
                    "BiasReluEpilogue{a.bep, a.out, a.Cout}, a.part, a.bar, smem);\n")),
    "basic_stage": (('#include "wgmma_tile.cuh"\n',  # since the wgmma phases
                     '#include "splitk_tf32.cuh"\n'),
                    "  for (int blk = 0; blk < a.B; ++blk) {\n    const float* act",
                    ("    ph::reduce_phase(a.conv, e2, a.part, a.bar);\n",
                     "act, a.out, c}, a.part,\n                               a.bar, smem);\n")),
    "basic_stage_int8": (('#include "wgmma_s8_phase.cuh"\n',  # since the s8 wgmma phases
                          '#include "mma_int8.cuh"\n'),
                         ("  // x's pixel maxima, the first conv's",
                          "  // Every block's two weight matrices k-contiguous"),
                         ("                   a.bar, ring, scratch, true);\n",
                          "act, a.out, c},\n                   a.part, a.bar, smem);\n")),
    "winograd_int8": ('#include "winograd.cuh"\n',
                      "  const int items = 16 * a.tile_blocks * a.col_blocks;",
                      "static_cast<int>(i % a.Cout), mp);\n  }\n"),
    "winograd": ('#include "wino_tf32.cuh"\n', "  wtc::phase<M, kVec, false>(", None),
}
# The f32 Winograd's barriers are in csrc/wino_tf32.cuh's phase: the tool
# stamps a copy of that header beside the stamped winograd.cu (which its
# quoted include finds first), after each of the phase's two barriers and
# after one more barrier at its end.
WINO_TF32_BARRIER = "  grid_sync(bar);\n"
WINO_TF32_LAST = "  inverse<M>(cv, cut.splits, part, scale, bias, out, relu);\n"
# The tiles' three passes, in csrc/wgmma_tile.cuh's f32 mma_stage (the GEMM
# phases), the s8 tile's products, and the passes each --variant keeps out.
PASSES = {"wgmma_tile.cuh": {"lo_hi": "wgmma_tf32(part, al[j], bh, j > 0);",
                             "hi_lo": "wgmma_tf32(part, ah[j], bl, 1);",
                             "hi_hi": "wgmma_tf32(part, ah[j], bh, 1);"},
          "wgmma_s8.cuh": {"s8": "wgmma_s8(acc, wg::desc128(sa + 32 * j, 16, 1024), "
                                 "wg::desc128(sb + 32 * j, 16, 1024),\n             add || j > 0);"}}
VARIANTS = {"as_is": (), "one_pass": ("lo_hi", "hi_lo"),
            "no_mma": ("lo_hi", "hi_lo", "hi_hi", "s8")}
TF32_KERNELS = ("stage", "transition", "basic_stage")  # on that tile, built once per variant
# The kernels built once per variant: the TF32 ones, and the int8
# transition ("no_mma" takes its s8 wgmma products out, "one_pass" is as_is).
VARIANT_KERNELS = TF32_KERNELS + ("transition_int8",)
# A kernel timed through another's source: the bf16w transition is
# transition.cu's bf16w instantiation (its bf16 wgmma tiles), as_is only.
SOURCE = {"transition_bf16w": "transition"}
STAMP = ("{ if (blockIdx.x == 0 && threadIdx.x == 0) { unsigned long long t; "
         "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); "
         "if (g_stamps < 1024) g_stamp[g_stamps++] = t; } }")
BARRIER_BENCH = r'''
#include "common.cuh"
#include "grid_sync.cuh"
__global__ void __launch_bounds__(256) barrier_kernel(unsigned int* bar, int iters) {
  for (int i = 0; i < iters; ++i) wt::grid_sync(bar);
}
extern "C" int barrier_bench(unsigned int* bar, int blocks, int iters, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&bar, &iters};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(barrier_kernel), dim3(blocks), dim3(256), args, 0, s));
}
'''
READ_STAMPS = r'''
extern "C" int read_stamps(unsigned long long* host, int* n) {
  cudaError_t e = cudaMemcpyFromSymbol(n, g_stamps, sizeof(int));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(host, g_stamp, sizeof(unsigned long long) * 1024);
  const int zero = 0;
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_stamps, &zero, sizeof(int));
  return static_cast<int>(e);
}
'''


# The int8 Winograd since its items became thread-block clusters has no
# grid barrier: thread 0 of every block (its first warpgroup's position)
# stamps its start, the span's V staged with the first weights, the rows
# quantized, the products, the end of its items (M stored), the cluster
# barrier before the inverse and its end, each block into slots of its own
# (WINO_INT8_STAMPS a block; past one span the last span's).
WINO_INT8_CLUSTER = "  cluster_sync();  // every position's M is in the cluster's shared memory\n"
WINO_INT8_HEAD = "  const unsigned rank = cluster_rank();\n"
WINO_INT8_LAST = "  cluster_sync();  // no block leaves while another reads its M\n"
WINO_INT8_STAGED = "    store_weights<kMB>(slots, wr);\n    wg_sync();\n"
WINO_INT8_QUANTIZED = "    wg::fence_proxy_async();\n    wg_sync();\n\n    for (int st = 0;"
WINO_INT8_PRODUCTS = "    if (!kSpans) break;\n  }\n"
WINO_INT8_STEPS = ("v_and_weights", "quantize", "products", "m_store", "cluster_wait", "inverse")
WINO_INT8_STAMPS = len(WINO_INT8_STEPS) + 1
BLOCK_STAMP = ("{ if (threadIdx.x == 0 && blockIdx.x < 2048) { unsigned long long t; "
               "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); "
               "g_stamp[blockIdx.x * 7 + (N_)] = t; atomicMax(&g_stamps, "
               "(int)(blockIdx.x * 7 + (N_) + 1)); } }")


def stamped_clusters(src: str) -> str:
    """The cluster form of csrc/winograd_int8.cu with a stamp of every
    block's thread 0 at its start, after the span's V and first weights are
    staged, after the rows are quantized, after the products, after its
    positions' items (before the cluster barrier), after the cluster
    barrier, and at its end."""
    include = '#include "winograd.cuh"\n'
    marks = (include, WINO_INT8_CLUSTER, WINO_INT8_HEAD, WINO_INT8_LAST, WINO_INT8_STAGED,
             WINO_INT8_QUANTIZED, WINO_INT8_PRODUCTS)
    if any(src.count(x) != 1 for x in marks):
        raise SystemExit("winograd_int8.cu does not have the layout this tool stamps")
    stamp = lambda i: "  " + BLOCK_STAMP.replace("N_", str(i)) + "\n"  # noqa: E731
    src = src.replace(WINO_INT8_HEAD, stamp(0) + WINO_INT8_HEAD)
    src = src.replace(WINO_INT8_STAGED, WINO_INT8_STAGED + stamp(1))
    src = src.replace(WINO_INT8_QUANTIZED, WINO_INT8_QUANTIZED.replace(
        "\n\n    for", "\n" + stamp(2) + "\n    for"))
    src = src.replace(WINO_INT8_PRODUCTS, stamp(3) + WINO_INT8_PRODUCTS)
    src = src.replace(WINO_INT8_CLUSTER, stamp(4) + WINO_INT8_CLUSTER + stamp(5))
    src = src.replace(WINO_INT8_LAST, WINO_INT8_LAST + stamp(6))
    return src.replace(include, include + "__device__ unsigned long long g_stamp[16384];\n"
                       "__device__ int g_stamps;\n", 1) + READ_BLOCK_STAMPS


READ_BLOCK_STAMPS = r'''
extern "C" int read_stamps(unsigned long long* host, int* n) {
  cudaError_t e = cudaMemcpyFromSymbol(n, g_stamps, sizeof(int));
  if (e == cudaSuccess && *n > 16384) *n = 16384;
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(host, g_stamp, sizeof(unsigned long long) * *n);
  const int zero = 0;
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_stamps, &zero, sizeof(int));
  return static_cast<int>(e);
}
'''


# The int8 transition since its s8 wgmma phases: thread 0 of every block
# stamps, each into a slot of its own (TR8_SLOTS a block), its start, each
# GEMM phase's share quantized, its first item's products and its items
# done (in a stamped copy of csrc/wgmma_s8_phase.cuh beside the stamped
# source, which its quoted include finds first; the kernel sets the slot
# base of each gemm_phase call), each grid barrier of the kernel body
# passed, the last phase's share quantized and its first item's products
# (of warpgroup 0: a block whose first warpgroup has no item leaves that
# slot empty), and its end.
TR8_PHASES = '#include "wgmma_s8_phase.cuh"\n'
TR8_HEAD = "  // 1. The reduce, on x's rows"
TR8_REDUCE = "  ph::gemm_phase(a.reduce,"
TR8_MID = "  ph::gemm_phase(a.mid,"
TR8_BARRIER = "  wt::grid_sync(a.bar);\n"
TR8_DUAL_QUANTIZED = "                     cnt, scratch);\n"
TR8_PAIR = "true, ap, ae, [&] { ph::ready(cnt, it.rb, P); });\n"
TR8_LAST = "  expand_and_project(a, we, wp, ring, scratch);\n"
PHASE_QUANTIZED = "  quantize_share(a, g.P, g.K, cg, aq, sx, cnt, scratch);\n"
PHASE_TILE = "    wgs8::tile<false>(aq, g.P, g.K, w, it.p0, it.n0, it.k0, it.k1, ring, true, acc, NoFin{});\n"
PHASE_ITEMS = "  if (g.splits == 1) return;\n  wt::grid_sync(bar);\n"
TR8_SLOTS = 16
# (step, from slot, to slot): the slots are 0 start; 1, 2, 3 the reduce's
# share quantized, first products, items done; 4 the first barrier; 5, 6, 7
# the mid's; 8 the second barrier; 9, 10 the last phase's share quantized
# and first products; 11 the end.
TRANSITION_INT8_STEPS = (
    ("reduce_quantize", 0, 1), ("reduce_first_products", 1, 2), ("reduce_items", 1, 3),
    ("barrier_1", 3, 4), ("mid_quantize", 4, 5), ("mid_first_products", 5, 6),
    ("mid_items", 5, 7), ("barrier_2", 7, 8), ("last_quantize", 8, 9),
    ("last_first_products", 9, 10), ("last_items", 9, 11))
STAMP_AT = ("{ if (threadIdx.x == 0 && blockIdx.x < 2048) { unsigned long long t; "
            "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); "
            "g_stamp[blockIdx.x * 16 + (K_)] = t; "
            "atomicMax(&g_stamps, (int)(blockIdx.x * 16 + 16)); } }")


def stamped_transition_int8(src: str, phases: str) -> tuple:
    """The s8 wgmma form of csrc/transition_int8.cu and a copy of
    csrc/wgmma_s8_phase.cuh, both stamped into TR8_SLOTS slots a block."""
    at = lambda k: STAMP_AT.replace("K_", str(k))  # noqa: E731
    marks = (TR8_HEAD, TR8_REDUCE, TR8_MID, TR8_DUAL_QUANTIZED, TR8_PAIR, TR8_LAST)
    if any(src.count(x) != 1 for x in marks) or src.count(TR8_BARRIER) < 2 or any(
            phases.count(x) != 1 for x in (PHASE_QUANTIZED, PHASE_TILE, PHASE_ITEMS)):
        raise SystemExit("transition_int8.cu does not have the layout this tool stamps")
    head, body = src.split(TR8_HEAD)
    first, second, rest = body.split(TR8_BARRIER, 2)  # the kernel body's two barriers
    body = (first + TR8_BARRIER + "  " + at(4) + "\n" + second + TR8_BARRIER + "  " + at(8)
            + "\n" + rest)
    src = head + "  " + at(0) + "\n" + TR8_HEAD + body
    src = src.replace(TR8_REDUCE, "  if (threadIdx.x == 0) g_base[blockIdx.x] = 1;\n" + TR8_REDUCE)
    src = src.replace(TR8_MID, "  if (threadIdx.x == 0) g_base[blockIdx.x] = 5;\n" + TR8_MID)
    src = src.replace(TR8_DUAL_QUANTIZED, TR8_DUAL_QUANTIZED + "  " + at(9) + "\n")
    src = src.replace(TR8_PAIR, TR8_PAIR + "      if (item == first) " + at(10) + "\n")
    src = src.replace(TR8_LAST, TR8_LAST + "  " + at(11) + "\n")
    base = "g_base[blockIdx.x < 2048 ? blockIdx.x : 0]"
    phases = phases.replace(PHASE_QUANTIZED, PHASE_QUANTIZED + "  " + at(base) + "\n")
    phases = phases.replace(PHASE_TILE, PHASE_TILE + "    if (item == first) " + at(base + " + 1") + "\n")
    phases = phases.replace(PHASE_ITEMS, "  " + at(base + " + 2") + "\n" + PHASE_ITEMS)
    decl = ("__device__ unsigned long long g_stamp[2048 * 16];\n__device__ int g_stamps;\n"
            "__device__ int g_base[2048];\n")
    phases = phases.replace('#include "wgmma_s8.cuh"\n', '#include "wgmma_s8.cuh"\n' + decl, 1)
    return src + READ_SLOT_STAMPS, phases


READ_SLOT_STAMPS = r"""
extern "C" int read_stamps(unsigned long long* host, int* n) {
  cudaError_t e = cudaMemcpyFromSymbol(n, g_stamps, sizeof(int));
  if (e == cudaSuccess && *n > 16384) *n = 16384;
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(host, g_stamp, sizeof(unsigned long long) * *n);
  static unsigned long long none[2048 * 16] = {};
  const int zero = 0;
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_stamps, &zero, sizeof(int));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_stamp, none, sizeof(none));
  return static_cast<int>(e);
}
"""


def slot_spans(ts) -> dict:
    """The s8 wgmma transition's stamps (TR8_SLOTS slots a block): the
    launch's span and, over the blocks that stamped both ends of a step,
    the median and the largest of each of TRANSITION_INT8_STEPS
    (microseconds)."""
    import statistics

    blocks = [ts[i:i + TR8_SLOTS] for i in range(0, len(ts), TR8_SLOTS)]
    blocks = [b for b in blocks if len(b) == TR8_SLOTS and b[0] and b[11]]
    out = {"stamped_us": (max(b[11] for b in blocks) - min(b[0] for b in blocks)) / 1e3,
           "blocks": len(blocks)}
    for name, i, j in TRANSITION_INT8_STEPS:
        v = [(b[j] - b[i]) / 1e3 for b in blocks if b[i] and b[j]]
        if v:
            out[f"{name}_us"] = [round(statistics.median(v), 2), round(max(v), 2), len(v)]
    return out


def kmajor_first_ms(q8, params) -> float:
    """The eager cost of the int8 transition's weight copies at a weight's
    first launch (kernels/quantized.py::transition_int8_kmajor on copies of
    the weights, none made yet): host milliseconds, synchronized; a replayed
    forward makes none."""
    import time

    import torch

    fresh = {k: v.clone() for k, v in params.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q8.transition_int8_kmajor(fresh)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def block_spans(ts) -> dict:
    """The cluster form's stamps (WINO_INT8_STAMPS a block) as the launch's
    span (the first block's start to the last block's end) and, over the
    blocks, the median and the largest of each of WINO_INT8_STEPS
    (microseconds)."""
    import statistics

    blocks = [ts[i:i + WINO_INT8_STAMPS] for i in range(0, len(ts), WINO_INT8_STAMPS)]
    blocks = [b for b in blocks if len(b) == WINO_INT8_STAMPS and all(b)]
    steps = {name: [(b[i + 1] - b[i]) / 1e3 for b in blocks]
             for i, name in enumerate(WINO_INT8_STEPS)}
    return {"stamped_us": (max(b[-1] for b in blocks) - min(b[0] for b in blocks)) / 1e3,
            "blocks": len(blocks),
            **{f"{k}_us": [round(statistics.median(v), 2), round(max(v), 2)]
               for k, v in steps.items()}}


def stamped_source(src: str, kernel: str) -> str:
    """The kernel's source with a stamp before its phases and after every
    grid barrier of the kernel body (and a barrier and a stamp after its
    last statement, where LAYOUT names one), and a C entry that reads the
    stamps; the int8 Winograd's cluster form stamps every block
    (stamped_clusters)."""
    if kernel == "winograd_int8" and WINO_INT8_CLUSTER in src:
        return stamped_clusters(src)
    includes, heads, lasts = LAYOUT[kernel]
    # The first include the source has (another commit's layout: a tuple).
    include = next((i for i in (includes if isinstance(includes, tuple) else (includes,))
                    if i in src), None)
    # A body's head and last statement; where a source has more than one
    # body (the transition's two tile forms) each present one is stamped.
    heads = [h for h in (heads if isinstance(heads, tuple) else (heads,)) if h in src]
    last = next((x for x in (lasts if isinstance(lasts, tuple) else (lasts,))
                 if x is not None and x in src), None)
    if include is None or not heads or lasts is not None and last is None:
        raise SystemExit(f"{kernel}.cu does not have the layout this tool stamps")
    src = src.replace("wt::grid_sync(a.bar);", "{ wt::grid_sync(a.bar); STAMP }")
    if last is not None:
        src = src.replace(last, last + "  { wt::grid_sync(a.bar); STAMP }\n")
    if kernel != "winograd":  # its stamped wino_tf32.cuh declares the buffer
        src = src.replace(include, include + "__device__ unsigned long long g_stamp[1024];\n"
                          "__device__ int g_stamps;\n#define STAMP " + STAMP + "\n", 1)
    for head in heads:
        src = src.replace(head, "  STAMP\n" + head)
    return src + READ_STAMPS


def stamped_wino_tf32(src: str) -> str:
    """csrc/wino_tf32.cuh with the stamp buffer declared after its includes,
    a stamp after each grid barrier of its phase, and a barrier and a stamp
    after the phase's inverse."""
    include = '#include "winograd.cuh"\n'
    if src.count(WINO_TF32_BARRIER) != 2 or src.count(WINO_TF32_LAST) != 1 or include not in src:
        raise SystemExit("wino_tf32.cuh does not have the layout this tool stamps")
    src = src.replace(WINO_TF32_BARRIER, "  { grid_sync(bar); STAMP }\n")
    src = src.replace(WINO_TF32_LAST, WINO_TF32_LAST + "  { grid_sync(bar); STAMP }\n")
    return src.replace(include, include + "__device__ unsigned long long g_stamp[1024];\n"
                       "__device__ int g_stamps;\n#define STAMP " + STAMP + "\n", 1)


def variant_sources(csrc: pathlib.Path, out: pathlib.Path, variant: str) -> pathlib.Path:
    """A copy of csrc under out/variant with the variant's passes of the
    tf32 tile taken out; returns the copy."""
    dst = out / variant
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    for header, passes in PASSES.items():
        if not (dst / header).exists():
            continue
        tile = (dst / header).read_text()
        for name in VARIANTS[variant]:
            if name not in passes:
                continue
            if tile.count(passes[name]) != 1:
                raise SystemExit(f"{header} does not have the {name} pass this tool edits")
            tile = tile.replace(passes[name], "(void)0;")
        (dst / header).write_text(tile)
    return dst


def build(root: pathlib.Path, out: pathlib.Path, kernels, variants=("as_is",)):
    """The barrier benchmark and the stamped kernel libraries (each of
    TF32_KERNELS once per variant, "<kernel>_stamped:<variant>"), built
    together; returns {name: library}."""
    from winograd_tpu_torch.kernels import _build

    csrc = root / "winograd_tpu_torch" / "csrc"
    out.mkdir(parents=True, exist_ok=True)
    (out / "barrier.cu").write_text(BARRIER_BENCH)
    jobs = {"barrier": (out / "barrier.cu", csrc)}  # name -> (source, include dir)
    for kernel in kernels:
        source = SOURCE.get(kernel, kernel)
        text = (csrc / f"{source}.cu").read_text()
        phases = None  # a stamped header copy beside the stamped source
        if kernel == "transition_int8" and TR8_PHASES in text:
            stamped, phases = stamped_transition_int8(
                text, (csrc / "wgmma_s8_phase.cuh").read_text())
        else:
            stamped = stamped_source(text, source)
        if kernel == "winograd":
            (out / "wino_tf32.cuh").write_text(stamped_wino_tf32(
                (csrc / "wino_tf32.cuh").read_text()))
        tf32 = kernel in VARIANT_KERNELS
        for variant in (variants if tf32 else ("as_is",)):
            src = variant_sources(csrc, out, variant) if tf32 else out
            (src / f"{kernel}_stamped.cu").write_text(stamped)
            if phases is not None:
                (src / "wgmma_s8_phase.cuh").write_text(phases)
            name = f"{kernel}_stamped:{variant}" if tf32 else f"{kernel}_stamped"
            jobs[name] = (src / f"{kernel}_stamped.cu", src if tf32 else csrc)
    lib_of = {name: out / f"lib{name.replace(':', '_')}.so" for name in jobs}
    nvcc = _build._nvcc()
    # libcuda (the TMA tensor maps) where the checkout links it.
    stubs = getattr(_build, "_stub_dirs", lambda _: [])(nvcc)
    links = [f"-L{d}" for d in stubs] + list(getattr(_build, "LINK_FLAGS", ()))
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-I", str(inc), "-o",
                               str(lib_of[name]), str(src), *links],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, (src, inc) in jobs.items()]
    for proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed:\n{log}")
    libs = {name: ctypes.CDLL(str(lib_of[name])) for name in jobs}
    for lib in libs.values():
        for fn in ("barrier_bench", "read_stamps"):
            if hasattr(lib, fn):
                getattr(lib, fn).restype = ctypes.c_int
        if hasattr(lib, "wt_error_string"):
            lib.wt_error_string.restype = ctypes.c_char_p
    return libs


def barrier_us(lib, dev, blocks: int) -> float:
    import torch

    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    ms = []
    for iters in (1, 101):
        for _ in range(3):  # the last of three
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            err = lib.barrier_bench(ctypes.c_void_p(bar.data_ptr()), blocks, iters, stream)
            b.record()
            torch.cuda.synchronize()
            if err:
                raise SystemExit(f"barrier_bench: CUDA error {err}")
        ms.append(a.elapsed_time(b))
    return 1e3 * (ms[1] - ms[0]) / 100


def stage_case(rng, dev, kernel, n, h, w, cio, cmid, nb):
    """Seeded stage params (quantized for the int8 stage) and a ReLU'd
    input."""
    import torch

    from winograd_tpu_torch.kernels import quantized as q8
    from winograd_tpu_torch.kernels import transforms
    from winograd_tpu_torch.kernels.direct import direct_filter
    from winograd_tpu_torch.kernels.stage import stack_stage_params

    def rand(*shape):
        return (rng.random(shape) - 0.5).astype(np.float32)

    blocks = []
    for _ in range(nb):
        wm = rand(cmid, cmid, 3, 3)
        blocks.append(dict(
            w_reduce=rand(cio, cmid), s_reduce=rand(cmid) + 0.5, b_reduce=rand(cmid),
            u2_mid=transforms.transform_filter(wm, m=2), w9_mid=direct_filter(wm),
            s_mid=rand(cmid) + 0.5, b_mid=rand(cmid), w_expand=rand(cmid, cio),
            s_expand=rand(cio) + 0.5, b_expand=rand(cio)))
    if kernel == "stage_int8":
        params = {k: v.to(dev) for k, v in q8.quantize_stage_params(blocks).items()}
    else:
        params = {k: v.to(dev) for k, v in stack_stage_params(blocks).items()}
    return torch.as_tensor(np.abs(rand(n, h, w, cio)), device=dev), params


def transition_case(rng, dev, kernel, n, h, w, cin, cmid, cout):
    """Seeded transition params (quantized for the int8 transition) and a
    ReLU'd input."""
    import torch

    from winograd_tpu_torch.kernels import quantized as q8
    from winograd_tpu_torch.kernels.direct import direct_filter

    def rand(*shape):
        return (rng.random(shape) - 0.5).astype(np.float32)

    params = dict(
        w_reduce=rand(cin, cmid), s_reduce=rand(cmid) + 0.5, b_reduce=rand(cmid),
        w9_mid=direct_filter(rand(cmid, cmid, 3, 3)), s_mid=rand(cmid) + 0.5, b_mid=rand(cmid),
        w_expand=rand(cmid, cout), s_expand=rand(cout) + 0.5, b_expand=rand(cout),
        w_proj=rand(cin, cout), s_proj=rand(cout) + 0.5, b_proj=rand(cout))
    if kernel == "transition_int8":
        params = {k: v.to(dev) for k, v in q8.quantize_transition_params(params).items()}
    else:
        params = {k: torch.as_tensor(v, device=dev) for k, v in params.items()}
    if kernel == "transition_bf16w":  # the f32 fold rounded to bf16 once, as cast_bf16w does
        from winograd_tpu_torch.kernels.transition import fuse_transition_weights

        params["wep"], params["bep"] = fuse_transition_weights(params)
        params.update({k: params[k].bfloat16() for k in ("w_reduce", "w9_mid", "wep")})
    return torch.as_tensor(np.abs(rand(n, h, w, cin)), device=dev), params


def basic_stage_case(rng, dev, kernel, n, h, w, c, nb):
    """Seeded basic-stage params (quantized for the int8 stage) and a ReLU'd
    input."""
    import torch

    from winograd_tpu_torch.kernels import basic_stage as bs
    from winograd_tpu_torch.kernels.direct import direct_filter

    def rand(*shape):
        return (rng.random(shape) - 0.5).astype(np.float32)

    blocks = [{f"{k}_{leg}": v for leg in ("a", "b") for k, v in (
        ("w9", direct_filter(rand(c, c, 3, 3) * 0.2)), ("s", rand(c) + 0.5), ("b", rand(c)))}
        for _ in range(nb)]
    if kernel == "basic_stage_int8":
        params = bs.quantize_basic_stage_params(blocks)
    else:
        params = bs.stack_basic_stage_params(blocks)
    params = {k: v.to(dev) for k, v in params.items()}
    return torch.as_tensor(np.abs(rand(n, h, w, c)), device=dev), params


def winograd_int8_case(rng, dev, n, h, w, cin, cout, relu):
    """Seeded int8 F(2,3) operands and a ReLU'd input."""
    import torch

    from winograd_tpu_torch.kernels import quantized as q8
    from winograd_tpu_torch.kernels import transforms

    def rand(*shape):
        return (rng.random(shape) - 0.5).astype(np.float32)

    u_q, s_u = q8.quantize_winograd_filter(transforms.transform_filter(rand(cout, cin, 3, 3), m=2))
    t = (lambda a: torch.as_tensor(a, device=dev))  # noqa: E731
    return (t(np.abs(rand(n, h, w, cin))), t(u_q), t(s_u), t(rand(cout) + 0.5), t(rand(cout)),
            relu)


def winograd_case(rng, dev, n, h, w, cin, cout, precision):
    """Seeded f32 Winograd operands (u bf16 at "bf16w") and an input."""
    import torch

    from winograd_tpu_torch.kernels import transforms

    def rand(*shape):
        return (rng.random(shape) - 0.5).astype(np.float32)

    t = (lambda a: torch.as_tensor(a, device=dev))  # noqa: E731
    u = t(transforms.transform_filter(rand(cout, cin, 3, 3), m=2))
    if precision == "bf16w":
        u = u.bfloat16()
    return t(rand(n, h, w, cin)), u, t(rand(cout) + 0.5), t(rand(cout)), True, precision


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=pathlib.Path, default=ROOT,
                    help="the checkout whose kernel and wrapper are timed")
    ap.add_argument("--kernel",
                    choices=("stage", "stage_int8", "transition_int8", "transition",
                             "transition_bf16w",
                             "basic_stage", "basic_stage_int8", "winograd_int8", "winograd",
                             "both"),
                    default="both")
    ap.add_argument("--variant", default="as_is", metavar="NAME,...",
                    help="variants of the f32 stage's, transition's and basic stage's tile: "
                    + ", ".join(VARIANTS))
    args = ap.parse_args()
    variants = tuple(v for v in args.variant.split(",") if v)
    if not variants or any(v not in VARIANTS for v in variants):
        ap.error(f"--variant takes names from {', '.join(VARIANTS)}")
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("chip_stage_timeline: needs a CUDA device", file=sys.stderr)
        return 1
    from winograd_tpu_torch.kernels import _build
    from winograd_tpu_torch.kernels import basic_stage as bs
    from winograd_tpu_torch.kernels import quantized as q8
    from winograd_tpu_torch.kernels import stage as st
    from winograd_tpu_torch.kernels import transition as tr
    from winograd_tpu_torch.kernels import winograd as wn
    from winograd_tpu_torch.utils.timing import bench_graph

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels = ("stage", "stage_int8") if args.kernel == "both" else (args.kernel,)
    libs = build(root, ROOT / "build" / "stage_timeline" / root.name, kernels, variants)
    sms = _build.sm_count(dev)
    for per_sm in (1, 2):
        print(json.dumps({"barrier_us": barrier_us(libs["barrier"], dev, per_sm * sms),
                          "blocks": per_sm * sms}), flush=True)
    wrappers = {"stage": (st.resnet_stage_fused, st.resnet_stage_fused_plain,
                          st._workspace_floats),
                "stage_int8": (q8.resnet_stage_int8, q8.resnet_stage_int8_plain,
                               q8._workspace_words),
                "transition_int8": (q8.transition_block_int8, q8.transition_block_int8_plain,
                                    q8._workspace_words),
                "transition": (tr.transition_block_fused, tr.transition_block_fused_plain,
                               tr._workspace_floats),
                "transition_bf16w": (tr.transition_block_fused,
                                     tr.transition_block_fused_plain, tr._workspace_floats),
                "basic_stage": (bs.basic_stage_fused, bs.basic_stage_fused_plain,
                                bs._workspace_floats),
                "basic_stage_int8": (bs.basic_stage_int8, bs.basic_stage_int8_plain,
                                     q8._workspace_words),
                "winograd_int8": (q8.conv3x3_bn_winograd_int8,
                                  q8.conv3x3_bn_winograd_int8_plain, None),
                "winograd": (wn.conv3x3_bn_winograd, wn.conv3x3_bn_winograd_plain, None)}
    rng = np.random.default_rng(0)
    stamps, count = (ctypes.c_ulonglong * 16384)(), ctypes.c_int(0)
    csrc = root / "winograd_tpu_torch" / "csrc"
    per_block = {k: k == "winograd_int8" and WINO_INT8_CLUSTER in (csrc / f"{k}.cu").read_text()
                 for k in kernels}
    per_slot = {k: k == "transition_int8" and TR8_PHASES in (csrc / f"{k}.cu").read_text()
                for k in kernels}
    ok = True
    for kernel in kernels:
        call, plain, workspace = wrappers[kernel]
        cases = []  # (shape, the wrapper's operands, the twin's output)
        if kernel in ("transition_int8", "transition", "transition_bf16w"):
            for shape in TRANSITION_SHAPES:
                x, params = transition_case(rng, dev, kernel, *shape)
                cases.append((shape, (x, params), plain(x, params)))
        for n, h, w, cio, cmid, nb, mid in SHAPES.get(kernel, []):
            x, params = stage_case(rng, dev, kernel, n, h, w, cio, cmid, nb)
            cases.append(((n, h, w, cio, cmid, nb, mid), (x, params, mid), plain(x, params, mid)))
        if kernel in ("basic_stage", "basic_stage_int8"):
            for shape in BASIC_STAGE_SHAPES:
                operands = basic_stage_case(rng, dev, kernel, *shape)
                cases.append((shape, operands, plain(*operands)))
        if kernel == "winograd_int8":
            for shape in WINOGRAD_INT8_SHAPES:
                operands = winograd_int8_case(rng, dev, *shape)
                cases.append((shape, operands, plain(*operands)))
        if kernel == "winograd":
            for shape in WINOGRAD_SHAPES:
                operands = winograd_case(rng, dev, *shape)
                cases.append((shape, operands, plain(*operands[:5])))
        tf32 = kernel in VARIANT_KERNELS
        for variant in (variants if tf32 else ("as_is",)):
            lib = libs[f"{kernel}_stamped:{variant}" if tf32 else f"{kernel}_stamped"]
            _build._LIBS[SOURCE.get(kernel, kernel)] = lib  # the wrapper launches it
            if workspace is not None:
                workspace.cache_clear()
            for shape, operands, ref in cases:
                for _ in range(3):  # the last of three calls
                    torch.cuda.synchronize()
                    if lib.read_stamps(stamps, ctypes.byref(count)):
                        raise SystemExit("read_stamps failed")
                    y = call(*operands)
                    torch.cuda.synchronize()
                    if lib.read_stamps(stamps, ctypes.byref(count)):
                        raise SystemExit("read_stamps failed")
                err = (y - ref).abs().max().item()
                if kernel not in TF32_KERNELS and kernel not in ("winograd", "transition_bf16w"):
                    agrees = bool(torch.equal(y, ref))
                else:
                    agrees = err <= 1e-4 * max(1.0, ref.abs().max().item())
                if variant == "as_is":
                    ok &= agrees
                ts = [stamps[i] for i in range(count.value)]
                # 20 calls in one CUDA graph, the median of 20 replays: its
                # difference from the stamped span is what a launch costs
                # outside the kernel body (the graph's launch, a barrier's
                # memset, the first block's start, the last one's end).
                replayed = bench_graph(lambda: call(*operands))
                if per_slot[kernel]:
                    spans = {**slot_spans(ts), "kmajor_first_ms": kmajor_first_ms(
                        q8, operands[1])}
                elif per_block[kernel]:
                    spans = block_spans(ts)
                else:
                    spans = {"stamped_us": (ts[-1] - ts[0]) / 1e3,
                             "spans_us": [round((b - a) / 1e3, 2) for a, b in zip(ts, ts[1:])]}
                print(json.dumps({"kernel": kernel, "variant": variant, "shape": list(shape),
                                  "root": str(root), "graph_us": replayed, **spans,
                                  "max_abs_err": err, "agrees_with_twin": agrees}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
