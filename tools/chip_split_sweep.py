#!/usr/bin/env python3
"""K-split sweep of the split-K kernels (csrc/pointwise.cu, csrc/direct.cu,
csrc/direct_int8.cu, csrc/transition_int8.cu, csrc/pointwise_int8.cu,
csrc/transition.cu, csrc/basic_stage.cu and csrc/basic_stage_int8.cu), of the f32 and bf16w
Winograd's work-item cut (csrc/winograd.cu), of the int8 tiers' FP64 F(2,3)
tile's item shape (winograd_bf16: csrc/winograd.cu's winograd_conv3x3_bn_bf16),
of the f32 and bf16w stage's plan
(csrc/stage.cu), of the int8 stage's (csrc/stage_int8.cu) and of the int8
Winograd's grid (csrc/winograd_int8.cu) on one CUDA card, and an A/B of
their wrappers (and of the stem's, csrc/stem.cu) against another checkout.
pointwise, direct, winograd, stage, transition and basic_stage run at f32
and, as pointwise_bf16w, direct_bf16w, winograd_bf16w (F(2,3)), stage_bf16w,
transition_bf16w and basic_stage_bf16w, on bf16 weights.

    python3 tools/chip_split_sweep.py [--only NAME,...]    # the sweep
    python3 tools/chip_split_sweep.py --ab DIR [--only ...] # the A/B against DIR

Run from the repository root on a machine with a CUDA card and nvcc. The
shapes are each served shape of the kernels (the four served forwards of
chip_smoke.py at N=1 and N=8, the int8 transition and pointwise, the basic
stages and the three direct 3x3s at N=32 too,
and the f32 Winograd's F(4,3) check shape). Every timed call is first held
against its plain twin (pointwise, direct, winograd, stage, stem,
transition and basic_stage within 1e-4 * max(1, max|plain|), direct_int8,
stage_int8, transition_int8, pointwise_int8, basic_stage_int8,
winograd_int8 and winograd_bf16 exactly). Device ms per
call: 20 calls in one CUDA graph, the median of 20 replays between CUDA
events, inputs in L2. The card's name and power limit
come first, then one JSON line per shape and candidate.

The sweep times each shape under the K split its wrapper's plan picks
("chosen") and under the splits that kernels/splitk.py::split_k gives for
1, 2, 4, ..., 32 wanted ranges (at most pointwise.py::CLUSTER_MAX on the
pointwise MMA path; the heads' GEMVs at P <= 8, pointwise, pointwise_bf16w
and pointwise_int8, under every cluster size 1, 2, 4, 8, 16 on column tiles
128 and 64 wide, after a line giving the clusters of 16 GEMV blocks the
card holds at once; the direct 3x3, whose splits are one cluster, under
every split 1-16 (past 8 a non-portable cluster); its lines give the bar, 1e-4 * max(1, max|plain|), beside the error); the int8
direct 3x3 under its plan and the int8 pointwise's cluster rule at both
tile widths (64, 128) and the K splits split_k gives for 1, 2, 4, ..., 64
wanted ranges (at most 16); the stage under its plan, under stage.py::stage_plan's
rule at each walk cap of STAGE_WALKS, and on a grid of one block an SM; the
int8 stage under its plan and under quantized.py::stage_int8_plan's walk
caps (STAGE_INT8_WALKS); the f32 and bf16w Winograd under its plan and under
the Cin splits that split_k gives for 1, 2, 3, 4 and 8 wanted ranges of at
least 32; the FP64 F(2,3) tile (winograd_bf16, and the int8 stage's
winograd2 mid) under its plan and under every Cout block of its items
(winograd.py::WINOGRAD_FP64_COLS), the bf16-filter 3x3 also on grids of
one and two blocks an SM; the int8 transition under its plan, under the walk caps
TRANSITION_INT8_WALKS for every phase, and under plans that change one of
its phases to such a walk: the reduce's, the mid's, or the last phase's
expand and projection together; the f32 transition under its plan
and under plans that change one phase's split (reduce, mid or expand) for
1, 2, 4, ..., 32 wanted ranges; the int8 pointwise under its plan and on
every other path that takes the shape (GEMV at P <= 8, one pass at a
padded K <= 256, the cluster path at any P, its tiles 64 and 128 columns
wide), the cluster path's K split for 1, 2, 4, ..., 64 wanted ranges (at
most 8); the f32, bf16w and int8 basic
stage under their plans and under the K splits split_k gives for 1, 2, 4,
..., 64 wanted ranges (the int8 one's at most 16; both convs share one
split); the int8 Winograd under its
plan, under every item shape its kernel takes (8 x 128, 16 x 128 or 32 x
256 tiles by channels), and in spans of 128 channels of K (the walk a Cin
past WINO_INT8_CHUNK takes).

--ab DIR times the public wrappers (kernels/pointwise.py::conv1x1_bn,
kernels/direct.py::conv3x3_bn_direct, kernels/winograd.py::
conv3x3_bn_winograd (at f32, bf16w and bf16), kernels/stage.py::resnet_stage_fused,
kernels/stem.py::stem_fused, kernels/transition.py::transition_block_fused,
kernels/quantized.py::conv3x3_bn_int8, ::resnet_stage_int8,
::transition_block_int8, ::conv1x1_bn_int8 and ::conv3x3_bn_winograd_int8,
kernels/basic_stage.py::basic_stage_fused and ::basic_stage_int8) of the
checkout DIR (for example an
unpacked `git archive` of another commit under build/) and of this one,
each in a process of its own that imports that checkout's package and
builds its kernels there, in turns DIR, this, this, DIR, on the same
seeded inputs ("--wrappers ROOT" is one such turn).

--only takes kernel names (pointwise, pointwise_bf16w, direct, direct_bf16w, winograd,
winograd_bf16w, winograd_bf16, stage, stage_bf16w, direct_int8, stage_int8, stem,
transition_int8, pointwise_int8, transition, transition_bf16w, winograd_int8,
basic_stage, basic_stage_bf16w, basic_stage_int8) and keeps those shapes alone.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent

POINTWISE = [  # (P, K, N, relu); the MMA tiles at P = 9 and 16 beside the GEMV's 8
    (1, 2048, 1000, False), (8, 2048, 1000, False), (1, 512, 1000, False),
    (8, 512, 1000, False), (9, 2048, 1000, False), (16, 2048, 1000, False),
    (49, 2048, 512, True), (49, 512, 2048, False), (49, 2304, 512, True), (49, 256, 512, False),
    (196, 1152, 256, True), (196, 128, 256, False), (392, 2048, 512, True),
    (784, 576, 128, True), (784, 64, 128, False), (3136, 64, 64, True), (3136, 64, 256, False),
]
DIRECT = [  # (N, H, W, Cin, Cout, relu)
    (1, 7, 7, 512, 512, True), (8, 7, 7, 512, 512, True), (32, 7, 7, 512, 512, True),
]
# The bf16w direct 3x3 (ResNet-34's conv5_x entry b-leg at bf16w), at these
# shapes of the f32 one (bf16 weights, kernel name "direct_bf16w").
DIRECT_BF16W = DIRECT
WINOGRAD = [  # (N, H, W, Cin, Cout, m, relu)
    (1, 56, 56, 64, 64, 2, True), (1, 28, 28, 128, 128, 2, True), (1, 14, 14, 256, 256, 2, True),
    (1, 14, 14, 128, 128, 4, True), (8, 56, 56, 64, 64, 2, True), (8, 28, 28, 128, 128, 2, True),
    (8, 14, 14, 256, 256, 2, True),
]
STAGE = [  # (N, H, W, Cio, Cmid, blocks, mid)
    (1, 56, 56, 256, 64, 2, "winograd2"), (1, 28, 28, 512, 128, 3, "winograd2"),
    (1, 14, 14, 1024, 256, 5, "direct"), (8, 14, 14, 1024, 256, 5, "direct"),
    (1, 28, 28, 512, 128, 1, "winograd2"), (1, 14, 14, 1024, 256, 1, "direct"),
    (32, 14, 14, 1024, 256, 5, "direct"), (1, 7, 7, 2048, 512, 2, "direct"),
    (8, 7, 7, 2048, 512, 2, "direct"),
]
# The bf16w instantiations of pointwise, Winograd and stage, at these shapes
# of theirs (bf16 weights, kernel names "pointwise_bf16w", "winograd_bf16w"
# (F(2,3) only) and "stage_bf16w").
POINTWISE_BF16W = POINTWISE
WINOGRAD_BF16W = [s for s in WINOGRAD if s[5] == 2]
# The int8 tiers' F(2,3) on bf16 filters (the FP64 tile): ResNet-18/34's
# conv2_x at N = 1, 8 and 32, (N, H, W, Cin, Cout, relu).
WINOGRAD_BF16 = [(n, 56, 56, 64, 64, True) for n in (1, 8, 32)]
STAGE_BF16W = [s for s in STAGE if s[-1] == "direct" or s[0] == 1]
# The candidate walk caps of stage.py::stage_plan (one for every phase, or none).
STAGE_WALKS = (256, 512, 1024, 2048, 1 << 20)
STAGE_INT8 = [  # (N, H, W, Cio, Cmid, blocks, mid)
    (1, 56, 56, 256, 64, 2, "winograd2"), (1, 28, 28, 512, 128, 3, "winograd2"),
    (1, 14, 14, 1024, 256, 5, "direct"), (1, 7, 7, 2048, 512, 2, "direct"),
    (8, 14, 14, 1024, 256, 5, "direct"), (32, 14, 14, 1024, 256, 5, "direct"),
    (8, 56, 56, 256, 64, 2, "winograd2"), (8, 28, 28, 512, 128, 3, "winograd2"),
    (32, 56, 56, 256, 64, 2, "winograd2"), (32, 28, 28, 512, 128, 3, "winograd2"),
]
STEM = [  # (N, H, W, Cin, C, precision): A/B only (its grid is the kernel's)
    (1, 224, 224, 3, 64, "f32"), (1, 224, 224, 3, 64, "bf16"), (8, 224, 224, 3, 64, "f32"),
    (8, 224, 224, 3, 64, "bf16"),
]
TRANSITION_INT8 = [  # (N, H, W, Cin, Cmid, Cout): ResNet-50's three at N = 1, 8 and 32
    (n, hw, hw, cin, cin // 2, 2 * cin) for n in (1, 8, 32)
    for hw, cin in ((56, 256), (28, 512), (14, 1024))
]
TRANSITION = [  # (N, H, W, Cin, Cmid, Cout): ResNet-50's three at N = 1, 8 and 32
    (n, hw, hw, cin, cin // 2, 2 * cin) for n in (1, 8, 32)
    for hw, cin in ((56, 256), (28, 512), (14, 1024))
]
TRANSITION_BF16W = TRANSITION  # the bf16w instantiation ("transition_bf16w") at the same shapes
POINTWISE_INT8 = [  # (P, K, N, relu): the served int8 1x1s at N = 1, 8 and 32
    (n, k, 1000, False) for n in (1, 8, 32) for k in (2048, 512)] + [
    (n * p, k, c, relu) for n in (1, 8, 32) for p, k, c, relu in (
        (3136, 64, 64, True), (3136, 64, 256, False), (784, 64, 128, False),
        (196, 128, 256, False), (49, 256, 512, False), (784, 576, 128, True),
        (196, 1152, 256, True), (49, 2304, 512, True))
]
WINOGRAD_INT8 = [  # (N, H, W, Cin, Cout, relu): ResNet-34's int8 Winograds at N = 1, 8, 32
    (n, hw, hw, c, c, True) for n in (1, 8, 32) for hw, c in ((28, 128), (14, 256))
]
BASIC_STAGE_INT8 = [  # (N, H, W, C, blocks): ResNet-34's conv5_x run at N = 1, 8, 32, ResNet-18's
    (1, 7, 7, 512, 2), (8, 7, 7, 512, 2), (32, 7, 7, 512, 2), (1, 7, 7, 512, 1),
]
BASIC_STAGE = BASIC_STAGE_INT8  # the f32 tier's run at the same shapes
BASIC_STAGE_BF16W = BASIC_STAGE  # the bf16w instantiation ("basic_stage_bf16w") at the same shapes
A_B_ONLY = ("stem",)
# The candidate walk caps of quantized.py::stage_int8_plan (one for every
# phase; 0 is its rule of about one item a block).
STAGE_INT8_WALKS = (0, 128, 256, 512, 1024, 1 << 20)
# The candidate walk caps of quantized.py::transition_int8_plan (0: its rule).
TRANSITION_INT8_WALKS = (0, 128, 256, 512, 1024, 1 << 20)
DIRECT_INT8 = [  # (N, H, W, Cin, Cout, relu)
    (1, 56, 56, 64, 64, True), (1, 7, 7, 512, 512, False), (8, 7, 7, 512, 512, False),
    (8, 56, 56, 64, 64, True), (32, 7, 7, 512, 512, False), (32, 56, 56, 64, 64, True),
]
WANTS = (1, 2, 4, 8, 16, 32, 64)
GEMV_WANTS = (1, 2, 4, 8, 16)  # the GEMVs' cluster sizes


def device_ms(fn, calls=20, reps=20, warmup=2):
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    pairs = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs) / calls


ONLY = ()  # kernel names kept by --only; all when empty


def cases(dev):
    """(kernel, shape, the wrapper's call, its plain twin's, the check of an
    output) for each shape of the kernels --only keeps, on inputs seeded
    alike in every checkout."""
    for case in _cases_all(dev):
        if not ONLY or case[0] in ONLY:
            yield case


def _cases_all(dev):
    import torch

    from winograd_tpu_torch.kernels import basic_stage as bs
    from winograd_tpu_torch.kernels import pointwise as pw
    from winograd_tpu_torch.kernels import quantized as q8
    from winograd_tpu_torch.kernels import transforms
    from winograd_tpu_torch.kernels.direct import conv3x3_bn_direct_plain, direct_filter
    from winograd_tpu_torch.kernels.stage import resnet_stage_fused_plain, stack_stage_params
    from winograd_tpu_torch.kernels.stem import stem_fused_plain
    from winograd_tpu_torch.kernels.transition import (
        fuse_transition_weights, transition_block_fused_plain,
    )
    from winograd_tpu_torch.kernels.winograd import conv3x3_bn_winograd_plain, winograd2_mid_plain
    from winograd_tpu_torch.models.convert import stem_filter_s2d

    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a, device=dev)

    def rand(*shape):
        return t((rng.random(shape) - 0.5).astype(np.float32))

    for name, shapes in (("pointwise", POINTWISE), ("pointwise_bf16w", POINTWISE_BF16W)):
        for p, k, n, relu in shapes:
            x, w, s, b = (rand(p, k), rand(k, n), t((rng.random(n) * 0.5).astype(np.float32)),
                          rand(n))
            if name == "pointwise_bf16w":
                w = w.bfloat16()
            ref = pw.conv1x1_bn_plain(x, w, s, b, relu)
            tol = 1e-4 * max(1.0, ref.abs().max().item())
            yield (name, (p, k, n, relu), (x, w, s, b, relu), ref,
                   lambda y, ref=ref, tol=tol: (y - ref).abs().max().item() <= tol)
    for name, shapes in (("direct", DIRECT), ("direct_bf16w", DIRECT_BF16W)):
        for n, h, wd, cin, cout, relu in shapes:
            x = rand(n, h, wd, cin)
            w9 = t(direct_filter((rng.random((cout, cin, 3, 3)) - 0.5).astype(np.float32)))
            if name == "direct_bf16w":
                w9 = w9.bfloat16()
            s, b = t((rng.random(cout) * 0.5).astype(np.float32)), rand(cout)
            ref = conv3x3_bn_direct_plain(x, w9, s, b, relu)
            tol = 1e-4 * max(1.0, ref.abs().max().item())
            yield (name, (n, h, wd, cin, cout, relu), (x, w9, s, b, relu), ref,
                   lambda y, ref=ref, tol=tol: (y - ref).abs().max().item() <= tol)
    for n, h, wd, cin, cout, m, relu in WINOGRAD:
        x = rand(n, h, wd, cin)
        u = t(transforms.transform_filter((rng.random((cout, cin, 3, 3)) - 0.5).astype(np.float32),
                                          m=m))
        s, b = t((rng.random(cout) * 0.5).astype(np.float32)), rand(cout)
        ref = conv3x3_bn_winograd_plain(x, u, s, b, relu)
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        yield ("winograd", (n, h, wd, cin, cout, m, relu), (x, u, s, b, relu), ref,
               lambda y, ref=ref, tol=tol: (y - ref).abs().max().item() <= tol)
    for n, h, wd, cin, cout, m, relu in WINOGRAD_BF16W:
        x = rand(n, h, wd, cin)
        u = t(transforms.transform_filter((rng.random((cout, cin, 3, 3)) - 0.5).astype(np.float32),
                                          m=m)).bfloat16()
        s, b = t((rng.random(cout) * 0.5).astype(np.float32)), rand(cout)
        ref = conv3x3_bn_winograd_plain(x, u, s, b, relu)
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        yield ("winograd_bf16w", (n, h, wd, cin, cout, m, relu), (x, u, s, b, relu, "bf16w"), ref,
               lambda y, ref=ref, tol=tol: (y - ref).abs().max().item() <= tol)
    for n, h, wd, cin, cout, relu in WINOGRAD_BF16:
        x = rand(n, h, wd, cin)
        u = t(transforms.transform_filter((rng.random((cout, cin, 3, 3)) - 0.5).astype(np.float32),
                                          m=2)).bfloat16()
        s, b = t((rng.random(cout) * 0.5).astype(np.float32)), rand(cout)
        ref = winograd2_mid_plain(x, u, s, b, relu)
        yield ("winograd_bf16", (n, h, wd, cin, cout, relu), (x, u, s, b, relu, "bf16"), ref,
               lambda y, ref=ref: (y - ref).abs().max().item() == 0.0)
    for name, n, h, wd, cio, cmid, nb, mid in (
            [("stage", *shape) for shape in STAGE]
            + [("stage_bf16w", *shape) for shape in STAGE_BF16W]):
        blocks = []
        for _ in range(nb):
            wm = (rng.random((cmid, cmid, 3, 3)) - 0.5).astype(np.float32)
            blocks.append(dict(
                w_reduce=rand(cio, cmid), s_reduce=t((rng.random(cmid) * 0.5).astype(np.float32)),
                b_reduce=rand(cmid), u2_mid=t(transforms.transform_filter(wm, m=2)),
                w9_mid=t(direct_filter(wm)), s_mid=t((rng.random(cmid) * 0.5).astype(np.float32)),
                b_mid=rand(cmid), w_expand=rand(cmid, cio),
                s_expand=t((rng.random(cio) * 0.5).astype(np.float32)), b_expand=rand(cio)))
        stacked = stack_stage_params(blocks)
        if name == "stage_bf16w":
            for key in ("w_reduce", "u2_mid", "w9_mid", "w_expand"):
                stacked[key] = stacked[key].bfloat16()
        x = rand(n, h, wd, cio)
        ref = resnet_stage_fused_plain(x, stacked, mid)
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        yield (name, (n, h, wd, cio, cmid, nb, mid), (x, stacked, mid), ref,
               lambda y, ref=ref, tol=tol: (y - ref).abs().max().item() <= tol)
    for n, h, wd, cio, cmid, nb, mid in STAGE_INT8:
        blocks = []
        for _ in range(nb):
            wm = (rng.random((cmid, cmid, 3, 3)) - 0.5).astype(np.float32)
            blocks.append(dict(
                w_reduce=(rng.random((cio, cmid)) - 0.5).astype(np.float32),
                s_reduce=(rng.random(cmid) * 0.5).astype(np.float32), b_reduce=rand(cmid).cpu(),
                u2_mid=transforms.transform_filter(wm, m=2), w9_mid=direct_filter(wm),
                s_mid=(rng.random(cmid) * 0.5).astype(np.float32), b_mid=rand(cmid).cpu(),
                w_expand=(rng.random((cmid, cio)) - 0.5).astype(np.float32),
                s_expand=(rng.random(cio) * 0.5).astype(np.float32), b_expand=rand(cio).cpu()))
        qs = {k: v.to(dev) for k, v in q8.quantize_stage_params(blocks).items()}
        x = rand(n, h, wd, cio).abs()
        ref = q8.resnet_stage_int8_plain(x, qs, mid)
        yield ("stage_int8", (n, h, wd, cio, cmid, nb, mid), (x, qs, mid), ref,
               lambda y, ref=ref: (y - ref).abs().max().item() == 0.0)
    for n, h, wd, cin, cout, relu in DIRECT_INT8:
        x = rand(n, h, wd, cin)
        w9_q, s_w9 = (t(a) for a in q8.quantize_weights(
            direct_filter((rng.random((cout, cin, 3, 3)) - 0.5).astype(np.float32))))
        s, b = t((rng.random(cout) * 0.5).astype(np.float32)), rand(cout)
        ref = q8.conv3x3_bn_int8_plain(x, w9_q, s_w9, s, b, relu)
        yield ("direct_int8", (n, h, wd, cin, cout, relu), (x, w9_q, s_w9, s, b, relu), ref,
               lambda y, ref=ref: (y - ref).abs().max().item() == 0.0)
    for n, h, wd, cin, c, precision in STEM:
        x = rand(n, h, wd, cin)
        w192 = t(stem_filter_s2d((rng.random((c, cin, 7, 7)) - 0.5).astype(np.float32)))
        s, b = t((rng.random(c) * 0.5).astype(np.float32)), rand(c)
        ref = stem_fused_plain(x, w192, s, b, precision)
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        yield ("stem", (n, h, wd, cin, c, precision), (x, w192, s, b, precision), ref,
               lambda y, ref=ref, tol=tol: (y - ref).abs().max().item() <= tol)
    for n, h, wd, cin, cmid, cout in TRANSITION_INT8:
        wm = (rng.random((cmid, cmid, 3, 3)) - 0.5).astype(np.float32)
        qp = {k: v.to(dev) for k, v in q8.quantize_transition_params(dict(
            w_reduce=(rng.random((cin, cmid)) - 0.5).astype(np.float32),
            s_reduce=(rng.random(cmid) * 0.5).astype(np.float32), b_reduce=rand(cmid).cpu(),
            w9_mid=direct_filter(wm), s_mid=(rng.random(cmid) * 0.5).astype(np.float32),
            b_mid=rand(cmid).cpu(), w_expand=(rng.random((cmid, cout)) - 0.5).astype(np.float32),
            s_expand=(rng.random(cout) * 0.5).astype(np.float32), b_expand=rand(cout).cpu(),
            w_proj=(rng.random((cin, cout)) - 0.5).astype(np.float32),
            s_proj=(rng.random(cout) * 0.5).astype(np.float32), b_proj=rand(cout).cpu())).items()}
        x = rand(n, h, wd, cin).abs()
        ref = q8.transition_block_int8_plain(x, qp)
        yield ("transition_int8", (n, h, wd, cin, cmid, cout), (x, qp), ref,
               lambda y, ref=ref: (y - ref).abs().max().item() == 0.0)
    for name, n, h, wd, cin, cmid, cout in (
            [("transition", *shape) for shape in TRANSITION]
            + [("transition_bf16w", *shape) for shape in TRANSITION_BF16W]):
        wm = (rng.random((cmid, cmid, 3, 3)) - 0.5).astype(np.float32)
        params = dict(
            w_reduce=rand(cin, cmid), s_reduce=t((rng.random(cmid) * 0.5).astype(np.float32)),
            b_reduce=rand(cmid), w9_mid=t(direct_filter(wm)),
            s_mid=t((rng.random(cmid) * 0.5).astype(np.float32)), b_mid=rand(cmid),
            w_expand=rand(cmid, cout), s_expand=t((rng.random(cout) * 0.5).astype(np.float32)),
            b_expand=rand(cout), w_proj=rand(cin, cout),
            s_proj=t((rng.random(cout) * 0.5).astype(np.float32)), b_proj=rand(cout))
        params["wep"], params["bep"] = fuse_transition_weights(params)  # as the models store it
        if name == "transition_bf16w":  # the f32 fold rounded once, as cast_bf16w does
            params.update({k: params[k].bfloat16() for k in ("w_reduce", "w9_mid", "wep")})
        x = rand(n, h, wd, cin)
        ref = transition_block_fused_plain(x, params)
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        yield (name, (n, h, wd, cin, cmid, cout), (x, params), ref,
               lambda y, ref=ref, tol=tol: (y - ref).abs().max().item() <= tol)
    for p, k, n, relu in POINTWISE_INT8:
        x = rand(p, k).abs() if relu else rand(p, k)
        w_q, s_w = (t(a) for a in q8.quantize_weights(
            (rng.random((k, n)) - 0.5).astype(np.float32)))
        s, b = t((rng.random(n) * 0.5).astype(np.float32)), rand(n)
        ref = q8.conv1x1_bn_int8_plain(x, w_q, s_w, s, b, relu)
        yield ("pointwise_int8", (p, k, n, relu), (x, w_q, s_w, s, b, relu), ref,
               lambda y, ref=ref: (y - ref).abs().max().item() == 0.0)
    for n, h, wd, cin, cout, relu in WINOGRAD_INT8:
        x = rand(n, h, wd, cin).abs()
        u_q, s_u = (t(a) for a in q8.quantize_winograd_filter(transforms.transform_filter(
            (rng.random((cout, cin, 3, 3)) - 0.5).astype(np.float32), m=2)))
        s, b = t((rng.random(cout) * 0.5).astype(np.float32)), rand(cout)
        ref = q8.conv3x3_bn_winograd_int8_plain(x, u_q, s_u, s, b, relu)
        yield ("winograd_int8", (n, h, wd, cin, cout, relu), (x, u_q, s_u, s, b, relu), ref,
               lambda y, ref=ref: (y - ref).abs().max().item() == 0.0)
    def basic_blocks(c, nb):
        return [{f"{k}_{leg}": v for leg in ("a", "b") for k, v in (
            ("w9", direct_filter(((rng.random((c, c, 3, 3)) - 0.5) * 0.2).astype(np.float32))),
            ("s", (rng.random(c) * 0.5 + 0.25).astype(np.float32)),
            ("b", (rng.random(c) - 0.5).astype(np.float32)))} for _ in range(nb)]

    for n, h, wd, c, nb in BASIC_STAGE_INT8:
        qs = {k: v.to(dev) for k, v in bs.quantize_basic_stage_params(basic_blocks(c, nb)).items()}
        x = rand(n, h, wd, c).abs()
        ref = bs.basic_stage_int8_plain(x, qs)
        yield ("basic_stage_int8", (n, h, wd, c, nb), (x, qs), ref,
               lambda y, ref=ref: (y - ref).abs().max().item() == 0.0)
    for name, n, h, wd, c, nb in ([("basic_stage", *shape) for shape in BASIC_STAGE]
                                  + [("basic_stage_bf16w", *shape) for shape in BASIC_STAGE_BF16W]):
        stacked = bs.stack_basic_stage_params(basic_blocks(c, nb))
        stacked = {k: v.to(dev) for k, v in stacked.items()}
        if name == "basic_stage_bf16w":
            stacked.update({k: stacked[k].bfloat16() for k in ("w9_a", "w9_b")})
        x = rand(n, h, wd, c).abs()
        ref = bs.basic_stage_fused_plain(x, stacked)
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        yield (name, (n, h, wd, c, nb), (x, stacked), ref,
               lambda y, ref=ref, tol=tol: (y - ref).abs().max().item() <= tol)


def wrappers(dev) -> bool:
    """One A/B turn: each shape's public wrapper of the imported checkout."""
    from winograd_tpu_torch.kernels import _build
    from winograd_tpu_torch.kernels.basic_stage import basic_stage_fused, basic_stage_int8
    from winograd_tpu_torch.kernels.direct import conv3x3_bn_direct
    from winograd_tpu_torch.kernels.pointwise import conv1x1_bn
    from winograd_tpu_torch.kernels.quantized import (
        conv1x1_bn_int8, conv3x3_bn_int8, conv3x3_bn_winograd_int8, resnet_stage_int8,
        transition_block_int8,
    )
    from winograd_tpu_torch.kernels.stage import resnet_stage_fused
    from winograd_tpu_torch.kernels.stem import stem_fused
    from winograd_tpu_torch.kernels.transition import transition_block_fused
    from winograd_tpu_torch.kernels.winograd import conv3x3_bn_winograd

    _build.build_all()
    call = {"pointwise": conv1x1_bn, "direct": conv3x3_bn_direct,
            "direct_bf16w": conv3x3_bn_direct, "winograd": conv3x3_bn_winograd,
            "winograd_bf16w": conv3x3_bn_winograd, "winograd_bf16": conv3x3_bn_winograd,
            "stage": resnet_stage_fused, "direct_int8": conv3x3_bn_int8,
            "pointwise_bf16w": conv1x1_bn, "stage_bf16w": resnet_stage_fused,
            "stage_int8": resnet_stage_int8, "stem": stem_fused,
            "transition_int8": transition_block_int8, "transition": transition_block_fused,
            "transition_bf16w": transition_block_fused,
            "pointwise_int8": conv1x1_bn_int8, "winograd_int8": conv3x3_bn_winograd_int8,
            "basic_stage": basic_stage_fused, "basic_stage_bf16w": basic_stage_fused,
            "basic_stage_int8": basic_stage_int8}
    ok = True
    for name, shape, args, _, agrees in cases(dev):
        fn = (lambda f=call[name], args=args: f(*args))
        good = agrees(fn())
        ok &= good
        print(json.dumps({"kernel": name, "shape": shape, "agrees": good, "ms": device_ms(fn)}),
              flush=True)
    return ok


def ab(other: pathlib.Path) -> bool:
    """Turns other, this, this, other; one line per shape."""
    times, ok = {}, True
    for turn, root in enumerate((other, ROOT, ROOT, other)):
        run = subprocess.run([sys.executable, __file__, "--wrappers", str(root),
                              "--only", ",".join(ONLY)], capture_output=True, text=True)
        sys.stderr.write(run.stderr)
        ok &= run.returncode == 0
        for line in run.stdout.splitlines():
            if line.startswith("{"):
                r = json.loads(line)
                times.setdefault((r["kernel"], tuple(r["shape"])), [None] * 4)[turn] = r["ms"]
    for (name, shape), ms in times.items():
        print(json.dumps({"kernel": name, "shape": shape, "other": str(other),
                          "other_ms": [ms[0], ms[3]], "this_ms": [ms[1], ms[2]]}), flush=True)
    return ok


def sweep(dev) -> bool:
    import torch

    from winograd_tpu_torch.kernels import _build
    from winograd_tpu_torch.kernels import direct as dr
    from winograd_tpu_torch.kernels import pointwise as pw
    from winograd_tpu_torch.kernels import quantized as q8
    from winograd_tpu_torch.kernels import winograd as wg
    from winograd_tpu_torch.kernels.splitk import split_k

    _build.build_all()
    sms = _build.sm_count(dev)
    # The clusters of 16 GEMV blocks on 128-column tiles the card holds at once.
    wide = {"pointwise": pw.gemv_clusters(dev, "pointwise", 0),
            "pointwise_bf16w": pw.gemv_clusters(dev, "pointwise", 1),
            "pointwise_int8": pw.gemv_clusters(dev, "pointwise_int8")}
    print(json.dumps({"gemv_clusters": wide, "tile": pw.GEMV_COLS,
                      "splits": pw.GEMV_CLUSTER_MAX}), flush=True)
    ok = True
    for name, shape, args, ref, agrees in cases(dev):
        if name in A_B_ONLY:
            continue
        if name in ("winograd", "winograd_bf16w"):
            ok &= sweep_winograd(name, shape, args[:5], ref, agrees, wg, split_k, sms)
            continue
        if name == "winograd_bf16":
            ok &= sweep_winograd_fp64(shape, args[:5], ref, agrees, wg, sms)
            continue
        if name == "transition_int8":
            ok &= sweep_transition_int8(shape, args, ref, agrees, q8, sms)
            continue
        if name in ("transition", "transition_bf16w"):
            ok &= sweep_transition(name, shape, args, ref, agrees, sms)
            continue
        if name == "pointwise_int8":
            ok &= sweep_pointwise_int8(shape, args, ref, agrees, q8, sms, wide[name])
            continue
        if name == "direct_int8":
            ok &= sweep_direct_int8(shape, args, ref, agrees, q8, sms)
            continue
        if name == "winograd_int8":
            ok &= sweep_winograd_int8(shape, args, ref, agrees, q8, sms)
            continue
        if name == "basic_stage_int8":
            ok &= sweep_basic_stage_int8(shape, args, ref, agrees, sms)
            continue
        if name in ("basic_stage", "basic_stage_bf16w"):
            ok &= sweep_basic_stage(name, shape, args, ref, agrees, sms)
            continue
        if name == "stage_int8":
            ok &= sweep_stage_int8(shape, args, ref, agrees, q8, sms)
            continue
        if name.startswith("stage"):
            ok &= sweep_stage(name, shape, args, ref, agrees, sms)
            continue
        cap = 1 << 30
        if name.startswith("pointwise"):
            p, k, n, _ = shape
            chosen = pw.split_plan(p, k, n, sms, wide[name])
            if chosen.gemv:
                ok &= sweep_gemv(name, shape, args, ref, agrees, pw, sms, chosen)
                continue
            kp, step, run = k, pw.SPLIT_STEP, pw.conv1x1_bn_planned
            cap = pw.CLUSTER_MAX   # the MMA path's splits of a tile are one cluster
        else:   # direct, direct_bf16w: the splits of a tile are one cluster
            chosen = dr.direct_plan(*shape[:5], sms)
            kp, step, run = 9 * shape[3], pw.SPLIT_STEP, dr.conv3x3_bn_direct_planned
            cap = dr.DIRECT_CLUSTER_MAX
        plans = {chosen.splits: chosen}
        for want in (range(1, cap + 1) if name.startswith("direct") else WANTS):
            sp = split_k(kp, min(want, cap), step, step)
            plans.setdefault(sp.splits, chosen._replace(splits=sp.splits, chunk=sp.chunk))
        for splits, plan in sorted(plans.items()):
            fn = (lambda run=run, plan=plan: run(*args, plan))
            y = fn()
            ok &= agrees(y)
            print(json.dumps({"kernel": name, "shape": shape, "splits": splits,
                              "chunk": plan.chunk, "chosen": plan == chosen,
                              "max_abs_err": (y - ref).abs().max().item(),
                              "bar": 1e-4 * max(1.0, ref.abs().max().item()),
                              "ms": device_ms(fn)}), flush=True)
    torch.cuda.synchronize()
    return ok


def sweep_direct_int8(shape, args, ref, agrees, q8, sms) -> bool:
    """The int8 direct 3x3 under its plan and under the int8 pointwise's
    cluster rule at every tile width (64, 128) and the K splits split_k
    gives for WANTS (at most DIRECT_INT8_CLUSTER_MAX)."""
    n, h, w, cin, cout, _ = shape
    chosen = q8.direct_int8_plan(n, h, w, cin, cout, sms)
    plans = [chosen]
    for cols in q8.POINTWISE_INT8_CLUSTER_COLS:
        for want in WANTS:
            plan = q8.direct_int8_plan(n, h, w, cin, cout, sms, want, cols)
            if plan not in plans:
                plans.append(plan)
    ok = True
    for plan in plans:
        fn = (lambda plan=plan: q8.conv3x3_bn_int8_planned(*args, plan))
        y = fn()
        ok &= agrees(y)
        print(json.dumps({"kernel": "direct_int8", "shape": shape, "tile": plan.tile,
                          "splits": plan.splits, "chunk": plan.chunk, "chosen": plan == chosen,
                          "max_abs_err": (y - ref).abs().max().item(),
                          "ms": device_ms(fn)}), flush=True)
    return ok


def sweep_transition_int8(shape, args, ref, agrees, q8, sms) -> bool:
    """The int8 transition under its plan, under transition_int8_plan's walk
    caps for every phase (TRANSITION_INT8_WALKS), and under plans that change
    one phase's walk: the reduce's, the mid's, or the last phase's
    (its expand and projection together)."""
    n, h, w, cin, cmid, cout = shape
    chosen = q8.transition_int8_plan(*shape, sms)
    walk = {m: q8.transition_int8_plan(*shape, sms, m) for m in TRANSITION_INT8_WALKS if m}
    plans = {("chosen",): chosen}
    for m, forced in walk.items():
        plans.setdefault(("all", m), forced)
        plans.setdefault(("reduce", m), chosen._replace(reduce=forced.reduce))
        plans.setdefault(("mid", m), chosen._replace(mid=forced.mid))
        plans.setdefault(("last", m), chosen._replace(expand=forced.expand, proj=forced.proj))
    ok, seen = True, set()
    for varied, plan in plans.items():
        if plan.args() in seen and varied != ("chosen",):
            continue
        seen.add(plan.args())
        x, q = args
        fn = (lambda plan=plan: q8.transition_block_int8_planned(x, q, plan))
        y = fn()
        ok &= agrees(y)
        print(json.dumps({"kernel": "transition_int8", "shape": shape, "varied": varied,
                          "plan": plan.args(), "chosen": plan == chosen,
                          "max_abs_err": (y - ref).abs().max().item(),
                          "ms": device_ms(fn)}), flush=True)
    return ok


def sweep_transition(name, shape, args, ref, agrees, sms) -> bool:
    """The f32 or bf16w transition under its plan and under plans that
    change one phase's K split."""
    from winograd_tpu_torch.kernels import transition as tr
    from winograd_tpu_torch.kernels.splitk import split_k

    n, h, w, cin, cmid, cout = shape
    chosen = tr.transition_plan(*shape, sms)
    ks = {"reduce": cin, "mid": 9 * cmid, "expand": cmid + cin}
    plans = {("chosen",): chosen}
    for want in WANTS:
        for phase, k in ks.items():
            plans.setdefault((phase, want), chosen._replace(
                **{phase: split_k(k, want, tr.TRANSITION_STEP, tr.TRANSITION_STEP)}))
    x, params = args
    operands = (x, params["w_reduce"], params["s_reduce"], params["b_reduce"],
                params["w9_mid"], params["s_mid"], params["b_mid"], params["wep"], params["bep"])
    ok, seen = True, set()
    for varied, plan in plans.items():
        if plan.args() in seen and varied != ("chosen",):
            continue
        seen.add(plan.args())
        fn = (lambda plan=plan: tr.transition_block_fused_planned(*operands, plan))
        y = fn()
        ok &= agrees(y)
        print(json.dumps({"kernel": name, "shape": shape, "varied": varied,
                          "plan": plan.args(), "chosen": plan == chosen,
                          "max_abs_err": (y - ref).abs().max().item(),
                          "ms": device_ms(fn)}), flush=True)
    return ok


def sweep_gemv(name, shape, args, ref, agrees, pw, sms, chosen) -> bool:
    """The f32 or bf16w GEMV under its plan and under every cluster size
    (1, 2, 4, 8, 16 K splits: a power of two) on tiles 128 and 64 columns
    wide."""
    p, k, n, _ = shape
    plans = [chosen]
    for cols in (pw.GEMV_COLS, pw.GEMV_COLS // 2):
        for want in GEMV_WANTS:
            width, tiles, split = pw.gemv_split(k, n, sms, cols=cols, want=want)
            plan = pw.Plan(True, width, tiles, split.splits, split.chunk)
            if plan not in plans:
                plans.append(plan)
    ok = True
    for plan in plans:
        fn = (lambda plan=plan: pw.conv1x1_bn_planned(*args, plan))
        y = fn()
        ok &= agrees(y)
        print(json.dumps({"kernel": name, "shape": shape, "path": "gemv", "cols": plan.tile,
                          "splits": plan.splits, "chunk": plan.chunk, "chosen": plan == chosen,
                          "max_abs_err": (y - ref).abs().max().item(),
                          "bar": 1e-4 * max(1.0, ref.abs().max().item()),
                          "ms": device_ms(fn)}), flush=True)
    return ok


def sweep_pointwise_int8(shape, args, ref, agrees, q8, sms, wide) -> bool:
    """The int8 pointwise under its plan, and on every path that takes the
    shape: the GEMV under every cluster size (GEMV_WANTS) on tiles 128 and
    64 columns wide, the cluster path at the K splits split_k gives for
    WANTS (at most a portable cluster) at both of its widths, the one
    pass."""
    p, k, n, _ = shape
    chosen = q8.pointwise_int8_plan(p, k, n, sms, wide_clusters=wide)
    plans = [chosen]
    for path in q8.POINTWISE_INT8_PATHS:
        widths = {"cluster": q8.POINTWISE_INT8_CLUSTER_COLS,
                  "gemv": (q8.POINTWISE_INT8_GEMV_COLS, q8.POINTWISE_INT8_GEMV_COLS // 2)}
        wants = {"one_pass": (0,), "gemv": GEMV_WANTS}.get(path, WANTS)
        for want, cols in ((w, c) for c in widths.get(path, (0,)) for w in wants):
            try:
                plan = q8.pointwise_int8_plan(p, k, n, sms, path, want, cols)
            except ValueError:
                break
            if plan not in plans:
                plans.append(plan)
    ok = True
    for plan in plans:
        fn = (lambda plan=plan: q8.conv1x1_bn_int8_planned(*args, plan))
        y = fn()
        ok &= agrees(y)
        print(json.dumps({"kernel": "pointwise_int8", "shape": shape, "path": plan.path,
                          "tile": plan.tile, "splits": plan.splits, "chunk": plan.chunk,
                          "chosen": plan == chosen,
                          "max_abs_err": (y - ref).abs().max().item(),
                          "ms": device_ms(fn)}), flush=True)
    return ok


def sweep_winograd_int8(shape, args, ref, agrees, q8, sms) -> bool:
    """The int8 Winograd under its plan, under every other item shape the
    kernel takes (WINO_INT8_ITEMS: tiles by channels), and in
    spans of WINO_INT8_GROUP channels of K."""
    n, h, w, cin, cout, _ = shape
    chosen = q8.winograd_int8_plan(n, h, w, cin, cout, sms)
    plans = [chosen]
    for tiles, cols in q8.WINO_INT8_ITEMS:
        plan = q8.winograd_int8_item(n, h, w, cin, cout, tiles, cols)
        if plan is not None and plan not in plans:
            plans.append(plan)
    if chosen.kp > q8.WINO_INT8_GROUP:
        plans.append(chosen._replace(chunk=q8.WINO_INT8_GROUP))
    ok = True
    for plan in plans:
        fn = (lambda plan=plan: q8.conv3x3_bn_winograd_int8_planned(*args, plan))
        y = fn()
        ok &= agrees(y)
        print(json.dumps({"kernel": "winograd_int8", "shape": shape, "items": plan.items(),
                          "item_tiles": plan.item_tiles, "cols": plan.cols,
                          "blocks": plan.blocks, "chunk": plan.chunk, "chosen": plan == chosen,
                          "max_abs_err": (y - ref).abs().max().item(),
                          "ms": device_ms(fn)}), flush=True)
    return ok


def sweep_basic_stage_int8(shape, args, ref, agrees, sms) -> bool:
    """The int8 basic stage under its plan and under the K splits split_k
    gives for WANTS (whole stages of the s8 wgmma tile, at most
    BASIC_STAGE_INT8_MAX_SPLITS)."""
    from winograd_tpu_torch.kernels import basic_stage as bs
    from winograd_tpu_torch.kernels import quantized as q8
    from winograd_tpu_torch.kernels.splitk import split_k

    chosen = bs.basic_stage_int8_plan(*shape[:4], sms)
    plans = {chosen.splits: chosen}
    for want in WANTS:
        sp = split_k(chosen.kp, min(want, bs.BASIC_STAGE_INT8_MAX_SPLITS), q8.STAGE_INT8_STEP,
                     q8.STAGE_INT8_STEP)
        plans.setdefault(sp.splits, chosen._replace(splits=sp.splits, chunk=sp.chunk))
    ok = True
    for splits, plan in sorted(plans.items()):
        fn = (lambda plan=plan: bs.basic_stage_int8_planned(*args, plan))
        y = fn()
        ok &= agrees(y)
        print(json.dumps({"kernel": "basic_stage_int8", "shape": shape, "splits": splits,
                          "chunk": plan.chunk, "chosen": plan == chosen,
                          "max_abs_err": (y - ref).abs().max().item(),
                          "ms": device_ms(fn)}), flush=True)
    return ok


def sweep_basic_stage(name, shape, args, ref, agrees, sms) -> bool:
    """The f32 or bf16w basic stage under its plan and under the K splits
    split_k gives for WANTS."""
    from winograd_tpu_torch.kernels import basic_stage as bs
    from winograd_tpu_torch.kernels.splitk import split_k
    from winograd_tpu_torch.kernels.transition import TRANSITION_STEP

    chosen = bs.basic_stage_plan(*shape[:4], sms)
    k = 9 * shape[3]
    plans = {chosen.conv.splits: chosen}
    for want in WANTS:
        conv = split_k(k, want, TRANSITION_STEP, TRANSITION_STEP)
        plans.setdefault(conv.splits, chosen._replace(conv=conv))
    ok = True
    for splits, plan in sorted(plans.items()):
        fn = (lambda plan=plan: bs.basic_stage_fused_planned(*args, plan))
        y = fn()
        ok &= agrees(y)
        print(json.dumps({"kernel": name, "shape": shape, "splits": splits,
                          "chunk": plan.conv.chunk, "chosen": plan == chosen,
                          "max_abs_err": (y - ref).abs().max().item(),
                          "bar": 1e-4 * max(1.0, ref.abs().max().item()),
                          "ms": device_ms(fn)}), flush=True)
    return ok


def sweep_stage(name, shape, args, ref, agrees, sms) -> bool:
    """The f32 or bf16w stage under its plan and under stage_plan's rule at
    each of STAGE_WALKS, and at one block an SM."""
    from winograd_tpu_torch.kernels import stage as st

    n, h, w, cio, cmid = shape[:5]
    chosen = st.stage_plan(n, h, w, cio, cmid, sms)
    plans = {("chosen", chosen.grid): chosen}
    for walk in STAGE_WALKS:
        plans.setdefault((walk, chosen.grid), st.stage_plan(n, h, w, cio, cmid, sms, walk, walk))
    one = st.stage_plan(n, h, w, cio, cmid, sms // st.STAGE_BLOCKS_PER_SM)  # one block an SM
    plans.setdefault(("one_per_sm", one.grid), one)
    ok, seen = True, []
    for (label, _), plan in plans.items():
        if plan in seen:
            continue
        seen.append(plan)
        fn = (lambda plan=plan: st.resnet_stage_fused_planned(*args, plan))
        y = fn()
        good = agrees(y)
        ok &= good
        print(json.dumps({"kernel": name, "shape": shape, "walk": label, "grid": plan.grid,
                          "phases": plan.phases(), "chosen": plan == chosen,
                          "max_abs_err": (y - ref).abs().max().item(),
                          "max_abs_ref": ref.abs().max().item(), "agrees": good,
                          "ms": device_ms(fn)}), flush=True)
    return ok


def sweep_stage_int8(shape, args, ref, agrees, q8, sms) -> bool:
    """The int8 stage under its plan and under stage_int8_plan's walk caps
    (STAGE_INT8_WALKS)."""
    n, h, w, cio, cmid, _, mid = shape
    groups = q8.expand_groups(cmid, mid)
    chosen = q8.stage_int8_plan(n, h, w, cio, cmid, mid, groups, sms)
    plans = {}
    for walk in STAGE_INT8_WALKS:
        plans.setdefault(q8.stage_int8_plan(n, h, w, cio, cmid, mid, groups, sms, walk), walk)
    if mid == "winograd2":   # the FP64 mid's Cout blocks
        from winograd_tpu_torch.kernels.winograd import WINOGRAD_FP64_COLS

        for cols in WINOGRAD_FP64_COLS:
            plans.setdefault(chosen._replace(mid=chosen.mid._replace(chunk=cols)), 0)
    ok = True
    for plan, walk in plans.items():
        fn = (lambda plan=plan: q8.resnet_stage_int8_planned(*args, plan))
        y = fn()
        ok &= agrees(y)
        print(json.dumps({"kernel": "stage_int8", "shape": shape, "walk": walk,
                          "phases": plan.phases(), "chosen": plan == chosen,
                          "max_abs_err": (y - ref).abs().max().item(),
                          "ms": device_ms(fn)}), flush=True)
    return ok


def sweep_winograd(name, shape, args, ref, agrees, wg, split_k, sms) -> bool:
    """The f32 or bf16w Winograd under its plan and under other Cin splits
    of its work items."""
    n, h, w, cin, cout, m, _ = shape
    a2 = (m + 2) ** 2
    chosen = wg.winograd_plan(n, h, w, cin, cout, m, sms)
    plans = [chosen]
    for want in (1, 2, 3, 4, 8):
        sp = split_k(cin, want, wg.WINOGRAD_STEP, wg.WINOGRAD_STEP)
        plan = chosen._replace(splits=sp.splits, chunk=sp.chunk)
        if plan not in plans:
            plans.append(plan)
    ok = True
    tiles = wg.winograd_tiles(n, h, w, m)
    for plan in plans:
        fn = (lambda plan=plan: wg.conv3x3_bn_winograd_planned(*args, plan))
        y = fn()
        ok &= agrees(y)
        print(json.dumps({"kernel": name, "shape": shape, "splits": plan.splits, "chunk": plan.chunk,
                          "items": plan.items(tiles, cout, a2), "chosen": plan == chosen,
                          "max_abs_err": (y - ref).abs().max().item(),
                          "ms": device_ms(fn)}), flush=True)
    return ok


def sweep_winograd_fp64(shape, args, ref, agrees, wg, sms) -> bool:
    """The int8 tiers' FP64 F(2,3) tile under its plan and under every Cout
    block of its items, each on a grid of one block an item, one block an
    SM and two."""
    n, h, w, _, cout, _ = shape
    chosen = wg.winograd_fp64_plan(n, h, w, cout, sms)
    plans = [chosen]
    for cols in wg.WINOGRAD_FP64_COLS:
        items = wg.winograd_fp64_items(n, h, w, cout, cols)
        for blocks in (items, sms, 2 * sms):
            plan = wg.WinogradFp64Plan(cols, min(items, blocks))
            if plan not in plans:
                plans.append(plan)
    ok = True
    for plan in plans:
        fn = (lambda plan=plan: wg.conv3x3_bn_winograd_fp64_planned(*args, plan))
        y = fn()
        ok &= agrees(y)
        print(json.dumps({"kernel": "winograd_bf16", "shape": shape, "cols": plan.cols,
                          "blocks": plan.blocks,
                          "items": wg.winograd_fp64_items(n, h, w, cout, plan.cols),
                          "chosen": plan == chosen, "max_abs_err": (y - ref).abs().max().item(),
                          "ms": device_ms(fn)}), flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ab", type=pathlib.Path, metavar="DIR")
    ap.add_argument("--wrappers", type=pathlib.Path, metavar="ROOT")
    ap.add_argument("--only", default="", metavar="NAME,...")
    args = ap.parse_args()
    global ONLY
    ONLY = tuple(n for n in args.only.split(",") if n)
    sys.path.insert(0, str((args.wrappers or ROOT).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("chip_split_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.wrappers:
        ok = wrappers(dev)
    else:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip(), flush=True)
        ok = ab(args.ab.resolve()) if args.ab else sweep(dev)
    if not ok:
        print("chip_split_sweep: a call disagreed with its plain twin", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
