#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (winograd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and nvcc.
Phases, each of which must pass (exit 1 otherwise):

1. device: a CUDA device is required (no CPU continuation); TF32 is turned
   off for cuBLAS and cuDNN so the plain versions and the library
   yardsticks compute in full float32. Prints the card's name and power
   limit as nvidia-smi reports them.
2. build: compiles csrc/*.cu with nvcc for sm_90a, one process per source.
3. serving (f32 tier): ResNet50Engine with seeded full-width weights
   answers 10 N=1 requests and 3 N=8 requests on the JAX package's fused
   route. The launch counters are zeroed just before and read just after;
   each forward must launch stem 1, pointwise 8, Winograd 1, stage 3,
   transition 3 and direct 2 times. One image's logits must agree with the
   same model through the plain versions on the CPU in float64 (the
   golden) within 1e-4 * max(1, max|golden|); every row of the N=8 logits
   must agree with that image's N=1 logits within the same bound.
4. profile (f32): torch.profiler over 5 N=1 and 3 N=8 requests served as in
   phase 3, each ended by a synchronize (after the launch counts were
   read): device time by kernel name per request, and the device's idle
   share, 1 - device busy time over the host clock of the profiled
   requests (an upper bound for unprofiled serving: the profiler adds host
   time).
4a. serving_bf16w: ResNet50Engine(tier="bf16w") on the same weights (cast
   to bf16 once) and images, 10 N=1 and 3 N=8 requests, counters zeroed
   just before and read just after: each forward must launch the bf16w
   instantiations, counted under their own names, stem_bf16w 1,
   pointwise_bf16w 4, stage_bf16w 4 (conv5_x too), transition_bf16w 3 and
   winograd_bf16w 1 (the entry block's F(2,3) on the bf16 tensor cores,
   every shape of it at m = 2). Logits against phase 3's float64 golden
   within BF16W_RTOL_BACKBONE
   (5e-3) * max(1, max|golden|); against the port's bf16w forward through
   the plain versions on the CPU in float32 within 1e-4 * max(1,
   max|ref|); each N=8 row against that image's N=1 logits within 1e-4 *
   max(1, max|N=1 row|).
4b. profile_bf16w: as phase 4, for the bf16w tier.
5. serving_int8: ResNet50Engine(tier="int8") on the same weights and
   images, 10 N=1 and 3 N=8 requests, counters zeroed just before and read
   just after: each forward must launch stem 1 (at bf16), pointwise_int8 4,
   direct_int8 1, stage_int8 4 and transition_int8 3 times. Logits against
   the f32 golden of phase 3 within INT8_RTOL_BACKBONE (5e-2) *
   max(1, max|golden|); against the port's int8 forward through the plain
   versions on the CPU in float32 within 1e-3 * max(1, max|ref|); each N=8
   row against that image's N=1 logits within the same 1e-3 bound.
6. profile_int8: as phase 4, for the int8 tier.
7. serving_basic: ResNetBasicEngine with seeded full-width ResNet-34
   weights (bench mode 24), 10 N=1 and 3 N=8 requests on the same images,
   counters zeroed just before and read just after: each forward must
   launch stem 1, Winograd 24, pointwise 7, direct 1 and basic_stage 1
   times; logits against the same model through the plain versions on the
   CPU in float64 within 1e-4 * max(1, max|golden|), N=8 rows against N=1
   within the same bound.
8. profile_basic: as phase 4, for phase 7.
8a. serving_basic_bf16w: ResNetBasicEngine(tier="bf16w") on phase 7's
   weights (cast to bf16 once) and images, 10 N=1 and 3 N=8 requests,
   counters zeroed just before and read just after: each forward must
   launch stem_bf16w 1, winograd_bf16w 24, pointwise_bf16w 7, direct_bf16w
   1 and basic_stage_bf16w 1 times. Logits as phase 4a's bars: phase 7's
   float64 golden within 5e-3 * max(1, max|golden|), the port's bf16w
   forward through the plain versions on the CPU within 1e-4 * max(1,
   max|ref|), each N=8 row against its N=1 logits within 1e-4.
8b. profile_basic_bf16w: as phase 4, for phase 8a.
9. serving_basic_int8: ResNetBasicEngine(tier="int8") on the same weights
   and images: each forward must launch stem 1 (at bf16), Winograd 6 (on
   bf16 filters), winograd_int8 18, pointwise_int8 7, direct_int8 1 and
   basic_stage_int8 1 times; logits against phase 7's golden within 5e-2 *
   max(1, max|golden|), against the port's int8 forward through the plain
   versions on the CPU in float32 within 1e-3 * max(1, max|ref|), N=8 rows
   against N=1 within 1e-3.
10. profile_basic_int8: as phase 4, for phase 9.
11. kernels: each kernel against its plain PyTorch version on the card, at
   every shape the first N=1 forward of phases 3, 4a, 5, 7, 8a and 9 gave it
   (recorded by shape in kernels/_build.py), and at shapes off the served
   N=1 lists (Winograd F(4,3) at 14x14x128; the block at bench modes 6 and
   9; the conv4_x stage and the 14->7 transition at N=8; the conv5_x stage
   geometry; the int8 stage at N=8 and at one block (mode 6); the int8
   14->7 transition at N=8; the stem at N=8 in both precisions; both basic
   stages at N=8 and at one block, the ResNet-18 run; the int8 Winograd at
   N=8, 14x14x256 and 28x28x128, and at Cin 1152 -> 128 and 2048 -> 256 on
   14x14 (WIDE_WINOGRAD_INT8: K walked in spans); the pointwise head and conv5_x reduce
   at N=8; the int8 pointwise head at N=8; the f32 and int8 direct 3x3s at
   N=8, 7x7x512; the bf16w pointwise head, the conv4_x and conv5_x bf16w
   stages, the 14->7 bf16w transition and the bf16w stem at N=8, the bf16w
   block at modes 6 and 9, the bf16w Winograd at 56x56x64, the bf16w direct
   3x3 at 7x7x512 and the bf16w basic stage at 7x7x512 at N=8), on seeded
   inputs. Bound: max abs error <= 1e-4 *
   max(1, max|plain|); the int8 direct 3x3, stage, transition, pointwise,
   basic stage and Winograd (their twins' arithmetic, exact int32 sums,
   the Winograd's transforms in FP64 rounded once), the bf16 stem and the
   int8 tier's bf16-filter Winograd (exact FP64 sums of bf16 products) 0:
   equal to their twins (the int8
   basic stage and Winograd held to 0 since their redesign on the tensor
   cores, 1e-3 before). One JSON line per shape:
   error; the K split of the split-K kernels ("splits": pointwise, direct,
   direct_int8, pointwise_int8 and both basic stages, from their wrappers'
   plans, pointwise_int8 with its plan's "route", GEMV, one_pass or
   cooperative; the f32 transition's splits of its reduce, mid and expand;
   for the f32 Winograd its plan's Cin splits); the int8 Winograd's plan
   (its items' "tile_blocks" and "col_blocks", its grid's "blocks", the
   "chunk" of K an item stages at once);
   device times of the kernel, its plain version and the library call (20
   calls captured in a CUDA graph, the median of 20 replays between CUDA
   events, divided by 20; inputs stay in L2 between calls); "wrapper_ms",
   one eager wrapper call
   between CUDA events, host path included (median of 20 after 2
   warm-ups); and the bound: the larger of the operations' time and the
   bytes' time (H100 SXM data sheet: 67 TFLOP/s FP32 outside the tensor
   cores, 495 TFLOP/s TF32, 989 TFLOP/s BF16 and 1979 TOPS INT8 dense on
   the tensor cores, 3.35 TB/s HBM). Operations: int8 MACs x 2 at the INT8
   rate; the bf16 stem's products and the int8 stage's bf16-filter F(2,3)
   products (as two BF16 passes, the JAX kernel's hi/lo split) at the BF16
   rate; the tensor-core products of the pointwise kernel (P > 8), the
   direct 3x3, the f32 Winograd, the f32 stage, the f32 transition (their
   reduce, mid and expand) and the f32 basic stage (its 2B convs) as three
   TF32 passes (their 3xTF32 split) at the TF32 rate; the bf16w
   instantiations' products (pointwise, GEMV included, stem, stage,
   transition, Winograd, direct and basic stage) as two BF16 passes (a_hi
   and a_lo) at the BF16 rate; the
   pointwise GEMV's (P <= 8) and the other f32 GEMMs, Winograd transforms,
   epilogues (4 FLOPs an output, 5 with a residual) and int8 quantization
   (2 a quantized value) at the FP32 rate; the bf16-filter Winograd's
   products as two BF16 passes too. Bytes: each input read once
   (int8 weights 1 byte, bf16 filters and weights 2), each output written
   once. Library: torch.matmul / F.conv2d (f32; a basic stage its 2B convs;
   a bf16w row the same call as its kernel's f32 row, on the f32 weights), the
   bf16-filter Winograd F.conv2d in bf16, and for the int8 kernels
   torch._int_mm on operands quantized (the 3x3s im2col'd, the int8
   Winograd's V per position) before the timed region, summed over the
   kernel's GEMMs, rows padded to 32 where P <= 16 (the call refuses fewer
   than 17), and torch.bmm in bf16 for the F(2,3) mid's products.
12. a "kernels" JSON line (per-image sums over each path's shapes, both
   models and all tiers; the stem row sums its f32 and bf16 shapes, the
   Winograd row its f32 and bf16-filter shapes; the bf16w instantiations
   are rows of their own, "<kernel>_bf16w", their source the kernel's
   file), the card line, and last
   {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import json
import statistics
import subprocess
import sys
import time

import numpy as np

FP32_FLOPS = 67e12   # H100 SXM, FP32 outside the tensor cores, dense
TF32_FLOPS = 495e12  # tensor cores, dense
BF16_FLOPS = 989e12  # tensor cores, dense
INT8_OPS = 1979e12   # tensor cores, dense
HBM_BYTES_S = 3.35e12
ATOL = 1e-4
INT8_CHAINED_RTOL = 1e-3
EXPECTED_PER_FORWARD = {
    "stem": 1, "pointwise": 8, "winograd": 1, "stage": 3, "transition": 3, "direct": 2,
}
EXPECTED_PER_FORWARD_BF16W = {
    "stem_bf16w": 1, "pointwise_bf16w": 4, "winograd_bf16w": 1, "stage_bf16w": 4,
    "transition_bf16w": 3,
}
EXPECTED_PER_FORWARD_INT8 = {
    "stem": 1, "pointwise_int8": 4, "direct_int8": 1, "stage_int8": 4, "transition_int8": 3,
}
EXPECTED_PER_FORWARD_BASIC = {
    "stem": 1, "winograd": 24, "pointwise": 7, "direct": 1, "basic_stage": 1,
}
EXPECTED_PER_FORWARD_BASIC_BF16W = {
    "stem_bf16w": 1, "winograd_bf16w": 24, "pointwise_bf16w": 7, "direct_bf16w": 1,
    "basic_stage_bf16w": 1,
}
EXPECTED_PER_FORWARD_BASIC_INT8 = {
    "stem": 1, "winograd": 6, "winograd_int8": 18, "pointwise_int8": 7, "direct_int8": 1,
    "basic_stage_int8": 1,
}
SOURCES = {
    "pointwise": ("winograd_tpu/kernels/pointwise.py:67",
                  ["winograd_tpu/kernels/pointwise.py:67 _matmul_bn_kernel"]),
    "winograd": ("winograd_tpu/kernels/winograd.py:384",
                 ["winograd_tpu/kernels/winograd.py:384 _winograd_kernel",
                  "winograd_tpu/kernels/winograd.py:252 _winograd_kernel_p64"]),
    "direct": ("winograd_tpu/kernels/direct.py:97",
               ["winograd_tpu/kernels/direct.py:97 _direct_kernel"]),
    "stem": ("winograd_tpu/kernels/stem.py:59",
             ["winograd_tpu/kernels/stem.py:59 _stem_kernel"]),
    "stage": ("winograd_tpu/kernels/stage.py:129",
              ["winograd_tpu/kernels/stage.py:129 _stage_kernel",
               "winograd_tpu/kernels/stage.py:169 _stage_kernel_resident",
               "winograd_tpu/kernels/block.py:32 _block_kernel",
               "winograd_tpu/kernels/block.py:150 _block_kernel_winograd"]),
    "transition": ("winograd_tpu/kernels/transition.py:38",
                   ["winograd_tpu/kernels/transition.py:38 _transition_kernel",
                    "winograd_tpu/kernels/transition.py:119 _transition_kernel_resident"]),
    "pointwise_int8": ("winograd_tpu/kernels/quantized.py:66",
                       ["winograd_tpu/kernels/quantized.py:66 _quant_matmul_kernel"]),
    "direct_int8": ("winograd_tpu/kernels/quantized.py:149",
                    ["winograd_tpu/kernels/quantized.py:149 _direct_int8_kernel",
                     "winograd_tpu/kernels/quantized.py:183 _direct_int8_banded_kernel"]),
    "stage_int8": ("winograd_tpu/kernels/quantized.py:765",
                   ["winograd_tpu/kernels/quantized.py:765 _stage_int8_kernel",
                    "winograd_tpu/kernels/quantized.py:853 _stage_int8_kernel_resident",
                    "winograd_tpu/kernels/quantized.py:653 _block_int8_kernel"]),
    "transition_int8": ("winograd_tpu/kernels/quantized.py:941",
                        ["winograd_tpu/kernels/quantized.py:941 _transition_int8_kernel",
                         "winograd_tpu/kernels/quantized.py:1003 "
                         "_transition_int8_kernel_resident"]),
    "winograd_int8": ("winograd_tpu/kernels/quantized.py:393",
                      ["winograd_tpu/kernels/quantized.py:393 _winograd_int8_kernel"]),
    "basic_stage": ("winograd_tpu/kernels/basic_stage.py:59",
                    ["winograd_tpu/kernels/basic_stage.py:59 _basic_stage_kernel"]),
    "basic_stage_int8": ("winograd_tpu/kernels/basic_stage.py:202",
                         ["winograd_tpu/kernels/basic_stage.py:202 _basic_stage_int8_kernel"]),
}
# The bf16w instantiations replace the same TPU kernels at precision="bf16w".
BF16W = ("pointwise", "stem", "stage", "transition", "winograd", "direct", "basic_stage")
SOURCES.update({f"{name}_bf16w": SOURCES[name] for name in BF16W})
# The int8 Winograd past one span of K (kernels/quantized.py::
# WINO_INT8_CHUNK): nine 128-channel groups, and the stash over 2048
# channels. Checked against the twin like every shape, counted in no image.
WIDE_WINOGRAD_INT8 = [(1, 14, 14, 1152, 128, True), (1, 14, 14, 2048, 256, True)]
# The twin's arithmetic (quantized once a row, exact int32 sums, epilogues
# rounded as the twin rounds, the int8 Winograd's transforms in FP64 rounded
# once): the kernel equals its twin. So do the stem and the Winograd at
# "bf16" (their shapes end in the precision): exact FP64 sums of bf16
# products, rounded once.
EXACT = ("direct_int8", "stage_int8", "transition_int8", "pointwise_int8", "basic_stage_int8",
         "winograd_int8")


def _rand(rng, *shape):
    return (rng.random(shape) - 0.5).astype(np.float32)


def _winograd_transform_flops(m):
    """FLOPs of the input transform per tile and input channel, and of the
    output transform per tile and output channel, counting only the nonzero
    entries of Bt and At, as csrc/winograd.cu's sandwich() computes them
    (one FMA, two FLOPs, each)."""
    from winograd_tpu_torch.kernels import transforms

    bt, _, at = transforms.matrices(m)
    a = m + 2
    return 2 * (2 * a * np.count_nonzero(bt)), 2 * ((a + m) * np.count_nonzero(at))


def _kernel_name(key):
    """A profiler event's kernel name without namespace, template or
    arguments; PyTorch's own kernels are lumped as "pytorch_ops"."""
    if "at::native" in key:
        return "pytorch_ops"
    key = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return key.split("(")[0].split("<")[0].strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()

    import torch.nn.functional as F

    from winograd_tpu_torch.config import (
        BF16W_RTOL_BACKBONE, INT8_RTOL_BACKBONE, ResNet34Config, ResNet50Config,
    )
    from winograd_tpu_torch.engine import ResNet50Engine, ResNetBasicEngine
    from winograd_tpu_torch.kernels import _build, transforms
    from winograd_tpu_torch.kernels import basic_stage as bs
    from winograd_tpu_torch.kernels import quantized as q8
    from winograd_tpu_torch.kernels.direct import (
        conv3x3_bn_direct, conv3x3_bn_direct_plain, direct_filter, direct_plan, im2col3x3,
    )
    from winograd_tpu_torch.kernels.pointwise import conv1x1_bn, conv1x1_bn_plain, split_plan
    from winograd_tpu_torch.kernels.stage import (
        resnet_stage_fused, resnet_stage_fused_plain, stack_stage_params,
    )
    from winograd_tpu_torch.kernels.stem import stem_fused, stem_fused_plain
    from winograd_tpu_torch.kernels.transition import (
        fuse_transition_weights, strided_im2col, transition_block_fused,
        transition_block_fused_plain, transition_plan,
    )
    from winograd_tpu_torch.kernels.winograd import (
        conv3x3_bn_winograd, conv3x3_bn_winograd_plain, winograd2_mid_plain, winograd_plan,
    )
    from winograd_tpu_torch.models.basic import (
        basicnet_forward, basicnet_forward_int8, basicnet_params, cast_basicnet_bf16w,
        init_basicnet_arrays, quantize_basicnet,
    )
    from winograd_tpu_torch.models.convert import cast_bf16w, params_from_jax, stem_filter_s2d
    from winograd_tpu_torch.models.resnet50 import (
        init_resnet50_arrays, init_resnet50_params, quantize_resnet50, resnet50_forward,
        resnet50_forward_int8,
    )

    dev = torch.device("cuda", 0)
    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)
            print(f"FAIL: {what}", file=sys.stderr)

    build_s = _build.build_all()
    print(json.dumps({"phase": "build", "seconds": build_s}), flush=True)

    def t(a):
        return torch.as_tensor(a, device=dev)

    def bn(rng, c):
        gamma, beta, mean = _rand(rng, c), _rand(rng, c), _rand(rng, c)
        var = (rng.random(c) * 3 + 5).astype(np.float32)
        s, b = transforms.fold_batchnorm(gamma, beta, mean, var)
        return t(s), t(b)

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def wrapper_ms(fn, reps=20, warmup=2):
        """One eager call between two events: device time plus whatever host
        time the device waits for."""
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(reps):
            a, b = events()
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)

    def device_ms(fn, calls=20, reps=20, warmup=2):
        """Device time per call: `calls` calls captured in one CUDA graph,
        the median of `reps` replays between two events, over `calls`."""
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
            a, b = events()
            a.record()
            graph.replay()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs) / calls

    def bound(work, nbytes):
        """work: operations by peak rate ({rate: count}). Returns the
        operations' time and the bytes' time, in ms; the bound is the
        larger."""
        ops_ms = 1e3 * sum(n / rate for rate, n in work.items())
        bytes_ms = 1e3 * nbytes / HBM_BYTES_S
        return ops_ms, bytes_ms

    def nchw(x):
        return x.permute(0, 3, 1, 2)

    # -- f32 cases: (kernel fn, plain fn, library fn, work, bytes) ----------
    def pointwise_work(p, k, n):
        """The GEMV's FFMA products at the FP32 rate; the MMA tiles' as three
        TF32 passes (3xTF32); the epilogue at the FP32 rate."""
        if split_plan(p, k, n, _build.sm_count(dev)).gemv:
            return {FP32_FLOPS: 2 * p * k * n + 4 * p * n}
        return {TF32_FLOPS: 3 * 2 * p * k * n, FP32_FLOPS: 4 * p * n}

    def pointwise_case(rng, p, k, n, relu):
        x, w = t(_rand(rng, p, k)), t(_rand(rng, k, n))
        s, b = bn(rng, n)
        return (lambda: conv1x1_bn(x, w, s, b, relu),
                lambda: conv1x1_bn_plain(x, w, s, b, relu),
                lambda: torch.matmul(x, w),
                pointwise_work(p, k, n), 4 * (p * k + k * n + p * n + 2 * n))

    def bf16w(layer):
        """A layer's weights in bfloat16 (the bf16w tier's storage)."""
        return {k: v.to(torch.bfloat16) if k.startswith(("w", "u2")) else v
                for k, v in layer.items()}

    def pointwise_bf16w_case(rng, p, k, n, relu):
        """Products as two BF16 passes (a_hi, a_lo), GEMV too; weights at 2
        bytes; library: the f32 row's torch.matmul on the f32 weights."""
        x, w = t(_rand(rng, p, k)), t(_rand(rng, k, n))
        w16 = w.to(torch.bfloat16)
        s, b = bn(rng, n)
        return (lambda: conv1x1_bn(x, w16, s, b, relu),
                lambda: conv1x1_bn_plain(x, w16, s, b, relu),
                lambda: torch.matmul(x, w),
                {BF16_FLOPS: 2 * 2 * p * k * n, FP32_FLOPS: 4 * p * n},
                4 * (p * k + p * n + 2 * n) + 2 * k * n)

    def conv3x3_inputs(rng, n, h, w, cin, cout):
        x, wt = t(_rand(rng, n, h, w, cin)), _rand(rng, cout, cin, 3, 3)
        s, b = bn(rng, cout)
        w_cl = t(wt).contiguous(memory_format=torch.channels_last)
        return x, wt, s, b, lambda: F.conv2d(nchw(x), w_cl, padding=1)

    def winograd_case(rng, n, h, w, cin, cout, m, relu, filt="f32"):
        """filt "bf16": the bf16-filter F(2,3) (its products as two BF16
        passes, the JAX kernel's hi/lo split; library F.conv2d in bf16);
        "bf16w": the bf16w instantiation (products as two BF16 passes, u at
        2 bytes; library the f32 row's call)."""
        x, wt, s, b, lib = conv3x3_inputs(rng, n, h, w, cin, cout)
        u = t(transforms.transform_filter(wt, m=m))
        a2, nt = (m + 2) ** 2, n * (-(-h // m)) * (-(-w // m))
        fwd, inv = _winograd_transform_flops(m)
        products, transforms_flops = 2 * a2 * nt * cin * cout, nt * (fwd * cin + inv * cout)
        if filt == "bf16":
            u = u.to(torch.bfloat16)
            x16 = nchw(x).to(torch.bfloat16)
            w16 = t(wt).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
            return (lambda: conv3x3_bn_winograd(x, u, s, b, relu, "bf16"),
                    lambda: winograd2_mid_plain(x, u, s, b, relu),
                    lambda: F.conv2d(x16, w16, padding=1),
                    {BF16_FLOPS: 2 * products, FP32_FLOPS: transforms_flops},
                    4 * n * h * w * (cin + cout) + 2 * a2 * cin * cout + 8 * cout)
        if filt == "bf16w":
            u = u.to(torch.bfloat16)
            return (lambda: conv3x3_bn_winograd(x, u, s, b, relu, "bf16w"),
                    lambda: conv3x3_bn_winograd_plain(x, u, s, b, relu), lib,
                    {BF16_FLOPS: 2 * products,
                     FP32_FLOPS: transforms_flops + 4 * n * h * w * cout},
                    4 * n * h * w * (cin + cout) + 2 * a2 * cin * cout + 8 * cout)
        return (lambda: conv3x3_bn_winograd(x, u, s, b, relu),
                lambda: conv3x3_bn_winograd_plain(x, u, s, b, relu),
                lib, {TF32_FLOPS: 3 * products,
                      FP32_FLOPS: transforms_flops + 4 * n * h * w * cout},
                4 * (n * h * w * (cin + cout) + a2 * cin * cout + 2 * cout))

    def direct_case(rng, n, h, w, cin, cout, relu, bf16=False):
        """bf16: the bf16w instantiation (w9 at 2 bytes, products as two BF16
        passes; library the f32 row's call)."""
        x, wt, s, b, lib = conv3x3_inputs(rng, n, h, w, cin, cout)
        w9 = t(direct_filter(wt))
        p = n * h * w
        rate, passes, wbytes = (BF16_FLOPS, 2, 2) if bf16 else (TF32_FLOPS, 3, 4)
        if bf16:
            w9 = w9.to(torch.bfloat16)
        return (lambda: conv3x3_bn_direct(x, w9, s, b, relu),
                lambda: conv3x3_bn_direct_plain(x, w9, s, b, relu),
                lib, {rate: passes * 2 * p * 9 * cin * cout, FP32_FLOPS: 4 * p * cout},
                4 * (n * h * w * (cin + cout) + 2 * cout) + wbytes * 9 * cin * cout)

    def stem_case(rng, n, h, w, cin, c, precision):
        """At "bf16w" w192 is bf16 (2 bytes), the products two BF16 passes
        (the JAX kernel's hi/lo split of the image), the library the f32
        row's cuDNN call."""
        x, w7 = t(_rand(rng, n, h, w, cin)), _rand(rng, c, cin, 7, 7)
        s, b = bn(rng, c)
        w192 = t(stem_filter_s2d(w7))
        dt = torch.bfloat16 if precision == "bf16" else torch.float32
        x_lib = nchw(x).to(dt)
        w7_cl = t(w7).to(dt).contiguous(memory_format=torch.channels_last)
        ho, wo, po, qo = -(-h // 2), -(-w // 2), -(-h // 4), -(-w // 4)
        products = 2 * n * ho * wo * 49 * cin * c
        work, wbytes = {FP32_FLOPS: products}, 4
        if precision == "bf16":
            work = {BF16_FLOPS: products}
        elif precision == "bf16w":
            work, wbytes, w192 = {BF16_FLOPS: 2 * products}, 2, w192.to(torch.bfloat16)
        return (lambda: stem_fused(x, w192, s, b, precision),
                lambda: stem_fused_plain(x, w192, s, b, precision),
                lambda: F.max_pool2d(F.conv2d(x_lib, w7_cl, stride=2, padding=3), 3, 2, 1),
                work, 4 * (n * h * w * cin + n * po * qo * c + 2 * c) + wbytes * 64 * cin * c)


    def conv3x3_filter(rng, cin, cout):
        w = _rand(rng, cout, cin, 3, 3)
        return w, t(w).contiguous(memory_format=torch.channels_last)

    def stage_blocks(rng, cio, cmid, nb):
        blocks = []
        for _ in range(nb):
            wm = _rand(rng, cmid, cmid, 3, 3)
            (s1, b1), (s2, b2), (s3, b3) = bn(rng, cmid), bn(rng, cmid), bn(rng, cio)
            blocks.append(dict(
                w_reduce=t(_rand(rng, cio, cmid)), s_reduce=s1, b_reduce=b1,
                u2_mid=t(transforms.transform_filter(wm, m=2)), w9_mid=t(direct_filter(wm)),
                s_mid=s2, b_mid=b2, w_expand=t(_rand(rng, cmid, cio)), s_expand=s3,
                b_expand=b3, w_mid=wm))
        return blocks

    def stage_case(rng, n, h, w, cio, cmid, nb, mid, bf16=False):
        """bf16: the bf16w instantiation (bf16 weights at 2 bytes, products
        as two BF16 passes; library the f32 row's calls)."""
        blocks = stage_blocks(rng, cio, cmid, nb)
        lib_w = [(b["w_reduce"], t(b.pop("w_mid")).contiguous(memory_format=torch.channels_last),
                  b["w_expand"]) for b in blocks]
        stacked = stack_stage_params(blocks)
        if bf16:
            stacked = bf16w(stacked)
        x = t(_rand(rng, n, h, w, cio))

        def lib():
            y = x
            for wr, wm_cl, we in lib_w:
                y = torch.matmul(y, wr)
                y = F.conv2d(nchw(y), wm_cl, padding=1).permute(0, 2, 3, 1)
                y = torch.matmul(y, we)
            return y

        p = n * h * w
        epilogues = 4 * p * 2 * cmid + 5 * p * cio
        if mid == "winograd2":
            nt = n * (-(-h // 2)) * (-(-w // 2))
            fwd, inv = _winograd_transform_flops(2)
            mid_products, mid_elems = 2 * 16 * nt * cmid * cmid, 16 * cmid * cmid
            epilogues += nt * (fwd + inv) * cmid
        else:
            mid_products, mid_elems = 2 * p * 9 * cmid * cmid, 9 * cmid * cmid
        rate, passes, wbytes = (BF16_FLOPS, 2, 2) if bf16 else (TF32_FLOPS, 3, 4)
        work = {rate: nb * passes * (4 * p * cio * cmid + mid_products),
                FP32_FLOPS: nb * epilogues}
        nbytes = (4 * (2 * p * cio + nb * (4 * cmid + 2 * cio))
                  + wbytes * nb * (2 * cio * cmid + mid_elems))
        return (lambda: resnet_stage_fused(x, stacked, mid),
                lambda: resnet_stage_fused_plain(x, stacked, mid), lib, work, nbytes)

    def transition_params(rng, cin, cmid, cout):
        wm = _rand(rng, cmid, cmid, 3, 3)
        (s1, b1), (s2, b2), (s3, b3), (sp, bp) = (bn(rng, c) for c in (cmid, cmid, cout, cout))
        return wm, dict(w_reduce=t(_rand(rng, cin, cmid)), s_reduce=s1, b_reduce=b1,
                        w9_mid=t(direct_filter(wm)), s_mid=s2, b_mid=b2,
                        w_expand=t(_rand(rng, cmid, cout)), s_expand=s3, b_expand=b3,
                        w_proj=t(_rand(rng, cin, cout)), s_proj=sp, b_proj=bp)

    def transition_case(rng, n, h, w, cin, cmid, cout, bf16=False):
        """bf16: the bf16w instantiation (bf16 weights at 2 bytes, products
        as two BF16 passes; library the f32 row's calls)."""
        wm, params = transition_params(rng, cin, cmid, cout)
        wm_cl = t(wm).contiguous(memory_format=torch.channels_last)
        params["wep"], params["bep"] = fuse_transition_weights(params)
        lib_params = params
        if bf16:
            params = bf16w(params)
        x = t(_rand(rng, n, h, w, cin))

        def lib():
            y = torch.matmul(x, lib_params["w_reduce"])
            y = F.conv2d(nchw(y), wm_cl, stride=2, padding=1).permute(0, 2, 3, 1)
            return (torch.matmul(y, lib_params["w_expand"])
                    + torch.matmul(x[:, ::2, ::2, :], lib_params["w_proj"]))

        ho, wo = -(-h // 2), -(-w // 2)
        p1, p2 = n * h * w, n * ho * wo
        flops = 2 * (p1 * cin * cmid + p2 * (9 * cmid * cmid + (cmid + cin) * cout))
        rate, passes, wbytes = (BF16_FLOPS, 2, 2) if bf16 else (TF32_FLOPS, 3, 4)
        nbytes = (4 * (p1 * cin + p2 * cout + 4 * cmid + cout)
                  + wbytes * (cin * cmid + 9 * cmid * cmid + (cmid + cin) * cout))
        return (lambda: transition_block_fused(x, params),
                lambda: transition_block_fused_plain(x, params), lib,
                {rate: passes * flops, FP32_FLOPS: 4 * (p1 + p2) * cmid + 2 * p2 * cout},
                nbytes)

    def basic_blocks(rng, c, nb):
        blocks = []
        for _ in range(nb):
            blk = {}
            for leg in ("a", "b"):
                w = _rand(rng, c, c, 3, 3)
                blk[f"w_{leg}"], blk[f"w9_{leg}"] = w, direct_filter(w)
                blk[f"s_{leg}"], blk[f"b_{leg}"] = (v.cpu().numpy() for v in bn(rng, c))
            blocks.append(blk)
        return blocks

    def basic_stage_case(rng, n, h, w, c, nb, bf16=False):
        """bf16: the bf16w instantiation (w9_a, w9_b at 2 bytes, products as
        two BF16 passes; library the f32 row's calls)."""
        blocks = basic_blocks(rng, c, nb)
        stacked = {k: v.to(dev) for k, v in bs.stack_basic_stage_params(blocks).items()}
        if bf16:
            stacked = bf16w(stacked)
        lib_w = [t(blk[f"w_{leg}"]).contiguous(memory_format=torch.channels_last)
                 for blk in blocks for leg in ("a", "b")]
        x = t(_rand(rng, n, h, w, c))

        def lib():
            y = nchw(x)
            for wc in lib_w:
                y = F.conv2d(y, wc, padding=1)
            return y

        p = n * h * w
        rate, passes, wbytes = (BF16_FLOPS, 2, 2) if bf16 else (TF32_FLOPS, 3, 4)
        return (lambda: bs.basic_stage_fused(x, stacked),
                lambda: bs.basic_stage_fused_plain(x, stacked), lib,
                {rate: nb * passes * 2 * 2 * p * 9 * c * c, FP32_FLOPS: nb * (4 + 5) * p * c},
                4 * (2 * p * c + nb * 4 * c) + wbytes * nb * 2 * 9 * c * c)

    # -- int8 cases ---------------------------------------------------------
    def qrows(a):
        """Activations quantized per row as int8 (rows of a 2-D view), with
        at least 32 rows (torch._int_mm refuses 16 or fewer)."""
        q = q8.quantize_rows(a.reshape(-1, a.shape[-1]))[0].to(torch.int8)
        return F.pad(q, (0, 0, 0, 32 - q.shape[0])) if q.shape[0] <= 16 else q.contiguous()

    def int_mm(*pairs):
        """The GEMMs through torch._int_mm, int8 x int8 -> int32. A B that
        cuBLASLt refuses row-major (some int8 shapes have no kernel in that
        layout) is handed over column-major, its layout chosen offline,
        before the timed region."""
        def layout(a, b):
            try:
                torch._int_mm(a, b)
                return a, b
            except RuntimeError:
                return a, b.t().contiguous().t()

        pairs = [layout(a, b) for a, b in pairs]

        def run():
            return [torch._int_mm(a, b) for a, b in pairs]
        return run

    def qweights(w):
        w_q, s_w = q8.quantize_weights(w)
        return t(w_q), t(s_w)

    def pointwise_int8_case(rng, p, k, n, relu):
        x = t(_rand(rng, p, k))
        w_q, s_w = qweights(_rand(rng, k, n))
        s, b = bn(rng, n)
        return (lambda: q8.conv1x1_bn_int8(x, w_q, s_w, s, b, relu),
                lambda: q8.conv1x1_bn_int8_plain(x, w_q, s_w, s, b, relu),
                int_mm((qrows(x), w_q)),
                {INT8_OPS: 2 * p * k * n, FP32_FLOPS: 4 * p * n + 2 * p * k},
                4 * p * k + k * n + 4 * p * n + 12 * n)

    def direct_int8_case(rng, n, h, w, cin, cout, relu):
        x = t(_rand(rng, n, h, w, cin))
        w9_q, s_w9 = qweights(direct_filter(_rand(rng, cout, cin, 3, 3)))
        s, b = bn(rng, cout)
        p = n * h * w
        return (lambda: q8.conv3x3_bn_int8(x, w9_q, s_w9, s, b, relu),
                lambda: q8.conv3x3_bn_int8_plain(x, w9_q, s_w9, s, b, relu),
                int_mm((qrows(im2col3x3(x)), w9_q)),
                {INT8_OPS: 2 * p * 9 * cin * cout, FP32_FLOPS: 4 * p * cout + 2 * p * 9 * cin},
                4 * p * cin + 9 * cin * cout + 4 * p * cout + 12 * cout)

    def stage_int8_case(rng, n, h, w, cio, cmid, nb, mid):
        blocks = stage_blocks(rng, cio, cmid, nb)
        for b in blocks:
            del b["w_mid"]
        qs = {k: v.to(dev) for k, v in q8.quantize_stage_params(blocks).items()}
        x = t(_rand(rng, n, h, w, cio))
        p = n * h * w
        hq = qrows(t(_rand(rng, p, cmid)))
        pairs = []
        for b in range(nb):
            pairs += [(qrows(x), qs["w_reduce_q"][b]), (hq, qs["w_expand_q"][b])]
            if mid == "direct":
                pairs.append((qrows(im2col3x3(t(_rand(rng, n, h, w, cmid)))), qs["w9_mid_q"][b]))
        mm = int_mm(*pairs)
        work = {INT8_OPS: nb * 4 * p * cio * cmid,
                FP32_FLOPS: nb * (4 * p * (2 * cmid + cio) + 2 * p * (cio + cmid))}
        if mid == "winograd2":
            nt = n * (-(-h // 2)) * (-(-w // 2))
            fwd, inv = _winograd_transform_flops(2)
            work[BF16_FLOPS] = nb * 2 * (2 * 16 * nt * cmid * cmid)
            work[FP32_FLOPS] += nb * nt * (fwd + inv) * cmid
            v = t(_rand(rng, 16, nt, cmid)).to(torch.bfloat16)
            u = qs["u2_mid_bf16"]

            def lib():
                return mm(), [torch.bmm(v, u[b]) for b in range(nb)]
            mid_bytes = 2 * 16 * cmid * cmid
        else:
            work[INT8_OPS] += nb * 2 * p * 9 * cmid * cmid
            work[FP32_FLOPS] += nb * 2 * p * 9 * cmid
            lib = mm
            mid_bytes = 9 * cmid * cmid
        nbytes = 8 * p * cio + nb * (2 * cio * cmid + mid_bytes + 4 * (6 * cmid + 3 * cio))
        return (lambda: q8.resnet_stage_int8(x, qs, mid),
                lambda: q8.resnet_stage_int8_plain(x, qs, mid), lib, work, nbytes)

    def basic_stage_int8_case(rng, n, h, w, c, nb):
        qs = {k: v.to(dev) for k, v in bs.quantize_basic_stage_params(basic_blocks(rng, c, nb)).items()}
        x = t(_rand(rng, n, h, w, c))
        cols = qrows(im2col3x3(x))
        p = n * h * w
        lib = int_mm(*[(cols, qs[f"w9_{leg}_q"][b]) for b in range(nb) for leg in ("a", "b")])
        work = {INT8_OPS: nb * 2 * 2 * p * 9 * c * c,
                FP32_FLOPS: nb * 2 * (4 * p * c + 2 * p * 9 * c)}
        return (lambda: bs.basic_stage_int8(x, qs), lambda: bs.basic_stage_int8_plain(x, qs),
                lib, work, 8 * p * c + nb * (2 * 9 * c * c + 4 * 6 * c))

    def winograd_int8_case(rng, n, h, w, cin, cout, relu):
        x = t(_rand(rng, n, h, w, cin))
        u_q, s_u = (t(a) for a in q8.quantize_winograd_filter(
            transforms.transform_filter(_rand(rng, cout, cin, 3, 3), m=2)))
        s, b = bn(rng, cout)
        nt = n * (-(-h // 2)) * (-(-w // 2))
        v = t(_rand(rng, 16, nt, cin))
        lib = int_mm(*[(qrows(v[p]), u_q[p]) for p in range(16)])
        fwd, inv = _winograd_transform_flops(2)
        work = {INT8_OPS: 2 * 16 * nt * cin * cout,
                FP32_FLOPS: nt * (fwd * cin + inv * cout) + 2 * 16 * nt * (cin + cout)
                + 4 * n * h * w * cout}
        return (lambda: q8.conv3x3_bn_winograd_int8(x, u_q, s_u, s, b, relu),
                lambda: q8.conv3x3_bn_winograd_int8_plain(x, u_q, s_u, s, b, relu),
                lib, work, 4 * n * h * w * (cin + cout) + 16 * cin * cout + 4 * 18 * cout)

    def transition_int8_case(rng, n, h, w, cin, cmid, cout):
        _, params = transition_params(rng, cin, cmid, cout)
        qp = {k: v.to(dev) for k, v in q8.quantize_transition_params(params).items()}
        x = t(_rand(rng, n, h, w, cin))
        ho, wo = -(-h // 2), -(-w // 2)
        p1, p2 = n * h * w, n * ho * wo
        h1 = t(_rand(rng, n, h, w, cmid))
        lib = int_mm((qrows(x), qp["w_reduce_q"]), (qrows(strided_im2col(h1)), qp["w9_mid_q"]),
                     (qrows(t(_rand(rng, p2, cmid))), qp["w_expand_q"]),
                     (qrows(x[:, ::2, ::2, :]), qp["w_proj_q"]))
        macs = p1 * cin * cmid + p2 * (9 * cmid * cmid + cmid * cout + cin * cout)
        work = {INT8_OPS: 2 * macs,
                FP32_FLOPS: 4 * (p1 * cmid + p2 * cmid + 2 * p2 * cout)
                + 2 * (p1 * cin + p2 * (9 * cmid + cmid + cin))}
        nbytes = (4 * (p1 * cin + p2 * cout) + cin * cmid + 9 * cmid * cmid
                  + (cmid + cin) * cout + 4 * (6 * cmid + 6 * cout))
        return (lambda: q8.transition_block_int8(x, qp),
                lambda: q8.transition_block_int8_plain(x, qp), lib, work, nbytes)

    # -- serving at full width ---------------------------------------------
    cfg = ResNet50Config()
    params = init_resnet50_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(1)
    images = _rand(rng, 8, cfg.img, cfg.img, 3)
    n_single, n_batch = 10, 3

    def serve(engine):
        """The counted run of one tier: counters zeroed, one N=1 forward
        whose launches by shape are kept, n_single N=1 and n_batch N=8
        requests, counters read. Returns (N=1 logits by image, N=8 logits,
        N=1 seconds, N=8 seconds, launches, first forward's shapes)."""
        _build.reset_counts()
        single = {0: engine(images[0])}
        torch.cuda.synchronize()
        shapes = {name: collections.Counter(c) for name, c in _build.LAUNCH_SHAPES.items()}
        lat = []
        for i in range(n_single):
            t0 = time.perf_counter()
            logits = engine(images[i % 8])
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            single.setdefault(i % 8, logits)
        batch_s = []
        for _ in range(n_batch):
            t0 = time.perf_counter()
            logits8 = engine(images)
            torch.cuda.synchronize()
            batch_s.append(time.perf_counter() - t0)
        return single, logits8, lat, batch_s, dict(_build.LAUNCHES), shapes

    def check_launches(expected, launches, shapes, tier):
        forwards = 1 + n_single + n_batch
        for name, per in expected.items():
            check(launches.get(name, 0) == per * forwards,
                  f"{tier} {name}: {launches.get(name, 0)} launches in {forwards} forwards, "
                  f"want {per} each")
            check(sum(shapes.get(name, {}).values()) == per,
                  f"{tier} {name}: first forward launched {dict(shapes.get(name, {}))}, want {per}")
        extra = set(launches) - set(expected)
        check(not extra, f"{tier}: kernels off the path launched: {sorted(extra)}")
        return forwards

    def serve_f32(phase, engine, expected, golden):
        """The f32 tier's counted run and checks; returns (launches, shapes)."""
        single, logits8, lat, batch_s, launches, shapes = serve(engine)
        forwards = check_launches(expected, launches, shapes, phase)
        got = single[0].double().cpu().numpy()
        tol = ATOL * max(1.0, float(np.abs(golden).max()))
        err = float(np.abs(got - golden).max())
        check(got.shape == golden.shape and np.isfinite(got).all() and err <= tol,
              f"{phase}: N=1 logits vs float64 CPU golden: max abs err {err} > {tol}")
        ref8 = torch.stack([single[i] for i in range(8)])
        err8 = float((logits8.double() - ref8.double()).abs().max())
        check(tuple(logits8.shape) == (8,) + golden.shape and bool(torch.isfinite(logits8).all())
              and err8 <= tol, f"{phase}: N=8 logits vs each image's N=1 logits: {err8}")
        print(json.dumps({
            "phase": phase, "n1_latency_ms_median": 1e3 * statistics.median(lat),
            "n1_latency_ms": [1e3 * v for v in lat],
            "n8_images_per_s": 8 / statistics.median(batch_s),
            "golden_max_abs_err": err, "golden_tol": tol,
            "golden_max_abs": float(np.abs(golden).max()),
            "n8_vs_n1_max_abs_err": err8, "launches": launches, "forwards": forwards,
        }), flush=True)
        return launches, shapes

    def serve_bf16w(phase, engine, expected, golden, ref_cpu, cfg):
        """The bf16w tier's counted run and checks; returns (launches, shapes)."""
        single, logits8, lat, batch_s, launches, shapes = serve(engine)
        forwards = check_launches(expected, launches, shapes, phase)
        check(set(shapes.get("stem_bf16w", {})) == {(1, cfg.img, cfg.img, 3, cfg.stem_c, "bf16w")},
              f"{phase} stem shapes {dict(shapes.get('stem_bf16w', {}))}, want bf16w")
        check(all(shape[5] == 2 for shape in shapes.get("winograd_bf16w", {})),
              f"{phase} Winograd shapes {dict(shapes.get('winograd_bf16w', {}))}, want F(2,3)")
        got = single[0].cpu()
        gold_tol = BF16W_RTOL_BACKBONE * max(1.0, float(np.abs(golden).max()))
        gold_err = float(np.abs(got.double().numpy() - golden).max())
        cpu_tol = ATOL * max(1.0, ref_cpu.abs().max().item())
        cpu_err = (got - ref_cpu).abs().max().item()
        check(got.shape == golden.shape and bool(torch.isfinite(got).all())
              and gold_err <= gold_tol, f"{phase}: N=1 logits vs golden: {gold_err} > {gold_tol}")
        check(cpu_err <= cpu_tol,
              f"{phase}: N=1 logits vs the CPU plain bf16w forward: {cpu_err} > {cpu_tol}")
        ref8 = torch.stack([single[i] for i in range(8)])
        row_err = (logits8 - ref8).abs().amax(dim=-1)
        row_tol = ATOL * ref8.abs().amax(dim=-1).clamp(min=1.0)
        check(tuple(logits8.shape) == (8,) + golden.shape and bool(torch.isfinite(logits8).all())
              and bool((row_err <= row_tol).all()),
              f"{phase}: N=8 rows vs each image's N=1 logits: {row_err.tolist()} > {row_tol.tolist()}")
        print(json.dumps({
            "phase": phase, "n1_latency_ms_median": 1e3 * statistics.median(lat),
            "n1_latency_ms": [1e3 * v for v in lat],
            "n8_images_per_s": 8 / statistics.median(batch_s),
            "golden_max_abs_err": gold_err, "golden_tol": gold_tol,
            "cpu_bf16w_max_abs_err": cpu_err, "cpu_bf16w_tol": cpu_tol,
            "n8_vs_n1_max_abs_err": float(row_err.max()),
            "same_class_as_f32": int(got.argmax()) == int(np.argmax(golden)),
            "launches": launches, "forwards": forwards,
        }), flush=True)
        return launches, shapes

    def serve_int8(phase, engine, expected, golden, ref_int8, cfg):
        """The int8 tier's counted run and checks; returns (launches, shapes)."""
        single8, logits88, lat8, batch8_s, launches8, shapes8 = serve(engine)
        forwards = check_launches(expected, launches8, shapes8, phase)
        check(set(shapes8.get("stem", {})) == {(1, cfg.img, cfg.img, 3, cfg.stem_c, "bf16")},
              f"{phase} stem shapes {dict(shapes8.get('stem', {}))}, want bf16")
        check(all(shape[-1] == "bf16" for shape in shapes8.get("winograd", {})),
              f"{phase} Winograd shapes {dict(shapes8.get('winograd', {}))}, want bf16 filters")
        got8 = single8[0].cpu()
        gold_tol = INT8_RTOL_BACKBONE * max(1.0, float(np.abs(golden).max()))
        gold_err = float(np.abs(got8.double().numpy() - golden).max())
        cpu_tol = INT8_CHAINED_RTOL * max(1.0, ref_int8.abs().max().item())
        cpu_err = (got8 - ref_int8).abs().max().item()
        check(got8.shape == golden.shape and bool(torch.isfinite(got8).all())
              and gold_err < gold_tol, f"{phase}: N=1 logits vs f32 golden: {gold_err} >= {gold_tol}")
        check(cpu_err <= cpu_tol,
              f"{phase}: N=1 logits vs the CPU plain int8 forward: {cpu_err} > {cpu_tol}")
        ref88 = torch.stack([single8[i] for i in range(8)])
        err88 = float((logits88 - ref88).abs().max())
        tol88 = INT8_CHAINED_RTOL * max(1.0, ref88.abs().max().item())
        check(tuple(logits88.shape) == (8,) + golden.shape and bool(torch.isfinite(logits88).all())
              and err88 <= tol88, f"{phase}: N=8 logits vs each image's N=1 logits: {err88} > {tol88}")
        print(json.dumps({
            "phase": phase, "n1_latency_ms_median": 1e3 * statistics.median(lat8),
            "n1_latency_ms": [1e3 * v for v in lat8],
            "n8_images_per_s": 8 / statistics.median(batch8_s),
            "golden_max_abs_err": gold_err, "golden_tol": gold_tol,
            "cpu_int8_max_abs_err": cpu_err, "cpu_int8_tol": cpu_tol,
            "n8_vs_n1_max_abs_err": err88, "n8_vs_n1_tol": tol88,
            "same_class_as_f32": int(got8.argmax()) == int(np.argmax(golden)),
            "launches": launches8, "forwards": forwards,
        }), flush=True)
        return launches8, shapes8

    from torch.profiler import ProfilerActivity, profile

    def profile_phase(engine, phase):
        for n, reps in ((1, 5), (8, 3)):
            engine(images[:n])
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    engine(images[:n])
                    torch.cuda.synchronize()
                window_ms = 1e3 * (time.perf_counter() - t0) / reps
            by_name = collections.defaultdict(float)
            for e in prof.key_averages():
                if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0:
                    by_name[_kernel_name(e.key)] += e.device_time_total / reps / 1e3
            busy = sum(by_name.values())
            check(0 < busy <= window_ms, f"{phase} N={n}: device busy {busy} ms of {window_ms} ms")
            print(json.dumps({
                "phase": phase, "n": n, "device_busy_ms": busy, "request_ms": window_ms,
                "idle_share": 1 - busy / window_ms,
                "device_ms_by_kernel": dict(sorted(by_name.items(), key=lambda kv: -kv[1])),
            }), flush=True)

    served = []  # (launches, first forward's shapes) of each counted run
    golden = resnet50_forward(
        images[0], params_from_jax(init_resnet50_arrays(cfg, seed=0), "cpu", torch.float64),
        device="cpu",
    ).numpy()
    engine = ResNet50Engine(params, device=dev)
    served.append(serve_f32("serving", engine, EXPECTED_PER_FORWARD, golden))
    profile_phase(engine, "profile")
    del engine

    # -- the bf16w tier -----------------------------------------------------
    engine16 = ResNet50Engine(params, tier="bf16w", device=dev)
    cpu_params = params_from_jax(init_resnet50_arrays(cfg, seed=0), "cpu", torch.float32)
    ref_bf16w = resnet50_forward(images[0], cast_bf16w(cpu_params), device="cpu",
                                 precision="bf16w")
    served.append(serve_bf16w("serving_bf16w", engine16, EXPECTED_PER_FORWARD_BF16W, golden,
                              ref_bf16w, cfg))
    profile_phase(engine16, "profile_bf16w")
    del engine16

    # -- the int8 tier ------------------------------------------------------
    engine8 = ResNet50Engine(params, tier="int8", device=dev)
    ref_int8 = resnet50_forward_int8(images[0], quantize_resnet50(cpu_params), device="cpu")
    served.append(serve_int8("serving_int8", engine8, EXPECTED_PER_FORWARD_INT8, golden,
                             ref_int8, cfg))
    profile_phase(engine8, "profile_int8")
    del engine8, params, cpu_params

    # -- the basic family: ResNet-34 at every tier --------------------------
    cfg34 = ResNet34Config("resnet34")
    case34 = init_basicnet_arrays(cfg34, seed=0)
    golden34 = basicnet_forward(images[0], basicnet_params(case34, cfg34, "cpu", torch.float64),
                                device="cpu").numpy()
    engine = ResNetBasicEngine(basicnet_params(case34, cfg34, dev), device=dev)
    served.append(serve_f32("serving_basic", engine, EXPECTED_PER_FORWARD_BASIC, golden34))
    profile_phase(engine, "profile_basic")
    del engine
    cpu34 = basicnet_params(case34, cfg34, "cpu")
    ref34_bf16w = basicnet_forward(images[0], cast_basicnet_bf16w(cpu34), device="cpu",
                                   precision="bf16w")
    engine16 = ResNetBasicEngine(cpu34, tier="bf16w", device=dev)
    served.append(serve_bf16w("serving_basic_bf16w", engine16, EXPECTED_PER_FORWARD_BASIC_BF16W,
                              golden34, ref34_bf16w, cfg34))
    profile_phase(engine16, "profile_basic_bf16w")
    del engine16
    ref34_int8 = basicnet_forward_int8(images[0], quantize_basicnet(cpu34), device="cpu")
    engine8 = ResNetBasicEngine(cpu34, tier="int8", device=dev)
    served.append(serve_int8("serving_basic_int8", engine8, EXPECTED_PER_FORWARD_BASIC_INT8,
                             golden34, ref34_int8, cfg34))
    profile_phase(engine8, "profile_basic_int8")
    del engine8, cpu34

    # -- kernels against their plain versions ------------------------------
    make_case = {"pointwise": pointwise_case, "winograd": winograd_case,
                 "direct": direct_case, "stem": stem_case, "stage": stage_case,
                 "transition": transition_case, "pointwise_int8": pointwise_int8_case,
                 "direct_int8": direct_int8_case, "stage_int8": stage_int8_case,
                 "transition_int8": transition_int8_case, "winograd_int8": winograd_int8_case,
                 "basic_stage": basic_stage_case, "basic_stage_int8": basic_stage_int8_case,
                 "pointwise_bf16w": pointwise_bf16w_case, "stem_bf16w": stem_case,
                 "stage_bf16w": lambda rng, *shape: stage_case(rng, *shape, bf16=True),
                 "transition_bf16w": lambda rng, *shape: transition_case(rng, *shape, bf16=True),
                 "winograd_bf16w": lambda rng, *shape: winograd_case(rng, *shape, filt="bf16w"),
                 "direct_bf16w": lambda rng, *shape: direct_case(rng, *shape, bf16=True),
                 "basic_stage_bf16w": lambda rng, *shape: basic_stage_case(rng, *shape, bf16=True)}
    # Off the served N=1 lists: F(4,3) accuracy at the mode-0 shape; the
    # block at modes 6 and 9; the batched layouts' cases (rows 7, 9, 18 and
    # 20 of the TPU kernel table) at N=8; the conv5_x stage geometry, which
    # the f32 route runs per layer; the int8 block (row 16) at mode 6; the
    # f32 and int8 direct 3x3s at N=8; the stem at N=8 in every precision;
    # the bf16w pointwise head, conv4_x and conv5_x stages and 14->7
    # transition at N=8, the bf16w block at modes 6 and 9; the bf16w
    # Winograd, direct 3x3 and basic stage of ResNet-34 at N=8.
    extra = {
        "winograd": [(1, 14, 14, 128, 128, 4, True)],
        "stage": [(1, 14, 14, 1024, 256, 1, "direct"), (1, 28, 28, 512, 128, 1, "winograd2"),
                  (8, 14, 14, 1024, 256, 5, "direct"), (1, 7, 7, 2048, 512, 2, "direct")],
        "transition": [(8, 14, 14, 1024, 512, 2048)],
        "stage_int8": [(8, 14, 14, 1024, 256, 5, "direct"), (1, 14, 14, 1024, 256, 1, "direct")],
        "transition_int8": [(8, 14, 14, 1024, 512, 2048)],
        "stem": [(8, 224, 224, 3, 64, "f32"), (8, 224, 224, 3, 64, "bf16")],
        "basic_stage": [(8, 7, 7, 512, 2), (1, 7, 7, 512, 1)],
        "basic_stage_int8": [(8, 7, 7, 512, 2), (1, 7, 7, 512, 1)],
        "winograd_int8": [(8, 14, 14, 256, 256, True), (8, 28, 28, 128, 128, True),
                          *WIDE_WINOGRAD_INT8],
        "pointwise": [(8, 2048, 1000, False), (392, 2048, 512, True)],
        "pointwise_int8": [(8, 2048, 1000, False)],
        "direct_int8": [(8, 7, 7, 512, 512, False)],
        "direct": [(8, 7, 7, 512, 512, True)],
        "pointwise_bf16w": [(8, 2048, 1000, False)],
        "stem_bf16w": [(8, 224, 224, 3, 64, "bf16w")],
        "stage_bf16w": [(8, 14, 14, 1024, 256, 5, "direct"), (8, 7, 7, 2048, 512, 2, "direct"),
                        (1, 14, 14, 1024, 256, 1, "direct"), (1, 28, 28, 512, 128, 1, "winograd2")],
        "transition_bf16w": [(8, 14, 14, 1024, 512, 2048)],
        "winograd_bf16w": [(8, 56, 56, 64, 64, 2, True)],
        "direct_bf16w": [(8, 7, 7, 512, 512, False)],
        "basic_stage_bf16w": [(8, 7, 7, 512, 2)],
    }
    sms = _build.sm_count(dev)

    def winograd_cut(n, h, w, cin, cout, m, relu, filt="f32"):
        """The f32 route's Cin splits."""
        if filt == "bf16":
            return None
        return winograd_plan(n, h, w, cin, cout, m, sms).splits

    splits_of = {
        "pointwise": lambda p, k, n, relu: split_plan(p, k, n, sms).splits,
        "direct": lambda n, h, w, cin, cout, relu: direct_plan(n, h, w, cin, cout, sms).splits,
        "direct_int8": lambda n, h, w, cin, cout, relu: q8.direct_int8_plan(
            n, h, w, cin, cout, sms).splits,
        "winograd": winograd_cut,
        "pointwise_int8": lambda p, k, n, relu: q8.pointwise_int8_plan(p, k, n, sms).splits,
        "transition": lambda *shape: [s.splits for s in transition_plan(*shape, sms)[1:]],
        "basic_stage_int8": lambda n, h, w, c, nb: bs.basic_stage_int8_plan(
            n, h, w, c, sms).splits,
        "basic_stage": lambda n, h, w, c, nb: bs.basic_stage_plan(n, h, w, c, sms).conv.splits,
    }
    for name in ("pointwise", "transition", "winograd", "direct", "basic_stage"):
        splits_of[f"{name}_bf16w"] = splits_of[name]

    def winograd_int8_cut(n, h, w, cin, cout, relu):
        plan = q8.winograd_int8_plan(n, h, w, cin, cout, sms)
        return {"tile_blocks": plan.tile_blocks, "col_blocks": plan.col_blocks,
                "blocks": plan.blocks, "chunk": plan.chunk}

    plans_of = {
        "pointwise_int8": lambda p, k, n, relu: {
            "route": q8.pointwise_int8_plan(p, k, n, sms).path},
        "winograd_int8": winograd_int8_cut,
    }
    all_launches = collections.Counter()
    per_image = collections.defaultdict(collections.Counter)
    for launches, shapes in served:
        all_launches.update(launches)
        for name, counter in shapes.items():
            per_image[name].update(counter)
    totals = {}
    rng = np.random.default_rng(0)
    for name in make_case:
        counter = per_image.get(name, collections.Counter())
        tot = collections.defaultdict(float)
        tot["max_abs_err"] = 0.0
        lib_ok = True
        for shape in list(counter) + extra.get(name, []):
            n_img = counter.get(shape, 0)
            kern, plain, lib, work, nbytes = make_case[name](rng, *shape)
            exact = name in EXACT or name in ("stem", "winograd") and shape[-1] == "bf16"
            rtol = 0.0 if exact else ATOL
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            finite = bool(torch.isfinite(got).all())
            tol = rtol * max(1.0, ref.abs().max().item())
            check(finite and err <= tol, f"{name}{shape}: max abs err {err} > {tol} (finite={finite})")
            try:
                lib()
                torch.cuda.synchronize()
                lib_ms = device_ms(lib)
            except RuntimeError as e:   # a library call that refuses these operands
                print(json.dumps({"kernel": name, "shape": shape, "library_error": str(e)[:300]}))
                lib_ms, lib_ok = None, False
            ms, plain_ms = device_ms(kern), device_ms(plain)
            host_ms = wrapper_ms(kern)
            ops_ms, bytes_ms = bound(work, nbytes)
            splits = {"splits": splits_of[name](*shape)} if name in splits_of else {}
            if name in plans_of:
                splits.update(plans_of[name](*shape))
            print(json.dumps({
                "kernel": name, "shape": shape, "per_image": n_img, **splits,
                "max_abs_err": err, "tol": tol, "ms": ms, "wrapper_ms": host_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "gops_s": sum(work.values()) / ms / 1e6,
            }), flush=True)
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            for key, v in (("ms", ms), ("wrapper_ms", host_ms), ("plain_ms", plain_ms),
                           ("library_ms", lib_ms or 0.0), ("ops_ms", ops_ms),
                           ("bytes_ms", bytes_ms), ("bound_ms", max(ops_ms, bytes_ms))):
                tot[key] += n_img * v
        tot["library_ok"] = lib_ok
        totals[name] = tot

    kernels = []
    for name, tot in totals.items():
        replaces, covers = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"winograd_tpu_torch/csrc/{name.removesuffix('_bf16w')}.cu",
            "replaces": replaces, "covers": covers, "launches": all_launches.get(name, 0),
            "max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
            "wrapper_ms": tot["wrapper_ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes",
            "library_ms": tot["library_ms"] if tot["library_ok"] else None,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
