"""Benchmark CLI: the reference's Test.c harness, on one NVIDIA GPU.

    python -m winograd_tpu_torch.bench <mode|all> [--iterations N] [--warmup N]
        [--seed S] [--json] [--no-strict] [--data-dir D] [--profile DIR]
        [--device cuda|cpu] [--resume FILE]
    python -m winograd_tpu_torch.bench --smoke [--device cuda|cpu]

The twin of winograd_tpu/bench/cli.py (`python -m winograd_tpu.bench`).
One mode is one case of config.py's CASES, made from its seed by
datagen/generate.py with a float64 golden (ops/reference.py). Modes 0-5
are the reference CLI's layer cases; 6-12 blocks, stages and transitions;
13-15 backbones and the trunk; 16 and 18 the ResNet-50 classifier at N=1
and N=8; 20 and 21 ResNet-101 and ResNet-152; 22 the stem; 23, 24 and 26
ResNet-18, ResNet-34 and ResNet-18 at N=8; 27 and 28 ResNet-50 and
ResNet-18 at N=32, each run as one batch (the JAX package's chunks of 8
are a TPU compile workaround). Every mode runs the port's in-house path
("cuda": the hand-written kernels; on the CPU their plain versions) and
the vendor baseline ("cudnn": baseline/cudnn.py, TF32 off), and where the
JAX package has them the other in-house columns: "direct" and
"winograd_f43" (modes 0/1; the stem's space-to-depth route on mode 22),
"int8" and "bf16w" (the serving tiers), and "pre" (the classifiers and the
stem: the f32 forward from the operand kernels/stem.py::stem_prepare_input
builds on the host, made once before timing). Each is checked against the golden: f32 paths, "pre"
included, at max abs error <= PARITY_ATOL, int8 and bf16w at their
relative bars. A breach raises ParityError and the CLI exits nonzero.

Timing follows the reference's protocol (100 iterations, 2 warm-ups,
utils/timing.py::bench_loop): mean and min on the host clock with a
synchronize per call, chained over back-to-back calls; device time per call
(`*_device_us`) from calls captured in one CUDA graph and replayed between
CUDA events (bench_graph). MFU is nominal FLOPs over device time over the
H100's dense BF16 peak, given on an H100 only. main adds to each row the
mode's seconds, its kernel launches by name, whether the native host
library (utils/native.py) loaded and the calls it served in the run's host
IO and checks ("native_library", "native_calls"), the process's peak
resident memory so far ("peak_host_mib") and the mode's peak device
allocations ("peak_device_mib").

--resume FILE keeps a sweep's rows in FILE, rewritten atomically after
every mode; on a restart a recorded row is reused when it has parity_ok and
the same iterations and seed, and every other requested mode runs again. A
row of a mode this call did not ask for is kept. A mode that fails stays
missing, and SWEEP INCOMPLETE fails the call (the JAX package's protocol).

--smoke (run_smoke) calls every kernel family once, untimed, at the JAX
package's smoke geometries, holds each output finite and within its
family's bar of the kernel's plain version on the same device, and exits
nonzero naming each family that failed.

The training modes (17: the 13-block backbone, 19: the ResNet-50
classifier, 25: ResNet-18) check the train forwards (kernels/vjp.py
through models/*::*_train; the cuDNN forward on the same raw weights) and
the bf16w train forward against the golden, then compute one step scalar
per path, the loss sum(out^2) plus every gradient leaf's squared norm:
"cuda" through the port's kernels, "cudnn" through baseline/cudnn.py's
forward differentiated by autograd with TF32 off, "bf16w" through the
bf16w forward. train_grad_rel_error (cuda against cudnn) must stay below
TRAIN_GRAD_RTOL, train_bf16w_grad_rel_error below BF16W_TRAIN_GRAD_RTOL.
Every timing field of these modes times that whole step (forward,
backward, the norms), as the JAX package's CLI does; they have no int8
column.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import resource
import subprocess
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from winograd_tpu_torch.baseline import cudnn as baseline
from winograd_tpu_torch.config import (
    BENCH_ITERATIONS,
    BENCH_WARMUP,
    BF16W_RTOL,
    BF16W_RTOL_BACKBONE,
    BF16W_TRAIN_GRAD_RTOL,
    CASES,
    H100_PEAK_FLOPS,
    INT8_RTOL,
    INT8_RTOL_BACKBONE,
    PARITY_ATOL,
    BackboneConfig,
    BasicNetConfig,
    BasicTrainConfig,
    BlockConfig,
    FullTrainConfig,
    ResNet50Config,
    StemConfig,
    TrainConfig,
    TransitionConfig,
    case_flops,
)
from winograd_tpu_torch.datagen.generate import make_case
from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.utils import native
from winograd_tpu_torch.utils.checker import ParityError, output_checker
from winograd_tpu_torch.utils.timing import bench_graph, bench_loop
from winograd_tpu_torch.utils.tree import tree_leaves, tree_unflatten

TRAIN_CONFIGS = (TrainConfig, FullTrainConfig, BasicTrainConfig)
# The f32 train step's scalar against the cuDNN autograd step's, relative
# (the JAX package's CLI's gate).
TRAIN_GRAD_RTOL = 1e-3


def _check(name: str, out: torch.Tensor, golden: np.ndarray, strict: bool):
    res = output_checker(_numpy(out, golden), golden, tol=PARITY_ATOL)
    print(f"  [{name}] {res}", file=sys.stderr)
    if strict and not res.ok():
        raise ParityError(f"{name}: parity breach: {res}")
    return res


def _check_tier(name: str, out: torch.Tensor, golden: np.ndarray, rtol: float,
                strict: bool) -> float:
    """Reduced-precision tier check: hard-fail on the tier's own relative
    bound (bf16w and int8 are accuracy tiers, not the f32 parity bar)."""
    rel = float(np.abs(_numpy(out, golden) - golden).max() / max(np.abs(golden).max(), 1.0))
    ok = bool(np.isfinite(rel) and rel < rtol)
    print(f"  [{name}] rel_error={rel:.3e} (tier bound {rtol:g})", file=sys.stderr)
    if strict and not ok:
        raise ParityError(f"{name}: tier breach: rel_error={rel}")
    return rel


def _numpy(out: torch.Tensor, golden: np.ndarray) -> np.ndarray:
    """A path's output as float32 numpy in the golden's shape (the CLI runs
    unbatched cases at N=1)."""
    return out.detach().float().cpu().numpy().reshape(golden.shape)


@functools.lru_cache(maxsize=None)
def card(index: int):
    """(name, power limit in W) of CUDA device `index` as nvidia-smi reports
    them; (None, None) where nvidia-smi cannot say."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
        name, limit = (v.strip() for v in line.split(","))
        return name, float(limit)
    except (OSError, subprocess.SubprocessError, ValueError):
        return None, None


def _paths(cfg, case: Dict[str, np.ndarray], dev: torch.device):
    """The mode's input (batched: unbatched cases run at N=1), its paths,
    name -> function of the input: "cuda" and "cudnn" always; "direct",
    "winograd_f43", "int8" and "bf16w" where the JAX package's CLI has
    them; and the prepared-input route (prepared operand on the device,
    function of it) where the JAX package's CLI has a "pre" column, else
    None."""
    from winograd_tpu_torch.kernels.stem import stem_prepare_input
    from winograd_tpu_torch.models.convert import (
        cast_layer_bf16w,
        cast_stages_bf16w,
        params_to,
        stages_from_jax,
        transition_from_jax,
    )

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev).contiguous()

    def on_device(params):
        return params_to(params, dev, torch.float32)

    x = t(case["x"])
    if x.dim() == 3:
        x = x[None]
    img_h, img_w = x.shape[1], x.shape[2]
    paths: Dict[str, Callable] = {}
    pre_fn = None
    if isinstance(cfg, BasicNetConfig):
        from winograd_tpu_torch.models.basic import (
            basicnet_arrays, basicnet_forward, basicnet_forward_int8, basicnet_forward_pre,
            basicnet_params, cast_basicnet_bf16w, quantize_basicnet,
        )

        params = basicnet_params(case, cfg, dev)
        ref = baseline.tensors(basicnet_arrays(case, cfg), dev)
        qparams = on_device(quantize_basicnet(params))
        params16 = cast_basicnet_bf16w(params)
        paths["cuda"] = lambda x_: basicnet_forward(x_, params, dev)
        paths["cudnn"] = lambda x_: baseline.basicnet_forward_cudnn(x_, ref)
        paths["int8"] = lambda x_: basicnet_forward_int8(x_, qparams, dev)
        paths["bf16w"] = lambda x_: basicnet_forward(x_, params16, dev, precision="bf16w")
        pre_fn = lambda xb: basicnet_forward_pre(xb, params, dev, h=img_h, w=img_w)  # noqa: E731
    elif isinstance(cfg, ResNet50Config):
        from winograd_tpu_torch.models.resnet50 import (
            cast_bf16w, quantize_resnet50, resnet50_arrays, resnet50_forward,
            resnet50_forward_int8, resnet50_forward_pre, resnet50_params,
        )

        params = resnet50_params(case, cfg, dev)
        ref = baseline.tensors(resnet50_arrays(case, cfg), dev)
        qparams = on_device(quantize_resnet50(params))
        params16 = cast_bf16w(params)
        paths["cuda"] = lambda x_: resnet50_forward(x_, params, dev)
        paths["cudnn"] = lambda x_: baseline.resnet50_forward_cudnn(x_, ref)
        paths["int8"] = lambda x_: resnet50_forward_int8(x_, qparams, dev)
        paths["bf16w"] = lambda x_: resnet50_forward(x_, params16, dev, precision="bf16w")
        pre_fn = lambda xb: resnet50_forward_pre(xb, params, dev, h=img_h, w=img_w)  # noqa: E731
    elif isinstance(cfg, (BackboneConfig, BlockConfig)):
        from winograd_tpu_torch.datagen.generate import backbone_stages, block_params_list
        from winograd_tpu_torch.models.downsample import (
            quantize_backbone, resnet50_stages, resnet50_stages_int8,
        )

        if isinstance(cfg, BlockConfig):
            arrays = [{"transition": None, "blocks": block_params_list(cfg, case)}]
        else:
            arrays = backbone_stages(cfg, case)
        stages = stages_from_jax(arrays, dev)
        ref = baseline.tensors(arrays, dev)
        qstages = on_device(quantize_backbone(stages))
        stages16 = cast_stages_bf16w(stages)
        paths["cuda"] = lambda x_: resnet50_stages(x_, stages)
        paths["cudnn"] = lambda x_: baseline.bottleneck_stages(x_, ref)
        paths["int8"] = lambda x_: resnet50_stages_int8(x_, qstages)
        paths["bf16w"] = lambda x_: resnet50_stages(x_, stages16, precision="bf16w")
    elif isinstance(cfg, TransitionConfig):
        from winograd_tpu_torch.datagen.generate import transition_params
        from winograd_tpu_torch.kernels.quantized import (
            quantize_transition_params, transition_block_int8,
        )
        from winograd_tpu_torch.models.downsample import downsample_bottleneck_block

        arrays = transition_params(case)
        params = transition_from_jax(arrays, dev)
        ref = baseline.tensors(arrays, dev)
        qparams = on_device(quantize_transition_params(params))
        params16 = cast_layer_bf16w(params)
        paths["cuda"] = lambda x_: downsample_bottleneck_block(x_, params)
        paths["cudnn"] = lambda x_: baseline.downsample_bottleneck_block(x_, ref)
        paths["int8"] = lambda x_: transition_block_int8(x_, qparams)
        paths["bf16w"] = lambda x_: downsample_bottleneck_block(x_, params16)
    elif isinstance(cfg, StemConfig):
        from winograd_tpu_torch.models.resnet50 import stem, stem_pre

        params = {"w192_stem": t(case["stem_w192"]), "s_stem": t(case["stem_scale"]),
                  "b_stem": t(case["stem_bias"])}
        ref = dict(params, w7_stem=t(case["stem_w7"]))
        params16 = cast_layer_bf16w(params)
        paths["cuda"] = lambda x_: stem(x_, params)
        paths["cudnn"] = lambda x_: baseline.stem(x_, ref)
        # The "direct" column carries the previous served route, the
        # space-to-depth patch matrix through the pointwise kernel, as in
        # the JAX package's CLI.
        paths["direct"] = lambda x_: stem(x_, params, algo="s2d")
        paths["int8"] = lambda x_: stem(x_, params, precision="bf16")
        paths["bf16w"] = lambda x_: stem(x_, params16, precision="bf16w")
        pre_fn = lambda xb: stem_pre(xb, params, h=img_h, w=img_w)  # noqa: E731
    elif cfg.kind == "winograd3x3":
        from winograd_tpu_torch.kernels import transforms
        from winograd_tpu_torch.kernels.direct import conv3x3_bn_direct, direct_filter
        from winograd_tpu_torch.kernels.quantized import (
            conv3x3_bn_winograd_int8, quantize_winograd_filter,
        )
        from winograd_tpu_torch.kernels.winograd import conv3x3_bn_winograd

        u2_np = case["u2"] if "u2" in case else transforms.transform_filter(case["w"], m=2)
        w9_np = case["w9"] if "w9" in case else direct_filter(case["w"])
        u, u2, w9, w = t(case["u"]), t(u2_np), t(w9_np), t(case["w"])
        s, b = t(case["scale"]), t(case["bias"])
        uq_np, su_np = quantize_winograd_filter(u2_np)
        uq, su = t(uq_np, torch.int8), t(su_np)
        u2_16 = u2.to(torch.bfloat16)
        relu = cfg.relu
        # The flagship: Winograd F(2,3). Measured alongside, as the reference
        # contrasts cuDNN's algorithms: the direct implicit GEMM and the
        # reference's own F(4,3).
        paths["cuda"] = lambda x_: conv3x3_bn_winograd(x_, u2, s, b, relu)
        paths["cudnn"] = lambda x_: baseline.conv3x3_bn_relu(x_, w, s, b, relu)
        paths["direct"] = lambda x_: conv3x3_bn_direct(x_, w9, s, b, relu)
        paths["winograd_f43"] = lambda x_: conv3x3_bn_winograd(x_, u, s, b, relu)
        paths["int8"] = lambda x_: conv3x3_bn_winograd_int8(x_, uq, su, s, b, relu)
        paths["bf16w"] = lambda x_: conv3x3_bn_winograd(x_, u2_16, s, b, relu, "bf16w")
    else:
        from winograd_tpu_torch.kernels.pointwise import conv1x1_bn
        from winograd_tpu_torch.kernels.quantized import conv1x1_bn_int8, quantize_weights

        w, s, b = t(case["w"]), t(case["scale"]), t(case["bias"])
        wq_np, sw_np = quantize_weights(case["w"])
        wq, sw = t(wq_np, torch.int8), t(sw_np)
        w16 = w.to(torch.bfloat16)
        relu = cfg.relu
        paths["cuda"] = lambda x_: conv1x1_bn(x_, w, s, b, relu)
        paths["cudnn"] = lambda x_: baseline.conv1x1_bn(x_, w, s, b, relu)
        paths["int8"] = lambda x_: conv1x1_bn_int8(x_, wq, sw, s, b, relu)
        paths["bf16w"] = lambda x_: conv1x1_bn(x_, w16, s, b, relu)
    pre = None if pre_fn is None else (stem_prepare_input(x).to(dev), pre_fn)
    return x, paths, pre


def _train_forwards(cfg, case: Dict[str, np.ndarray], dev: torch.device):
    """A training mode's input (batched), its trainable parameters (raw
    filters, folded BN) as tensors on dev, and its forwards (x, params) ->
    output: "cuda" the port's train forward, "cudnn" baseline/cudnn.py's on
    the same weights, "bf16w" the port's at the bf16w tier."""
    from winograd_tpu_torch.models.train import (
        trainable_basicnet_params, trainable_resnet50_params,
    )

    if isinstance(cfg, BasicTrainConfig):
        from winograd_tpu_torch.models.basic import basicnet_arrays, basicnet_forward_train

        tree = trainable_basicnet_params(basicnet_arrays(case, cfg))
        train, ref = basicnet_forward_train, baseline.basicnet_forward_cudnn
    elif isinstance(cfg, FullTrainConfig):
        from winograd_tpu_torch.models.resnet50 import resnet50_arrays, resnet50_forward_train

        tree = trainable_resnet50_params(resnet50_arrays(case, cfg))
        train, ref = resnet50_forward_train, baseline.resnet50_forward_cudnn
    else:
        from winograd_tpu_torch.datagen.generate import backbone_stages
        from winograd_tpu_torch.models.downsample import resnet50_stages_train

        def raw(d):
            return {k: v for k, v in d.items() if k not in ("u_mid", "u2_mid", "w9_mid")}

        tree = [{"transition": None if st["transition"] is None else raw(st["transition"]),
                 "blocks": [raw(b) for b in st["blocks"]]}
                for st in backbone_stages(cfg, case)]
        train, ref = resnet50_stages_train, baseline.bottleneck_stages
    x = torch.as_tensor(np.asarray(case["x"]), dtype=torch.float32, device=dev)
    forwards = {"cuda": lambda x_, p: train(x_, p, None, dev), "cudnn": ref,
                "bf16w": lambda x_, p: train(x_, p, "bf16w", dev)}
    return x[None] if x.dim() == 3 else x, baseline.tensors(tree, dev), forwards


def train_step(forward: Callable, params) -> Callable:
    """x -> (the train-step scalar, the gradient leaves) of forward(x,
    params): the loss sum(out^2), its gradients with respect to every leaf
    of params (tree_leaves' order), and the scalar, the loss plus every
    gradient leaf's squared norm, a 0-d tensor (the JAX package's CLI's
    protocol: every gradient stays live)."""
    leaves = tree_leaves(params)

    def step(x):
        with torch.enable_grad():
            ps = [p.detach().requires_grad_() for p in leaves]
            out = forward(x, tree_unflatten(params, ps))
            loss = (out * out).sum()
            grads = torch.autograd.grad(loss, ps)
        norms = torch.stack([torch.vdot(g.reshape(-1), g.reshape(-1)) for g in grads])
        return loss.detach() + norms.sum(), grads

    return step


def train_step_scalar(forward: Callable, params) -> Callable:
    """x -> train_step's scalar alone."""
    step = train_step(forward, params)
    return lambda x: step(x)[0]


def _train_checks(cfg, case, dev, golden, strict, extras):
    """A training mode's parity (module docstring): the forwards against the
    golden, the step scalars' agreement into extras. Returns the input,
    the steps by path, the f32 checks, the bf16w tier's error and its
    bar."""
    x, params, forwards = _train_forwards(cfg, case, dev)
    checks = {name: _check(f"{cfg.name}/{name}", forwards[name](x, params), golden, strict)
              for name in ("cuda", "cudnn")}
    bar = BF16W_RTOL_BACKBONE if isinstance(cfg, (BackboneConfig, BasicNetConfig)) else BF16W_RTOL
    rel = {"bf16w": _check_tier(f"{cfg.name}/bf16w", forwards["bf16w"](x, params), golden,
                                bar, strict)}
    steps = {name: train_step_scalar(fwd, params) for name, fwd in forwards.items()}
    scalars = {name: float(step(x)) for name, step in steps.items()}
    ref = max(abs(scalars["cudnn"]), 1.0)
    for key, name, tol in (("train_grad_rel_error", "cuda", TRAIN_GRAD_RTOL),
                           ("train_bf16w_grad_rel_error", "bf16w", BF16W_TRAIN_GRAD_RTOL)):
        err = abs(scalars[name] - scalars["cudnn"]) / ref
        print(f"  [{cfg.name}/{key}] {err:.3e} (bar {tol:g})", file=sys.stderr)
        if strict and not err < tol:
            raise ParityError(f"{cfg.name}: {name} train-step scalar breach: {err}")
        extras[key] = err
    return x, steps, checks, rel, {"bf16w": bar}


def _profile(profile_dir: str, mode: int, x: torch.Tensor, paths: Dict[str, Callable]) -> None:
    """One call of each path under torch.profiler (CUDA activity on the
    card), written as a Chrome trace to profile_dir/mode<m>.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if x.is_cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        for fn in paths.values():
            fn(x)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    prof.export_chrome_trace(os.path.join(profile_dir, f"mode{mode}.json"))


def run_case(
    mode: int,
    iterations: int = BENCH_ITERATIONS,
    warmup: int = BENCH_WARMUP,
    seed: int = 0,
    strict: bool = True,
    data_dir: str | None = None,
    profile_dir: str | None = None,
    device="cuda",
) -> Dict:
    """Run one benchmark case; returns a dict of timings and parity stats.

    device "cuda" (the default, which must exist) runs the kernels; "cpu"
    (only on request) their plain versions, with no device times. With
    data_dir, inputs, weights and golden come from the on-disk artifact set
    (datagen's load_case); otherwise they are made in memory from the seed.
    """
    dev = _build.require_device(device)
    cfg = CASES[mode]
    if data_dir is not None:
        from winograd_tpu_torch.datagen.generate import load_case

        case = load_case(mode, data_dir)
    else:
        case = make_case(mode, seed=seed)
    golden = case["golden"]
    train = isinstance(cfg, TRAIN_CONFIGS)
    extras: Dict = {}
    # A training mode differentiates its paths, so it runs outside inference mode.
    with baseline.full_float32(), (contextlib.nullcontext() if train else torch.inference_mode()):
        tf32 = baseline.tf32_enabled()
        if train:
            # Each path is its whole train step; parity on the forwards.
            x, paths, checks, rel, tols = _train_checks(cfg, case, dev, golden, strict, extras)
            pre = None
        else:
            x, paths, pre = _paths(cfg, case, dev)
            # Parity first: every path against the independent golden.
            checks = {name: _check(f"{cfg.name}/{name}", paths[name](x), golden, strict)
                      for name in ("cuda", "cudnn", "direct", "winograd_f43") if name in paths}
            if pre is not None:
                x_pre, pre_fn = pre
                checks["pre"] = _check(f"{cfg.name}/pre", pre_fn(x_pre), golden, strict)
            # The reduced-precision tiers hard-fail on their own bars; composed
            # backbones and whole models compound per-layer error.
            is_backbone = isinstance(cfg, (BackboneConfig, BasicNetConfig))
            tols = {"int8": INT8_RTOL_BACKBONE if is_backbone else INT8_RTOL,
                    "bf16w": BF16W_RTOL_BACKBONE if is_backbone else BF16W_RTOL}
            rel = {tier: _check_tier(f"{cfg.name}/{tier}", paths[tier](x), golden, tol, strict)
                   for tier, tol in tols.items()}

        if profile_dir is not None:
            _profile(profile_dir, mode, x, paths)

        loops = {name: bench_loop(f"{cfg.name}/{name}", functools.partial(paths[name], x),
                                  iterations, warmup)
                 for name in ("cuda", "cudnn")}
        device_us = {name: bench_graph(fn, x) for name, fn in paths.items()}
        if pre is not None:
            device_us["pre"] = bench_graph(pre_fn, x_pre)
    for name, us in device_us.items():
        if name in loops:
            loops[name].device_us = us
            print(f"  {loops[name]}", file=sys.stderr)
        elif us is not None:
            print(f"  {cfg.name}/{name}: device {us:.1f} us", file=sys.stderr)

    flops = case_flops(cfg)
    device_name, power_limit = card(dev.index or 0) if dev.type == "cuda" else (None, None)
    on_h100 = dev.type == "cuda" and "H100" in torch.cuda.get_device_name(dev)

    def _mfu(us: Optional[float]):
        """Model FLOPs utilization against the H100's dense BF16 peak
        (nominal conv FLOPs / device time), on an H100 only."""
        if us is None or not on_h100 or not us > 0:
            return None
        return round(flops / (us * 1e-6) / H100_PEAK_FLOPS, 4)

    batch = getattr(cfg, "batch", 1)

    def _im_s(us: Optional[float]):
        """Images per second from the device time per call."""
        if us is None or not us > 0:
            return None
        return round(batch / (us * 1e-6), 1)

    def _max_error(name):
        return checks[name].max_error if name in checks else None

    r_cuda, r_cudnn = loops["cuda"], loops["cudnn"]
    return {
        **extras,
        "mode": mode,
        "name": cfg.name,
        "backend": dev.type,
        "device_name": device_name,
        "power_limit_w": power_limit,
        "tf32": tf32,
        "flops": flops,
        "mfu_cuda": _mfu(r_cuda.device_us),
        "mfu_cudnn": _mfu(r_cudnn.device_us),
        "cuda_mean_us": r_cuda.mean_us,
        "cuda_min_us": r_cuda.min_us,
        "cuda_chained_us": r_cuda.chained_us,
        "cuda_device_us": r_cuda.device_us,
        "cudnn_mean_us": r_cudnn.mean_us,
        "cudnn_min_us": r_cudnn.min_us,
        "cudnn_chained_us": r_cudnn.chained_us,
        "cudnn_device_us": r_cudnn.device_us,
        "direct_device_us": device_us.get("direct"),
        "winograd_f43_device_us": device_us.get("winograd_f43"),
        "pre_device_us": device_us.get("pre"),
        "int8_device_us": device_us.get("int8"),
        "int8_rel_error": rel.get("int8"),
        "bf16w_device_us": device_us["bf16w"],
        "bf16w_rel_error": rel["bf16w"],
        "throughput_im_s": _im_s(r_cuda.device_us),
        "throughput_int8_im_s": _im_s(device_us.get("int8")),
        "iterations": r_cuda.iterations,
        "max_error_cuda": _max_error("cuda"),
        "max_error_cudnn": _max_error("cudnn"),
        "max_error_direct": _max_error("direct"),
        "max_error_winograd_f43": _max_error("winograd_f43"),
        "parity_ok": (
            all(c.ok() for c in checks.values())
            and all(rel[tier] < tol for tier, tol in tols.items())
            and extras.get("train_grad_rel_error", 0.0) < TRAIN_GRAD_RTOL
            and extras.get("train_bf16w_grad_rel_error", 0.0) < BF16W_TRAIN_GRAD_RTOL
        ),
    }


def run_smoke(device="cuda") -> int:
    """One untimed call of every kernel family at the JAX package's smoke
    geometries (winograd_tpu/bench/cli.py::run_smoke: the mode-0 3x3 and
    mode-2 1x1, the mode-6 block, a two-block conv4_x stage, the mode-9
    28x28 F(2,3) block, the conv4->5 transition, the stem and head at 224,
    the block and transition train VJPs) plus the basic stage (two blocks at
    7x7x512), each at f32 and, where the family has the tier, bf16w and
    int8 (the int8 tier's FP64 F(2,3) on bf16 filters among them). Every
    output must be finite and within its family's bar of the kernel's plain
    version on the same device: 1e-4 * max(1, max|plain|) at f32 and bf16w,
    equality where the kernel computes the twin's arithmetic exactly (the
    int8 kernels, the bf16 stem and the FP64 F(2,3)); the train VJPs'
    input gradients against the same Function on CPU copies (the plain
    versions) at 1e-4. On the card it builds every kernel library first.
    Returns 1 naming each family that failed, else 0, after a line with the
    run's seconds."""
    from winograd_tpu_torch.config import BlockConfig, TransitionConfig
    from winograd_tpu_torch.datagen import generate as gen
    from winograd_tpu_torch.kernels import basic_stage as bs
    from winograd_tpu_torch.kernels import quantized as q8
    from winograd_tpu_torch.kernels.block import (
        bottleneck_block_fused, bottleneck_block_fused_plain,
    )
    from winograd_tpu_torch.kernels.direct import conv3x3_bn_direct, conv3x3_bn_direct_plain
    from winograd_tpu_torch.kernels.pointwise import conv1x1_bn, conv1x1_bn_plain
    from winograd_tpu_torch.kernels.stage import (
        resnet_stage_fused, resnet_stage_fused_plain, stack_stage_params,
    )
    from winograd_tpu_torch.kernels.stem import (
        stem_fused, stem_fused_plain, stem_fused_pre, stem_fused_pre_plain, stem_prepare_input,
    )
    from winograd_tpu_torch.kernels.transition import (
        transition_block_fused, transition_block_fused_plain,
    )
    from winograd_tpu_torch.kernels.vjp import (
        bottleneck_block_train_fused, transition_block_train_fused,
    )
    from winograd_tpu_torch.kernels.winograd import (
        conv3x3_bn_winograd, conv3x3_bn_winograd_plain, winograd2_mid_plain,
    )
    from winograd_tpu_torch.models.convert import (
        cast_layer_bf16w, stages_from_jax, stem_filter_s2d, transition_from_jax,
    )

    dev = _build.require_device(device)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        # Every kernel library at once, one nvcc each.
        print(f"  [smoke] build: {_build.build_all():.1f} s", file=sys.stderr)
    failures = []

    def t(a, dtype=torch.float32, on=dev):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=on).contiguous()

    def check(name, kernel, plain, exact=False):
        try:
            out = kernel()
            ref = plain()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out, ref = out.detach().float().cpu(), ref.detach().float().cpu()
            finite = bool(torch.isfinite(out).all())
            err = (out - ref).abs().max().item()
            tol = 0.0 if exact else PARITY_ATOL * max(1.0, ref.abs().max().item())
            ok = finite and out.shape == ref.shape and err <= tol
            what = f"max abs err {err:.3e} (bar {tol:.3e}){'' if finite else ', NON-FINITE'}"
        except Exception as e:  # noqa: BLE001 - report every family
            ok, what = False, f"{type(e).__name__}: {e}"
        print(f"  [smoke] {name}: {'ok' if ok else 'FAIL'} {what}", file=sys.stderr)
        if not ok:
            failures.append(name)

    def bf16(a):
        return a.to(torch.bfloat16)

    with baseline.full_float32(), torch.inference_mode():
        # Layer kernels at the mode-0 and mode-2 geometries, every tier.
        c0 = make_case(0)
        x0, s0, b0 = t(c0["x"])[None], t(c0["scale"]), t(c0["bias"])
        u2, u4, w9 = t(c0["u2"]), t(c0["u"]), t(c0["w9"])
        check("winograd_f23", lambda: conv3x3_bn_winograd(x0, u2, s0, b0),
              lambda: conv3x3_bn_winograd_plain(x0, u2, s0, b0))
        check("winograd_f43", lambda: conv3x3_bn_winograd(x0, u4, s0, b0),
              lambda: conv3x3_bn_winograd_plain(x0, u4, s0, b0))
        check("winograd_f23_bf16w", lambda: conv3x3_bn_winograd(x0, bf16(u2), s0, b0, True,
                                                                "bf16w"),
              lambda: conv3x3_bn_winograd_plain(x0, bf16(u2), s0, b0))
        check("winograd_f23_bf16", lambda: conv3x3_bn_winograd(x0, bf16(u2), s0, b0, True,
                                                               "bf16"),
              lambda: winograd2_mid_plain(x0, bf16(u2), s0, b0), exact=True)
        uq_np, su_np = q8.quantize_winograd_filter(c0["u2"])
        uq, su = t(uq_np, torch.int8), t(su_np)
        check("winograd_int8", lambda: q8.conv3x3_bn_winograd_int8(x0, uq, su, s0, b0),
              lambda: q8.conv3x3_bn_winograd_int8_plain(x0, uq, su, s0, b0), exact=True)
        check("direct3x3", lambda: conv3x3_bn_direct(x0, w9, s0, b0),
              lambda: conv3x3_bn_direct_plain(x0, w9, s0, b0))
        check("direct3x3_bf16w", lambda: conv3x3_bn_direct(x0, bf16(w9), s0, b0),
              lambda: conv3x3_bn_direct_plain(x0, bf16(w9), s0, b0))
        w9q_np, sw9_np = q8.quantize_weights(c0["w9"])
        w9q, sw9 = t(w9q_np, torch.int8), t(sw9_np)
        check("direct3x3_int8", lambda: q8.conv3x3_bn_int8(x0, w9q, sw9, s0, b0),
              lambda: q8.conv3x3_bn_int8_plain(x0, w9q, sw9, s0, b0), exact=True)
        c2 = make_case(2)
        x2, w2, s2, b2 = t(c2["x"])[None], t(c2["w"]), t(c2["scale"]), t(c2["bias"])
        check("pointwise", lambda: conv1x1_bn(x2, w2, s2, b2, True),
              lambda: conv1x1_bn_plain(x2, w2, s2, b2, True))
        check("pointwise_bf16w", lambda: conv1x1_bn(x2, bf16(w2), s2, b2, True),
              lambda: conv1x1_bn_plain(x2, bf16(w2), s2, b2, True))
        wq2_np, sw2_np = q8.quantize_weights(c2["w"])
        wq2, sw2 = t(wq2_np, torch.int8), t(sw2_np)
        check("pointwise_int8", lambda: q8.conv1x1_bn_int8(x2, wq2, sw2, s2, b2, True),
              lambda: q8.conv1x1_bn_int8_plain(x2, wq2, sw2, s2, b2, True), exact=True)

        # The persistent kernels at the composed geometries.
        c6 = make_case(6)
        p6_np = gen.block_params_list(CASES[6], c6)
        p6 = stages_from_jax([{"transition": None, "blocks": p6_np}], dev)[0]["blocks"][0]
        x6 = t(c6["x"])[None]
        check("block", lambda: bottleneck_block_fused(x6, p6),
              lambda: bottleneck_block_fused_plain(x6, p6))
        stage_cfg = BlockConfig("smoke_stage", c_io=1024, c_mid=256, hw=14, blocks=2)
        cs = gen.make_block_case(stage_cfg, seed=1)
        blocks = stages_from_jax([{"transition": None,
                                   "blocks": gen.block_params_list(stage_cfg, cs)}], dev)[0]
        stacked = stack_stage_params(blocks["blocks"])
        xs = t(cs["x"])[None]
        check("stage", lambda: resnet_stage_fused(xs, stacked),
              lambda: resnet_stage_fused_plain(xs, stacked))
        stacked16 = stack_stage_params([cast_layer_bf16w(b) for b in blocks["blocks"]])
        check("stage_bf16w", lambda: resnet_stage_fused(xs, stacked16),
              lambda: resnet_stage_fused_plain(xs, stacked16))
        qs = q8.quantize_stage_params(blocks["blocks"])
        qs = {k: v.to(dev) for k, v in qs.items()}
        check("stage_int8", lambda: q8.resnet_stage_int8(xs, qs),
              lambda: q8.resnet_stage_int8_plain(xs, qs), exact=True)
        c9 = make_case(9)
        b9 = stages_from_jax([{"transition": None,
                               "blocks": gen.block_params_list(CASES[9], c9)}], dev)[0]
        stacked9 = stack_stage_params(b9["blocks"])
        x9 = t(c9["x"])[None]
        check("stage_winograd2_28", lambda: resnet_stage_fused(x9, stacked9),
              lambda: resnet_stage_fused_plain(x9, stacked9))
        c12 = make_case(12)
        p12 = transition_from_jax(gen.transition_params(c12), dev)
        x12 = t(c12["x"])[None]
        check("transition", lambda: transition_block_fused(x12, p12),
              lambda: transition_block_fused_plain(x12, p12))
        p12w = cast_layer_bf16w(p12)
        check("transition_bf16w", lambda: transition_block_fused(x12, p12w),
              lambda: transition_block_fused_plain(x12, p12w))
        q12 = {k: v.to(dev) for k, v in q8.quantize_transition_params(p12).items()}
        check("transition_int8", lambda: q8.transition_block_int8(x12, q12),
              lambda: q8.transition_block_int8_plain(x12, q12), exact=True)
        rng = np.random.default_rng(4)
        basic = [gen._basic_block_params_random(rng, 512, bn_scale=0.5) for _ in range(2)]
        xb = t(gen._rand(rng, 1, 7, 7, 512))
        sb = {k: v.to(dev) for k, v in bs.stack_basic_stage_params(
            [{k: t(v) for k, v in b.items()} for b in basic]).items()}
        check("basic_stage", lambda: bs.basic_stage_fused(xb, sb),
              lambda: bs.basic_stage_fused_plain(xb, sb))
        sb16 = {k: bf16(v) if k.startswith("w9_") else v for k, v in sb.items()}
        check("basic_stage_bf16w", lambda: bs.basic_stage_fused(xb, sb16),
              lambda: bs.basic_stage_fused_plain(xb, sb16))
        qb = {k: v.to(dev) for k, v in bs.quantize_basic_stage_params(basic).items()}
        check("basic_stage_int8", lambda: bs.basic_stage_int8(xb, qb),
              lambda: bs.basic_stage_int8_plain(xb, qb), exact=True)

        # Stem (raw image and prepared operand) and head, the mode-16
        # additions.
        rng = np.random.default_rng(3)
        ximg = t(gen._rand(rng, 1, 224, 224, 3))
        bns = gen._bn_params(rng, 64)
        w192 = t(stem_filter_s2d(gen._rand(rng, 64, 3, 7, 7)))
        ss, sbias = t(bns["scale"]), t(bns["bias"])
        for precision, w, exact in (("f32", w192, False), ("bf16w", bf16(w192), False),
                                    ("bf16", w192, True)):
            suffix = {"f32": "", "bf16w": "_bf16w", "bf16": "_int8"}[precision]
            check(f"stem{suffix}", lambda: stem_fused(ximg, w, ss, sbias, precision),
                  lambda: stem_fused_plain(ximg, w, ss, sbias, precision), exact=exact)
            if precision != "bf16":
                xpre = stem_prepare_input(ximg.cpu(), precision).to(dev)
                check(f"stem_pre{suffix}",
                      lambda: stem_fused_pre(xpre, w, ss, sbias, 224, 224, precision),
                      lambda: stem_fused_pre_plain(xpre, w, ss, sbias, 224, 224, precision))
        xh = t(gen._rand(rng, 1, 2048))
        w_fc, b_fc = t(gen._rand(rng, 2048, 1000, scale=0.06)), t(gen._rand(rng, 1000))
        ones = torch.ones(1000, device=dev)
        check("head", lambda: conv1x1_bn(xh, w_fc, ones, b_fc, False),
              lambda: conv1x1_bn_plain(xh, w_fc, ones, b_fc, False))

    # Training VJPs (forward and backward through the serving kernels): the
    # input gradient of sum(out^2), against the same Function on CPU copies.
    def grad_x(fn, x, params, on):
        params = {k: v.to(on) for k, v in params.items()}
        with torch.enable_grad():
            xg = x.to(on).clone().requires_grad_()
            out = fn(xg, params)
            (g,) = torch.autograd.grad((out * out).sum(), xg)
        return g

    def raw(params):
        keys = ("w_reduce", "s_reduce", "b_reduce", "w_mid", "s_mid", "b_mid", "w_expand",
                "s_expand", "b_expand", "w_proj", "s_proj", "b_proj")
        return {k: t(params[k], on="cpu") for k in keys if k in params}

    cpu = torch.device("cpu")
    with baseline.full_float32():
        p6r = raw(p6_np[0])
        check("block_train_vjp",
              lambda: grad_x(bottleneck_block_train_fused, x6, p6r, dev),
              lambda: grad_x(bottleneck_block_train_fused, x6, p6r, cpu))
        tcfg = TransitionConfig("smoke_t", 512, 256, 1024, hw=28)
        ct = gen.make_transition_case(tcfg, seed=2)
        ptr_ = raw(gen.transition_params(ct))
        xt = t(ct["x"])[None]
        check("transition_train_vjp",
              lambda: grad_x(transition_block_train_fused, xt, ptr_, dev),
              lambda: grad_x(transition_block_train_fused, xt, ptr_, cpu))

    seconds = time.perf_counter() - t0
    if failures:
        print(f"SMOKE FAILURES: {failures} ({seconds:.1f} s)", file=sys.stderr)
        return 1
    print("smoke: every kernel family ran finite and within its bar of its plain version "
          f"({seconds:.1f} s with the build)", file=sys.stderr)
    return 0


def _read_resume(path: str) -> Dict[int, Dict]:
    """The rows of a --resume file by mode; none when it does not exist."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return {r["mode"]: r for r in json.load(f)}


def _write_resume(path: str, by_mode: Dict[int, Dict]) -> None:
    """Every row by mode into path, atomically (a temporary file renamed)."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump([by_mode[m] for m in sorted(by_mode)], f)
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="winograd_tpu_torch benchmark harness")
    ap.add_argument("mode", nargs="?", default="all",
                    help=f"case {min(CASES)}-{max(CASES)} or 'all' (reference modes: 0-5)")
    ap.add_argument("--iterations", type=int, default=BENCH_ITERATIONS)
    ap.add_argument("--warmup", type=int, default=BENCH_WARMUP)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true", help="emit JSON results to stdout")
    ap.add_argument("--no-strict", action="store_true",
                    help="report parity breaches without failing")
    ap.add_argument("--data-dir", default=None,
                    help="load inputs/weights/golden from this artifact directory "
                         "(python -m winograd_tpu_torch.datagen output) instead of "
                         "generating them in memory")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of one call of each path "
                         "per case to DIR")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) runs the kernels; cpu their plain versions")
    ap.add_argument("--smoke", action="store_true",
                    help="call every kernel family once, untimed, against its plain version "
                         "(run_smoke); exits nonzero naming the families that failed")
    ap.add_argument("--resume", default=None, metavar="FILE",
                    help="keep the sweep's rows in FILE, rewritten after every mode; on a "
                         "restart skip the modes recorded there with parity_ok under the same "
                         "iterations and seed")
    args = ap.parse_args(argv)
    if args.smoke:
        return run_smoke(args.device)

    if args.mode == "all":
        modes = sorted(CASES)
    else:
        try:
            modes = [int(args.mode)]
        except ValueError:
            ap.error(f"mode must be an integer or 'all', got {args.mode!r}")
        if modes[0] not in CASES:
            ap.error(f"unknown mode {modes[0]}; valid modes: {sorted(CASES)}")
    _build.require_device(args.device)

    requested = list(modes)
    # by_mode holds every row of the --resume file, so that a narrower call
    # keeps the other modes' rows; a recorded row stands for this call's
    # mode only when it passed parity under the same iterations and seed.
    by_mode = _read_resume(args.resume) if args.resume else {}
    usable = [m for m in modes if by_mode.get(m, {}).get("parity_ok")
              and by_mode[m].get("bench_iterations") == args.iterations
              and by_mode[m].get("bench_seed") == args.seed]
    if usable:
        print(f"resume: skipping recorded modes {usable}", file=sys.stderr)
    failed = False
    for m in modes:
        if m in usable:
            continue
        print(f"=== mode {m}: {CASES[m].name} ===", file=sys.stderr)
        _build.reset_counts()
        native.CALLS.clear()
        on_card = torch.device(args.device).type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            row = run_case(m, args.iterations, args.warmup, args.seed,
                           strict=not args.no_strict, data_dir=args.data_dir,
                           profile_dir=args.profile, device=args.device)
            row["bench_seed"] = args.seed
            row["bench_iterations"] = args.iterations
            # The mode's whole run (golden, checks, timing) on the host clock,
            # the kernel launches it made, every path's counted, and the
            # calls the native host library served.
            row["seconds"] = time.perf_counter() - t0
            row["launches"] = dict(_build.LAUNCHES)
            row["native_library"] = native.available()
            row["native_calls"] = dict(native.CALLS)
            # Peak memory: the process's resident set so far (Linux
            # ru_maxrss, KiB) and the mode's device allocations.
            row["peak_host_mib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
            row["peak_device_mib"] = (torch.cuda.max_memory_allocated() / 2**20
                                      if on_card else None)
            by_mode[m] = row
            if args.resume:
                _write_resume(args.resume, by_mode)
        except ParityError as e:
            print(f"  PARITY FAILURE: {e}", file=sys.stderr)
            failed = True
        except (FileNotFoundError, ValueError) as e:
            print(f"  DATA ERROR: {e}", file=sys.stderr)
            failed = True
        except RuntimeError as e:
            print(f"  RUNTIME FAILURE: {e}", file=sys.stderr)
            failed = True
    # A sweep must hold every mode it was asked for.
    results = [by_mode[m] for m in requested if m in by_mode]
    missing = [m for m in requested if m not in by_mode]
    if missing:
        print(f"SWEEP INCOMPLETE: missing modes {missing}", file=sys.stderr)
        failed = True
    if args.json:
        print(json.dumps(results))
    else:
        def us(v):
            return "     n/a" if v is None else f"{v:8.1f}"

        for r in results:
            print(
                f"mode {r['mode']:>2} {r['name']:<24} "
                f"cuda device {us(r['cuda_device_us'])} us (mean {r['cuda_mean_us']:8.1f}) | "
                f"cudnn device {us(r['cudnn_device_us'])} us (mean {r['cudnn_mean_us']:8.1f}) | "
                f"max_err {r['max_error_cuda']:.2e}"
            )
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
