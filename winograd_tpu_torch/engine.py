"""Serving layer: ResNet models with their weights resident on one device,
each input shape's forward captured once as a CUDA graph and replayed.

Port of winograd_tpu/engine.py on one device: BottleneckEngine (a run of
identity bottleneck blocks), BackboneEngine (a multi-stage backbone),
ResNet50Engine and ResNetBasicEngine (ResNet-18/34), each at the f32, bf16w
and int8 tiers; the classifiers' prepare_input / serve_pre (the
prepared-input contract: the host builds the stem's operand, the card reads
it, kernels/stem.py), throughput, the from_case, from_checkpoint
(models/checkpoint.py) and from_torch (models/import_torch.py) constructors,
and engine_from_torch. The mesh partitions are not ported yet (ROADMAP.md
A10): asked for, they raise NotImplementedError.

Compiled once per shape, as the JAX engines jit their forward: on a CUDA
device the first request of an input shape runs the forward once eagerly on
a side stream (which builds the kernels' libraries and their host plans;
nothing is built or loaded inside a capture) and captures one forward into a
torch.cuda.CUDAGraph that reads a static input buffer. That request and
every later one of the shape copy the input into the buffer, replay the
graph and return a clone of its static output, never the buffer itself,
which the next replay overwrites. All graphs of an engine share one memory
pool. The capture is utils/timing.py::capture_graph, the one bench_graph
times through. Host inputs (numpy arrays, CPU tensors) are copied into the
buffer from pageable memory: on the H100 a reused pinned staging buffer was
no faster at N=1 and 1-9% faster at N=8 (bench/staging.py, PERF.md section
5), so a caller serving batches from the host may stage its own and pass a
device tensor. A capture that fails
raises, naming the shape and the reason, and later captures go to a fresh
pool: the engine never serves eagerly on the card. The first request of a
shape therefore launches each kernel CAPTURE_PASSES times its count in one
forward; a replay runs no wrapper and counts nothing
(kernels/_build.py::LAUNCHES), and adds one to the engine's `replays`. On
the CPU, only when asked for, the forward runs eagerly through the kernels'
plain versions.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Callable, Dict, NamedTuple, Optional

import torch

from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.kernels.quantized import quantize_stage_params, resnet_stage_int8
from winograd_tpu_torch.kernels.stem import stem_prepare_input
from winograd_tpu_torch.kernels.transition import fuse_transition_weights
from winograd_tpu_torch.models import checkpoint, import_torch
from winograd_tpu_torch.models.basic import (
    basicnet_forward,
    basicnet_forward_int8,
    basicnet_forward_pre,
    basicnet_params,
    cast_basicnet_bf16w,
    quantize_basicnet,
)
from winograd_tpu_torch.models.convert import (
    basicnet_params_from_jax,
    cast_stages_bf16w,
    params_from_jax,
    params_to,
    stages_from_jax,
)
from winograd_tpu_torch.models.downsample import (
    quantize_backbone,
    resnet50_stages,
    resnet50_stages_int8,
)
from winograd_tpu_torch.models.resnet import bottleneck_block, resnet_stage
from winograd_tpu_torch.models.resnet50 import (
    cast_bf16w,
    quantize_resnet50,
    resnet50_forward,
    resnet50_forward_int8,
    resnet50_forward_pre,
    resnet50_params,
)
from winograd_tpu_torch.utils.timing import capture_graph

TIERS = ("f32", "bf16w", "int8")

# Forwards that run through the kernel wrappers when a shape is first
# served: one eager warm-up, one capture.
CAPTURE_PASSES = 2

# The stem precision prepare_input builds the operand at, by tier (the JAX
# package's _prepare_input: the int8 tier's stem rounds the image to bf16).
PREPARE_PRECISION = {"f32": "f32", "bf16w": "bf16w", "int8": "bf16"}


class _Graph(NamedTuple):
    """One captured forward: the buffer it reads, the graph, the buffer it
    writes."""

    static_in: torch.Tensor
    graph: torch.cuda.CUDAGraph
    static_out: torch.Tensor


class _Engine:
    """Weights resident on one device at one tier; each request shape's
    forward captured once (module docstring)."""

    def _init_serving(self, tier: str, device, mesh=None, partition: str = "data") -> None:
        if tier not in TIERS:
            raise ValueError(f"unknown tier {tier!r}; choose from {TIERS}")
        if mesh is not None or partition != "data":
            raise NotImplementedError(
                "mesh and partition are not ported yet (ROADMAP.md, queue A "
                "item 10: parallelism); the engine serves one device"
            )
        self.tier = tier
        self.device = _build.require_device(device)
        self._graphs: Dict[tuple, _Graph] = {}
        self._pool = None
        self.replays = 0  # requests served by a graph replay

    def _capture(self, key: tuple, fn: Callable, x: torch.Tensor) -> _Graph:
        static_in = torch.empty(x.shape, dtype=torch.float32, device=self.device)
        static_in.copy_(x)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        try:
            graph, static_out = capture_graph(
                lambda: fn(static_in), pool=self._pool,
                what=f"{type(self).__name__}: the forward of request {key} (input shape "
                     f"{tuple(x.shape)})")
        except RuntimeError:
            self._pool = None  # a failed capture leaves its pool recording
            raise
        return _Graph(static_in, graph, static_out)

    def _run(self, key: tuple, fn: Callable, x: torch.Tensor) -> torch.Tensor:
        """fn(x) through the graph of `key`, captured at its first request;
        on the CPU, eagerly. x: float32, batched."""
        if self.device.type == "cpu":
            with torch.inference_mode():
                return fn(x.to(self.device))
        with torch.inference_mode(), torch.cuda.device(self.device):
            entry = self._graphs.get(key)
            if entry is None:
                entry = self._graphs[key] = self._capture(key, fn, x)
            entry.static_in.copy_(x)
            entry.graph.replay()
            self.replays += 1
            return entry.static_out.clone()

    def _serve(self, x, fn: Callable) -> torch.Tensor:
        """fn on image(s) or maps x, (H, W, C) run as N=1 and returned
        without the batch axis."""
        x = torch.as_tensor(x, dtype=torch.float32)
        squeeze = x.dim() == 3
        if squeeze:
            x = x[None]
        out = self._run(("forward",) + tuple(x.shape), fn, x)
        return out[0] if squeeze else out


def _throughput(engine: _Engine, batch: int, c_in: int, iters: int, hw: int) -> Dict:
    """Steady-state images/s at a batch size and map side (the graph is
    shape-specific): one warm request (which captures the shape), then
    `iters` requests and one synchronize. Inputs are random normal from a
    torch.Generator seeded 0, made once on the engine's device."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((batch, hw, hw, c_in), generator=gen).to(engine.device)

    def wait():
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)

    engine(x)
    wait()
    t0 = time.perf_counter()
    outs = [engine(x) for _ in range(iters)]
    wait()
    dt = time.perf_counter() - t0
    del outs
    return {"batch": batch, "iters": iters, "images_per_sec": batch * iters / dt,
            "latency_ms": dt / iters * 1e3}


class BottleneckEngine(_Engine):
    """Serves a run of identity bottleneck blocks through the port's kernels.

    params_list: one param dict per block, numpy arrays or CPU tensors in
    the JAX package's layout (models/resnet.py: w_reduce, the raw w_mid or
    its u2_mid / w9_mid layouts, w_expand and the BN pairs); the layouts are
    derived once here (models/convert.py::stages_from_jax). tier "f32":
    with algo3x3 "auto" a run of more than one block takes resnet_stage's
    gate (one stage kernel launch when it fits), else each block runs
    bottleneck_block(algo3x3); "bf16w": bfloat16 weights, one bf16w stage
    kernel launch (models/convert.py::cast_stages_bf16w); "int8": quantized
    once here (kernels/quantized.py::quantize_stage_params), one int8 stage
    kernel launch."""

    def __init__(self, params_list, mesh=None, algo3x3: str = "auto", tier: str = "f32",
                 device="cuda"):
        self._init_serving(tier, device, mesh)
        self.algo3x3 = algo3x3
        stage = stages_from_jax([{"transition": None, "blocks": list(params_list)}], "cpu")[0]
        if tier == "int8":
            params = quantize_stage_params(stage["blocks"])
            forward = resnet_stage_int8
        elif tier == "bf16w":
            params = cast_stages_bf16w([stage])[0]
            forward = self._stage_bf16w
        else:
            params = stage
            forward = self._stage_f32
        self._params = params_to(params, self.device, torch.float32)
        self._forward = forward
        self._c_io = stage["blocks"][0]["w_reduce"].shape[0]

    def _stage_f32(self, x, p):
        if self.algo3x3 == "auto" and len(p["blocks"]) > 1:
            return resnet_stage(x, p["blocks"], stacked=p["stacked"])
        for b in p["blocks"]:
            x = bottleneck_block(x, b, algo3x3=self.algo3x3)
        return x

    @staticmethod
    def _stage_bf16w(x, p):
        return resnet_stage(x, p["blocks"], stacked=p["stacked"], precision="bf16w")

    @classmethod
    def from_checkpoint(cls, path: str, **kw) -> "BottleneckEngine":
        """One block from a models/checkpoint.py::save_params npz of its
        trained weights (raw w_mid); the offline layouts are derived here."""
        _build.require_device(kw.get("device", "cuda"))
        params, _ = checkpoint.load_params(path)
        return cls([params], **kw)

    def __call__(self, x) -> torch.Tensor:
        """Run the blocks. x: (H, W, Cio) or (N, H, W, Cio)."""
        return self._serve(x, lambda xs: self._forward(xs.contiguous(), self._params))

    def throughput(self, batch: int, c_io: Optional[int] = None, iters: int = 20,
                   hw: int = 14) -> Dict:
        return _throughput(self, batch, c_io or self._c_io, iters, hw)


def _with_fused_transition(tparams):
    """A transition's params with its fused expand+projection weights (wep,
    bep; kernels/transition.py::fuse_transition_weights) folded once, at
    engine construction, where they are missing."""
    if tparams is None or "wep" in tparams or "w_expand" not in tparams:
        return tparams
    wep, bep = fuse_transition_weights({k: torch.as_tensor(v) for k, v in tparams.items()})
    return {**tparams, "wep": wep, "bep": bep}


class BackboneEngine(_Engine):
    """Serves a multi-stage backbone (models/downsample.py::resnet50_stages's
    structure: stride-2 transitions and identity runs) through the port's
    kernels, at the f32, bf16w or int8 tier.

    stages: the JAX package's structure, numpy arrays or CPU tensors
    ([{"transition": params or None, "blocks": [params, ...]}]); the
    kernels' layouts, each transition's fused wep/bep and each fused stage's
    stack are built once here (models/convert.py::stages_from_jax), then
    cast to bf16 (cast_stages_bf16w) or quantized (quantize_backbone) by
    tier."""

    def __init__(self, stages, tier: str = "f32", mesh=None, device="cuda"):
        self._init_serving(tier, device, mesh)
        converted = stages_from_jax(stages, "cpu")
        if tier == "int8":
            params, forward = quantize_backbone(converted), resnet50_stages_int8
        elif tier == "bf16w":
            params = cast_stages_bf16w(converted)
            forward = functools.partial(resnet50_stages, precision="bf16w")
        else:
            params, forward = converted, resnet50_stages
        self._params = params_to(params, self.device, torch.float32)
        self._forward = forward

    def __call__(self, x) -> torch.Tensor:
        """x: (H, W, C_in) or (N, H, W, C_in) at the first stage's shape."""
        return self._serve(x, lambda xs: self._forward(xs.contiguous(), self._params))

    def throughput(self, batch: int, hw: int, c_in: int, iters: int = 20) -> Dict:
        return _throughput(self, batch, c_in, iters, hw)


def _state_dict(sd_or_path):
    if isinstance(sd_or_path, (str, os.PathLike)):
        return import_torch.load_torch_checkpoint(os.fspath(sd_or_path))
    return sd_or_path


class _ClassifierEngine(_Engine):
    """A classifier's weights resident on one device, served at one tier. A
    subclass names, per tier, the forward from images and the one from the
    prepared operand (f32 and bf16w only), the conversion of the f32
    parameters into the tier's (none at f32), and how parameters are built
    from a datagen case, a trained tree and a torchvision state dict."""

    _forwards: Dict[str, Callable] = {}
    _forwards_pre: Dict[str, Callable] = {}
    _convert: Dict[str, Callable] = {}

    def __init__(self, params: Dict, tier: str = "f32", device="cuda",
                 mesh=None, partition: str = "data"):
        self._init_serving(tier, device, mesh, partition)
        params = self._prepare(params)
        if tier in self._convert:
            params = self._convert[tier](params)
        self._params = params_to(params, self.device, torch.float32)
        self._forward = self._forwards[tier]

    def _prepare(self, params: Dict) -> Dict:
        return params

    def __call__(self, x) -> torch.Tensor:
        """x: (224, 224, 3) or (N, 224, 224, 3) image(s), array or tensor;
        returns (num_classes,) / (N, num_classes) logits on the engine's
        device. A single image runs as N=1."""
        return self._serve(x, lambda xs: self._forward(xs, self._params, self.device))

    def classify(self, x) -> torch.Tensor:
        """Argmax class id(s) for image(s) x."""
        return torch.argmax(self(x), dim=-1)

    def prepare_input(self, x) -> torch.Tensor:
        """The prepared-input contract, host side: raw image(s) -> the
        stem's operand, a CPU tensor (kernels/stem.py::stem_prepare_input at
        the tier's stem precision, PREPARE_PRECISION). Run it in the input
        pipeline and serve the result with serve_pre."""
        return stem_prepare_input(x, PREPARE_PRECISION[self.tier])

    def serve_pre(self, xb, img: int = 224) -> torch.Tensor:
        """(N, num_classes) logits from a prepared operand (prepare_input)
        of N img x img images, each shape captured once like __call__. The
        f32 and bf16w tiers only; the int8 tier serves the raw image."""
        if self.tier not in self._forwards_pre:
            raise ValueError(f"serve_pre serves the f32 and bf16w tiers, not {self.tier!r}; "
                             "the int8 tier takes the raw image (engine(x))")
        forward = self._forwards_pre[self.tier]
        xb = torch.as_tensor(xb, dtype=torch.float32)
        return self._run(("pre", img) + tuple(xb.shape), lambda xs: forward(
            xs, self._params, self.device, h=img, w=img), xb)

    def throughput(self, batch: int, iters: int = 20, img: int = 224) -> Dict:
        """img must match the deployment image side (224 for the standard
        model): the graph is shape-specific."""
        return _throughput(self, batch, 3, iters, img)

    @classmethod
    def from_case(cls, case, cfg, **kw):
        """Build from a flat datagen case dict of the model."""
        device = _build.require_device(kw.get("device", "cuda"))
        return cls(cls._params_from_case(case, cfg, device), **kw)

    @classmethod
    def from_checkpoint(cls, path: str, **kw):
        """The deployment end of the training pipeline: a checkpoint of
        trained parameters (raw filters, folded BN), through the offline
        preprocessing (prepare_*_serving), served. path: a models/
        checkpoint.py::save_model file, or a save_checkpoint_dir directory
        (the JAX package's orbax directory's twin)."""
        device = _build.require_device(kw.get("device", "cuda"))
        if os.path.isdir(path):
            trained = checkpoint.load_checkpoint_dir(path, device="cpu")
        else:
            trained, _ = checkpoint.load_model(path)
        return cls(cls._serving_params(trained, device), **kw)

    @classmethod
    def from_torch(cls, sd_or_path, **kw):
        """Serve a torchvision-format ResNet checkpoint: a state_dict (tensors
        or arrays) or a .pt/.pth path. BN folding and every kernel layout
        happen here, once (models/import_torch.py); depth is inferred."""
        device = _build.require_device(kw.get("device", "cuda"))
        return cls(cls._serving_params_from_torch(_state_dict(sd_or_path), device), **kw)


class ResNet50Engine(_ClassifierEngine):
    """Serves the complete bottleneck classifier (224x224x3 image in, 1000
    logits out) through the port's kernels: ResNet-50, and ResNet-101 and
    ResNet-152 (from torchvision-format weights, from_torch), each forward
    launching ResNet-50's kernels (the deeper conv3_x and conv4_x runs stay
    one stage launch each; chip_smoke.py's depth phase serves both at every
    tier). Any batch runs whole, as one graph a shape (N=32 in chip_smoke.py's
    batch32 phase).

    params: the port's f32 parameter dicts (models/resnet50.py::
    init_resnet50_params, or models/convert.py::params_from_jax); they are
    copied to `device` once, each transition's wep/bep folded where missing
    (_with_fused_transition). tier "f32" serves them as they are; "bf16w"
    casts them once here (models/convert.py::cast_bf16w: bfloat16 weights,
    f32 BN) and serves resnet50_forward(precision="bf16w"); "int8"
    quantizes them once here (models/resnet50.py::quantize_resnet50) and
    serves resnet50_forward_int8. device defaults to "cuda" and must exist;
    the CPU runs the kernels' plain versions and only when asked for."""

    _forwards = {"f32": resnet50_forward,
                 "bf16w": functools.partial(resnet50_forward, precision="bf16w"),
                 "int8": resnet50_forward_int8}
    _forwards_pre = {"f32": resnet50_forward_pre,
                     "bf16w": functools.partial(resnet50_forward_pre, precision="bf16w")}
    _convert = {"bf16w": cast_bf16w, "int8": quantize_resnet50}

    def _prepare(self, params: Dict) -> Dict:
        if self.tier == "int8":
            return params
        stages = [dict(st, transition=_with_fused_transition(st.get("transition")))
                  for st in params["stages"]]
        return dict(params, stages=stages)

    @classmethod
    def _params_from_case(cls, case, cfg, device) -> Dict:
        return resnet50_params(case, cfg, device)

    @classmethod
    def _serving_params(cls, trained: Dict, device) -> Dict:
        return params_from_jax(checkpoint.prepare_resnet50_serving(trained), device)

    @classmethod
    def _serving_params_from_torch(cls, sd: Dict, device) -> Dict:
        return params_from_jax(import_torch.resnet_serving_params_from_torch(sd), device)


class ResNetBasicEngine(_ClassifierEngine):
    """Serves the basic-block family (ResNet-18/34: 224x224x3 image in, 1000
    logits out) through the port's kernels.

    params: the port's f32 parameters (models/basic.py::basicnet_params,
    or models/convert.py::basicnet_params_from_jax); they are copied to
    `device` once. tier "f32" serves them as they are (basicnet_forward);
    "bf16w" casts them once here (models/convert.py::cast_basicnet_bf16w:
    bfloat16 weights, f32 BN) and serves basicnet_forward(precision=
    "bf16w"); "int8" quantizes them once here (models/basic.py::
    quantize_basicnet) and serves basicnet_forward_int8. device defaults to
    "cuda" and must exist; the CPU runs the kernels' plain versions and only
    when asked for."""

    _forwards = {"f32": basicnet_forward,
                 "bf16w": functools.partial(basicnet_forward, precision="bf16w"),
                 "int8": basicnet_forward_int8}
    _forwards_pre = {"f32": basicnet_forward_pre,
                     "bf16w": functools.partial(basicnet_forward_pre, precision="bf16w")}
    _convert = {"bf16w": cast_basicnet_bf16w, "int8": quantize_basicnet}

    @classmethod
    def _params_from_case(cls, case, cfg, device) -> Dict:
        return basicnet_params(case, cfg, device)

    @classmethod
    def _serving_params(cls, trained: Dict, device) -> Dict:
        return basicnet_params_from_jax(checkpoint.prepare_basicnet_serving(trained), device)

    @classmethod
    def _serving_params_from_torch(cls, sd: Dict, device) -> Dict:
        return basicnet_params_from_jax(import_torch.basicnet_serving_params_from_torch(sd),
                                        device)


def engine_from_torch(sd_or_path, **kw) -> _ClassifierEngine:
    """Serve any torchvision-format ResNet checkpoint: the block family
    read from the state dict (models/import_torch.py::resnet_family) picks
    ResNet50Engine (bottleneck 50/101/152) or ResNetBasicEngine (basic
    18/34); kw (tier, device) pass through."""
    _build.require_device(kw.get("device", "cuda"))
    sd = _state_dict(sd_or_path)
    family = import_torch.resnet_family(sd)
    cls = {"bottleneck": ResNet50Engine, "basic": ResNetBasicEngine}[family]
    return cls.from_torch(sd, **kw)
