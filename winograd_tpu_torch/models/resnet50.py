"""The complete ResNet-50 classifier: stem, projection block, 16-block trunk,
head; a 224x224x3 image to 1000 logits through the port's six kernels.

Port of winograd_tpu/models/resnet50.py::resnet50_forward_pallas on the JAX
package's fused route. Per forward at full width: the stem 1 launch; the
projection block pointwise 3 and Winograd 1; the stage kernel 3 (conv2_x,
conv3_x, conv4_x, one launch each); the transition kernel 3; conv5_x's two
identity blocks, whose weights fail the fused gates (models/resnet.py), per
layer: pointwise 4 and direct 2; the head pointwise 1. 18 launches in all.

resnet50_forward(precision="bf16w") is the bf16w serving tier,
resnet50_forward_pallas(precision="bf16w"), on parameters from
convert.py::cast_bf16w (bfloat16 weights, f32 BN): the kernels' bf16w
instantiations, with the bf16w stage gate fusing every identity run. Per
forward: the stem at bf16w 1; the projection block pointwise 3 and the
Winograd F(2,3) at bf16w 1; the transition kernel 3; the stage kernel 4
(conv5_x too); the head pointwise 1. 13 launches in all.

resnet50_forward_int8 is the port of resnet50_forward_int8, the int8
serving tier, on parameters from quantize_resnet50: the stem at bf16 (1
launch); the projection block per layer, int8 pointwise 3 and int8 direct 1
(the add and ReLU are PyTorch ops); the int8 transition kernel 3; the int8
stage kernel 4 (F(2,3) on bf16 filters at conv2_x and conv3_x, the int8
direct mid at conv4_x and conv5_x); the head int8 pointwise 1. 13 launches
in all.

resnet50_forward_train (the JAX package's resnet50_forward_train) is the
classifier differentiable on its trainable parameters (stem {w7_stem,
s_stem, b_stem}, the projection and stages with raw w_mid, head {w_fc,
b_fc}) through kernels/vjp.py: the stem kernel, the projection block's
serving composition, models/downsample.py::resnet50_stages_train and the
head FC. Per f32 forward at full width: the stem 1, pointwise 4 (the
projection block's three 1x1s, the head), Winograd 1, stage 10 (conv2_x
and conv5_x one launch each, every conv3_x and conv4_x block one) and
transition 3: 19 launches; at "bf16w" the same counts under the bf16w
instantiations' names.

resnet50_forward_pre (the JAX package's resnet50_forward_pre) serves the
prepared-input contract: the stem reads the operand kernels/stem.py::
stem_prepare_input built on the host (stem_pre, counted as "stem_pre" or
"stem_pre_bf16w"), the rest is resnet50_forward's, at "f32" or "bf16w"."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from winograd_tpu_torch.config import TransitionConfig
from winograd_tpu_torch.datagen.generate import (
    _block_params_random,
    _bn_params,
    _rand,
    _transition_params_random,
    backbone_stages,
)
from winograd_tpu_torch.kernels import _build, vjp
from winograd_tpu_torch.kernels.pointwise import conv1x1_bn
from winograd_tpu_torch.kernels.quantized import (
    conv1x1_bn_int8,
    conv3x3_bn_int8,
    quantize_transition_params,
    quantize_weights,
)
from winograd_tpu_torch.kernels.stem import stem_fused, stem_fused_pre, stem_s2d_cols
from winograd_tpu_torch.models.convert import (
    cast_bf16w,
    params_from_jax,
    stem_filter_s2d,
)
from winograd_tpu_torch.models.downsample import (
    projection_bottleneck_block,
    quantize_backbone,
    resnet50_stages,
    resnet50_stages_int8,
    resnet50_stages_train,
)
from winograd_tpu_torch.models.resnet import check_precision, train_input
from winograd_tpu_torch.ops.torch_ops import maxpool3x3_s2

__all__ = [
    "cast_bf16w", "head", "head_int8", "init_resnet50_arrays", "init_resnet50_params",
    "projection_block_int8", "quantize_resnet50", "resnet50_arrays", "resnet50_forward",
    "resnet50_forward_int8", "resnet50_forward_pre", "resnet50_forward_train",
    "resnet50_params", "stem", "stem_filter_s2d", "stem_pre",
]


def stem(x: torch.Tensor, params: Dict, precision: str = "f32",
         algo: str = "fused") -> torch.Tensor:
    """7x7/2 conv + BN + ReLU + 3x3/2 maxpool; keys w192_stem, s_stem, b_stem.
    algo "fused" (the served route): the stem kernel at precision "f32",
    "bf16w" (bfloat16 w192) or "bf16" (the int8 tier's). algo "s2d" (the
    JAX package's stem_pallas(algo="s2d"), f32 only): the space-to-depth
    patch matrix (kernels/stem.py::stem_s2d_cols) through the pointwise
    kernel, then the maxpool."""
    if algo == "fused":
        return stem_fused(x, params["w192_stem"], params["s_stem"], params["b_stem"], precision)
    if algo != "s2d" or precision != "f32":
        raise ValueError(f"unknown stem route algo={algo!r} at precision {precision!r}")
    squeeze = x.dim() == 3
    cols = stem_s2d_cols(x[None] if squeeze else x)
    h = maxpool3x3_s2(conv1x1_bn(cols, params["w192_stem"], params["s_stem"], params["b_stem"],
                                 relu=True))
    return h[0] if squeeze else h


def stem_pre(xb: torch.Tensor, params: Dict, precision: str = "f32", h: int = 224,
             w: int = 224) -> torch.Tensor:
    """The stem on a prepared operand (kernels/stem.py::stem_prepare_input)
    of an h x w image, at precision "f32", "bf16w" or "bf16"; keys as
    stem's. Equal to stem(x, params, precision) to the bit."""
    return stem_fused_pre(xb, params["w192_stem"], params["s_stem"], params["b_stem"], h, w,
                          precision)


def head(x: torch.Tensor, params: Dict, precision: str = "f32") -> torch.Tensor:
    """Global avgpool + FC through the pointwise kernel with scale 1; keys
    w_fc (C, classes), bfloat16 at "bf16w", and b_fc (classes,)."""
    w_fc = params["w_fc"]
    check_precision(precision, w_fc)
    ones = torch.ones(w_fc.shape[1], dtype=params["b_fc"].dtype, device=w_fc.device)
    return conv1x1_bn(x.mean(dim=(-3, -2)), w_fc, ones, params["b_fc"], relu=False)


def head_train(x: torch.Tensor, params: Dict, precision=None) -> torch.Tensor:
    """Global avgpool + FC, differentiable: kernels/vjp.py::conv1x1_bn_train
    with scale 1 on the float32 w_fc (a bf16 copy in the forward at
    "bf16w")."""
    ones = torch.ones(params["w_fc"].shape[1], dtype=params["b_fc"].dtype, device=x.device)
    return vjp.conv1x1_bn_train(x.mean(dim=(-3, -2)), params["w_fc"], ones, params["b_fc"],
                                False, precision)


def resnet50_forward_train(x, params: Dict, precision=None, device="cuda") -> torch.Tensor:
    """Differentiable logits of image(s) x, (H, W, 3) or (N, H, W, 3), on the
    trainable parameters (module docstring), which live on `device` and
    whose BN dtype x is cast to. precision None (f32) or "bf16w" (the
    forward on bf16 copies of the f32 weights; the backward f32). CUDA runs
    the kernels; the CPU (only on request) runs their plain versions."""
    x = train_input(x, params["head"]["b_fc"], device)
    h = vjp.stem_train_fused(x, params["stem"], precision)
    h = vjp.projection_block_train_fused(h, params["proj"], precision)
    h = resnet50_stages_train(h, params["stages"], precision, device)
    return head_train(h, params["head"], precision)


def _images(x, dtype, device):
    x = torch.as_tensor(x, dtype=dtype, device=device).contiguous()
    return (x[None], True) if x.dim() == 3 else (x, False)


def resnet50_forward(x, params: Dict, device="cuda", precision: str = "f32") -> torch.Tensor:
    """Logits of image(s) x, (H, W, 3) or (N, H, W, 3), in the dtype of the
    params' BN (float32 at "bf16w"), which must live on `device`. precision
    "f32", or "bf16w" on parameters from cast_bf16w. CUDA runs the kernels;
    the CPU (only on request) runs their plain versions."""
    device = _build.require_device(device)
    x, squeeze = _images(x, params["head"]["b_fc"].dtype, device)
    h = stem(x, params["stem"], precision)
    h = projection_bottleneck_block(h, params["proj"], precision)
    h = resnet50_stages(h, params["stages"], precision)
    logits = head(h, params["head"], precision)
    return logits[0] if squeeze else logits


def _prepared(xb, device) -> torch.Tensor:
    return torch.as_tensor(xb, dtype=torch.float32, device=device).contiguous()


def resnet50_forward_pre(xb, params: Dict, device="cuda", precision: str = "f32",
                         h: int = 224, w: int = 224) -> torch.Tensor:
    """(N, num_classes) logits from the prepared operand xb (kernels/stem.py::
    stem_prepare_input of N h x w images, float32) on params that live on
    `device`: stem_pre, then resnet50_forward's layers at `precision`
    ("f32", or "bf16w" on parameters from cast_bf16w)."""
    device = _build.require_device(device)
    hh = stem_pre(_prepared(xb, device), params["stem"], precision, h, w)
    hh = projection_bottleneck_block(hh, params["proj"], precision)
    hh = resnet50_stages(hh, params["stages"], precision)
    return head(hh, params["head"], precision)


def quantize_resnet50(params: Dict) -> Dict:
    """The port's f32 parameters -> the int8 tier's (the JAX package's
    quantize_resnet50): the stem stays f32 (it runs at bf16); the
    projection block, the trunk and the head FC go int8 (weights per output
    channel; BN and biases f32)."""
    w_q, s_w = quantize_weights(params["head"]["w_fc"].detach().cpu().numpy())
    return {
        "stem": {k: params["stem"][k] for k in ("w192_stem", "s_stem", "b_stem")},
        "proj": quantize_transition_params(params["proj"]),
        "stages": quantize_backbone(params["stages"]),
        "head": {"w_fc_q": torch.from_numpy(w_q), "w_fc_s": torch.from_numpy(s_w),
                 "b_fc": params["head"]["b_fc"].detach().cpu().float()},
    }


def projection_block_int8(x: torch.Tensor, q: Dict) -> torch.Tensor:
    """conv2_x's stride-1 projection block at the int8 tier, per layer:
    int8 1x1 reduce, int8 direct 3x3, int8 1x1 expand, int8 1x1
    projection; add, ReLU (quantize_transition_params layout)."""
    h = conv1x1_bn_int8(x, q["w_reduce_q"], q["w_reduce_s"], q["s_reduce"], q["b_reduce"], True)
    h = conv3x3_bn_int8(h, q["w9_mid_q"], q["w9_mid_s"], q["s_mid"], q["b_mid"], True)
    h = conv1x1_bn_int8(h, q["w_expand_q"], q["w_expand_s"], q["s_expand"], q["b_expand"],
                        False)
    skip = conv1x1_bn_int8(x, q["w_proj_q"], q["w_proj_s"], q["s_proj"], q["b_proj"], False)
    return torch.relu(h + skip)


def head_int8(x: torch.Tensor, q: Dict) -> torch.Tensor:
    """Global avgpool + the int8 FC with BN scale 1; keys w_fc_q (C,
    classes) int8, w_fc_s, b_fc (classes,). The mean is taken in float64
    and rounded once, so it does not depend on the order of its sum (the
    FC's row scale would turn a last-bit difference into a quantization
    step)."""
    ones = torch.ones(q["w_fc_q"].shape[1], dtype=torch.float32, device=x.device)
    pooled = x.double().mean(dim=(-3, -2)).to(x.dtype)
    return conv1x1_bn_int8(pooled, q["w_fc_q"], q["w_fc_s"], ones, q["b_fc"], False)


def resnet50_forward_int8(x, qparams: Dict, device="cuda") -> torch.Tensor:
    """Logits of image(s) x, (H, W, 3) or (N, H, W, 3), at the int8 tier, on
    parameters from quantize_resnet50 (or convert.py::qparams_from_jax)
    that live on `device`; float32. CUDA runs the kernels; the CPU (only on
    request) runs their plain versions."""
    device = _build.require_device(device)
    x, squeeze = _images(x, torch.float32, device)
    h = stem(x, qparams["stem"], precision="bf16")
    h = projection_block_int8(h, qparams["proj"])
    h = resnet50_stages_int8(h, qparams["stages"])
    logits = head_int8(h, qparams["head"])
    return logits[0] if squeeze else logits


def init_resnet50_arrays(cfg, seed: int = 0) -> Dict:
    """Random full-model parameters as numpy arrays in the JAX package's
    tree structure (its init_resnet50_params): datagen's draws, in the order
    of make_resnet50_case's after its image, without the goldens; raw
    filters (w7_stem, w_mid), from which params_from_jax derives the
    kernels' layouts."""
    rng = np.random.default_rng(seed)
    w7 = _rand(rng, cfg.stem_c, 3, 7, 7)
    bn_stem = _bn_params(rng, cfg.stem_c, scale=0.5)
    c_io0, c_mid0, hw0, _ = cfg.stages[0]
    proj = _transition_params_random(
        rng, TransitionConfig("p0", cfg.stem_c, c_mid0, c_io0, hw=hw0), bn_scale=0.5)
    stages = []
    prev = None
    for c_io, c_mid, hw, blocks in cfg.stages:
        transition = None
        if prev is not None:
            transition = _transition_params_random(
                rng, TransitionConfig("t", prev, c_mid, c_io, hw=2 * hw), bn_scale=0.5)
        stages.append({
            "transition": transition,
            "blocks": [_block_params_random(rng, c_io, c_mid, bn_scale=0.5)
                       for _ in range(blocks)],
        })
        prev = c_io
    c_last = cfg.stages[-1][0]
    return {
        "stem": {"w7_stem": w7, "s_stem": bn_stem["scale"], "b_stem": bn_stem["bias"]},
        "proj": proj,
        "stages": stages,
        "head": {
            "w_fc": _rand(rng, c_last, cfg.num_classes, scale=2 * np.sqrt(2.0 / c_last)),
            "b_fc": _rand(rng, cfg.num_classes),
        },
    }


PROJ_KEYS = (
    "w_reduce", "s_reduce", "b_reduce", "w_mid", "u2_mid", "w9_mid",
    "s_mid", "b_mid", "w_expand", "s_expand", "b_expand",
    "w_proj", "s_proj", "b_proj",
)


def resnet50_arrays(case: Dict[str, np.ndarray], cfg) -> Dict:
    """The nested parameter tree {"stem", "proj", "stages", "head"}, numpy
    arrays with the raw filters, from a flat make_resnet50_case dict
    (datagen/generate.py): the JAX package's resnet50_params. The cuDNN
    baseline (baseline/cudnn.py) runs it as it is; resnet50_params derives
    the kernels' layouts from it."""
    return {
        "stem": {
            "w49_stem": case["stem_w49"],
            "w7_stem": case["stem_w7"],
            "w192_stem": case.get("stem_w192", stem_filter_s2d(case["stem_w7"])),
            "s_stem": case["stem_scale"],
            "b_stem": case["stem_bias"],
        },
        "proj": {k: case[f"p0_{k}"] for k in PROJ_KEYS if f"p0_{k}" in case},
        "stages": backbone_stages(cfg, case),
        "head": {"w_fc": case["head_wfc"], "b_fc": case["head_bfc"]},
    }


def resnet50_params(case: Dict[str, np.ndarray], cfg, device="cuda",
                    dtype=torch.float32) -> Dict:
    """The port's forward parameters on `device` from a flat
    make_resnet50_case dict: the twin of the JAX package's resnet50_params,
    every kernel layout built by this package's transforms."""
    device = _build.require_device(device)
    return params_from_jax(resnet50_arrays(case, cfg), device, dtype)


def init_resnet50_params(cfg, seed: int = 0, device="cuda", dtype=torch.float32) -> Dict:
    """Seeded random parameters on `device`, every kernel layout built by
    this package's transforms."""
    device = _build.require_device(device)
    return params_from_jax(init_resnet50_arrays(cfg, seed), device, dtype)
