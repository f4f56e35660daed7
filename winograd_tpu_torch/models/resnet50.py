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
in all."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from winograd_tpu_torch.config import BN_EPS
from winograd_tpu_torch.kernels import _build, transforms
from winograd_tpu_torch.kernels.pointwise import conv1x1_bn
from winograd_tpu_torch.kernels.quantized import (
    conv1x1_bn_int8,
    conv3x3_bn_int8,
    quantize_transition_params,
    quantize_weights,
)
from winograd_tpu_torch.kernels.stem import stem_fused
from winograd_tpu_torch.models.convert import cast_bf16w, params_from_jax, stem_filter_s2d
from winograd_tpu_torch.models.downsample import (
    projection_bottleneck_block,
    quantize_backbone,
    resnet50_stages,
    resnet50_stages_int8,
)
from winograd_tpu_torch.models.resnet import check_precision

__all__ = [
    "cast_bf16w", "head", "head_int8", "init_resnet50_arrays", "init_resnet50_params",
    "projection_block_int8", "quantize_resnet50", "resnet50_forward",
    "resnet50_forward_int8", "stem", "stem_filter_s2d",
]


def stem(x: torch.Tensor, params: Dict, precision: str = "f32") -> torch.Tensor:
    """7x7/2 conv + BN + ReLU + 3x3/2 maxpool; keys w192_stem, s_stem, b_stem;
    precision "f32", "bf16w" (bfloat16 w192) or "bf16" (the int8 tier's)."""
    return stem_fused(x, params["w192_stem"], params["s_stem"], params["b_stem"], precision)


def head(x: torch.Tensor, params: Dict, precision: str = "f32") -> torch.Tensor:
    """Global avgpool + FC through the pointwise kernel with scale 1; keys
    w_fc (C, classes), bfloat16 at "bf16w", and b_fc (classes,)."""
    w_fc = params["w_fc"]
    check_precision(precision, w_fc)
    ones = torch.ones(w_fc.shape[1], dtype=params["b_fc"].dtype, device=w_fc.device)
    return conv1x1_bn(x.mean(dim=(-3, -2)), w_fc, ones, params["b_fc"], relu=False)


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


# Random parameters: the same numpy draws, in the same order, as
# winograd_tpu/datagen/generate.py's _rand / _bn_params / _*_params_random,
# so one seed gives both packages the same network.


def _rand(rng, *shape, scale: float = 1.0) -> np.ndarray:
    return ((rng.random(shape) - 0.5) * scale).astype(np.float32)


def _bn(rng, channels: int, scale: float):
    gamma = _rand(rng, channels, scale=scale)
    beta = _rand(rng, channels, scale=scale)
    mean = _rand(rng, channels, scale=scale)
    var = (rng.random(channels) * 3 + 5).astype(np.float32)
    return transforms.fold_batchnorm(gamma, beta, mean, var, eps=BN_EPS)


def _transition(rng, c_in, c_mid, c_out, bn_scale) -> Dict[str, np.ndarray]:
    w_mid = _rand(rng, c_mid, c_mid, 3, 3)
    (s1, b1), (s2, b2), (s3, b3), (sp, bp) = (
        _bn(rng, c, bn_scale) for c in (c_mid, c_mid, c_out, c_out)
    )
    return dict(
        w_reduce=_rand(rng, c_in, c_mid), s_reduce=s1, b_reduce=b1,
        w_mid=w_mid, s_mid=s2, b_mid=b2,
        w_expand=_rand(rng, c_mid, c_out), s_expand=s3, b_expand=b3,
        w_proj=_rand(rng, c_in, c_out), s_proj=sp, b_proj=bp,
    )


def _block(rng, c_io, c_mid, bn_scale) -> Dict[str, np.ndarray]:
    w_mid = _rand(rng, c_mid, c_mid, 3, 3)
    (s1, b1), (s2, b2), (s3, b3) = (_bn(rng, c, bn_scale) for c in (c_mid, c_mid, c_io))
    return dict(
        w_reduce=_rand(rng, c_io, c_mid), s_reduce=s1, b_reduce=b1,
        w_mid=w_mid, s_mid=s2, b_mid=b2,
        w_expand=_rand(rng, c_mid, c_io), s_expand=s3, b_expand=b3,
    )


def init_resnet50_arrays(cfg, seed: int = 0) -> Dict:
    """Random full-model parameters as numpy arrays in the JAX package's
    tree structure, with raw filters (w7_stem, w_mid); params_from_jax
    derives the kernels' layouts from them."""
    rng = np.random.default_rng(seed)
    w7 = _rand(rng, cfg.stem_c, 3, 7, 7)
    s_stem, b_stem = _bn(rng, cfg.stem_c, 0.5)
    c_io0, c_mid0 = cfg.stages[0][0], cfg.stages[0][1]
    proj = _transition(rng, cfg.stem_c, c_mid0, c_io0, 0.5)
    stages = []
    prev = None
    for c_io, c_mid, _hw, blocks in cfg.stages:
        transition = None
        if prev is not None:
            transition = _transition(rng, prev, c_mid, c_io, 0.5)
        stages.append({
            "transition": transition,
            "blocks": [_block(rng, c_io, c_mid, 0.5) for _ in range(blocks)],
        })
        prev = c_io
    c_last = cfg.stages[-1][0]
    return {
        "stem": {"w7_stem": w7, "s_stem": s_stem, "b_stem": b_stem},
        "proj": proj,
        "stages": stages,
        "head": {
            "w_fc": _rand(rng, c_last, cfg.num_classes, scale=2 * np.sqrt(2.0 / c_last)),
            "b_fc": _rand(rng, cfg.num_classes),
        },
    }


def init_resnet50_params(cfg, seed: int = 0, device="cuda", dtype=torch.float32) -> Dict:
    """Seeded random parameters on `device`, every kernel layout built by
    this package's transforms."""
    device = _build.require_device(device)
    return params_from_jax(init_resnet50_arrays(cfg, seed), device, dtype)
