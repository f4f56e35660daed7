"""The basic-block ResNet family (ResNet-18/34): stem, stages, head, at the
f32, the bf16w and the int8 tier.

Port of winograd_tpu/models/basic.py (basicnet_forward_pallas,
basicnet_forward_int8 and their parts) on the JAX package's routes, whose
gates are kept as they are (TPU measurements, not re-derived on the H100):

* a stride-1 3x3 runs Winograd F(2,3) on its u2_* filter, except on maps of
  at most SMALL_MAP_PIXELS pixels, where it runs the direct implicit GEMM
  on w9_*;
* a stride-2 entry block runs its strided 3x3 as a strided im2col and the
  pointwise kernel, its 1x1 projection as a subsample and the pointwise
  kernel;
* a stage whose identity blocks carry the stacked "fused" artifact
  (attach_fused_stage_artifacts: FUSED_STAGE_MIN_CHANNELS channels and up)
  runs them in one basic-stage kernel launch on small maps.

At full-width ResNet-34 an f32 forward launches the stem 1, Winograd 24,
pointwise 7 (three entries' strided convs and projections, the head),
direct 1 (conv5_x's entry b-leg at 7x7) and basic_stage 1 (conv5_x's two
identity blocks) times.

basicnet_forward(precision="bf16w") is the bf16w tier,
basicnet_forward_pallas(precision="bf16w"), on parameters from
convert.py::cast_basicnet_bf16w (bfloat16 weights, f32 BN): the same
routes through the kernels' bf16w instantiations, each F(2,3) on the
bf16 tensor cores (kernels/winograd.py's "bf16w"). At full-width ResNet-34:
stem_bf16w 1, winograd_bf16w 24, pointwise_bf16w 7, direct_bf16w 1 and
basic_stage_bf16w 1 (ResNet-18: winograd_bf16w 10).

The int8 tier (quantize_basicnet, basicnet_forward_int8) runs the stem at
bf16 and routes each stride-1 3x3 above SMALL_MAP_PIXELS by its width: up
to INT8_BF16_MAX_COUT output channels F(2,3) on the bf16 filter u2_*_bf16,
above it the int8 Winograd on u2_*_q; on small maps the int8 direct 3x3.
At full-width ResNet-34: stem (bf16) 1, Winograd (bf16 filter) 6,
winograd_int8 18, pointwise_int8 7, direct_int8 1, basic_stage_int8 1.

basicnet_forward_train (the JAX package's basicnet_forward_train) is the
same network differentiable on its trainable parameters (kernels/vjp.py),
on the same routes and gates.

basicnet_forward_pre (the JAX package's basicnet_forward_pre) serves the
prepared-input contract at "f32" or "bf16w": the stem on the operand
kernels/stem.py::stem_prepare_input built on the host (models/resnet50.py::
stem_pre), then basicnet_forward's stages and head.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from winograd_tpu_torch.datagen.generate import (
    _basic_block_params_random,
    _basic_entry_params_random,
    _bn_params,
    _rand,
)
from winograd_tpu_torch.kernels import _build, vjp
from winograd_tpu_torch.kernels.basic_stage import (
    basic_stage_fused,
    basic_stage_int8,
    quantize_basic_stage_params,
    stack_basic_stage_params,
)
from winograd_tpu_torch.kernels.direct import conv3x3_bn_direct
from winograd_tpu_torch.kernels.pointwise import conv1x1_bn
from winograd_tpu_torch.kernels.quantized import (
    _numpy,
    conv1x1_bn_int8,
    conv3x3_bn_int8,
    conv3x3_bn_winograd_int8,
    quantize_weights,
    quantize_winograd_filter,
)
from winograd_tpu_torch.kernels.transition import strided_im2col
from winograd_tpu_torch.kernels.winograd import conv3x3_bn_winograd
from winograd_tpu_torch.models.convert import (
    basic_block_views,
    basicnet_params_from_jax,
    cast_basicnet_bf16w,
    stem_filter,
    stem_filter_s2d,
)
from winograd_tpu_torch.models.resnet import check_precision, train_input
from winograd_tpu_torch.models.resnet50 import (
    _images, _prepared, head, head_int8, head_train, stem, stem_pre,
)

__all__ = [
    "FUSED_STAGE_MIN_CHANNELS", "INT8_BF16_MAX_COUT", "SMALL_MAP_PIXELS",
    "attach_fused_stage_artifacts", "basic_block", "basic_block_int8", "basicnet_arrays",
    "basicnet_forward", "basicnet_forward_int8", "basicnet_forward_pre",
    "basicnet_forward_train", "basicnet_params",
    "basicnet_stages", "cast_basicnet_bf16w", "downsample_basic_block",
    "downsample_basic_block_int8", "fused_stage_eligible", "init_basicnet_arrays",
    "quantize_basicnet",
]

# A stride-1 3x3 on a map of at most this many pixels runs the direct
# implicit GEMM (the JAX package's rule: the F(2,3) filter streams 16/9 the
# direct layout's bytes over a map too small to amortize them on the TPU).
SMALL_MAP_PIXELS = 8 * 8

# A stage's identity run is stacked for the basic-stage kernel when its
# blocks are uniform and at least this wide (the JAX package's rule: 7x7x512
# is the geometry that won on the TPU).
FUSED_STAGE_MIN_CHANNELS = 512

# At the int8 tier a stride-1 3x3 above SMALL_MAP_PIXELS with at most this
# many output channels runs F(2,3) on the bf16 filter, a wider one the int8
# Winograd (the JAX package's rule: at 64 channels its int8 path ran
# half-lane on the TPU).
INT8_BF16_MAX_COUT = 64


def _small_map(x: torch.Tensor) -> bool:
    return x.shape[-3] * x.shape[-2] <= SMALL_MAP_PIXELS


def _conv3x3(x, p: Dict, leg: str, relu: bool, precision: str = "f32") -> torch.Tensor:
    """Stride-1 3x3 + BN (+ReLU): F(2,3) on u2_<leg>, or direct on w9_<leg>
    where the map is small and the block has it (or u2_<leg> is absent); at
    `precision` ("f32", or "bf16w" on bfloat16 filters)."""
    if f"u2_{leg}" in p and not (_small_map(x) and f"w9_{leg}" in p):
        return conv3x3_bn_winograd(x, p[f"u2_{leg}"], p[f"s_{leg}"], p[f"b_{leg}"], relu,
                                   precision)
    w9 = p[f"w9_{leg}"]
    check_precision(precision, w9)
    return conv3x3_bn_direct(x, w9, p[f"s_{leg}"], p[f"b_{leg}"], relu)


def basic_block(x: torch.Tensor, params: Dict, precision: str = "f32") -> torch.Tensor:
    """Identity basic block: 3x3 + BN + ReLU -> 3x3 + BN -> add skip -> ReLU.
    x: (N, H, W, C)."""
    h = _conv3x3(x, params, "a", True, precision)
    h = _conv3x3(h, params, "b", False, precision)
    return torch.relu(h + x)


def downsample_basic_block(x: torch.Tensor, params: Dict, precision: str = "f32") -> torch.Tensor:
    """Stride-2 entry basic block: stride-2 3x3 (+BN+ReLU) -> 3x3 (+BN), a
    stride-2 1x1 projection shortcut (+BN); add -> ReLU. w9_a is the
    (9*Cin, Cout) layout of the strided conv; w_proj (Cin, Cout), s_proj,
    b_proj."""
    p = params
    check_precision(precision, p["w9_a"], p["w_proj"])
    h = conv1x1_bn(strided_im2col(x), p["w9_a"], p["s_a"], p["b_a"], relu=True)
    h = _conv3x3(h, p, "b", False, precision)
    skip = conv1x1_bn(x[:, ::2, ::2, :].contiguous(), p["w_proj"], p["s_proj"], p["b_proj"],
                      relu=False)
    return torch.relu(h + skip)


def fused_stage_eligible(blocks: List[Dict], min_channels: int = FUSED_STAGE_MIN_CHANNELS,
                         wkey: str = "w9_a") -> bool:
    """True when a stage's identity blocks qualify for the basic-stage
    kernel: all with both filters of wkey's layout, of one shape, at least
    min_channels wide. wkey "w9_a" reads serving blocks ((9C, C), output
    channels last), "w_a" trainable ones (raw OIHW, output channels first)."""
    if not blocks or not all(wkey in b and wkey.replace("_a", "_b") in b for b in blocks):
        return False
    w = blocks[0][wkey]
    channels = w.shape[-1] if w.ndim == 2 else w.shape[0]
    return channels >= min_channels and len({tuple(b[wkey].shape) for b in blocks}) == 1


def attach_fused_stage_artifacts(params: Dict,
                                 min_channels: int = FUSED_STAGE_MIN_CHANNELS) -> Dict:
    """Attach the stacked "fused" artifact (stack_basic_stage_params) to
    every stage whose identity blocks qualify, its blocks' tensors of the
    same keys becoming views into it (stored once); drop it from a stage
    that does not qualify. Mutates and returns params."""
    for st in params["stages"]:
        if fused_stage_eligible(st["blocks"], min_channels):
            st["fused"] = stack_basic_stage_params(st["blocks"])
            st["blocks"] = basic_block_views(st["fused"], st["blocks"])
        else:
            st.pop("fused", None)
    return params


def basicnet_stages(x: torch.Tensor, stages: List[Dict], precision: str = "f32") -> torch.Tensor:
    """Each stage: its optional stride-2 "entry" block, then its identity
    "blocks", in one basic-stage launch when the stage carries "fused" and
    the map is small; at `precision` ("f32", or "bf16w" on bfloat16
    weights)."""
    for st in stages:
        if st.get("entry") is not None:
            x = downsample_basic_block(x, st["entry"], precision)
        if st.get("fused") is not None and _small_map(x):
            check_precision(precision, st["fused"]["w9_a"], st["fused"]["w9_b"])
            x = basic_stage_fused(x, st["fused"])
        else:
            for b in st["blocks"]:
                x = basic_block(x, b, precision)
    return x


def basicnet_forward(x, params: Dict, device="cuda", precision: str = "f32") -> torch.Tensor:
    """Logits of image(s) x, (H, W, 3) or (N, H, W, 3), on params that live
    on `device`. precision "f32": in the dtype of the params; "bf16w": the
    bf16w tier on parameters from cast_basicnet_bf16w (bfloat16 weights,
    float32 activations and BN), a ValueError on any other weights. CUDA
    runs the kernels; the CPU (only on request) runs their plain
    versions."""
    device = _build.require_device(device)
    dtype = torch.float32 if precision == "bf16w" else params["head"]["w_fc"].dtype
    x, squeeze = _images(x, dtype, device)
    h = stem(x, params["stem"], precision)
    h = basicnet_stages(h, params["stages"], precision)
    logits = head(h, params["head"], precision)
    return logits[0] if squeeze else logits


def basicnet_forward_pre(xb, params: Dict, device="cuda", precision: str = "f32",
                         h: int = 224, w: int = 224) -> torch.Tensor:
    """(N, num_classes) logits from the prepared operand xb (kernels/stem.py::
    stem_prepare_input of N h x w images, float32) on params that live on
    `device`, at `precision` ("f32", or "bf16w" on parameters from
    cast_basicnet_bf16w)."""
    device = _build.require_device(device)
    hh = stem_pre(_prepared(xb, device), params["stem"], precision, h, w)
    hh = basicnet_stages(hh, params["stages"], precision)
    return head(hh, params["head"], precision)


# --- training -------------------------------------------------------------------


def basicnet_forward_train(x, params: Dict, precision=None, device="cuda", *,
                           fused_min_channels: int = FUSED_STAGE_MIN_CHANNELS) -> torch.Tensor:
    """Differentiable logits of image(s) x, (H, W, 3) or (N, H, W, 3), on the
    trainable parameters (raw w_a, w_b OIHW and folded BN; the entry's w_a
    the strided 3x3, w_proj (Cin, Cout)) that live on `device`, through
    kernels/vjp.py: the stem kernel; each stride-1 3x3 direct on maps of at
    most SMALL_MAP_PIXELS, F(2,3) Winograd elsewhere; an entry's strided
    3x3 as a strided im2col through the pointwise Function on
    direct_filter_t(w_a), its projection a subsample through it; an
    identity run on a small map that fused_stage_eligible passes (at
    fused_min_channels, the width serving's attach_fused_stage_artifacts
    was given) through the basic-stage kernel forward; the head FC. The
    JAX package's basicnet_forward_train, its gates kept. At full-width
    ResNet-18, per f32 forward: stem 1, Winograd 10, pointwise 7, direct 1,
    basic_stage 1. precision None or "bf16w"."""
    x = train_input(x, params["head"]["b_fc"], device)
    squeeze = x.dim() == 3
    h = vjp.stem_train_fused(x[None] if squeeze else x, params["stem"], precision)

    def conv3x3(x_, w, s, b, relu):
        if _small_map(x_):
            return vjp.conv3x3_bn_direct_train(x_, w, s, b, relu, precision)
        return vjp.conv3x3_bn_winograd_train(x_, w, s, b, relu, 2, precision)

    for st in params["stages"]:
        e = st.get("entry")
        if e is not None:
            g = vjp.conv1x1_bn_train(strided_im2col(h), vjp.direct_filter_t(e["w_a"]), e["s_a"],
                                     e["b_a"], True, precision)
            g = conv3x3(g, e["w_b"], e["s_b"], e["b_b"], False)
            skip = vjp.conv1x1_bn_train(h[:, ::2, ::2, :], e["w_proj"], e["s_proj"], e["b_proj"],
                                        False, precision)
            h = torch.relu(g + skip)
        blocks = st["blocks"]
        if _small_map(h) and fused_stage_eligible(blocks, fused_min_channels, wkey="w_a"):
            h = vjp.basic_stage_train_streamed(h, blocks, precision)
        else:
            for b in blocks:
                g = conv3x3(h, b["w_a"], b["s_a"], b["b_a"], True)
                g = conv3x3(g, b["w_b"], b["s_b"], b["b_b"], False)
                h = torch.relu(g + h)
    logits = head_train(h, params["head"], precision)
    return logits[0] if squeeze else logits


# --- the int8 tier ------------------------------------------------------------


def quantize_basicnet(params: Dict) -> Dict:
    """The port's f32 parameters -> the int8 tier's (the JAX package's
    quantize_basicnet): int8 weights per output channel, BN and biases f32,
    the stem f32 (it runs at bf16). Each stride-1 3x3 outside a "fused"
    stage also carries the F(2,3) filter its width routes to: bf16 up to
    INT8_BF16_MAX_COUT output channels, else per-position int8
    (quantize_winograd_filter). A "fused" stage gets the stacked int8
    artifact (quantize_basic_stage_params), its blocks as views into it."""

    def q(w, prefix):
        w_q, s_w = quantize_weights(_numpy(w))
        return {f"{prefix}_q": torch.from_numpy(w_q), f"{prefix}_s": torch.from_numpy(s_w)}

    def f32(v):
        return torch.from_numpy(np.asarray(_numpy(v), np.float32))

    def q_block(p, small_map_stage):
        out = {k: f32(p[k]) for k in ("s_a", "b_a", "s_b", "b_b")}
        out.update(q(p["w9_a"], "w9_a"))
        out.update(q(p["w9_b"], "w9_b"))
        for leg in () if small_map_stage else ("a", "b"):
            if f"u2_{leg}" not in p:
                continue
            u2 = np.asarray(_numpy(p[f"u2_{leg}"]), np.float32)
            if p[f"s_{leg}"].shape[0] <= INT8_BF16_MAX_COUT:
                out[f"u2_{leg}_bf16"] = torch.from_numpy(u2).to(torch.bfloat16)
            else:
                u_q, s_u = quantize_winograd_filter(u2)
                out[f"u2_{leg}_q"], out[f"u2_{leg}_s"] = torch.from_numpy(u_q), torch.from_numpy(s_u)
        if "w_proj" in p:
            out.update(q(p["w_proj"], "w_proj"))
            out["s_proj"], out["b_proj"] = f32(p["s_proj"]), f32(p["b_proj"])
        return out

    def q_stage(st):
        small = st.get("fused") is not None
        out = {"entry": None if st.get("entry") is None else q_block(st["entry"], small),
               "blocks": [q_block(b, small) for b in st["blocks"]]}
        if small:
            out["fused"] = quantize_basic_stage_params(st["blocks"])
            out["blocks"] = basic_block_views(out["fused"], out["blocks"])
        return out

    head_q = q(params["head"]["w_fc"], "w_fc")
    return {
        "stem": params["stem"],
        "stages": [q_stage(st) for st in params["stages"]],
        "head": {"w_fc_q": head_q["w_fc_q"], "w_fc_s": head_q["w_fc_s"],
                 "b_fc": f32(params["head"]["b_fc"])},
    }


def _conv3x3_int8(x, p: Dict, leg: str, relu: bool) -> torch.Tensor:
    """The int8 tier's stride-1 3x3, routed by map size and width."""
    if not _small_map(x):
        if p[f"s_{leg}"].shape[0] <= INT8_BF16_MAX_COUT and f"u2_{leg}_bf16" in p:
            return conv3x3_bn_winograd(x, p[f"u2_{leg}_bf16"], p[f"s_{leg}"], p[f"b_{leg}"], relu,
                                       "bf16")
        if f"u2_{leg}_q" in p:
            return conv3x3_bn_winograd_int8(x, p[f"u2_{leg}_q"], p[f"u2_{leg}_s"],
                                            p[f"s_{leg}"], p[f"b_{leg}"], relu)
    return conv3x3_bn_int8(x, p[f"w9_{leg}_q"], p[f"w9_{leg}_s"], p[f"s_{leg}"], p[f"b_{leg}"],
                           relu)


def downsample_basic_block_int8(h: torch.Tensor, e: Dict) -> torch.Tensor:
    """Stride-2 entry basic block at the int8 tier: the strided conv and the
    projection through the int8 pointwise kernel, the b-leg routed by
    _conv3x3_int8."""
    g = conv1x1_bn_int8(strided_im2col(h), e["w9_a_q"], e["w9_a_s"], e["s_a"], e["b_a"], True)
    g = _conv3x3_int8(g, e, "b", False)
    skip = conv1x1_bn_int8(h[:, ::2, ::2, :].contiguous(), e["w_proj_q"], e["w_proj_s"],
                           e["s_proj"], e["b_proj"], False)
    return torch.relu(g + skip)


def basic_block_int8(h: torch.Tensor, b: Dict) -> torch.Tensor:
    """Identity basic block at the int8 tier, per layer."""
    g = _conv3x3_int8(h, b, "a", True)
    g = _conv3x3_int8(g, b, "b", False)
    return torch.relu(g + h)


def basicnet_forward_int8(x, qparams: Dict, device="cuda") -> torch.Tensor:
    """Logits of image(s) x, (H, W, 3) or (N, H, W, 3), at the int8 tier, on
    parameters from quantize_basicnet (or convert.py::
    qbasicnet_params_from_jax) that live on `device`; float32. CUDA runs the
    kernels; the CPU (only on request) runs their plain versions."""
    device = _build.require_device(device)
    x, squeeze = _images(x, torch.float32, device)
    h = stem(x, qparams["stem"], precision="bf16")
    for st in qparams["stages"]:
        if st.get("entry") is not None:
            h = downsample_basic_block_int8(h, st["entry"])
        if st.get("fused") is not None and _small_map(h):
            h = basic_stage_int8(h, st["fused"])
        else:
            for b in st["blocks"]:
                h = basic_block_int8(h, b)
    logits = head_int8(h, qparams["head"])
    return logits[0] if squeeze else logits


# --- seeded parameters ----------------------------------------------------------


def init_basicnet_arrays(cfg, seed: int = 0) -> Dict[str, np.ndarray]:
    """The seeded image "x" and every parameter of the basic-family model as
    one flat dict of numpy arrays, the same draws, in the same order, under
    the same keys as the JAX package's datagen make_basicnet_case (without
    its float64 goldens): stem_w7 / stem_w49 / stem_w192 / stem_scale /
    stem_bias, the stride-2 entry blocks "t{si}_*" (w_a, w9_a, u2_b, w9_b,
    w_proj, ...), the identity blocks "s{si}_b{bi}_*" (w_*, u2_*, w9_*),
    head_wfc / head_bfc."""
    rng = np.random.default_rng(seed)
    shape = (cfg.img, cfg.img, 3) if cfg.batch == 1 else (cfg.batch, cfg.img, cfg.img, 3)
    case = {"x": _rand(rng, *shape)}
    w7 = _rand(rng, cfg.stem_c, 3, 7, 7)
    bn_stem = _bn_params(rng, cfg.stem_c, scale=0.5)
    case.update(stem_w7=w7, stem_w49=stem_filter(w7), stem_w192=stem_filter_s2d(w7),
                stem_scale=bn_stem["scale"], stem_bias=bn_stem["bias"])
    prev = cfg.stem_c
    for si, (c, _hw, blocks) in enumerate(cfg.stages):
        if prev != c:
            e = _basic_entry_params_random(rng, prev, c, bn_scale=0.5)
            case.update({f"t{si}_{k}": v for k, v in e.items()})
            blocks -= 1
        for bi in range(blocks):
            b = _basic_block_params_random(rng, c, bn_scale=0.5)
            case.update({f"s{si}_b{bi}_{k}": v for k, v in b.items()})
        prev = c
    c_last = cfg.stages[-1][0]
    case["head_wfc"] = _rand(rng, c_last, cfg.num_classes, scale=2 * np.sqrt(2.0 / c_last))
    case["head_bfc"] = _rand(rng, cfg.num_classes)
    return case


def basicnet_arrays(case: Dict[str, np.ndarray], cfg) -> Dict:
    """The nested parameter tree {"stem", "stages", "head"}, numpy arrays
    with the raw filters, from a flat case dict (init_basicnet_arrays, or
    datagen's make_basicnet_case): the JAX package's basicnet_params before
    its fused artifacts. The cuDNN baseline (baseline/cudnn.py) runs it as
    it is."""
    def sub(prefix):
        return {k[len(prefix):]: v for k, v in case.items() if k.startswith(prefix)}

    stages = []
    for si in range(len(cfg.stages)):
        blocks, bi = [], 0
        while any(k.startswith(f"s{si}_b{bi}_") for k in case):
            blocks.append(sub(f"s{si}_b{bi}_"))
            bi += 1
        stages.append({"entry": sub(f"t{si}_") or None, "blocks": blocks})
    return {
        "stem": {"w49_stem": case["stem_w49"], "w7_stem": case["stem_w7"],
                 "w192_stem": case.get("stem_w192", stem_filter_s2d(case["stem_w7"])),
                 "s_stem": case["stem_scale"], "b_stem": case["stem_bias"]},
        "stages": stages,
        "head": {"w_fc": case["head_wfc"], "b_fc": case["head_bfc"]},
    }


def basicnet_params(case: Dict[str, np.ndarray], cfg, device="cuda",
                    dtype=torch.float32) -> Dict:
    """The nested forward parameters {"stem", "stages", "head"} from a flat
    case dict (init_basicnet_arrays, or datagen's make_basicnet_case), on
    `device` in `dtype`, with the fused artifacts attached
    (attach_fused_stage_artifacts). The port of the JAX package's
    basicnet_params."""
    device = _build.require_device(device)
    return attach_fused_stage_artifacts(
        basicnet_params_from_jax(basicnet_arrays(case, cfg), device, dtype))
