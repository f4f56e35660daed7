"""Training: autograd Functions whose forward is the serving kernel.

Port of winograd_tpu/kernels/vjp.py (its nine custom VJPs). The forward of
every Function runs the port's serving kernel through its wrapper, inside
Function.forward, so autograd never traces a wrapper (they write their
outputs through ctypes). The backward is PyTorch:

* the per-layer Functions (Conv1x1BnTrain, Conv3x3BnWinogradTrain,
  Conv3x3BnDirectTrain) save (x, w, scale, bias, y). The backward masks the
  gradient by the ReLU (y > 0), recovers the pre-BN activation from y
  (_recover_z) for d(scale), and takes dw as matmuls (the 1x1) or nine
  shifted-patch einsums (_conv3x3_dw). The 3x3s' dx runs the forward kernel
  again, on the spatially flipped, channel-transposed filter with an
  identity BN: csrc/winograd.cu at F(2,3) (winograd_tpu/kernels/vjp.py:
  198-205) or csrc/direct.cu (:245-252). The 1x1's dx is a matmul, as the
  JAX package leaves it to XLA.
* the composites (stem, block, transition, projection, the streamed
  bottleneck and basic stages) save only their input and raw parameters.
  Their backward recomputes the per-layer composition (the Functions
  above) under torch.enable_grad() and differentiates it with
  torch.autograd.grad: the remat pattern of the JAX package's _*_bwd.

Parameters are the raw trainable set: OIHW filters (w_mid, w_a, w_b,
w7_stem) and folded BN; the kernels' layouts (filter_transform,
direct_filter_t, stem_filter_s2d) are derived from them in the forward.

precision: None, the f32 tier; "bf16w", the bf16w tier: the forward runs
the kernels' bf16w instantiations on bfloat16 copies of the float32 master
weights made in the forward (a Winograd filter transformed in float32
first, then cast, as the JAX package orders it). The backward is float32 at
both tiers, so a bf16w step launches both families. On the card the
backward's matmuls are full float32 when TF32 is off (models/train.py runs
the step inside baseline/cudnn.py::full_float32()).

CPU tensors run every kernel's plain version (the tests, and the float64
reference step); CUDA tensors launch the kernels, with no fallback.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from winograd_tpu_torch.kernels import transforms
from winograd_tpu_torch.kernels.basic_stage import basic_stage_fused, stack_basic_stage_params
from winograd_tpu_torch.kernels.block import bottleneck_block_fused
from winograd_tpu_torch.kernels.direct import conv3x3_bn_direct
from winograd_tpu_torch.kernels.pointwise import conv1x1_bn
from winograd_tpu_torch.kernels.stage import (
    WINOGRAD_MIN_PIXELS,
    resnet_stage_fused,
    stack_stage_params,
)
from winograd_tpu_torch.kernels.stem import stem_fused, stem_s2d_cols
from winograd_tpu_torch.kernels.transition import (
    fuse_transition_weights,
    strided_im2col,
    transition_block_fused,
)
from winograd_tpu_torch.kernels.winograd import conv3x3_bn_winograd
from winograd_tpu_torch.ops.torch_ops import maxpool3x3_s2
from winograd_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

# The train functions' precisions (module docstring).
PRECISIONS = (None, "bf16w")


def _check_precision(precision) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown training precision {precision!r}; choose from {PRECISIONS}")


def _tier(w: torch.Tensor, precision) -> torch.Tensor:
    """A weight as the forward at `precision` takes it: a bfloat16 copy at
    "bf16w", else itself."""
    return w.to(torch.bfloat16) if precision == "bf16w" else w


def _bf16w(layer: Dict, keys, precision) -> Dict:
    """`layer` with the weights `keys` as _tier gives them."""
    return {k: _tier(v, precision) if k in keys else v for k, v in layer.items()}


# --- differentiable layouts ----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _g_matrix(m: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """G of F(m,3), copied to the device once (no host copy under a graph
    capture)."""
    return torch.as_tensor(transforms.matrices(m)[1], dtype=dtype, device=device)


def filter_transform(w: torch.Tensor, m: int = 4) -> torch.Tensor:
    """Differentiable G g G^T in w's dtype: (Cout, Cin, 3, 3) -> (a^2, Cin,
    Cout), transforms.transform_filter's layout. The twin of
    winograd_tpu/kernels/vjp.py::filter_transform_jnp."""
    g = _g_matrix(m, w.dtype, w.device)
    a = transforms.alpha(m)
    u = torch.einsum("ar,oirs,bs->aboi", g, w, g)
    cout, cin = w.shape[0], w.shape[1]
    return u.reshape(a * a, cout, cin).transpose(1, 2).contiguous()


def stem_filter_s2d(w7: torch.Tensor) -> torch.Tensor:
    """Differentiable stem s2d GEMM layout: (Cout, Cin, 7, 7) OIHW -> (64*Cin,
    Cout), models/convert.py::stem_filter_s2d's rows ((a, b, u, v, c)): a
    zero tap row and column 7, then a permutation. The twin of
    winograd_tpu/kernels/vjp.py::stem_filter_s2d_jnp."""
    cout, cin = w7.shape[0], w7.shape[1]
    wt = F.pad(w7.permute(2, 3, 1, 0), (0, 0, 0, 0, 0, 1, 0, 1))  # (8, 8, cin, cout)
    wt = wt.reshape(4, 2, 4, 2, cin, cout).permute(0, 2, 1, 3, 4, 5)
    return wt.reshape(64 * cin, cout).contiguous()


def direct_filter_t(w: torch.Tensor) -> torch.Tensor:
    """Differentiable direct_filter: (Cout, Cin, 3, 3) -> (9*Cin, Cout), row
    (3r + s) * Cin + c (kernels/direct.py::direct_filter, which is numpy)."""
    cout, cin = w.shape[0], w.shape[1]
    return w.permute(2, 3, 1, 0).reshape(9 * cin, cout).contiguous()


def _recover_z(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The pre-BN activation from the fused output, z = (y - bias) / scale:
    exact wherever the ReLU-masked gradient is nonzero (winograd_tpu/kernels/
    vjp.py::_recover_z). A zero scale is taken as 1, so its channel gives a
    finite z (and d(scale) stays finite) instead of NaN."""
    s = torch.where(scale == 0, torch.ones_like(scale), scale)
    return (y - bias) / s


def _conv3x3_dw(x: torch.Tensor, gs: torch.Tensor) -> torch.Tensor:
    """dw[o, c, r, s] = sum over n, i, j of gs[n, i, j, o] * xpad[n, i + r,
    j + s, c]: nine shifted-patch einsums; (O, C, 3, 3)."""
    x4 = x if x.dim() == 4 else x[None]
    g4 = gs if gs.dim() == 4 else gs[None]
    h, wd = x4.shape[1], x4.shape[2]
    xpad = F.pad(x4, (0, 0, 1, 1, 1, 1))
    rows = [torch.stack([torch.einsum("nijo,nijc->oc", g4, xpad[:, r:r + h, s:s + wd, :])
                         for s in range(3)], dim=-1) for r in range(3)]
    return torch.stack(rows, dim=-2)


def _bn_grads(y, scale, bias, g):
    """d(scale) and d(bias) of y = z * scale + bias, z recovered from y."""
    z = _recover_z(y, scale, bias)
    c = g.shape[-1]
    return (z * g).reshape(-1, c).sum(0), g.reshape(-1, c).sum(0)


def _masked(g: torch.Tensor, y: torch.Tensor, relu: bool) -> torch.Tensor:
    return torch.where(y > 0, g, torch.zeros_like(g)) if relu else g


def _identity_bn(c: int, like: torch.Tensor):
    ones = torch.ones(c, dtype=like.dtype, device=like.device)
    return ones, torch.zeros_like(ones)


# --- per-layer Functions --------------------------------------------------------


class Conv1x1BnTrain(torch.autograd.Function):
    """Fused 1x1 conv + BN (+ReLU): forward kernels/pointwise.py::conv1x1_bn
    (its bf16w instantiation on a bf16 copy of w at "bf16w"); backward
    dx = gs w^T, dw = x^T gs, d(scale), d(bias). The port of
    winograd_tpu/kernels/vjp.py::conv1x1_bn_train."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, relu, precision):
        x = x.contiguous()
        y = conv1x1_bn(x, _tier(w, precision), scale, bias, relu)
        ctx.relu = relu
        ctx.save_for_backward(x, w, scale, bias, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, scale, bias, y = ctx.saved_tensors
        g = _masked(g, y, ctx.relu)
        gs = g * scale
        cin, cout = w.shape
        need = ctx.needs_input_grad
        dx = torch.matmul(gs, w.t()) if need[0] else None
        dw = torch.matmul(x.reshape(-1, cin).t(), gs.reshape(-1, cout)) if need[1] else None
        dscale, dbias = _bn_grads(y, scale, bias, g)
        return dx, dw, dscale, dbias, None, None


def conv1x1_bn_train(x, w, scale, bias, relu: bool, precision=None) -> torch.Tensor:
    """Differentiable fused 1x1 conv + BN (+ReLU). x: (..., Cin); w: (Cin,
    Cout) float32 (the master weight at either precision)."""
    _check_precision(precision)
    return Conv1x1BnTrain.apply(x, w, scale, bias, bool(relu), precision)


def _flipped(w: torch.Tensor) -> torch.Tensor:
    """The data gradient's filter: w spatially flipped, channels transposed,
    (Cin, Cout, 3, 3)."""
    return w.flip((2, 3)).transpose(0, 1)


def _conv3x3_grads(ctx, g, data_gradient):
    """The 3x3 Functions' backward: dx = data_gradient(gs, w), the forward
    kernel on _flipped(w) with an identity BN; dw by _conv3x3_dw; d(scale),
    d(bias)."""
    x, w, scale, bias, y = ctx.saved_tensors
    g = _masked(g, y, ctx.relu)
    gs = (g * scale).contiguous()
    dx = data_gradient(gs, w) if ctx.needs_input_grad[0] else None
    dw = _conv3x3_dw(x, gs) if ctx.needs_input_grad[1] else None
    return (dx, dw, *_bn_grads(y, scale, bias, g))


def _winograd_dx(gs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    one, zero = _identity_bn(w.shape[1], gs)
    return conv3x3_bn_winograd(gs, filter_transform(_flipped(w), 2), one, zero, relu=False)


def _direct_dx(gs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    one, zero = _identity_bn(w.shape[1], gs)
    return conv3x3_bn_direct(gs, direct_filter_t(_flipped(w)), one, zero, relu=False)


class Conv3x3BnWinogradTrain(torch.autograd.Function):
    """Fused 3x3 conv + BN (+ReLU) by Winograd F(m,3): forward
    kernels/winograd.py::conv3x3_bn_winograd on filter_transform(w, m) (at
    "bf16w" transformed in float32, then cast: the bf16w route, F(2,3)
    only); backward dx through the same kernel at F(2,3) on the flipped,
    transposed filter with an identity BN, dw by _conv3x3_dw. The port of
    winograd_tpu/kernels/vjp.py::conv3x3_bn_winograd_train."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, relu, m, precision):
        x = x.contiguous()
        u = _tier(filter_transform(w, m), precision)
        y = conv3x3_bn_winograd(x, u, scale, bias, relu, "bf16w" if precision else "f32")
        ctx.relu = relu
        ctx.save_for_backward(x, w, scale, bias, y)
        return y

    @staticmethod
    def backward(ctx, g):
        return _conv3x3_grads(ctx, g, _winograd_dx) + (None, None, None)


def conv3x3_bn_winograd_train(x, w, scale, bias, relu: bool = True, m: int = 4,
                              precision=None) -> torch.Tensor:
    """Differentiable fused 3x3 Winograd conv + BN (+ReLU). x: (H, W, Cin)
    or (N, H, W, Cin); w: the raw (Cout, Cin, 3, 3) filter."""
    _check_precision(precision)
    return Conv3x3BnWinogradTrain.apply(x, w, scale, bias, bool(relu), int(m), precision)


class Conv3x3BnDirectTrain(torch.autograd.Function):
    """Fused 3x3 conv + BN (+ReLU) through the direct implicit GEMM: forward
    kernels/direct.py::conv3x3_bn_direct on direct_filter_t(w) (bf16 at
    "bf16w"); backward dx through the same kernel on the flipped,
    transposed filter with an identity BN, dw by _conv3x3_dw. The port of
    winograd_tpu/kernels/vjp.py::conv3x3_bn_direct_train."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, relu, precision):
        x = x.contiguous()
        y = conv3x3_bn_direct(x, _tier(direct_filter_t(w), precision), scale, bias, relu)
        ctx.relu = relu
        ctx.save_for_backward(x, w, scale, bias, y)
        return y

    @staticmethod
    def backward(ctx, g):
        return _conv3x3_grads(ctx, g, _direct_dx) + (None, None)


def conv3x3_bn_direct_train(x, w, scale, bias, relu: bool = True, precision=None) -> torch.Tensor:
    """Differentiable fused 3x3 conv + BN (+ReLU), direct implicit GEMM.
    x: (H, W, Cin) or (N, H, W, Cin); w: the raw (Cout, Cin, 3, 3) filter."""
    _check_precision(precision)
    return Conv3x3BnDirectTrain.apply(x, w, scale, bias, bool(relu), precision)


# --- the rematerializing composites -------------------------------------------


class _Remat(torch.autograd.Function):
    """forward(x, tree) runs a fused kernel; the backward recomputes
    math(x, tree), the per-layer composition of the same function, under
    enable_grad and differentiates it. Saves only x and the tree's leaves."""

    @staticmethod
    def forward(ctx, forward, math, like, x, *leaves):
        ctx.math, ctx.like = math, like
        ctx.save_for_backward(x, *leaves)
        return forward(x.contiguous(), tree_unflatten(like, list(leaves)))

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            y = ctx.math(inputs[0], tree_unflatten(ctx.like, inputs[1:]))
            grads = iter(torch.autograd.grad(
                y, [t for t, n in zip(inputs, need) if n], g, allow_unused=True))
        return (None, None, None) + tuple(next(grads) if n else None for n in need)


def _remat(forward: Callable, math: Callable, x: torch.Tensor, tree) -> torch.Tensor:
    """_Remat on x, one image (H, W, C) or a batch, and the parameter tree."""
    squeeze = x.dim() == 3
    out = _Remat.apply(forward, math, tree_map(lambda _: 0, tree), x[None] if squeeze else x,
                       *tree_leaves(tree))
    return out[0] if squeeze else out


def _stem_forward(x, p, precision=None):
    w192 = _tier(stem_filter_s2d(p["w7_stem"]), precision)
    return stem_fused(x, w192, p["s_stem"], p["b_stem"], precision or "f32")


def _stem_math(x, p):
    """The s2d patch matrix, conv + BN + ReLU through Conv1x1BnTrain, the
    maxpool (ops/torch_ops.py::maxpool3x3_s2: -inf pads 1 top/left and
    h % 2 bottom/right, as the JAX package's, so gradients route alike)."""
    cols = stem_s2d_cols(x)
    h = conv1x1_bn_train(cols, stem_filter_s2d(p["w7_stem"]), p["s_stem"], p["b_stem"], True)
    return maxpool3x3_s2(h)


def stem_train_fused(x, params: Dict, precision=None) -> torch.Tensor:
    """Differentiable ResNet stem whose forward is the fused stem kernel
    (kernels/stem.py::stem_fused on stem_filter_s2d(w7_stem)); params
    {w7_stem, s_stem, b_stem}. The backward differentiates the s2d route
    (_stem_math). winograd_tpu/kernels/vjp.py::stem_train_fused."""
    _check_precision(precision)
    return _remat(functools.partial(_stem_forward, precision=precision), _stem_math, x, params)


def _block_forward(x, p, precision=None):
    kp = dict(p)
    kp["w9_mid"] = direct_filter_t(p["w_mid"])
    # Both layouts, so the block kernel's mid choice (F(2,3) on large maps)
    # is serving's.
    kp["u2_mid"] = filter_transform(p["w_mid"], 2)
    return bottleneck_block_fused(
        x, _bf16w(kp, ("w_reduce", "w9_mid", "u2_mid", "w_expand"), precision))


def _bottleneck_math(x, p, skip=None, mid: str = "winograd"):
    """1x1 reduce, the 3x3 (F(2,3), or direct), 1x1 expand, then the skip
    (x itself when None) and ReLU, through the per-layer Functions."""
    h = conv1x1_bn_train(x, p["w_reduce"], p["s_reduce"], p["b_reduce"], True)
    if mid == "winograd":
        h = conv3x3_bn_winograd_train(h, p["w_mid"], p["s_mid"], p["b_mid"], True, 2)
    else:
        h = conv3x3_bn_direct_train(h, p["w_mid"], p["s_mid"], p["b_mid"], True)
    h = conv1x1_bn_train(h, p["w_expand"], p["s_expand"], p["b_expand"], False)
    return torch.relu(h + (x if skip is None else skip))


def bottleneck_block_train_fused(x, params: Dict, precision=None) -> torch.Tensor:
    """Differentiable identity bottleneck whose forward is the block kernel
    (kernels/block.py::bottleneck_block_fused, w9_mid and u2_mid derived
    from the raw w_mid). The backward differentiates the per-layer
    composition, its mid through Conv3x3BnWinogradTrain at F(2,3).
    winograd_tpu/kernels/vjp.py::bottleneck_block_train_fused."""
    _check_precision(precision)
    return _remat(functools.partial(_block_forward, precision=precision), _bottleneck_math,
                  x, params)


def _transition_forward(x, p, precision=None):
    kp = dict(p)
    kp["w9_mid"] = direct_filter_t(p["w_mid"])
    # Folded in float32, then cast (the JAX kernel's order at bf16w).
    kp["wep"], kp["bep"] = fuse_transition_weights(kp)
    return transition_block_fused(x, _bf16w(kp, ("w_reduce", "w9_mid", "wep"), precision))


def _transition_math(x, p):
    """The stride-2 transition per layer: reduce, the strided 3x3 as a
    strided im2col through Conv1x1BnTrain on direct_filter_t(w_mid),
    expand, the subsampled projection; add, ReLU."""
    h = conv1x1_bn_train(x, p["w_reduce"], p["s_reduce"], p["b_reduce"], True)
    h = conv1x1_bn_train(strided_im2col(h), direct_filter_t(p["w_mid"]), p["s_mid"],
                         p["b_mid"], True)
    h = conv1x1_bn_train(h, p["w_expand"], p["s_expand"], p["b_expand"], False)
    skip = conv1x1_bn_train(x[:, ::2, ::2, :], p["w_proj"], p["s_proj"], p["b_proj"], False)
    return torch.relu(h + skip)


def transition_block_train_fused(x, params: Dict, precision=None) -> torch.Tensor:
    """Differentiable stride-2 transition whose forward is the transition
    kernel (kernels/transition.py::transition_block_fused, w9_mid from the
    raw w_mid, the expand and projection folded into wep/bep). The backward
    differentiates _transition_math.
    winograd_tpu/kernels/vjp.py::transition_block_train_fused."""
    _check_precision(precision)
    return _remat(functools.partial(_transition_forward, precision=precision),
                  _transition_math, x, params)


def _projection_forward(x, p, precision=None):
    from winograd_tpu_torch.models.downsample import projection_bottleneck_block

    kp = dict(p)
    kp["u2_mid"] = filter_transform(p["w_mid"], 2)
    kp = _bf16w(kp, ("w_reduce", "u2_mid", "w_expand", "w_proj"), precision)
    return projection_bottleneck_block(x, kp, precision or "f32")


def _projection_math(x, p):
    skip = conv1x1_bn_train(x, p["w_proj"], p["s_proj"], p["b_proj"], False)
    return _bottleneck_math(x, p, skip)


def projection_block_train_fused(x, params: Dict, precision=None) -> torch.Tensor:
    """Differentiable stride-1 projection bottleneck (conv2_x's entry) whose
    forward is the serving composition (models/downsample.py::
    projection_bottleneck_block, u2_mid from the raw w_mid). The backward
    differentiates the per-layer composition with the projection's 1x1.
    winograd_tpu/kernels/vjp.py::projection_block_train_fused."""
    _check_precision(precision)
    return _remat(functools.partial(_projection_forward, precision=precision),
                  _projection_math, x, params)


def _large_map(x: torch.Tensor) -> bool:
    return x.shape[-3] * x.shape[-2] >= WINOGRAD_MIN_PIXELS


def _stage_forward(x, blocks: List[Dict], precision=None):
    kps = []
    for b in blocks:
        kp = dict(b)
        kp["w9_mid"] = direct_filter_t(b["w_mid"])
        if _large_map(x):
            # The F(2,3) layout only where the stage kernel runs it.
            kp["u2_mid"] = filter_transform(b["w_mid"], 2)
        kps.append(_bf16w(kp, ("w_reduce", "w9_mid", "u2_mid", "w_expand"), precision))
    return resnet_stage_fused(x, stack_stage_params(kps))


def _stage_math(x, blocks: List[Dict]):
    """The blocks' per-layer compositions chained, each mid on the stage
    kernel's route: F(2,3) from WINOGRAD_MIN_PIXELS up, direct below."""
    mid = "winograd" if _large_map(x) else "direct"
    for p in blocks:
        x = _bottleneck_math(x, p, mid=mid)
    return x


def resnet_stage_train_streamed(x, blocks: List[Dict], precision=None) -> torch.Tensor:
    """Differentiable run of identity bottlenecks whose forward is the stage
    kernel (kernels/stage.py::resnet_stage_fused over all of them; w9_mid,
    and u2_mid on maps of WINOGRAD_MIN_PIXELS and up, from each raw w_mid).
    The backward chains the blocks' per-layer compositions (_stage_math).
    winograd_tpu/kernels/vjp.py::resnet_stage_train_streamed."""
    _check_precision(precision)
    return _remat(functools.partial(_stage_forward, precision=precision), _stage_math,
                  x, list(blocks))


def _basic_stage_forward(x, blocks: List[Dict], precision=None):
    kps = [_bf16w({"w9_a": direct_filter_t(b["w_a"]), "s_a": b["s_a"], "b_a": b["b_a"],
                   "w9_b": direct_filter_t(b["w_b"]), "s_b": b["s_b"], "b_b": b["b_b"]},
                  ("w9_a", "w9_b"), precision) for b in blocks]
    return basic_stage_fused(x, stack_basic_stage_params(kps))


def _basic_stage_math(x, blocks: List[Dict]):
    for p in blocks:
        h = conv3x3_bn_direct_train(x, p["w_a"], p["s_a"], p["b_a"], True)
        h = conv3x3_bn_direct_train(h, p["w_b"], p["s_b"], p["b_b"], False)
        x = torch.relu(h + x)
    return x


def basic_stage_train_streamed(x, blocks: List[Dict], precision=None) -> torch.Tensor:
    """Differentiable run of identity basic blocks whose forward is the
    basic-stage kernel (kernels/basic_stage.py::basic_stage_fused, w9_a and
    w9_b from the raw w_a, w_b). The backward chains the direct-conv
    Functions. winograd_tpu/kernels/vjp.py::basic_stage_train_streamed."""
    _check_precision(precision)
    return _remat(functools.partial(_basic_stage_forward, precision=precision),
                  _basic_stage_math, x, list(blocks))
