"""Plain PyTorch operators on F.conv2d / matmul, NHWC at every function.

Port of the parts of winograd_tpu/ops/jnp_ops.py that the served ResNet-50
and ResNet-18/34 paths need. This is the vendor-baseline role (cuDNN and cuBLAS on the card;
baseline/cudnn.py runs these with TF32 off); the served path does not
call it, except for maxpool3x3_s2, which the stem's plain twin and the
stem's s2d route use.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1)


def _batched(fn, x, *args, **kw):
    squeeze = x.dim() == 3
    y = fn(x[None] if squeeze else x, *args, **kw)
    return y[0] if squeeze else y


def bn_act(y, scale, bias, relu: bool):
    out = y * scale + bias
    return torch.relu(out) if relu else out


def conv1x1_bn(x, w, scale, bias, relu: bool):
    """x: (..., Cin); w: (Cin, Cout)."""
    return bn_act(torch.matmul(x, w), scale, bias, relu)


def _conv(x, w, scale, bias, relu, stride, pad):
    """x NHWC, w OIHW, pad (left, right, top, bottom) zeros."""
    y = F.conv2d(F.pad(_nchw(x), pad), w, stride=stride)
    return bn_act(_nhwc(y), scale, bias, relu)


def conv3x3_bn_relu(x, w, scale, bias, relu: bool = True):
    """3x3 stride-1 SAME conv + BN (+ReLU); w: (Cout, Cin, 3, 3) OIHW."""
    return _batched(_conv, x, w, scale, bias, relu, 1, (1, 1, 1, 1))


def conv3x3_s2_bn_relu(x, w, scale, bias, relu: bool = True):
    """3x3 stride-2 conv, pad 1 on every side, + BN (+ReLU)."""
    return _batched(_conv, x, w, scale, bias, relu, 2, (1, 1, 1, 1))


def conv7x7_s2_bn_relu(x, w7, scale, bias):
    """Stem conv 7x7/2, pad 3 (one more at the bottom/right of an odd
    extent, ceil(h/2) output) + BN + ReLU; w7: (Cout, Cin, 7, 7)."""
    h, w = x.shape[-3], x.shape[-2]
    pad = (3, 2 + w % 2, 3, 2 + h % 2)
    return _batched(_conv, x, w7, scale, bias, True, 2, pad)


def _maxpool(x):
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(_nchw(x), (1, w % 2, 1, h % 2), value=float("-inf"))
    return _nhwc(F.max_pool2d(xp, 3, 2))


def maxpool3x3_s2(x):
    """3x3/2 max pool, pad 1 top/left and h%2 bottom/right with -inf,
    ceil(h/2) output."""
    return _batched(_maxpool, x)


def stem(x, params):
    """conv7x7/2 + BN + ReLU + maxpool3x3/2; keys w7_stem, s_stem, b_stem."""
    h = conv7x7_s2_bn_relu(x, params["w7_stem"], params["s_stem"], params["b_stem"])
    return maxpool3x3_s2(h)


def head(x, params):
    """Global avgpool + FC logits; keys w_fc (C, classes), b_fc."""
    return torch.matmul(x.mean(dim=(-3, -2)), params["w_fc"]) + params["b_fc"]


def bottleneck_block(x, params):
    """Identity-skip bottleneck with raw OIHW w_mid."""
    p = params
    h = conv1x1_bn(x, p["w_reduce"], p["s_reduce"], p["b_reduce"], True)
    h = conv3x3_bn_relu(h, p["w_mid"], p["s_mid"], p["b_mid"], True)
    h = conv1x1_bn(h, p["w_expand"], p["s_expand"], p["b_expand"], False)
    return torch.relu(h + x)


def downsample_bottleneck_block(x, params, stride: int = 2):
    """ResNet v1.5 transition block (stride 2) or the stride-1 projection
    block; keys as bottleneck_block plus w_proj, s_proj, b_proj."""
    p = params
    h = conv1x1_bn(x, p["w_reduce"], p["s_reduce"], p["b_reduce"], True)
    conv3 = conv3x3_s2_bn_relu if stride == 2 else conv3x3_bn_relu
    h = conv3(h, p["w_mid"], p["s_mid"], p["b_mid"], True)
    h = conv1x1_bn(h, p["w_expand"], p["s_expand"], p["b_expand"], False)
    skip = x[..., ::2, ::2, :] if stride == 2 else x
    skip = conv1x1_bn(skip, p["w_proj"], p["s_proj"], p["b_proj"], False)
    return torch.relu(h + skip)


def basic_block(x, params):
    """Basic block with identity skip (ResNet-18/34): 3x3 + BN + ReLU ->
    3x3 + BN -> add -> ReLU. Keys: w_a/w_b (C, C, 3, 3) OIHW, s_a/b_a,
    s_b/b_b."""
    p = params
    h = conv3x3_bn_relu(x, p["w_a"], p["s_a"], p["b_a"], True)
    h = conv3x3_bn_relu(h, p["w_b"], p["s_b"], p["b_b"], False)
    return torch.relu(h + x)


def downsample_basic_block(x, params):
    """Basic downsampling block: stride-2 3x3 + BN + ReLU -> 3x3 + BN;
    stride-2 1x1 projection shortcut + BN; add -> ReLU. Keys as basic_block
    (w_a is (Cout, Cin, 3, 3)) plus w_proj (Cin, Cout), s_proj, b_proj."""
    p = params
    h = conv3x3_s2_bn_relu(x, p["w_a"], p["s_a"], p["b_a"], True)
    h = conv3x3_bn_relu(h, p["w_b"], p["s_b"], p["b_b"], False)
    skip = conv1x1_bn(x[..., ::2, ::2, :], p["w_proj"], p["s_proj"], p["b_proj"], False)
    return torch.relu(h + skip)
