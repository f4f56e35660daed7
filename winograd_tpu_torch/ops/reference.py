"""Numpy golden models (float64 accumulation, cast to float32 at the end).

A copy of winograd_tpu/ops/reference.py: the correctness oracle of the port,
independent of PyTorch and of every kernel. The fused ops mirror the
reference's semantics exactly:
* conv3x3 "same" (pad 1) + folded-BN FMA + ReLU — the Winograd cases
  (the reference repo's Kernel128_winograd.cu kernels compute cross-correlation,
  matching cuDNN CUDNN_CROSS_CORRELATION).
* conv1x1 + folded-BN FMA with ReLU optional — the pointwise cases; the
  expand layers have NO ReLU (the reference repo's Kernel128_one.cu:271-272,
  Kernel256_one.cu:273).

Layouts are channels-last (HWC / NHWC), as in the JAX package, the port's
kernels and the reference's input files.
"""

from __future__ import annotations

import numpy as np


def conv3x3_same(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Cross-correlation, 3x3, pad 1, stride 1.

    x: (H, W, Cin) or (N, H, W, Cin); w: (Cout, Cin, 3, 3). Returns same
    spatial shape with Cout channels, float64.
    """
    if x.ndim == 3:
        return conv3x3_same(x[None], w)[0]
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    xp = np.pad(x.astype(np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    out = np.zeros((n, h, wd, cout), dtype=np.float64)
    wk = w.astype(np.float64)
    for r in range(3):
        for s in range(3):
            patch = xp[:, r : r + h, s : s + wd, :]  # (N,H,W,Cin)
            out += np.einsum("nhwc,oc->nhwo", patch, wk[:, :, r, s])
    return out


def conv1x1(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Pointwise conv. x: (..., Cin); w: (Cin, Cout). Returns float64."""
    return x.astype(np.float64) @ w.astype(np.float64)


def bn_act(y: np.ndarray, scale: np.ndarray, bias: np.ndarray, relu: bool) -> np.ndarray:
    """Folded-BN FMA (+ optional ReLU) epilogue on the channel axis."""
    out = y * scale.astype(np.float64) + bias.astype(np.float64)
    if relu:
        out = np.maximum(out, 0.0)
    return out


def conv3x3_bn_relu(x, w, scale, bias, relu: bool = True) -> np.ndarray:
    """Golden model for the Winograd cases. Returns float32."""
    return bn_act(conv3x3_same(x, w), scale, bias, relu).astype(np.float32)


def conv1x1_bn(x, w, scale, bias, relu: bool) -> np.ndarray:
    """Golden model for the pointwise cases. Returns float32."""
    return bn_act(conv1x1(x, w), scale, bias, relu).astype(np.float32)


def conv3x3_stride2(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """SAME-pad stride-2 3x3 cross-correlation = dense conv sampled at even
    positions (output ceil(H/2) x ceil(W/2))."""
    dense = conv3x3_same(x, w)
    return dense[..., ::2, ::2, :] if x.ndim == 4 else dense[::2, ::2, :]


def downsample_bottleneck_block(
    x,
    w_reduce, s_reduce, b_reduce,
    w_mid, s_mid, b_mid,
    w_expand, s_expand, b_expand,
    w_proj, s_proj, b_proj,
    stride: int = 2,
) -> np.ndarray:
    """ResNet v1.5 downsampling bottleneck (golden): stride 2 on the 3x3,
    stride-2 1x1 projection shortcut with BN (no ReLU), float32 out.

    stride=1 is the PROJECTION block (conv2_x's entry in the full ResNet-50:
    channels change, resolution doesn't, the shortcut is a 1x1 projection)."""
    h1 = bn_act(conv1x1(x, w_reduce), s_reduce, b_reduce, relu=True)
    mid = conv3x3_stride2(h1, w_mid) if stride == 2 else conv3x3_same(h1, w_mid)
    h2 = bn_act(mid, s_mid, b_mid, relu=True)
    h3 = bn_act(conv1x1(h2, w_expand), s_expand, b_expand, relu=False)
    if stride == 2:
        x_sub = x[..., ::2, ::2, :] if x.ndim == 4 else x[::2, ::2, :]
    else:
        x_sub = x
    skip = bn_act(conv1x1(x_sub, w_proj), s_proj, b_proj, relu=False)
    return np.maximum(h3 + skip, 0.0).astype(np.float32)


def conv7x7_same(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Cross-correlation, 7x7, pad 3, stride 1 (the ResNet stem filter).
    x: (H, W, Cin) or (N, H, W, Cin); w: (Cout, Cin, 7, 7). float64 out."""
    if x.ndim == 3:
        return conv7x7_same(x[None], w)[0]
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    xp = np.pad(x.astype(np.float64), ((0, 0), (3, 3), (3, 3), (0, 0)))
    out = np.zeros((n, h, wd, cout), dtype=np.float64)
    wk = w.astype(np.float64)
    for r in range(7):
        for s in range(7):
            patch = xp[:, r : r + h, s : s + wd, :]
            out += np.einsum("nhwc,oc->nhwo", patch, wk[:, :, r, s])
    return out


def conv7x7_stride2(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Stride-2 7x7 conv, pad 3 (ResNet stem): the dense conv sampled at
    even positions (output ceil(H/2) x ceil(W/2))."""
    dense = conv7x7_same(x, w)
    return dense[..., ::2, ::2, :] if x.ndim == 4 else dense[::2, ::2, :]


def maxpool3x3_stride2(x: np.ndarray) -> np.ndarray:
    """3x3/2 max pool, pad 1 (the ResNet stem pool): dense 3x3 max with
    -inf padding, sampled at even positions."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    n, h, w, c = x.shape
    xp = np.full((n, h + 2, w + 2, c), -np.inf, dtype=x.dtype)
    xp[:, 1 : h + 1, 1 : w + 1, :] = x
    dense = xp[:, 0:h, 0:w, :]
    for r in range(3):
        for s in range(3):
            if r == 0 and s == 0:
                continue
            dense = np.maximum(dense, xp[:, r : r + h, s : s + w, :])
    out = dense[:, ::2, ::2, :]
    return out[0] if squeeze else out


def stem(x, w7, scale, bias) -> np.ndarray:
    """ResNet-50 stem (golden): 7x7/2 conv + folded-BN + ReLU + 3x3/2
    maxpool. (224, 224, 3) -> (56, 56, 64). float64 out."""
    h = bn_act(conv7x7_stride2(x, w7), scale, bias, relu=True)
    return maxpool3x3_stride2(h)


def head(x, w_fc, b_fc) -> np.ndarray:
    """ResNet-50 head (golden): global average pool + fully-connected.
    (..., H, W, C) -> (..., num_classes) logits, float64 out."""
    pooled = x.astype(np.float64).mean(axis=(-3, -2))
    return pooled @ w_fc.astype(np.float64) + b_fc.astype(np.float64)


def bottleneck_block(
    x,
    w_reduce,
    s_reduce,
    b_reduce,
    w_mid,
    s_mid,
    b_mid,
    w_expand,
    s_expand,
    b_expand,
) -> np.ndarray:
    """ResNet v1 bottleneck with identity skip (golden model), float32 out.

    1x1 reduce (+BN+ReLU) -> 3x3 (+BN+ReLU) -> 1x1 expand (+BN, no ReLU)
    -> add skip -> ReLU.
    """
    h1 = bn_act(conv1x1(x, w_reduce), s_reduce, b_reduce, relu=True)
    h2 = bn_act(conv3x3_same(h1, w_mid), s_mid, b_mid, relu=True)
    h3 = bn_act(conv1x1(h2, w_expand), s_expand, b_expand, relu=False)
    return np.maximum(h3 + x.astype(np.float64), 0.0).astype(np.float32)


def basic_block(
    x,
    w_a, s_a, b_a,
    w_b, s_b, b_b,
) -> np.ndarray:
    """ResNet BASIC block with identity skip (golden model), float32 out —
    the ResNet-18/34 block family: 3x3 (+BN+ReLU) -> 3x3 (+BN, no ReLU) ->
    add skip -> ReLU (torchvision BasicBlock semantics; the reference's
    scope is bottleneck layers only, report.pdf section 1)."""
    h1 = bn_act(conv3x3_same(x, w_a), s_a, b_a, relu=True)
    h2 = bn_act(conv3x3_same(h1, w_b), s_b, b_b, relu=False)
    return np.maximum(h2 + x.astype(np.float64), 0.0).astype(np.float32)


def downsample_basic_block(
    x,
    w_a, s_a, b_a,
    w_b, s_b, b_b,
    w_proj, s_proj, b_proj,
) -> np.ndarray:
    """ResNet BASIC downsampling block (golden), float32 out: stride-2 3x3
    (+BN+ReLU) -> 3x3 (+BN, no ReLU); stride-2 1x1 projection shortcut with
    BN (no ReLU); add -> ReLU (torchvision BasicBlock with downsample)."""
    h1 = bn_act(conv3x3_stride2(x, w_a), s_a, b_a, relu=True)
    h2 = bn_act(conv3x3_same(h1, w_b), s_b, b_b, relu=False)
    x_sub = x[..., ::2, ::2, :] if x.ndim == 4 else x[::2, ::2, :]
    skip = bn_act(conv1x1(x_sub, w_proj), s_proj, b_proj, relu=False)
    return np.maximum(h2 + skip, 0.0).astype(np.float32)
