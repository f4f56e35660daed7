"""Fused ResNet stem: 7x7/2 conv + BN + ReLU + 3x3/2 maxpool.

Port of winograd_tpu/kernels/stem.py::stem_fused_pallas and, for the
prepared-input contract, ::stem_prepare_input and ::stem_fused_pallas_pre.
The CUDA kernel is csrc/stem.cu. stem_fused reads the raw NHWC image.
stem_prepare_input is the host side of the prepared-input contract: it
builds, on the CPU, the operand csrc/stem.cu's second entry reads (the image
zero-padded by 3 on every side, its channels zero-padded to a multiple of 4,
float32: one 16-byte load per 4 channels of a pixel on the card), and
stem_fused_pre runs the stem on it, equal to stem_fused on the same image to
the bit on either device. The TPU operand's space-to-depth relayout and
128-lane K padding exist for the TPU's tiling and are not copied. The plain
twin takes the
space-to-depth route of the JAX package (pad, s2d by the stride, the 4x4
cell neighbourhood as a 64*Cin patch matrix, one matmul with w192), then
BN, ReLU and the maxpool. Precision "f32" is the f32 tier's stem; "bf16"
(the int8 tier's, the JAX package's stem_fused_pallas(precision="bf16"))
rounds the image and w192 to bf16; the kernel sums their exact products
in FP64 and rounds once, and the plain twin does the matmul in float64, so
the two agree to the bit. "bf16w" (the bf16w tier's,
stem_fused_pallas(precision="bf16w")) takes a bfloat16 w192 and the f32
image as it is: the kernel reads w192 at half the bytes and sums the exact
products in FP64, the plain twin is the float64 matmul of the same values
(the JAX kernel's hi/lo split of the image is within ~2^-17 of exact).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.ops.torch_ops import maxpool3x3_s2


def stem_s2d_cols(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, ceil(H/2), ceil(W/2), 64*C): the stride-2 7x7
    patch matrix in the row order of w192 ((a, b, u, v, c))."""
    n, h, w, c = x.shape
    ho, wo = -(-h // 2), -(-w // 2)
    hp, wp = 2 * (ho + 3), 2 * (wo + 3)
    xp = F.pad(x, (0, 0, 3, wp - 3 - w, 3, hp - 3 - h))
    s2d = xp.reshape(n, hp // 2, 2, wp // 2, 2, c)
    s2d = s2d.permute(0, 1, 3, 2, 4, 5).reshape(n, hp // 2, wp // 2, 4 * c)
    return torch.cat(
        [s2d[:, a : a + ho, b : b + wo, :] for a in range(4) for b in range(4)],
        dim=-1,
    )


# The C entry's precision argument is the index in this tuple.
PRECISIONS = ("f32", "bf16", "bf16w")


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def stem_fused_plain(x, w192, scale, bias, precision: str = "f32") -> torch.Tensor:
    """s2d patch matmul, BN, ReLU, 3x3/2 maxpool. x: (N, H, W, Cin)."""
    if precision == "bf16":
        cols = stem_s2d_cols(_round_bf16(x)).double()
        y = torch.matmul(cols, _round_bf16(w192).double()).to(x.dtype)
    elif precision == "bf16w":
        y = torch.matmul(stem_s2d_cols(x).double(), w192.double()).to(x.dtype)
    else:
        y = torch.matmul(stem_s2d_cols(x), w192)
    y = torch.relu(y * scale + bias)
    return maxpool3x3_s2(y)


@_build.checked("stem", "stem_bf16w")
def stem_fused(x, w192, scale, bias, precision: str = "f32") -> torch.Tensor:
    """Whole stem, (H, W, Cin) or (N, H, W, Cin) -> (..., ceil(H/4),
    ceil(W/4), C).

    w192: (64*Cin, C), models/resnet50.py::stem_filter_s2d(w7), bfloat16 at
    "bf16w" and float32 else; precision "f32", "bf16" or "bf16w"
    (PRECISIONS); x float32. CPU tensors run the plain version; CUDA tensors
    launch csrc/stem.cu, counted as "stem_bf16w" at "bf16w"."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown stem precision {precision!r}; choose from {PRECISIONS}")
    if (w192.dtype == torch.bfloat16) != (precision == "bf16w"):
        raise ValueError(f"w192 {w192.dtype} at precision {precision!r}: bfloat16 weights are "
                         "the 'bf16w' precision's, and only its")
    if precision == "bf16w":
        _build.check_bf16w(x)
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    n, h, w, cin = x.shape
    if w192.shape[0] != 64 * cin:
        raise ValueError(f"w192 {tuple(w192.shape)} does not take {cin} input channels")
    if x.device.type == "cpu":
        out = stem_fused_plain(x, w192, scale, bias, precision)
    else:
        c = w192.shape[1]
        _build.check_operands(scale, bias, c, x)
        _build.check_tensors(
            w192, dtype=torch.bfloat16 if precision == "bf16w" else torch.float32,
            device=x.device)
        po, qo = -(-h // 4), -(-w // 4)
        out = torch.empty(n, po, qo, c, device=x.device, dtype=torch.float32)
        i = _build.cint
        _build.launch(
            "stem", "stem_conv7x7_bn_relu_maxpool", (n, h, w, cin, c, precision), x.device,
            _build.ptr(x), _build.ptr(w192), _build.ptr(scale), _build.ptr(bias),
            _build.ptr(out), i(n), i(h), i(w), i(cin), i(c), i(PRECISIONS.index(precision)),
            counter="stem_bf16w" if precision == "bf16w" else None,
        )
    return out[0] if squeeze else out


# The prepared operand pads the image by the conv's 3 on every side.
PRE_PAD = 3


def _pre_channels(cin: int) -> int:
    return -(-cin // 4) * 4


def stem_prepare_input(x, precision: str = "f32") -> torch.Tensor:
    """The prepared-input contract, host side: raw image(s) (H, W, Cin) or
    (N, H, W, Cin), a numpy array or a tensor, -> the CPU float32 tensor
    (N, H + 6, W + 6, C4) that stem_fused_pre reads: the image zero-padded
    by PRE_PAD on every side, its channels zero-padded to C4, Cin rounded up
    to a multiple of 4. At precision "bf16" (the int8 tier's) the values are
    rounded to bf16 first, as the stem rounds them."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown stem precision {precision!r}; choose from {PRECISIONS}")
    x = torch.as_tensor(x).detach().to(device="cpu", dtype=torch.float32)
    if x.dim() == 3:
        x = x[None]
    if precision == "bf16":
        x = _round_bf16(x)
    cin = x.shape[-1]
    return F.pad(x, (0, _pre_channels(cin) - cin) + (PRE_PAD, PRE_PAD) * 2).contiguous()


def _check_pre(xb: torch.Tensor, h: int, w: int, cin: int) -> None:
    want = (h + 2 * PRE_PAD, w + 2 * PRE_PAD, _pre_channels(cin))
    if xb.dim() != 4 or tuple(xb.shape[1:]) != want or xb.dtype != torch.float32:
        raise ValueError(f"prepared operand {tuple(xb.shape)} {xb.dtype} is not the float32 "
                         f"(N, {want[0]}, {want[1]}, {want[2]}) of an {h}x{w}x{cin} image "
                         "(stem_prepare_input)")


def stem_fused_pre_plain(xb, w192, scale, bias, h: int, w: int,
                         precision: str = "f32") -> torch.Tensor:
    """The image cut back out of the prepared operand, then stem_fused_plain."""
    cin = w192.shape[0] // 64
    x = xb[:, PRE_PAD:PRE_PAD + h, PRE_PAD:PRE_PAD + w, :cin]
    return stem_fused_plain(x, w192, scale, bias, precision)


@_build.checked("stem_pre", "stem_pre_bf16w")
def stem_fused_pre(xb, w192, scale, bias, h: int, w: int,
                   precision: str = "f32") -> torch.Tensor:
    """The stem on a prepared operand (stem_prepare_input) of an h x w
    image: (N, h + 6, w + 6, C4) -> (N, ceil(h/4), ceil(w/4), C), equal to
    stem_fused on the image to the bit. w192, scale, bias and precision as
    stem_fused takes them. CPU tensors run the plain version; CUDA tensors
    launch csrc/stem.cu's stem_pre_conv7x7_bn_relu_maxpool, counted as
    "stem_pre" ("stem_pre_bf16w" at "bf16w")."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown stem precision {precision!r}; choose from {PRECISIONS}")
    if (w192.dtype == torch.bfloat16) != (precision == "bf16w"):
        raise ValueError(f"w192 {w192.dtype} at precision {precision!r}: bfloat16 weights are "
                         "the 'bf16w' precision's, and only its")
    cin = w192.shape[0] // 64
    if w192.shape[0] != 64 * cin:
        raise ValueError(f"w192 {tuple(w192.shape)} is not (64 * Cin, C)")
    _check_pre(xb, h, w, cin)
    if xb.device.type == "cpu":
        return stem_fused_pre_plain(xb, w192, scale, bias, h, w, precision)
    n, c = xb.shape[0], w192.shape[1]
    _build.check_operands(scale, bias, c, xb)
    _build.check_tensors(
        w192, dtype=torch.bfloat16 if precision == "bf16w" else torch.float32, device=xb.device)
    out = torch.empty(n, -(-h // 4), -(-w // 4), c, device=xb.device, dtype=torch.float32)
    i = _build.cint
    _build.launch(
        "stem", "stem_pre_conv7x7_bn_relu_maxpool", (n, h, w, cin, c, precision), xb.device,
        _build.ptr(xb), _build.ptr(w192), _build.ptr(scale), _build.ptr(bias), _build.ptr(out),
        i(n), i(h), i(w), i(cin), i(c), i(PRECISIONS.index(precision)),
        counter="stem_pre_bf16w" if precision == "bf16w" else "stem_pre",
    )
    return out
