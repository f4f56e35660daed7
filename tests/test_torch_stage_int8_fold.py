"""The folded quantization of csrc/stage_int8.cu in plain PyTorch
(kernels/quantized.py: abs_bits, row_max_in_pieces, im2col_row_max,
group_row_max, quantize_with_max) against quantize_rows, bit for bit.

The kernel quantizes a GEMM's rows with maxima its producers published in
pieces (one atomicMax of the bits of |y| a row and tile); these tests hold
that arithmetic, on the CPU, to the one-pass row max of the plain versions:
rows split into pieces, the im2col window's max of nine pixel maxima, the
grouped expand's per-group maxima; zero rows, negative values, inf and NaN.
Inputs are made from a seed with numpy."""

import numpy as np
import pytest
import torch

from winograd_tpu_torch.kernels import quantized as q8
from winograd_tpu_torch.kernels.direct import im2col3x3


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous().view(torch.int32)


def _same(a, b):
    """Equal to the bit, a NaN where the other has a NaN (any payload)."""
    a, b = a.float(), b.float()
    assert a.shape == b.shape
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    assert torch.equal(_bits(a[~nan]), _bits(b[~nan]))


def _rows(seed, p, k, specials=True):
    """(p, k) float32 rows: uniform, scaled per row over six decades, a zero
    row, an all-negative row, and (specials) a row with an inf and one with
    a NaN among ordinary values."""
    rng = np.random.default_rng(seed)
    x = (rng.random((p, k)) - 0.5) * 10.0 ** rng.integers(-3, 3, size=(p, 1))
    x[0] = 0.0
    x[1 % p] = -np.abs(x[1 % p])
    if specials:
        x[2 % p, k // 3] = np.inf
        x[3 % p, k // 2] = -np.inf
        x[4 % p, k - 1] = np.nan
    return torch.as_tensor(x.astype(np.float32))


@pytest.mark.parametrize("k,piece", [(256, 64), (100, 64), (300, 128), (64, 64), (8, 3)])
def test_row_max_in_pieces_quantizes_as_one_pass(k, piece):
    x = _rows(0, 9, k)
    want_q, want_s = q8.quantize_rows(x)
    got_q, got_s = q8.quantize_with_max(x, q8.row_max_in_pieces(x, piece))
    _same(got_s, want_s)
    _same(got_q, want_q)


def test_published_bits_order_as_abs_with_nan_on_top():
    v = torch.tensor([0.0, -0.0, 1e-40, -2.5, 3.0, float("inf"), -float("inf"), float("nan")])
    bits = q8.abs_bits(v)
    order = torch.argsort(bits[:-1])
    assert torch.equal(v[:-1].abs()[order], torch.sort(v[:-1].abs()).values)
    assert bits[-1] > bits[:-1].max()
    _same(q8.max_of_bits(bits[:-1].amax()), v[:-1].abs().amax())
    assert torch.isnan(q8.max_of_bits(bits.amax()))


@pytest.mark.parametrize("n,h,w,c", [(1, 5, 5, 8), (2, 4, 7, 12), (3, 1, 1, 4), (1, 3, 2, 16)])
def test_im2col_row_max_is_the_max_of_nine_pixels(n, h, w, c):
    """The direct mid's row: its nine pixels' published maxima give the
    im2col row's max (padding 0), and the quantization is quantize_rows'."""
    x = _rows(1, n * h * w, c).reshape(n, h, w, c)
    cols = im2col3x3(x).reshape(n * h * w, 9 * c)
    pixel = q8.abs_bits(x).amax(dim=-1)
    want_q, want_s = q8.quantize_rows(cols)
    got_q, got_s = q8.quantize_with_max(cols, q8.im2col_row_max(pixel))
    _same(got_s, want_s)
    _same(got_q, want_q)


@pytest.mark.parametrize("groups,piece", [(2, 32), (4, 64), (1, 256)])
def test_group_row_max_quantizes_each_group(groups, piece):
    """The winograd2 route's expand: h2 quantized per row and group of
    Cmid / groups channels, each group's maxima published by items of 32
    channels, as the plain stage quantizes each group's columns."""
    x = _rows(2, 11, 256)
    cg = 256 // groups
    maxima = q8.group_row_max(x, groups)
    for g in range(groups):
        cols = x[:, g * cg:(g + 1) * cg]
        assert torch.equal(maxima[:, g], q8.row_max_in_pieces(cols, piece))
        want_q, want_s = q8.quantize_rows(cols)
        got_q, got_s = q8.quantize_with_max(cols, maxima[:, g])
        _same(got_s, want_s)
        _same(got_q, want_q)


def test_a_nan_row_keeps_a_nan_scale():
    """A NaN anywhere in a row gives the row a NaN scale, as torch.amax gives
    the plain version; the other rows are untouched."""
    x = _rows(3, 6, 40, specials=False)
    x[5, 7] = float("nan")
    _, s = q8.quantize_with_max(x, q8.row_max_in_pieces(x, 16))
    assert torch.isnan(s[5]).all() and not torch.isnan(s[:5]).any()
