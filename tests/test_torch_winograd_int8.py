"""The port's int8 Winograd F(2,3) (kernels/quantized.py
conv3x3_bn_winograd_int8) and the bf16-filter F(2,3) (kernels/winograd.py
on a bfloat16 u) against winograd_tpu's conv3x3_bn_winograd_int8_pallas and
conv3x3_bn_winograd_pallas(precision="bf16w"), at narrow widths. JAX runs
in Pallas interpret mode; the port runs its plain twins in float32 on the
CPU. Inputs are made from a seed with numpy.

Bounds: quantize_winograd_filter bit for bit. The int8 Winograd within
1e-3 * max(1, max|ref|): the port transforms V in float64 and rounds once,
JAX sums it in float32, and an ulp of difference may move a V value across
a quantization step (one step is 1/127 of its row's largest value). The
bf16-filter F(2,3) within 1e-4 * max(1, max|ref|): the port's float64
algebra against JAX's hi/lo bf16 split of V (products within 2^-17)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from winograd_tpu.kernels import quantized as jq
from winograd_tpu.kernels.winograd import conv3x3_bn_winograd_pallas
from winograd_tpu_torch.kernels import quantized as tq
from winograd_tpu_torch.kernels import transforms
from winograd_tpu_torch.kernels.winograd import conv3x3_bn_winograd

INT8_RTOL = 1e-3
ATOL = 1e-4


def _close(out, ref, rtol):
    ref, out = np.asarray(ref), np.asarray(out)
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    assert np.abs(out - ref).max() <= rtol * max(1.0, np.abs(ref).max())


def _case(seed, n, h, w, cin, cout):
    rng = np.random.default_rng(seed)
    x = np.abs((rng.random((n, h, w, cin)) - 0.5).astype(np.float32))
    wt = ((rng.random((cout, cin, 3, 3)) - 0.5) * 0.2).astype(np.float32)
    scale = (rng.random(cout) * 0.5 + 0.25).astype(np.float32)
    bias = (rng.random(cout) - 0.5).astype(np.float32)
    return x, transforms.transform_filter(wt, m=2), scale, bias


def test_quantize_winograd_filter_matches_jax_bit_for_bit():
    _, u, _, _ = _case(0, 1, 4, 4, 12, 20)
    u[3, :, 7] = 0.0                                  # a zero column keeps scale 1
    for a, b in zip(tq.quantize_winograd_filter(u), jq.quantize_winograd_filter(u)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# (N, H, W, Cin, Cout): one output tile at Cout 128 over one group and over
# two 128-channel groups; Cin off a multiple of 128 (one group of Cin);
# Cout 256, the quantized V stash over two groups; odd maps.
@pytest.mark.parametrize("n,h,w,cin,cout", [
    (1, 6, 6, 128, 128), (2, 5, 7, 256, 128), (1, 7, 7, 72, 96), (1, 6, 5, 256, 256),
])
@pytest.mark.parametrize("relu", [True, False])
def test_winograd_int8_matches_jax(n, h, w, cin, cout, relu):
    x, u, scale, bias = _case(h * w + cin + cout, n, h, w, cin, cout)
    x[0, 1, 1] = 0.0                                  # a zero pixel
    u_q, s_u = tq.quantize_winograd_filter(u)
    ref = jq.conv3x3_bn_winograd_int8_pallas(
        *map(jnp.asarray, (x, u_q, s_u, scale, bias)), relu=relu)
    out = tq.conv3x3_bn_winograd_int8(*map(torch.from_numpy, (x, u_q, s_u, scale, bias)),
                                      relu=relu)
    _close(out.numpy(), ref, INT8_RTOL)
    assert tq.wino_int8_stash(cout) == (cout > 128)


def test_winograd_int8_matches_jax_at_wide_cin():
    """Nine 128-channel groups (Cin 1152 at Cout 128), wider than the span of
    K the card's kernel stages at once, on a 4x4 map."""
    x, u, scale, bias = _case(1152, 1, 4, 4, 1152, 128)
    u_q, s_u = tq.quantize_winograd_filter(u)
    ref = jq.conv3x3_bn_winograd_int8_pallas(
        *map(jnp.asarray, (x, u_q, s_u, scale, bias)), relu=True)
    out = tq.conv3x3_bn_winograd_int8(*map(torch.from_numpy, (x, u_q, s_u, scale, bias)),
                                      relu=True)
    _close(out.numpy(), ref, INT8_RTOL)
    assert tq.winograd_int8_plan(1, 4, 4, 1152, 128).chunk < 1152


def test_winograd_int8_zero_input_and_ragged_cout():
    x, u, scale, bias = _case(5, 1, 4, 4, 16, 8)
    u_q, s_u = tq.quantize_winograd_filter(u)
    zero = tq.conv3x3_bn_winograd_int8(torch.zeros(1, 4, 4, 16), *map(torch.from_numpy,
                                       (u_q, s_u, scale, bias)), relu=False)
    np.testing.assert_array_equal(zero.numpy(), np.broadcast_to(bias, (1, 4, 4, 8)))
    with pytest.raises(ValueError, match="128"):
        tq.wino_int8_stash(192)


@pytest.mark.parametrize("n,h,w,cin,cout", [(1, 8, 8, 64, 64), (2, 5, 7, 12, 20)])
@pytest.mark.parametrize("relu", [True, False])
def test_winograd_bf16_filter_matches_jax_bf16w(n, h, w, cin, cout, relu):
    x, u, scale, bias = _case(n + h + cin, n, h, w, cin, cout)
    u_bf16 = jnp.asarray(u).astype(jnp.bfloat16)
    ref = conv3x3_bn_winograd_pallas(jnp.asarray(x), u_bf16, jnp.asarray(scale),
                                     jnp.asarray(bias), relu=relu, precision="bf16w")
    out = conv3x3_bn_winograd(torch.from_numpy(x), torch.from_numpy(u).to(torch.bfloat16),
                              torch.from_numpy(scale), torch.from_numpy(bias), relu=relu,
                              precision="bf16")
    _close(out.numpy(), ref, ATOL)
    with pytest.raises(ValueError, match="F\\(2,3\\)"):
        u4 = transforms.transform_filter(np.zeros((cout, cin, 3, 3), np.float32), m=4)
        conv3x3_bn_winograd(torch.from_numpy(x), torch.from_numpy(u4).to(torch.bfloat16),
                            torch.from_numpy(scale), torch.from_numpy(bias), precision="bf16")
