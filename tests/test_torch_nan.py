"""A NaN through the fused ReLU and max-pool: the JAX package's kernels
(Pallas interpret mode on the CPU) keep it, since jnp.maximum(NaN, 0) is
NaN, and so must the port. Here the port's plain versions of pointwise,
stage (both mids), stem, Winograd and the int8 Winograd, which are what the
kernels are held to on the card (tests/test_torch_cuda.py::
test_nan_checks_name_the_kernel_that_launched holds the kernels' fused
ReLU itself). The same seeded input with one NaN goes through both; the
NaN positions must agree, and every other output within the f32 bar
1e-4 * max(1, max|ref|) (the int8 Winograd within its bar against JAX,
1e-3 * max(1, max|ref|): tests/test_torch_winograd_int8.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from winograd_tpu.datagen.generate import _block_params_random
from winograd_tpu.kernels.pointwise import conv1x1_bn_pallas
from winograd_tpu.kernels.quantized import conv3x3_bn_winograd_int8_pallas
from winograd_tpu.kernels.stage import resnet_stage_fused_pallas
from winograd_tpu.kernels.stage import stack_stage_params as jax_stack
from winograd_tpu.kernels.stem import stem_fused_pallas
from winograd_tpu.kernels.winograd import conv3x3_bn_winograd_pallas
from winograd_tpu_torch.config import PARITY_ATOL
from winograd_tpu_torch.kernels import transforms
from winograd_tpu_torch.kernels.pointwise import conv1x1_bn
from winograd_tpu_torch.kernels.quantized import conv3x3_bn_winograd_int8, quantize_winograd_filter
from winograd_tpu_torch.kernels.stage import resnet_stage_fused, stack_stage_params
from winograd_tpu_torch.kernels.stem import stem_fused
from winograd_tpu_torch.kernels.winograd import conv3x3_bn_winograd
from winograd_tpu_torch.models.resnet50 import stem_filter_s2d


def _same_nans(out, ref, rtol=PARITY_ATOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    nan = np.isnan(ref)
    assert nan.any(), "the NaN did not reach the output"
    np.testing.assert_array_equal(np.isnan(out), nan)
    ok = ~nan
    assert np.abs(out[ok] - ref[ok]).max() <= rtol * max(1.0, np.abs(ref[ok]).max())


def _uniform(rng, *shape):
    return (rng.random(shape) - 0.5).astype(np.float32)


@pytest.mark.parametrize("relu", [True, False])
def test_pointwise_keeps_a_nan(relu):
    rng = np.random.default_rng(1)
    x, w = _uniform(rng, 49, 64), _uniform(rng, 64, 40)
    scale, bias = _uniform(rng, 40), _uniform(rng, 40)
    x[17, 5] = np.nan
    ref = conv1x1_bn_pallas(*map(jnp.asarray, (x, w, scale, bias)), relu=relu)
    out = conv1x1_bn(*map(torch.from_numpy, (x, w, scale, bias)), relu=relu)
    _same_nans(out.numpy(), ref)
    assert np.isnan(np.asarray(ref))[17].all()


@pytest.mark.parametrize("mid,hw", [("direct", 7), ("winograd2", 8)])
def test_stage_keeps_a_nan(mid, hw):
    rng = np.random.default_rng(2)
    blocks = [_block_params_random(rng, 32, 8, bn_scale=0.5) for _ in range(2)]
    x = _uniform(rng, 1, hw, hw, 32)
    x[0, 1, 2, 3] = np.nan
    ref = resnet_stage_fused_pallas(jnp.asarray(x), jax_stack(blocks), mid_algo=mid,
                                    precision="highest")
    stacked = stack_stage_params([{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
                                  for b in blocks])
    out = resnet_stage_fused(torch.from_numpy(x), stacked, mid_algo=mid)
    _same_nans(out.numpy(), ref)


def test_stem_keeps_a_nan_through_relu_and_max_pool():
    rng = np.random.default_rng(3)
    x, w7 = _uniform(rng, 32, 32, 3), _uniform(rng, 16, 3, 7, 7)
    scale, bias = (rng.random(16) * 0.5).astype(np.float32), _uniform(rng, 16)
    x[13, 20, 1] = np.nan
    w192 = stem_filter_s2d(w7)
    ref = stem_fused_pallas(*map(jnp.asarray, (x, w192, scale, bias)))
    out = stem_fused(*map(torch.from_numpy, (x, w192, scale, bias)))
    _same_nans(out.numpy(), ref)


@pytest.mark.parametrize("m", [2, 4])
def test_winograd_keeps_a_nan(m):
    rng = np.random.default_rng(4 + m)
    x, w = _uniform(rng, 1, 8, 8, 16), _uniform(rng, 24, 16, 3, 3)
    scale, bias = (rng.random(24) * 0.5).astype(np.float32), _uniform(rng, 24)
    x[0, 3, 4, 7] = np.nan
    u = transforms.transform_filter(w, m=m)
    ref = conv3x3_bn_winograd_pallas(*map(jnp.asarray, (x, u, scale, bias)), relu=True)
    out = conv3x3_bn_winograd(*map(torch.from_numpy, (x, u, scale, bias)), relu=True)
    _same_nans(out.numpy(), ref)


# The int8 Winograd's two scale branches: Cout 128 over two 128-channel
# groups (each group's row scale its own) and Cout 256, JAX's quantized V
# stash (one scale over all of Cin). A NaN in x makes the scale of every V
# row whose transform reads it NaN, so those rows' M; the transforms skip
# zero coefficients, so only the outputs whose inverse reads such a row
# are NaN: fewer than the four tiles' 16 outputs that hold the pixel.
@pytest.mark.parametrize("cin,cout", [(256, 128), (16, 256)])
def test_winograd_int8_keeps_a_nan(cin, cout):
    rng = np.random.default_rng(cin + cout)
    x = np.abs(_uniform(rng, 1, 6, 6, cin))
    w = (_uniform(rng, cout, cin, 3, 3) * 0.2).astype(np.float32)
    scale, bias = (rng.random(cout) * 0.5 + 0.25).astype(np.float32), _uniform(rng, cout)
    x[0, 3, 2, 5] = np.nan
    u_q, s_u = quantize_winograd_filter(transforms.transform_filter(w, m=2))
    ref = conv3x3_bn_winograd_int8_pallas(*map(jnp.asarray, (x, u_q, s_u, scale, bias)),
                                          relu=True)
    out = conv3x3_bn_winograd_int8(*map(torch.from_numpy, (x, u_q, s_u, scale, bias)), relu=True)
    _same_nans(out.numpy(), ref, rtol=1e-3)
    nan_pixels = np.isnan(np.asarray(ref)).any(axis=-1)
    assert np.isnan(np.asarray(ref))[nan_pixels].all() and 0 < nan_pixels.sum() < 16
