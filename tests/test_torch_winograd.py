"""Port's Winograd kernel module against winograd_tpu's
conv3x3_bn_winograd_pallas, F(2,3) and F(4,3), including maps that m does
not divide (the edge tiles clip). JAX runs in interpret mode on the CPU;
the port runs its plain twin (the Winograd algebra on u) in float32.
Bound: 1e-4 * max(1, max|ref|)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from winograd_tpu.kernels import transforms as jax_transforms
from winograd_tpu.kernels.winograd import conv3x3_bn_winograd_pallas
from winograd_tpu_torch.config import PARITY_ATOL
from winograd_tpu_torch.kernels import transforms
from winograd_tpu_torch.kernels.winograd import conv3x3_bn_winograd, tile_size
from winograd_tpu_torch.ops import torch_ops


def _case(seed, n, hw, cin, cout, m):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, hw, hw, cin)) - 0.5).astype(np.float32)
    w = (rng.random((cout, cin, 3, 3)) - 0.5).astype(np.float32)
    scale = (rng.random(cout) * 0.5).astype(np.float32)
    bias = (rng.random(cout) - 0.5).astype(np.float32)
    return x, w, transforms.transform_filter(w, m=m), scale, bias


@pytest.mark.parametrize("m,hw,relu", [(2, 8, True), (2, 7, False), (4, 8, True), (4, 7, True), (4, 6, False)])
def test_winograd_matches_jax(m, hw, relu):
    x, w, u, scale, bias = _case(10 * m + hw, 1, hw, 16, 24, m)
    ref = np.asarray(conv3x3_bn_winograd_pallas(
        *map(jnp.asarray, (x, u, scale, bias)), relu=relu))
    out = conv3x3_bn_winograd(*map(torch.from_numpy, (x, u, scale, bias)), relu=relu).numpy()
    assert out.shape == ref.shape == (1, hw, hw, 24)
    assert np.abs(out - ref).max() <= PARITY_ATOL * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("m", [2, 4])
def test_winograd_matches_direct_conv_batched(m):
    """N=2, 3-D input squeeze, and the algebra against F.conv2d."""
    x, w, u, scale, bias = _case(m, 2, 9, 8, 8, m)
    out = conv3x3_bn_winograd(*map(torch.from_numpy, (x, u, scale, bias)))
    ref = torch_ops.conv3x3_bn_relu(*map(torch.from_numpy, (x, w, scale, bias)))
    torch.testing.assert_close(out, ref, rtol=0, atol=PARITY_ATOL)
    one = conv3x3_bn_winograd(*map(torch.from_numpy, (x[1], u, scale, bias)))
    torch.testing.assert_close(one, out[1], rtol=0, atol=1e-6)


def test_transforms_match_jax_package():
    rng = np.random.default_rng(5)
    w = (rng.random((6, 4, 3, 3)) - 0.5).astype(np.float32)
    for m in (2, 4):
        for ours, theirs in zip(transforms.matrices(m), jax_transforms.matrices(m)):
            np.testing.assert_array_equal(ours, theirs)
        np.testing.assert_array_equal(
            transforms.transform_filter(w, m=m), jax_transforms.transform_filter(w, m=m))
        assert tile_size(torch.from_numpy(transforms.transform_filter(w, m=m))) == m
    args = [(rng.random(6) - 0.5).astype(np.float32) for _ in range(3)] + [
        (rng.random(6) + 5).astype(np.float32)]
    for ours, theirs in zip(transforms.fold_batchnorm(*args), jax_transforms.fold_batchnorm(*args)):
        np.testing.assert_array_equal(ours, theirs)
    with pytest.raises(ValueError):
        tile_size(torch.zeros(25, 4, 4))
