"""Port's direct 3x3 kernel module against winograd_tpu's
conv3x3_bn_direct_pallas (interpret mode on the CPU), and the port's
direct_filter against the JAX package's. Bound: 1e-4 * max(1, max|ref|)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from winograd_tpu.kernels.direct import conv3x3_bn_direct_pallas
from winograd_tpu.kernels.direct import direct_filter as jax_direct_filter
from winograd_tpu_torch.config import PARITY_ATOL
from winograd_tpu_torch.kernels.direct import conv3x3_bn_direct, direct_filter
from winograd_tpu_torch.ops import torch_ops


def _case(seed, n, h, w, cin, cout):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, h, w, cin)) - 0.5).astype(np.float32)
    wt = (rng.random((cout, cin, 3, 3)) - 0.5).astype(np.float32)
    scale = (rng.random(cout) * 0.5).astype(np.float32)
    bias = (rng.random(cout) - 0.5).astype(np.float32)
    return x, wt, scale, bias


@pytest.mark.parametrize("hw,relu", [(7, True), (7, False), (5, True)])
def test_direct_matches_jax(hw, relu):
    x, wt, scale, bias = _case(hw, 1, hw, hw, 16, 32)
    w9 = direct_filter(wt)
    np.testing.assert_array_equal(w9, np.asarray(jax_direct_filter(wt)))
    ref = np.asarray(conv3x3_bn_direct_pallas(
        *map(jnp.asarray, (x, w9, scale, bias)), relu=relu))
    out = conv3x3_bn_direct(*map(torch.from_numpy, (x, w9, scale, bias)), relu=relu).numpy()
    assert out.shape == ref.shape == (1, hw, hw, 32)
    assert np.abs(out - ref).max() <= PARITY_ATOL * max(1.0, np.abs(ref).max())


def test_direct_matches_conv2d_on_rectangular_batch():
    x, wt, scale, bias = _case(1, 2, 6, 9, 8, 12)
    out = conv3x3_bn_direct(*map(torch.from_numpy, (x, direct_filter(wt), scale, bias)))
    ref = torch_ops.conv3x3_bn_relu(*map(torch.from_numpy, (x, wt, scale, bias)))
    torch.testing.assert_close(out, ref, rtol=0, atol=PARITY_ATOL)
    with pytest.raises(ValueError):
        conv3x3_bn_direct(torch.from_numpy(x), torch.zeros(9 * 4, 12),
                          *map(torch.from_numpy, (scale, bias)))
