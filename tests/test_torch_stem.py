"""Port's stem kernel module against winograd_tpu's stem_fused_pallas
(interpret mode on the CPU) at an even and an odd image side; the port's
w192 layout against the JAX package's; the maxpool against the JAX
package's jnp_ops. Bound: 1e-4 * max(1, max|ref|)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from winograd_tpu.kernels.stem import stem_fused_pallas
from winograd_tpu.models.resnet50 import stem_filter_s2d as jax_stem_filter_s2d
from winograd_tpu.ops import jnp_ops
from winograd_tpu_torch.config import PARITY_ATOL
from winograd_tpu_torch.kernels.stem import stem_fused
from winograd_tpu_torch.models.resnet50 import stem_filter_s2d
from winograd_tpu_torch.ops import torch_ops


def _case(seed, img, cin=3, c=16):
    rng = np.random.default_rng(seed)
    x = (rng.random((img, img, cin)) - 0.5).astype(np.float32)
    w7 = (rng.random((c, cin, 7, 7)) - 0.5).astype(np.float32)
    scale = (rng.random(c) * 0.5).astype(np.float32)
    bias = (rng.random(c) - 0.5).astype(np.float32)
    return x, w7, scale, bias


@pytest.mark.parametrize("img", [32, 30])
def test_stem_matches_jax(img):
    x, w7, scale, bias = _case(img, img)
    w192 = stem_filter_s2d(w7)
    np.testing.assert_array_equal(w192, jax_stem_filter_s2d(w7))
    ref = np.asarray(stem_fused_pallas(*map(jnp.asarray, (x, w192, scale, bias))))
    out = stem_fused(*map(torch.from_numpy, (x, w192, scale, bias))).numpy()
    side = -(-img // 4)
    assert out.shape == ref.shape == (side, side, 16)
    assert np.abs(out - ref).max() <= PARITY_ATOL * max(1.0, np.abs(ref).max())
    # The plain s2d route equals the conv7x7 + maxpool baseline.
    base = torch_ops.stem(torch.from_numpy(x), {
        "w7_stem": torch.from_numpy(w7), "s_stem": torch.from_numpy(scale),
        "b_stem": torch.from_numpy(bias)}).numpy()
    assert np.abs(out - base).max() <= PARITY_ATOL * max(1.0, np.abs(base).max())


@pytest.mark.parametrize("side", [8, 7])
def test_maxpool_matches_jax(side):
    x = np.random.default_rng(side).standard_normal((2, side, side + 1, 4)).astype(np.float32)
    ref = np.asarray(jnp_ops.maxpool3x3_s2(jnp.asarray(x)))
    out = torch_ops.maxpool3x3_s2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, ref)
