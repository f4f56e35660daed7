"""The port's transition kernel module against winograd_tpu's
transition_block_fused_pallas, on an even and an odd map, and its offline
weight fusion against fuse_transition_weights. JAX runs in Pallas interpret
mode; the port runs its plain twin in float32. Bound: 1e-4 * max(1,
max|ref|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from winograd_tpu.config import TransitionConfig
from winograd_tpu.datagen.generate import _transition_params_random
from winograd_tpu.kernels.transition import fuse_transition_weights as jax_fuse
from winograd_tpu.kernels.transition import transition_block_fused_pallas
from winograd_tpu_torch.config import PARITY_ATOL
from winograd_tpu_torch.kernels.transition import (
    fuse_transition_weights,
    transition_block_fused,
)
from winograd_tpu_torch.models.downsample import downsample_bottleneck_block


def _case(seed, n, hw, c_in=32, c_mid=16, c_out=64):
    rng = np.random.default_rng(seed)
    params = _transition_params_random(
        rng, TransitionConfig("t", c_in, c_mid, c_out, hw=hw), bn_scale=0.5)
    x = (rng.random((n, hw, hw, c_in)) - 0.5).astype(np.float32)
    return x, params


def _torch(params):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}


def _close(out, ref):
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    assert np.abs(np.asarray(out) - ref).max() <= PARITY_ATOL * max(1.0, np.abs(ref).max())


def test_fuse_transition_weights_matches_jax():
    _, params = _case(0, 1, 9)
    wep, bep = fuse_transition_weights(_torch(params))
    jwep, jbep = jax_fuse(jax.tree.map(jnp.asarray, params))
    assert wep.shape == (16 + 32, 64) and bep.shape == (1, 64)
    np.testing.assert_array_equal(wep.numpy(), np.asarray(jwep))
    np.testing.assert_array_equal(bep.numpy(), np.asarray(jbep))


@pytest.mark.parametrize("n,hw", [(1, 14), (2, 9)])
def test_transition_matches_jax(n, hw):
    x, params = _case(hw, n, hw)
    ref = transition_block_fused_pallas(jnp.asarray(x), jax.tree.map(jnp.asarray, params))
    ho = -(-hw // 2)
    assert ref.shape == (n, ho, ho, 64)
    p = _torch(params)
    _close(transition_block_fused(torch.from_numpy(x), p).numpy(), ref)
    p["wep"], p["bep"] = fuse_transition_weights(p)        # the converted params' form
    _close(transition_block_fused(torch.from_numpy(x), p, resident=True).numpy(), ref)
    _close(downsample_bottleneck_block(torch.from_numpy(x), p, algo="composed").numpy(), ref)
    if n == 1:
        _close(transition_block_fused(torch.from_numpy(x[0]), p).numpy(), np.asarray(ref)[0])
