"""The port's stage and block kernel modules against winograd_tpu's
resnet_stage_fused_pallas and bottleneck_block_fused_pallas, on both
mid-layers (direct im2col and F(2,3) Winograd), at narrow widths. JAX runs
in Pallas interpret mode at precision "highest"; the port runs its plain
twins in float32. Bound: 1e-4 * max(1, max|ref|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from winograd_tpu.datagen.generate import _block_params_random
from winograd_tpu.kernels.block import bottleneck_block_fused_pallas
from winograd_tpu.kernels.stage import resnet_stage_fused_pallas
from winograd_tpu.kernels.stage import stack_stage_params as jax_stack
from winograd_tpu_torch.config import PARITY_ATOL
from winograd_tpu_torch.kernels.block import bottleneck_block_fused
from winograd_tpu_torch.kernels.stage import (
    resnet_stage_fused,
    stack_stage_params,
)


def _close(out, ref):
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    bound = PARITY_ATOL * max(1.0, np.abs(ref).max())
    assert np.abs(np.asarray(out) - ref).max() <= bound


def _case(seed, n, hw, nb, cio=32, cmid=8):
    rng = np.random.default_rng(seed)
    blocks = [_block_params_random(rng, cio, cmid, bn_scale=0.5) for _ in range(nb)]
    x = (rng.random((n, hw, hw, cio)) - 0.5).astype(np.float32)
    return x, blocks


def _torch(block):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in block.items()}


def test_stack_stage_params_matches_jax():
    _, blocks = _case(0, 1, 7, 3)
    ours = stack_stage_params([_torch(b) for b in blocks])
    theirs = jax_stack(blocks)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v))
    del blocks[1]["u2_mid"]
    assert "u2_mid" not in stack_stage_params([_torch(b) for b in blocks])


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("hw,nb", [(28, 2), (14, 3)])
@pytest.mark.parametrize("mid", ["direct", "winograd2"])
def test_stage_matches_jax(mid, hw, nb, n):
    x, blocks = _case(hw + nb + n, n, hw, nb)
    ref = resnet_stage_fused_pallas(
        jnp.asarray(x), jax_stack(blocks), mid_algo=mid, precision="highest")
    stacked = stack_stage_params([_torch(b) for b in blocks])
    _close(resnet_stage_fused(torch.from_numpy(x), stacked, mid_algo=mid).numpy(), ref)


def test_stage_resident_matches_jax_resident_layout():
    """resident=True at N=2 with the direct mid, the only case where the
    JAX package takes its weight-resident kernel; the port's kernel is the
    same either way."""
    x, blocks = _case(5, 2, 7, 2)
    ref = resnet_stage_fused_pallas(
        jnp.asarray(x), jax_stack(blocks), mid_algo="direct", resident=True,
        precision="highest")
    stacked = stack_stage_params([_torch(b) for b in blocks])
    out = resnet_stage_fused(torch.from_numpy(x), stacked, mid_algo="direct", resident=True)
    _close(out.numpy(), ref)
    np.testing.assert_array_equal(
        out.numpy(), resnet_stage_fused(torch.from_numpy(x), stacked, mid_algo="direct").numpy())


@pytest.mark.parametrize("mid", ["direct", "winograd2"])
def test_block_matches_jax(mid):
    x, (block,) = _case(7, 1, 28, 1)
    ref = bottleneck_block_fused_pallas(
        jnp.asarray(x), jax.tree.map(jnp.asarray, block), mid_algo=mid, precision="highest")
    out = bottleneck_block_fused(torch.from_numpy(x[0]), _torch(block), mid_algo=mid)
    _close(out.numpy(), np.asarray(ref)[0])


def test_auto_mid_takes_winograd_from_28x28_with_u2_mid():
    from winograd_tpu_torch.kernels.stage import resolve_mid_algo

    assert resolve_mid_algo("auto", {"u2_mid": 0}, 28, 28) == "winograd2"
    assert resolve_mid_algo("auto", {"u2_mid": 0}, 14, 14) == "direct"
    assert resolve_mid_algo("auto", {}, 56, 56) == "direct"
    with pytest.raises(ValueError):
        resolve_mid_algo("winograd4", {}, 28, 28)
    with pytest.raises(ValueError):
        resolve_mid_algo("winograd2", {}, 28, 28)
