"""The port's streamed training stages (winograd_tpu_torch/kernels/vjp.py::
resnet_stage_train_streamed at 28x28, F(2,3) mid, and 8x8, direct mid;
basic_stage_train_streamed) against jax.grad of their ops/jnp_ops.py block
chains: every gradient of sum(out^2) within 5e-4 * max(1, max|ref|); the
forward against the JAX fused forward (interpret mode) within 1e-4 *
max(1, max|ref|). On the CPU at tiny shapes (helpers in
test_torch_vjp_blocks.py)."""

import numpy as np
import pytest

from test_torch_vjp import _rand
from test_torch_vjp_blocks import _basic, _block, _chain, _check_composite
from winograd_tpu.kernels import vjp as jvjp
from winograd_tpu.ops import jnp_ops
from winograd_tpu_torch.kernels import vjp


@pytest.mark.parametrize("hw", [28, 8])
def test_resnet_stage_train_streamed_matches_jax(hw):
    """Both mid routes: F(2,3) at 28x28, direct at 8x8."""
    rng = np.random.default_rng(9 + hw)
    blocks = [_block(rng, 16, 8) for _ in range(2)]
    _check_composite(vjp.resnet_stage_train_streamed, jvjp.resnet_stage_train_streamed,
                     _chain(jnp_ops.bottleneck_block), _rand(rng, 1, hw, hw, 16), blocks)


def test_basic_stage_train_streamed_matches_jax():
    rng = np.random.default_rng(12)
    blocks = [_basic(rng, 16) for _ in range(2)]
    _check_composite(vjp.basic_stage_train_streamed, jvjp.basic_stage_train_streamed,
                     _chain(jnp_ops.basic_block), _rand(rng, 1, 7, 7, 16), blocks)
