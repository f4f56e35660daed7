"""The port's Conv3x3BnWinogradTrain (winograd_tpu_torch/kernels/vjp.py)
against the JAX package's conv3x3_bn_winograd_train custom_vjp (the Pallas
forward in interpret mode), at F(2,3) and F(4,3), with and without the
ReLU: output and every gradient of sum(out^2) within 1e-4 * max(1,
max|ref|). On the CPU at a tiny shape; inputs made with numpy from a seed
(helpers in test_torch_vjp.py)."""

import numpy as np
import pytest

from test_torch_vjp import LAYER_RTOL, _compare, _layer
from winograd_tpu.kernels import vjp as jvjp
from winograd_tpu_torch.kernels import vjp


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("m", [2, 4])
def test_conv3x3_bn_winograd_train_matches_the_jax_custom_vjp(m, relu):
    x, p = _layer(np.random.default_rng(1), (1, 9, 9, 16), (8, 16, 3, 3), 8)
    _compare(lambda x_, p_: vjp.conv3x3_bn_winograd_train(x_, p_["w"], p_["s"], p_["b"], relu, m),
             lambda x_, p_: jvjp.conv3x3_bn_winograd_train(x_, p_["w"], p_["s"], p_["b"], relu,
                                                           m),
             x, p, LAYER_RTOL)
