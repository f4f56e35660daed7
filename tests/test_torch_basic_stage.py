"""The port's basic-stage module (kernels/basic_stage.py) against
winograd_tpu/kernels/basic_stage.py at narrow widths: a run of identity
basic blocks (ResNet-18/34) at f32 and at the int8 tier. JAX runs in Pallas
interpret mode; the port runs its plain twins in float32 on the CPU. Inputs
and weights are made from a seed with numpy.

Bounds: the stacking and quantization bit for bit; the f32 run within
1e-4 * max(1, max|ref|) of JAX at precision="highest" (the port's kernel
computes in FP32 FFMA; the JAX default "bf16x3" differs from both by
~1e-5); the int8 run within 1e-3 * max(1, max|ref|): its second conv
quantizes the first's output, and an f32-level difference there may flip a
rounding step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from winograd_tpu.datagen.generate import _basic_block_params_random
from winograd_tpu.kernels import basic_stage as jbs
from winograd_tpu_torch.kernels import basic_stage as tbs

ATOL = 1e-4
CHAINED_RTOL = 1e-3


def _close(out, ref, rtol):
    ref, out = np.asarray(ref), np.asarray(out)
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    assert np.abs(out - ref).max() <= rtol * max(1.0, np.abs(ref).max())


def _case(seed, n, hw, nb, c):
    rng = np.random.default_rng(seed)
    blocks = [_basic_block_params_random(rng, c, bn_scale=0.5) for _ in range(nb)]
    x = np.abs((rng.random((n, hw, hw, c)) - 0.5).astype(np.float32))  # a ReLU'd activation
    return x, blocks


def _same(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        a, b = ours[k].numpy(), np.asarray(v)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_stacking_and_quantization_match_jax_bit_for_bit():
    _, blocks = _case(0, 1, 4, 3, 16)
    blocks[1]["w9_b"][:, 5] = 0.0                      # a zero column keeps scale 1
    _same(tbs.stack_basic_stage_params(blocks), jbs.stack_basic_stage_params(blocks))
    _same(tbs.quantize_basic_stage_params(blocks), jbs.quantize_basic_stage_params(blocks))
    as_tensors = [{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()} for b in blocks]
    _same(tbs.quantize_basic_stage_params(as_tensors), jbs.quantize_basic_stage_params(blocks))


@pytest.mark.parametrize("n,nb", [(1, 1), (1, 3), (2, 1), (2, 3)])
def test_basic_stage_matches_jax(n, nb):
    x, blocks = _case(10 * n + nb, n, 5, nb, 16)
    ref = jbs.basic_stage_fused_pallas(
        jnp.asarray(x), jbs.stack_basic_stage_params(blocks), precision="highest")
    out = tbs.basic_stage_fused(torch.from_numpy(x), tbs.stack_basic_stage_params(blocks))
    _close(out.numpy(), ref, ATOL)
    one = tbs.basic_stage_fused(torch.from_numpy(x[0]), tbs.stack_basic_stage_params(blocks))
    assert one.shape == x.shape[1:]


@pytest.mark.parametrize("n,nb", [(1, 2), (2, 1)])
def test_basic_stage_int8_matches_jax(n, nb):
    x, blocks = _case(20 * n + nb, n, 5, nb, 16)
    x[0, 0, 0] = 0.0                                   # a zero pixel inside the windows
    ref = jbs.basic_stage_int8_pallas(jnp.asarray(x), jbs.quantize_basic_stage_params(blocks))
    out = tbs.basic_stage_int8(torch.from_numpy(x), tbs.quantize_basic_stage_params(blocks))
    _close(out.numpy(), ref, CHAINED_RTOL)


def test_basic_stage_rejects_mismatched_params():
    x, blocks = _case(3, 1, 4, 2, 8)
    stacked = tbs.stack_basic_stage_params(blocks)
    with pytest.raises(ValueError, match="w9_b"):
        tbs.basic_stage_fused(torch.from_numpy(x), dict(stacked, w9_b=stacked["w9_b"][:, :9]))
    q = tbs.quantize_basic_stage_params(blocks)
    with pytest.raises(ValueError, match="s_b"):
        tbs.basic_stage_int8(torch.from_numpy(x), dict(q, s_b=q["s_b"][:, :, :4]))
