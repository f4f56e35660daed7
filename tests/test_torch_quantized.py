"""The port's int8 tier module (kernels/quantized.py) and the bf16 stem
against winograd_tpu's int8 kernels, at narrow widths. JAX runs in Pallas
interpret mode; the port runs its plain twins in float32 on the CPU.
Inputs are made from a seed with numpy.

Bounds: the quantize functions bit for bit; one int8 layer (one
quantization of identical inputs, an exact integer product) and the bf16
stem within 1e-5 * max(1, max|ref|); the stage and transition, whose
chained layers may flip a rounding when f32-level differences reach the
next quantization, within 1e-3 * max(1, max|ref|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from winograd_tpu.config import TransitionConfig
from winograd_tpu.datagen.generate import _block_params_random, _transition_params_random
from winograd_tpu.kernels import quantized as jq
from winograd_tpu.kernels.stem import stem_fused_pallas
from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.kernels import quantized as tq
from winograd_tpu_torch.kernels.stem import stem_fused
from winograd_tpu_torch.models.convert import stem_filter_s2d

LAYER_RTOL = 1e-5
CHAINED_RTOL = 1e-3


def _close(out, ref, rtol):
    ref = np.asarray(ref)
    out = np.asarray(out)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= rtol * max(1.0, np.abs(ref).max())


def _rand(rng, *shape):
    return (rng.random(shape) - 0.5).astype(np.float32)


def _bn(rng, c):
    return (rng.random(c) * 0.5 + 0.25).astype(np.float32), _rand(rng, c)


def _bits(t):
    """A tensor's raw bits as numpy (bf16 as its 16-bit pattern)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jax_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_same(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        a, b = _bits(ours[k]), _jax_bits(v)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def test_quantize_functions_match_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    w = _rand(rng, 24, 40)
    w[:, 3] = 0.0                                     # a zero column keeps scale 1
    ours, theirs = tq.quantize_weights(w), jq.quantize_weights(w)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    blocks = [_block_params_random(rng, 32, 8, bn_scale=0.5) for _ in range(2)]
    _assert_same(tq.quantize_block_params(blocks[0]), jq.quantize_block_params(blocks[0]))
    _assert_same(tq.quantize_block_params(_torch(blocks[0])), jq.quantize_block_params(blocks[0]))
    _assert_same(tq.quantize_stage_params(blocks), jq.quantize_stage_params(blocks))
    t = _transition_params_random(rng, TransitionConfig("t", 16, 8, 32, hw=8), bn_scale=0.5)
    _assert_same(tq.quantize_transition_params(t), jq.quantize_transition_params(t))


@pytest.mark.parametrize("relu", [True, False])
def test_conv1x1_int8_matches_jax(relu):
    rng = np.random.default_rng(1 + relu)
    x = _rand(rng, 2, 5, 7, 24)
    x[0, 0, 0] = 0.0                                  # an all-zero row
    w_q, s_w = jq.quantize_weights(_rand(rng, 24, 40))
    scale, bias = _bn(rng, 40)
    ref = jq.conv1x1_bn_int8_pallas(*map(jnp.asarray, (x, w_q, s_w, scale, bias)), relu=relu)
    out = tq.conv1x1_bn_int8(*map(torch.from_numpy, (x, w_q, s_w, scale, bias)), relu=relu)
    _close(out.numpy(), ref, LAYER_RTOL)


def test_conv1x1_int8_head_matches_jax():
    """The int8 head at N=1 (one row, the R-34 head's K; the GEMV on the
    card)."""
    rng = np.random.default_rng(3)
    x = _rand(rng, 1, 512)
    w_q, s_w = jq.quantize_weights(_rand(rng, 512, 1000))
    scale, bias = _bn(rng, 1000)
    ref = jq.conv1x1_bn_int8_pallas(*map(jnp.asarray, (x, w_q, s_w, scale, bias)), relu=False)
    out = tq.conv1x1_bn_int8(*map(torch.from_numpy, (x, w_q, s_w, scale, bias)), relu=False)
    assert out.shape == (1, 1000)
    _close(out.numpy(), ref, LAYER_RTOL)


@pytest.mark.parametrize("band_h", [None, 4])
def test_conv3x3_int8_matches_jax(band_h):
    """The whole-image kernel and the row-banded one (rows 13 and 14) are
    one function of the input; the port's per-im2col-row scales match both."""
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 8, 8, 12)
    w9 = np.asarray(_rand(rng, 16, 12, 3, 3).transpose(2, 3, 1, 0).reshape(9 * 12, 16))
    w9_q, s_w9 = jq.quantize_weights(w9)
    scale, bias = _bn(rng, 16)
    ref = jq.conv3x3_bn_int8_pallas(*map(jnp.asarray, (x, w9_q, s_w9, scale, bias)),
                                    relu=True, band_h=band_h)
    out = tq.conv3x3_bn_int8(*map(torch.from_numpy, (x, w9_q, s_w9, scale, bias)), relu=True)
    _close(out.numpy(), ref, LAYER_RTOL)


def test_stem_bf16_matches_jax():
    rng = np.random.default_rng(4)
    x = _rand(rng, 32, 32, 3)
    w192 = stem_filter_s2d(_rand(rng, 16, 3, 7, 7))
    scale, bias = _bn(rng, 16)
    ref = stem_fused_pallas(*map(jnp.asarray, (x, w192, scale, bias)), precision="bf16")
    out = stem_fused(*map(torch.from_numpy, (x, w192, scale, bias)), precision="bf16")
    _close(out.numpy(), ref, LAYER_RTOL)
    with pytest.raises(ValueError, match="precision"):
        stem_fused(*map(torch.from_numpy, (x, w192, scale, bias)), precision="bf16w")


def _stage_case(seed, n, hw, nb, cio, cmid):
    rng = np.random.default_rng(seed)
    blocks = [_block_params_random(rng, cio, cmid, bn_scale=0.5) for _ in range(nb)]
    x = np.abs(_rand(rng, n, hw, hw, cio))            # a ReLU'd activation
    return x, blocks


@pytest.mark.parametrize("mid,n,hw,nb,cio,cmid", [
    ("direct", 2, 8, 2, 32, 8),
    ("winograd2", 1, 8, 2, 32, 8),
    ("winograd2", 1, 4, 1, 32, 256),                  # two 128-channel expand groups
])
def test_stage_int8_matches_jax(mid, n, hw, nb, cio, cmid):
    x, blocks = _stage_case(hw + nb + cmid, n, hw, nb, cio, cmid)
    qj = jq.quantize_stage_params(blocks)
    ref = jq.resnet_stage_int8_pallas(jnp.asarray(x), qj, mid_algo=mid)
    out = tq.resnet_stage_int8(torch.from_numpy(x), tq.quantize_stage_params(blocks), mid)
    _close(out.numpy(), ref, CHAINED_RTOL)
    assert tq.expand_groups(cmid, mid) == (2 if cmid == 256 else 1)


def test_stage_int8_at_one_block_matches_jax_block_kernel():
    """Row 16: the int8 block kernel (direct mid) is the stage at B = 1."""
    x, blocks = _stage_case(7, 2, 8, 1, 32, 8)
    ref = jq.bottleneck_block_int8_pallas(jnp.asarray(x), jq.quantize_block_params(blocks[0]))
    out = tq.resnet_stage_int8(torch.from_numpy(x), tq.quantize_stage_params(blocks), "direct")
    _close(out.numpy(), ref, CHAINED_RTOL)


@pytest.mark.parametrize("n,h,w", [(2, 8, 8), (1, 7, 9)])
def test_transition_int8_matches_jax(n, h, w):
    rng = np.random.default_rng(h * w)
    t = _transition_params_random(rng, TransitionConfig("t", 16, 8, 32, hw=h), bn_scale=0.5)
    x = np.abs(_rand(rng, n, h, w, 16))
    ref = jq.transition_block_int8_pallas(jnp.asarray(x), jq.quantize_transition_params(t))
    out = tq.transition_block_int8(torch.from_numpy(x), tq.quantize_transition_params(t))
    assert out.shape == (n, -(-h // 2), -(-w // 2), 32)
    _close(out.numpy(), ref, CHAINED_RTOL)


def test_operand_checks_by_dtype():
    """The kernels' operand check takes float32, int8 and bfloat16, each
    where the caller names it, and refuses every other type."""
    f32 = torch.zeros(4)
    for dtype in (torch.float32, torch.int8, torch.bfloat16):
        with pytest.raises(ValueError, match="CUDA"):        # type passes, device does not
            _build.check_tensors(f32.to(dtype), dtype=dtype)
    with pytest.raises(TypeError):
        _build.check_tensors(f32.to(torch.int8))             # int8 where float32 is named
    with pytest.raises(TypeError):
        _build.check_tensors(f32.double())
    with pytest.raises(TypeError):
        _build.check_tensors(f32.half(), dtype=torch.float16)
