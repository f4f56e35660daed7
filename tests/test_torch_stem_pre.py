"""The stem's prepared-input contract on the CPU: the port's
stem_prepare_input -> stem_fused_pre against the JAX package's
stem_prepare_input -> stem_pallas_pre (Pallas interpret mode) at 32x32 and
an odd side, within 1e-4 * max(1, max|ref|), and to the bit against the
port's own stem_fused on the same image at every precision; the operand's
layout; the wrapper's refusals. The model-level pre forwards are held in
tests/test_torch_engine.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from winograd_tpu.kernels.stem import stem_prepare_input as jax_prepare
from winograd_tpu.models.resnet50 import stem_pallas_pre
from winograd_tpu_torch.config import PARITY_ATOL
from winograd_tpu_torch.kernels.stem import (
    PRE_PAD,
    stem_fused,
    stem_fused_pre,
    stem_prepare_input,
)
from winograd_tpu_torch.models.convert import stem_filter_s2d


def _case(seed, n, img, cin=3, c=16):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, img, img, cin)) - 0.5).astype(np.float32)
    w7 = (rng.random((c, cin, 7, 7)) - 0.5).astype(np.float32)
    scale = (rng.random(c) * 0.5).astype(np.float32)
    bias = (rng.random(c) - 0.5).astype(np.float32)
    return x, stem_filter_s2d(w7), scale, bias


@pytest.mark.parametrize("img", [32, 30])
def test_stem_pre_matches_jax_stem_pallas_pre(img):
    x, w192, scale, bias = _case(img, 2, img)
    params = {"w192_stem": jnp.asarray(w192), "s_stem": jnp.asarray(scale),
              "b_stem": jnp.asarray(bias)}
    ref = np.asarray(stem_pallas_pre(jax_prepare(jnp.asarray(x)), params, h=img, w=img))
    w192_t, s, b = map(torch.from_numpy, (w192, scale, bias))
    out = stem_fused_pre(stem_prepare_input(x), w192_t, s, b, img, img)
    side = -(-img // 4)
    assert tuple(out.shape) == ref.shape == (2, side, side, 16)
    assert np.abs(out.numpy() - ref).max() <= PARITY_ATOL * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("precision", ["f32", "bf16", "bf16w"])
def test_stem_pre_equals_stem_fused_to_the_bit(precision):
    x, w192, scale, bias = _case(7, 2, 30)
    w = torch.from_numpy(w192)
    if precision == "bf16w":
        w = w.to(torch.bfloat16)
    s, b = torch.from_numpy(scale), torch.from_numpy(bias)
    want = stem_fused(torch.from_numpy(x), w, s, b, precision)
    got = stem_fused_pre(stem_prepare_input(x, precision), w, s, b, 30, 30, precision)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cin", [3, 4, 5])
def test_operand_is_the_padded_image(cin):
    x = np.random.default_rng(cin).standard_normal((9, 11, cin)).astype(np.float32)
    xb = stem_prepare_input(x)
    c4 = -(-cin // 4) * 4
    assert xb.device.type == "cpu" and xb.dtype == torch.float32 and xb.is_contiguous()
    assert tuple(xb.shape) == (1, 9 + 2 * PRE_PAD, 11 + 2 * PRE_PAD, c4)
    inner = xb[0, PRE_PAD:PRE_PAD + 9, PRE_PAD:PRE_PAD + 11]
    np.testing.assert_array_equal(inner[..., :cin].numpy(), x)
    pad = xb.clone()
    pad[0, PRE_PAD:PRE_PAD + 9, PRE_PAD:PRE_PAD + 11, :cin] = 0
    assert not pad.any()
    # At "bf16" (the int8 tier's) the values are bf16-rounded, the layout the same.
    xb16 = stem_prepare_input(torch.from_numpy(x), "bf16")
    assert xb16.shape == xb.shape
    assert torch.equal(xb16, xb.to(torch.bfloat16).float())


def test_stem_pre_refuses_a_mismatched_operand():
    x, w192, scale, bias = _case(1, 1, 32)
    w, s, b = map(torch.from_numpy, (w192, scale, bias))
    xb = stem_prepare_input(x)
    with pytest.raises(ValueError, match="prepared operand"):
        stem_fused_pre(xb, w, s, b, 30, 32)
    with pytest.raises(ValueError, match="prepared operand"):
        stem_fused_pre(xb.double(), w, s, b, 32, 32)
    with pytest.raises(ValueError, match="bfloat16"):
        stem_fused_pre(xb, w, s, b, 32, 32, "bf16w")
    with pytest.raises(ValueError, match="precision"):
        stem_prepare_input(x, "bf16x3")
