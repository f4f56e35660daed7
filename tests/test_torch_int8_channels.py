"""The port's int8 ops at channel counts that are not multiples of 4
(Cin = 3 and 6, Cmid = 6), which their wrappers pad with zero channels
before the kernels (or, on the CPU, the plain twins) run: against
winograd_tpu's int8 ops in Pallas interpret mode, and against the plain
twins on the unpadded operands. Inputs are made from a seed with numpy.

Bounds: one int8 layer within 1e-5 * max(1, max|ref|) of JAX (one
quantization of identical inputs, an exact integer product); the stage,
transition and basic stage within 1e-3 * max(1, max|ref|) (chained
quantizations may flip a rounding on f32-level differences). Against the
unpadded plain twin: equal to the bit, since a zero channel changes neither
a row's max|a| nor its integer sum and a padded output channel is 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from winograd_tpu.config import TransitionConfig
from winograd_tpu.datagen.generate import (
    _basic_block_params_random, _block_params_random, _transition_params_random,
)
from winograd_tpu.kernels import basic_stage as jbs
from winograd_tpu.kernels import quantized as jq
from winograd_tpu_torch.kernels import basic_stage as tbs
from winograd_tpu_torch.kernels import quantized as tq

LAYER_RTOL = 1e-5
CHAINED_RTOL = 1e-3


def _close(out, ref, rtol):
    ref, out = np.asarray(ref), np.asarray(out)
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    assert np.abs(out - ref).max() <= rtol * max(1.0, np.abs(ref).max())


def _rand(rng, *shape):
    return (rng.random(shape) - 0.5).astype(np.float32)


def _bn(rng, c):
    return (rng.random(c) * 0.5 + 0.25).astype(np.float32), _rand(rng, c)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def test_padding_helpers_add_zero_channels():
    w9 = torch.arange(9 * 3 * 2, dtype=torch.float32).reshape(27, 2) + 1
    p = tq.pad_windows(w9, 4, 3)
    assert p.shape == (36, 3)
    for rs in range(9):
        assert torch.equal(p[4 * rs:4 * rs + 3, :2], w9[3 * rs:3 * rs + 3])
        assert not p[4 * rs + 3].any()
    assert not p[:, 2].any()
    x = torch.ones(2, 5, 6, dtype=torch.int8)
    assert tq.pad_to(x, 1, 5) is x
    assert tq.pad_to(x, -1, 8).shape == (2, 5, 8) and not tq.pad_to(x, -1, 8)[..., 6:].any()
    assert tq.pad_to(x, 0, 3).shape == (3, 5, 6)
    assert [tq.ceil4(c) for c in (1, 3, 4, 6, 13)] == [4, 4, 4, 8, 16]


@pytest.mark.parametrize("cin", [3, 6])
def test_conv1x1_int8_any_cin(cin):
    rng = np.random.default_rng(cin)
    x = _rand(rng, 2, 5, 7, cin)
    x[0, 0, 0] = 0.0                                  # an all-zero row
    w_q, s_w = jq.quantize_weights(_rand(rng, cin, 20))
    scale, bias = _bn(rng, 20)
    ref = jq.conv1x1_bn_int8_pallas(*map(jnp.asarray, (x, w_q, s_w, scale, bias)), relu=True)
    out = tq.conv1x1_bn_int8(*_t(x, w_q, s_w, scale, bias), relu=True)
    _close(out.numpy(), ref, LAYER_RTOL)
    assert torch.equal(out, tq.conv1x1_bn_int8_plain(*_t(x, w_q, s_w, scale, bias), relu=True))


@pytest.mark.parametrize("cin", [3, 6])
def test_conv3x3_int8_any_cin(cin):
    rng = np.random.default_rng(10 + cin)
    x = _rand(rng, 2, 6, 5, cin)
    w9 = np.asarray(_rand(rng, 12, cin, 3, 3).transpose(2, 3, 1, 0).reshape(9 * cin, 12))
    w9_q, s_w9 = jq.quantize_weights(w9)
    scale, bias = _bn(rng, 12)
    ref = jq.conv3x3_bn_int8_pallas(*map(jnp.asarray, (x, w9_q, s_w9, scale, bias)), relu=True)
    out = tq.conv3x3_bn_int8(*_t(x, w9_q, s_w9, scale, bias), relu=True)
    _close(out.numpy(), ref, LAYER_RTOL)
    assert torch.equal(out, tq.conv3x3_bn_int8_plain(*_t(x, w9_q, s_w9, scale, bias)))
    assert tq.conv3x3_bn_int8(*_t(x[0], w9_q, s_w9, scale, bias)).shape == (6, 5, 12)


# (mid, Cio, Cmid): a padded Cmid on either mid, a padded Cio, both.
@pytest.mark.parametrize("mid,cio,cmid", [
    ("direct", 16, 6), ("winograd2", 16, 6), ("direct", 6, 8), ("direct", 3, 6),
])
def test_stage_int8_any_channels(mid, cio, cmid):
    rng = np.random.default_rng(cio * cmid)
    blocks = [_block_params_random(rng, cio, cmid, bn_scale=0.5) for _ in range(2)]
    x = np.abs(_rand(rng, 1, 8, 8, cio))
    qj = jq.quantize_stage_params(blocks)
    ref = jq.resnet_stage_int8_pallas(jnp.asarray(x), qj, mid_algo=mid)
    qt = tq.quantize_stage_params(blocks)
    out = tq.resnet_stage_int8(torch.from_numpy(x), qt, mid)
    _close(out.numpy(), ref, CHAINED_RTOL)
    assert out.is_contiguous()
    if mid == "direct":
        assert torch.equal(out, tq.resnet_stage_int8_plain(torch.from_numpy(x), qt, mid))


def test_stage_int8_padding_keeps_the_expand_groups():
    """Cmid 254 pads to 256, whose winograd2 expand would quantize in two
    128-channel groups; the unpadded count's one group is kept."""
    assert tq.expand_groups(254, "winograd2") == 1 and tq.expand_groups(256, "winograd2") == 2
    rng = np.random.default_rng(254)
    blocks = [_block_params_random(rng, 8, 254, bn_scale=0.5)]
    x = torch.from_numpy(np.abs(_rand(rng, 1, 4, 4, 8)))
    qt = tq.quantize_stage_params(blocks)
    out = tq.resnet_stage_int8(x, qt, "winograd2")
    ref = tq.resnet_stage_int8_plain(x, qt, "winograd2")
    _close(out.numpy(), ref.numpy(), CHAINED_RTOL)
    padded = tq.resnet_stage_int8_plain(tq.pad_to(x, -1, 8), tq.pad_stage_int8(qt, 8, 256),
                                        "winograd2", groups=1)
    assert torch.equal(out, padded)


@pytest.mark.parametrize("cin,cmid", [(3, 8), (6, 6), (16, 6)])
def test_transition_int8_any_channels(cin, cmid):
    rng = np.random.default_rng(cin + 10 * cmid)
    t = _transition_params_random(rng, TransitionConfig("t", cin, cmid, 16, hw=8), bn_scale=0.5)
    x = np.abs(_rand(rng, 1, 8, 7, cin))
    ref = jq.transition_block_int8_pallas(jnp.asarray(x), jq.quantize_transition_params(t))
    qt = tq.quantize_transition_params(t)
    out = tq.transition_block_int8(torch.from_numpy(x), qt)
    assert out.shape == (1, 4, 4, 16)
    _close(out.numpy(), ref, CHAINED_RTOL)
    assert torch.equal(out, tq.transition_block_int8_plain(torch.from_numpy(x), qt))


@pytest.mark.parametrize("c", [3, 6])
def test_basic_stage_int8_any_channels(c):
    rng = np.random.default_rng(30 + c)
    blocks = [_basic_block_params_random(rng, c, bn_scale=0.5) for _ in range(2)]
    x = np.abs(_rand(rng, 1, 5, 5, c))
    ref = jbs.basic_stage_int8_pallas(jnp.asarray(x), jbs.quantize_basic_stage_params(blocks))
    qt = tbs.quantize_basic_stage_params(blocks)
    out = tbs.basic_stage_int8(torch.from_numpy(x), qt)
    _close(out.numpy(), ref, CHAINED_RTOL)
    assert out.is_contiguous()
    assert torch.equal(out, tbs.basic_stage_int8_plain(torch.from_numpy(x), qt))
