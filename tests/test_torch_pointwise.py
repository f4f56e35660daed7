"""Port's pointwise kernel module against winograd_tpu's conv1x1_bn_pallas.

Same numpy inputs through both; the JAX side runs its Pallas kernel in
interpret mode on the CPU (bf16x3 split products, ~1e-5), the port runs its
plain twin in float32, so the bound is the f32 bar
1e-4 * max(1, max|ref|)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from winograd_tpu.kernels.pointwise import conv1x1_bn_pallas
from winograd_tpu_torch.config import PARITY_ATOL
from winograd_tpu_torch.kernels import transforms
from winograd_tpu_torch.kernels.pointwise import conv1x1_bn


def _case(seed, p, cin, cout):
    rng = np.random.default_rng(seed)
    x = (rng.random((p, cin)) - 0.5).astype(np.float32)
    w = (rng.random((cin, cout)) - 0.5).astype(np.float32)
    g, b, m = ((rng.random(cout) - 0.5).astype(np.float32) for _ in range(3))
    var = (rng.random(cout) * 3 + 5).astype(np.float32)
    scale, bias = transforms.fold_batchnorm(g, b, m, var)
    return x, w, scale, bias


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("p", [1, 49, 196])
def test_conv1x1_bn_matches_jax(p, relu):
    x, w, scale, bias = _case(p, p, 64, 40)
    ref = np.asarray(conv1x1_bn_pallas(*map(jnp.asarray, (x, w, scale, bias)), relu=relu))
    out = conv1x1_bn(*map(torch.from_numpy, (x, w, scale, bias)), relu=relu).numpy()
    assert out.shape == ref.shape == (p, 40)
    assert np.abs(out - ref).max() <= PARITY_ATOL * max(1.0, np.abs(ref).max())
    if relu:
        assert (out >= 0).all()


# The heads (P = N images, the R-34 head's K; the GEMV on the card) at N=1
# and N=8, f32 and bf16w (a bfloat16 weight; the JAX kernel at
# precision="bf16w"), each within the f32 bar.
@pytest.mark.parametrize("bf16w", [False, True])
@pytest.mark.parametrize("p", [1, 8])
def test_conv1x1_bn_head_matches_jax(p, bf16w):
    x, w, scale, bias = _case(100 + p, p, 512, 1000)
    wt = torch.from_numpy(w)
    if bf16w:
        wt = wt.to(torch.bfloat16)
        w = wt.float().numpy()
    jw = jnp.asarray(w).astype(jnp.bfloat16) if bf16w else jnp.asarray(w)
    ref = np.asarray(conv1x1_bn_pallas(jnp.asarray(x), jw, jnp.asarray(scale), jnp.asarray(bias),
                                       relu=False, precision="bf16w" if bf16w else "bf16x3"))
    out = conv1x1_bn(torch.from_numpy(x), wt, *map(torch.from_numpy, (scale, bias)),
                     relu=False).numpy()
    assert out.shape == ref.shape == (p, 1000)
    assert np.abs(out - ref).max() <= PARITY_ATOL * max(1.0, np.abs(ref).max())


def test_conv1x1_bn_keeps_leading_dims():
    x, w, scale, bias = _case(3, 2 * 5 * 7, 24, 16)
    x4 = x.reshape(2, 5, 7, 24)
    out = conv1x1_bn(*map(torch.from_numpy, (x4, w, scale, bias)), relu=True)
    flat = conv1x1_bn(*map(torch.from_numpy, (x, w, scale, bias)), relu=True)
    assert out.shape == (2, 5, 7, 16)
    torch.testing.assert_close(out.reshape(-1, 16), flat, rtol=0, atol=0)


def test_conv1x1_bn_rejects_channel_mismatch():
    x, w, scale, bias = _case(4, 4, 8, 8)
    with pytest.raises(ValueError):
        conv1x1_bn(torch.from_numpy(x[:, :4].copy()), *map(torch.from_numpy, (w, scale, bias)), relu=True)
