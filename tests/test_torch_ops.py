"""The port's plain PyTorch operators (ops/torch_ops.py, the vendor-baseline
role) against the JAX package's jnp_ops on the same numpy inputs.
Bound: 1e-4 * max(1, max|ref|)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from winograd_tpu.ops import jnp_ops
from winograd_tpu_torch.config import PARITY_ATOL
from winograd_tpu_torch.ops import torch_ops


def _block(seed, cin, cmid, cout, proj):
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.random(s) - 0.5).astype(np.float32)  # noqa: E731
    p = {"w_reduce": r(cin, cmid), "w_mid": r(cmid, cmid, 3, 3), "w_expand": r(cmid, cout)}
    for k, c in (("reduce", cmid), ("mid", cmid), ("expand", cout)):
        p[f"s_{k}"], p[f"b_{k}"] = r(c), r(c)
    if proj:
        p["w_proj"], p["s_proj"], p["b_proj"] = r(cin, cout), r(cout), r(cout)
    return p


def _both(fn_t, fn_j, x, params, **kw):
    out = fn_t(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in params.items()}, **kw)
    ref = fn_j(jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()}, **kw)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    assert np.abs(out.numpy() - ref).max() <= PARITY_ATOL * max(1.0, np.abs(ref).max())


def test_bottleneck_block_matches_jnp_ops():
    x = (np.random.default_rng(0).random((1, 6, 6, 16)) - 0.5).astype(np.float32)
    _both(torch_ops.bottleneck_block, jnp_ops.bottleneck_block, x, _block(1, 16, 8, 16, False))


@pytest.mark.parametrize("stride,hw", [(2, 7), (2, 8), (1, 6)])
def test_downsample_bottleneck_block_matches_jnp_ops(stride, hw):
    x = (np.random.default_rng(hw).random((2, hw, hw, 8)) - 0.5).astype(np.float32)
    _both(torch_ops.downsample_bottleneck_block, jnp_ops.downsample_bottleneck_block,
          x, _block(stride, 8, 4, 16, True), stride=stride)


def test_head_and_stem_match_jnp_ops():
    rng = np.random.default_rng(3)
    x = (rng.random((2, 3, 3, 16)) - 0.5).astype(np.float32)
    head = {"w_fc": (rng.random((16, 10)) - 0.5).astype(np.float32),
            "b_fc": (rng.random(10) - 0.5).astype(np.float32)}
    _both(torch_ops.head, jnp_ops.head, x, head)
    img = (rng.random((13, 13, 3)) - 0.5).astype(np.float32)
    stem = {"w7_stem": (rng.random((8, 3, 7, 7)) - 0.5).astype(np.float32),
            "s_stem": rng.random(8).astype(np.float32),
            "b_stem": (rng.random(8) - 0.5).astype(np.float32)}
    _both(torch_ops.stem, jnp_ops.stem, img, stem)
