"""The port's CUDA kernels against their plain twins on the card, at edge
shapes the served path does not reach: ragged channel counts, maps that the
Winograd tile does not divide, odd stem images, batches. Needs an NVIDIA
GPU and nvcc; skipped elsewhere. Run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(--noconftest: the repo's conftest imports jax, which the port's machine
need not have). Bound: 1e-4 * max(1, max|ref|) in float32, TF32 off.
"""

import numpy as np
import pytest
import torch

from winograd_tpu_torch.kernels import transforms
from winograd_tpu_torch.kernels.direct import (
    conv3x3_bn_direct, conv3x3_bn_direct_plain, direct_filter,
)
from winograd_tpu_torch.kernels.pointwise import conv1x1_bn, conv1x1_bn_plain
from winograd_tpu_torch.kernels.stem import stem_fused, stem_fused_plain
from winograd_tpu_torch.kernels.winograd import (
    conv3x3_bn_winograd, conv3x3_bn_winograd_plain,
)
from winograd_tpu_torch.models.convert import stem_filter_s2d

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _r(rng, dev, *shape):
    return torch.as_tensor((rng.random(shape) - 0.5).astype(np.float32), device=dev)


def _bn(rng, dev, c):
    return (torch.as_tensor((rng.random(c) * 0.5).astype(np.float32), device=dev),
            _r(rng, dev, c))


def _agree(out, ref):
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    assert torch.isfinite(out).all()
    bound = 1e-4 * max(1.0, ref.abs().max().item())
    assert (out - ref).abs().max().item() <= bound


@pytest.mark.parametrize("p,k,n", [(1, 7, 5), (65, 130, 70), (129, 4608, 33)])
@pytest.mark.parametrize("relu", [True, False])
def test_pointwise_ragged(dev, p, k, n, relu):
    rng = np.random.default_rng(p + k + n)
    x, w = _r(rng, dev, p, k), _r(rng, dev, k, n)
    s, b = _bn(rng, dev, n)
    _agree(conv1x1_bn(x, w, s, b, relu), conv1x1_bn_plain(x, w, s, b, relu))


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("n,hw,cin,cout", [(2, 7, 13, 70), (1, 9, 8, 33), (3, 6, 20, 16)])
def test_winograd_edges_and_batches(dev, m, n, hw, cin, cout):
    rng = np.random.default_rng(m * hw + cin)
    x = _r(rng, dev, n, hw, hw, cin)
    w = (rng.random((cout, cin, 3, 3)) - 0.5).astype(np.float32)
    u = torch.as_tensor(transforms.transform_filter(w, m=m), device=dev)
    s, b = _bn(rng, dev, cout)
    _agree(conv3x3_bn_winograd(x, u, s, b), conv3x3_bn_winograd_plain(x, u, s, b))


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 5, 7, 3, 70), (1, 9, 9, 13, 65)])
def test_direct_ragged(dev, n, h, w, cin, cout):
    rng = np.random.default_rng(h * w + cout)
    x = _r(rng, dev, n, h, w, cin)
    w9 = torch.as_tensor(direct_filter((rng.random((cout, cin, 3, 3)) - 0.5).astype(np.float32)),
                         device=dev)
    s, b = _bn(rng, dev, cout)
    _agree(conv3x3_bn_direct(x, w9, s, b, relu=False),
           conv3x3_bn_direct_plain(x, w9, s, b, relu=False))


@pytest.mark.parametrize("n,h,w,cin,c", [(2, 30, 30, 3, 16), (1, 33, 31, 3, 64), (1, 17, 18, 4, 24)])
def test_stem_odd_images(dev, n, h, w, cin, c):
    rng = np.random.default_rng(h * w + c)
    x = _r(rng, dev, n, h, w, cin)
    w192 = torch.as_tensor(stem_filter_s2d((rng.random((c, cin, 7, 7)) - 0.5).astype(np.float32)),
                           device=dev)
    s, b = _bn(rng, dev, c)
    _agree(stem_fused(x, w192, s, b), stem_fused_plain(x, w192, s, b))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    rng = np.random.default_rng(0)
    x, w = _r(rng, dev, 8, 6), _r(rng, dev, 6, 4)
    s, b = _bn(rng, dev, 4)
    with pytest.raises(ValueError):
        conv1x1_bn(_r(rng, dev, 6, 8).t(), w, s, b, True)   # not contiguous
    with pytest.raises(TypeError):
        conv1x1_bn(x.double(), w.double(), s.double(), b.double(), True)
    with pytest.raises(ValueError):
        conv1x1_bn(x, w, s[:3], b[:3], True)                 # BN not per channel
