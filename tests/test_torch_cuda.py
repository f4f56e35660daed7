"""The port's CUDA kernels against their plain twins on the card, at edge
shapes the served path does not reach: ragged channel counts, maps that the
Winograd tile does not divide, odd stem images, batches, stages and
transitions whose phases split K, and the int8 tier's kernels at ragged
rows, border-heavy 7x7 maps and N=8; the basic family's kernels (the f32
and int8 basic stage, the int8 Winograd in both of its branches, the
bf16-filter Winograd) at N=3, one block, channel counts off 128 and an
all-zero image (every row's scale 1); the split-K pointwise kernel at the
served small-P shapes, a ragged last split and one split, bit-identical
from call to call, the split-K direct 3x3 at its served 7x7x512 shape,
the int8 direct 3x3 and stage on the tensor cores held to exact equality
with their twins (the stage at its served shapes too), the int8 Winograd
at Cin past one span of K (1152 and 2048) and in spans at narrow widths,
the f32 basic stage on the 3xTF32 tensor cores at its served shapes under
any split, repeating to the bit, and every int8
entry at channel counts that its wrapper pads; the f32 Winograd and stage
on the tensor cores at their served shapes (N=1 and N=8, both mids, the
F(4,3) check shape), their plans filling a wave of SMs and two calls equal
to the bit, and the Winograd at ragged Cin and Cout (Cin 3 and 13, Cout off
multiples of 4 on the 4-byte path) and split Cin; the stem on the FP64
tensor cores at its served shape (N=1 and N=8, both precisions, the bf16
stem equal to its twin there and on the odd images), and the int8
transition on s8 mma.sync equal to its twin and repeating to the bit at its
served shapes, odd maps and padded channel counts; the bf16w tier's
instantiations (pointwise with the head's N, N off multiples of 8 and odd,
K off multiples of 16, the GEMV at P <= 8 and the tiles just above; the stem
on bf16 w192; the stage at one to five blocks, both mids, conv5_x at N=1 and
8; the transition at its served shapes and ragged channels; the Winograd
F(2,3), the direct 3x3 and the basic stage at their served ResNet-34 shapes
at N=1 and N=8, ragged Cout and Cin), each within the f32 bound of its twin
and repeating to the bit, and each refusing an activation that is not
float32; the int8 tier's F(2,3) on bf16 filters (FP64) equal to its twin;
the training Functions of kernels/vjp.py (each per-layer Function and
composite, f32 and bf16w) against the same Function on the CPU, output and
every gradient, and one SGD step replayed from a CUDA graph against the
same step run eagerly; the stage at ResNet-152's depths (35 and 7 blocks)
and every kernel family at the N=32 shapes of ResNet-50 and ResNet-18/34,
at every tier; and a world of two gloo ranks sharing the card
(tests/torch_parallel_ranks.py::cuda_world) serving the narrow classifiers
under the parallel partitions "model", "pipe" and "data" at every tier
against the single-device engines (f32 and bf16w 1e-4, int8 1e-3 times
max(1, max|ref|); bf16w and int8 under "model", their own arithmetic (every
3x3 direct on bf16 or int8 weights of the filter, each rank's shard
quantized apart), within 1e-4 and 1e-3 of their own plain versions on the
CPU and 5e-3 and 5e-2 of the f32 engine); and utils/debug.py::nan_checks
naming the counter a NaN-producing launch went under, and refusing a graph
capture. Needs an NVIDIA GPU and nvcc; skipped elsewhere. Run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(--noconftest: the repo's conftest imports jax, which the port's machine
need not have). Bound: 1e-4 * max(1, max|ref|) in float32, TF32 off; the
int8 transition at odd maps, 1e-3 * max(1, max|ref|), the bound it met
before its s8 mma.sync design; the int8 direct 3x3, stage, transition,
basic stage and Winograd (the same arithmetic as their twins, exact int32
sums, the Winograd's transforms in FP64 rounded once; the last two also at
their served shapes, under their plans and another grid or split, and
repeating to the bit), the padded int8 entries and the bf16 stem (exact
FP64 sums), 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

from winograd_tpu_torch.config import BasicNetConfig, ResNet50Config
from winograd_tpu_torch.engine import ResNet50Engine, ResNetBasicEngine
from winograd_tpu_torch.kernels import _build, transforms
from winograd_tpu_torch.kernels.direct import (
    conv3x3_bn_direct, conv3x3_bn_direct_plain, direct_filter, direct_plan,
)
from winograd_tpu_torch.kernels import basic_stage as bs
from winograd_tpu_torch.kernels import quantized as q8
from winograd_tpu_torch.kernels.pointwise import conv1x1_bn, conv1x1_bn_plain, split_plan
from winograd_tpu_torch.kernels.stage import (
    resnet_stage_fused, resnet_stage_fused_plain, stack_stage_params,
)
from winograd_tpu_torch.kernels.stem import (
    stem_fused, stem_fused_plain, stem_fused_pre, stem_fused_pre_plain, stem_prepare_input,
)
from winograd_tpu_torch.kernels.transition import (
    TRANSITION_MAX_SUM, TRANSITION_STEP, fuse_transition_weights, transition_block_fused,
    transition_block_fused_plain, transition_block_fused_planned, transition_plan,
)
from winograd_tpu_torch.kernels.splitk import split_k
from winograd_tpu_torch.kernels.winograd import (
    WINOGRAD_STEP, conv3x3_bn_winograd, conv3x3_bn_winograd_plain, conv3x3_bn_winograd_planned,
    winograd2_mid_plain, winograd_plan, winograd_tiles,
)
from winograd_tpu_torch.models.basic import basicnet_params, init_basicnet_arrays
from winograd_tpu_torch.models.convert import stem_filter_s2d
from winograd_tpu_torch.models.resnet50 import init_resnet50_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        _build._nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _r(rng, dev, *shape):
    return torch.as_tensor((rng.random(shape) - 0.5).astype(np.float32), device=dev)


def _bn(rng, dev, c):
    return (torch.as_tensor((rng.random(c) * 0.5).astype(np.float32), device=dev),
            _r(rng, dev, c))


def _equal(out, ref):
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() == 0.0


def _agree(out, ref, rtol=1e-4):
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    assert torch.isfinite(out).all()
    bound = rtol * max(1.0, ref.abs().max().item())
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


# The served 7x7x512 3x3 (ResNet-50's conv5_x, ResNet-34's entry b-leg) at
# N=1 and N=8, K split over blocks; two calls equal to the bit.
@pytest.mark.parametrize("n", [1, 8])
def test_direct_split_k_served_shape(dev, n):
    rng = np.random.default_rng(n)
    x = _r(rng, dev, n, 7, 7, 512)
    w9 = torch.as_tensor(direct_filter((rng.random((512, 512, 3, 3)) - 0.5).astype(np.float32)),
                         device=dev)
    s, b = _bn(rng, dev, 512)
    assert direct_plan(n, 7, 7, 512, 512, _build.sm_count(dev)).splits > 1
    first = conv3x3_bn_direct(x, w9, s, b, relu=True)
    _agree(first, conv3x3_bn_direct_plain(x, w9, s, b, relu=True))
    assert torch.equal(first, conv3x3_bn_direct(x, w9, s, b, relu=True))


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


def _stacked(rng, dev, nb, cio, cmid):
    blocks = []
    for _ in range(nb):
        w = (rng.random((cmid, cmid, 3, 3)) - 0.5).astype(np.float32)
        (s1, b1), (s2, b2), (s3, b3) = (_bn(rng, dev, c) for c in (cmid, cmid, cio))
        blocks.append(dict(
            w_reduce=_r(rng, dev, cio, cmid), s_reduce=s1, b_reduce=b1,
            u2_mid=torch.as_tensor(transforms.transform_filter(w, m=2), device=dev),
            w9_mid=torch.as_tensor(direct_filter(w), device=dev), s_mid=s2, b_mid=b2,
            w_expand=_r(rng, dev, cmid, cio), s_expand=s3, b_expand=b3))
    return stack_stage_params(blocks)


# (N, H=W, Cio, Cmid, blocks): odd maps, ragged channels, and shapes whose
# GEMM phases split K (K >= 256) with a ragged last split.
@pytest.mark.parametrize("mid", ["direct", "winograd2"])
@pytest.mark.parametrize("n,hw,cio,cmid,nb", [
    (1, 7, 70, 20, 3), (3, 9, 70, 20, 1), (3, 29, 70, 20, 3), (1, 7, 300, 40, 2),
    (2, 9, 144, 300, 2),
])
def test_stage_edges_and_batches(dev, mid, n, hw, cio, cmid, nb):
    rng = np.random.default_rng(n * hw + cio + cmid + nb)
    stacked = _stacked(rng, dev, nb, cio, cmid)
    x = _r(rng, dev, n, hw, hw, cio)
    _agree(resnet_stage_fused(x, stacked, mid), resnet_stage_fused_plain(x, stacked, mid))


def _transition(rng, dev, cin, cmid, cout):
    w = (rng.random((cmid, cmid, 3, 3)) - 0.5).astype(np.float32)
    (s1, b1), (s2, b2), (s3, b3), (sp, bp) = (_bn(rng, dev, c) for c in (cmid, cmid, cout, cout))
    return dict(w_reduce=_r(rng, dev, cin, cmid), s_reduce=s1, b_reduce=b1,
                w9_mid=torch.as_tensor(direct_filter(w), device=dev), s_mid=s2, b_mid=b2,
                w_expand=_r(rng, dev, cmid, cout), s_expand=s3, b_expand=b3,
                w_proj=_r(rng, dev, cin, cout), s_proj=sp, b_proj=bp)


# Odd maps, ragged channels (the 4-byte path), batches, and the served
# transitions (56->28, 28->14, 14->7 at N=1; 14->7 at N=8) on the 3xTF32
# phases: within the f32 bar, two calls equal to the bit.
@pytest.mark.parametrize("n,h,w,cin,cmid,cout", [
    (3, 15, 15, 70, 20, 130), (3, 7, 7, 300, 40, 90), (1, 14, 14, 64, 32, 128),
    (2, 9, 8, 256, 300, 70), (1, 56, 56, 256, 128, 512), (1, 28, 28, 512, 256, 1024),
    (1, 14, 14, 1024, 512, 2048), (8, 14, 14, 1024, 512, 2048),
])
def test_transition_odd_maps_and_batches(dev, n, h, w, cin, cmid, cout):
    rng = np.random.default_rng(h * w + cin + cout)
    p = _transition(rng, dev, cin, cmid, cout)
    x = _r(rng, dev, n, h, w, cin)
    first = transition_block_fused(x, p)
    _agree(first, transition_block_fused_plain(x, p))
    assert torch.equal(first, transition_block_fused(x, p))


def test_stage_and_transition_reject_what_the_kernels_do_not_take(dev):
    rng = np.random.default_rng(1)
    stacked = _stacked(rng, dev, 2, 16, 8)
    x = _r(rng, dev, 1, 7, 7, 16)
    with pytest.raises(ValueError):
        resnet_stage_fused(x.transpose(1, 2).contiguous().transpose(1, 2), stacked)
    with pytest.raises(TypeError):
        resnet_stage_fused(x.double(), {k: v.double() for k, v in stacked.items()})
    with pytest.raises(ValueError):
        resnet_stage_fused(x[..., :8].contiguous(), stacked)               # Cio mismatch
    with pytest.raises(ValueError):
        resnet_stage_fused(x, dict(stacked, w_expand=stacked["w_expand"][:, :, :8]))
    p = _transition(rng, dev, 16, 8, 32)
    with pytest.raises(ValueError):
        transition_block_fused(x.transpose(1, 2), p)                       # not contiguous
    with pytest.raises(TypeError):
        transition_block_fused(x.double(), {k: v.double() for k, v in p.items()})
    with pytest.raises(ValueError):
        transition_block_fused(x, dict(p, w9_mid=p["w9_mid"][:-1].contiguous()))


def test_transition_entry_refuses_a_plan_it_does_not_take(dev):
    """csrc/transition.cu's entry refuses a grid larger than it holds
    resident, a split off the tile's k step and one that leaves K uncovered."""
    rng = np.random.default_rng(3)
    p = _transition(rng, dev, 256, 64, 128)
    wep, bep = fuse_transition_weights(p)
    x = _r(rng, dev, 1, 14, 14, 256)
    args = (x, p["w_reduce"], p["s_reduce"], p["b_reduce"], p["w9_mid"], p["s_mid"],
            p["b_mid"], wep, bep)
    plan = transition_plan(1, 14, 14, 256, 64, 128, _build.sm_count(dev))
    _agree(transition_block_fused_planned(*args, plan), transition_block_fused_plain(x, p))
    for bad in (plan._replace(blocks=4 * plan.blocks),
                plan._replace(reduce=split_k(256, 2, 32, 32)._replace(chunk=100)),
                plan._replace(mid=plan.mid._replace(splits=1, chunk=64))):
        with pytest.raises(RuntimeError):
            transition_block_fused_planned(*args, bad)


# --- the int8 tier -------------------------------------------------------


def _q(rng, dev, k, n):
    w_q, s_w = q8.quantize_weights((rng.random((k, n)) - 0.5).astype(np.float32))
    return torch.as_tensor(w_q, device=dev), torch.as_tensor(s_w, device=dev)


# Ragged rows and columns, K off multiples of 32 (zero-padded to the MMA's
# depth), a zero row: equal to the twin on every path of the plan.
@pytest.mark.parametrize("p,k,n", [(1, 8, 5), (65, 132, 70), (129, 4608, 33), (7, 300, 70),
                                   (100, 36, 130)])
@pytest.mark.parametrize("relu", [True, False])
def test_pointwise_int8_ragged(dev, p, k, n, relu):
    rng = np.random.default_rng(p + k + n)
    x = _r(rng, dev, p, k)
    x[0] = 0.0                                            # a zero row keeps scale 1
    w_q, s_w = _q(rng, dev, k, n)
    s, b = _bn(rng, dev, n)
    ref = q8.conv1x1_bn_int8_plain(x, w_q, s_w, s, b, relu)
    _equal(q8.conv1x1_bn_int8(x, w_q, s_w, s, b, relu), ref)
    sms = _build.sm_count(dev)
    for path in q8.POINTWISE_INT8_PATHS:
        try:
            plan = q8.pointwise_int8_plan(p, k, n, sms, path)
        except ValueError:                                # a path that cannot take the shape
            continue
        _equal(q8.conv1x1_bn_int8_planned(x, w_q, s_w, s, b, relu, plan), ref)


# The served int8 1x1s (P, K, N, relu): ResNet-50's projection block and
# head, ResNet-34's strided b-legs, projections and head, at N=1 and N=8
# (P x 8): equal to the twin, and two calls equal to the bit.
SERVED_POINTWISE_INT8 = [
    (3136, 64, 64, True), (3136, 64, 256, False), (1, 2048, 1000, False), (8, 2048, 1000, False),
    (784, 576, 128, True), (196, 1152, 256, True), (49, 2304, 512, True), (784, 64, 128, False),
    (196, 128, 256, False), (49, 256, 512, False), (1, 512, 1000, False), (8, 512, 1000, False),
    (25088, 64, 256, True), (392, 2304, 512, True), (1568, 1152, 256, True),
]


@pytest.mark.parametrize("p,k,n,relu", SERVED_POINTWISE_INT8)
def test_pointwise_int8_served_shapes(dev, p, k, n, relu):
    rng = np.random.default_rng(p + k + n)
    x = _r(rng, dev, p, k).abs() if relu else _r(rng, dev, p, k)
    w_q, s_w = _q(rng, dev, k, n)
    s, b = _bn(rng, dev, n)
    first = q8.conv1x1_bn_int8(x, w_q, s_w, s, b, relu)
    _equal(first, q8.conv1x1_bn_int8_plain(x, w_q, s_w, s, b, relu))
    assert torch.equal(first, q8.conv1x1_bn_int8(x, w_q, s_w, s, b, relu))


def test_pointwise_int8_entry_refuses_a_plan_it_does_not_take(dev):
    """csrc/pointwise_int8.cu's entry refuses a GEMV past its rows, a one-pass
    K past its shared memory, a cooperative grid larger than it holds
    resident, and a split that leaves K uncovered."""
    rng = np.random.default_rng(4)
    w_q, s_w = _q(rng, dev, 512, 64)
    s, b = _bn(rng, dev, 64)
    sms = _build.sm_count(dev)
    gemv = q8.pointwise_int8_plan(8, 512, 64, sms)
    coop = q8.pointwise_int8_plan(100, 512, 64, sms)
    one = q8.pointwise_int8_plan(100, 256, 64, sms)
    for p, k, bad in ((9, 512, gemv), (100, 512, one._replace(kp=512, chunk=512)),
                      (100, 512, coop._replace(blocks=4 * coop.blocks)),
                      (100, 512, coop._replace(splits=1)), (8, 512, gemv._replace(chunk=32))):
        x = _r(rng, dev, p, k)
        with pytest.raises(RuntimeError):
            q8.conv1x1_bn_int8_planned(x, w_q[:k].contiguous(), s_w, s, b, True, bad)


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 5, 7, 4, 70), (8, 7, 7, 16, 24), (1, 9, 9, 12, 65)])
def test_direct_int8_borders_and_batches(dev, n, h, w, cin, cout):
    rng = np.random.default_rng(h * w + cout)
    x = _r(rng, dev, n, h, w, cin)
    w9_q, s_w9 = _q(rng, dev, 9 * cin, cout)
    s, b = _bn(rng, dev, cout)
    _agree(q8.conv3x3_bn_int8(x, w9_q, s_w9, s, b), q8.conv3x3_bn_int8_plain(x, w9_q, s_w9, s, b))


@pytest.mark.parametrize("n,h,w,cin,c", [(2, 30, 30, 3, 16), (1, 33, 31, 3, 64)])
def test_stem_bf16_odd_images(dev, n, h, w, cin, c):
    rng = np.random.default_rng(h * w + c + 1)
    x = _r(rng, dev, n, h, w, cin)
    w192 = torch.as_tensor(stem_filter_s2d((rng.random((c, cin, 7, 7)) - 0.5).astype(np.float32)),
                           device=dev)
    s, b = _bn(rng, dev, c)
    _agree(stem_fused(x, w192, s, b, "bf16"), stem_fused_plain(x, w192, s, b, "bf16"))


def _qstacked(rng, dev, nb, cio, cmid):
    blocks = []
    for _ in range(nb):
        w = (rng.random((cmid, cmid, 3, 3)) - 0.5).astype(np.float32)
        (s1, b1), (s2, b2), (s3, b3) = (_bn(rng, dev, c) for c in (cmid, cmid, cio))
        blocks.append(dict(
            w_reduce=(rng.random((cio, cmid)) - 0.5).astype(np.float32), s_reduce=s1,
            b_reduce=b1, u2_mid=transforms.transform_filter(w, m=2), w9_mid=direct_filter(w),
            s_mid=s2, b_mid=b2, w_expand=(rng.random((cmid, cio)) - 0.5).astype(np.float32),
            s_expand=s3, b_expand=b3))
    return {k: v.to(dev) for k, v in q8.quantize_stage_params(blocks).items()}


# (N, H=W, Cio, Cmid, blocks): border-heavy 7x7 and odd maps, N=8, phases
# that split K, and Cmid 256 (two 128-channel expand groups on winograd2).
@pytest.mark.parametrize("mid", ["direct", "winograd2"])
@pytest.mark.parametrize("n,hw,cio,cmid,nb", [
    (1, 7, 68, 20, 3), (8, 7, 72, 40, 2), (3, 9, 68, 20, 1), (1, 7, 300, 40, 2),
    (2, 9, 144, 256, 2),
])
def test_stage_int8_edges_and_batches(dev, mid, n, hw, cio, cmid, nb):
    rng = np.random.default_rng(n * hw + cio + cmid + nb)
    stacked = _qstacked(rng, dev, nb, cio, cmid)
    x = _r(rng, dev, n, hw, hw, cio).abs()
    _equal(q8.resnet_stage_int8(x, stacked, mid), q8.resnet_stage_int8_plain(x, stacked, mid))


# The served int8 stages on the direct mid (conv4_x at N=1 and N=8, conv5_x)
# and the winograd2 ones (conv2_x, conv3_x), held to the bit: a last-bit
# difference here moves a whole quantization step in the next block.
@pytest.mark.parametrize("n,hw,cio,cmid,nb,mid", [
    (1, 14, 1024, 256, 5, "direct"), (8, 14, 1024, 256, 5, "direct"),
    (1, 7, 2048, 512, 2, "direct"), (8, 7, 2048, 512, 2, "direct"),
    (1, 56, 256, 64, 2, "winograd2"), (1, 28, 512, 128, 3, "winograd2"),
])
def test_stage_int8_equals_its_twin(dev, n, hw, cio, cmid, nb, mid):
    rng = np.random.default_rng(hw + cmid + nb)
    stacked = _qstacked(rng, dev, nb, cio, cmid)
    x = _r(rng, dev, n, hw, hw, cio).abs()
    _equal(q8.resnet_stage_int8(x, stacked, mid), q8.resnet_stage_int8_plain(x, stacked, mid))


# Every int8 entry at channel counts off the kernels' four-k words, which
# the wrappers pad with zero channels: equal to the twins on the unpadded
# operands.
@pytest.mark.parametrize("c", [3, 6])
def test_int8_entries_take_any_channel_count(dev, c):
    rng = np.random.default_rng(40 + c)
    x = _r(rng, dev, 2, 7, 5, c).abs()
    w_q, s_w = _q(rng, dev, c, 12)
    s, b = _bn(rng, dev, 12)
    _equal(q8.conv1x1_bn_int8(x, w_q, s_w, s, b, True),
           q8.conv1x1_bn_int8_plain(x, w_q, s_w, s, b, True))
    w9_q, s_w9 = _q(rng, dev, 9 * c, 12)
    _equal(q8.conv3x3_bn_int8(x, w9_q, s_w9, s, b), q8.conv3x3_bn_int8_plain(x, w9_q, s_w9, s, b))
    for mid in ("direct", "winograd2"):
        stacked = _qstacked(rng, dev, 2, c, 6)
        _equal(q8.resnet_stage_int8(x, stacked, mid), q8.resnet_stage_int8_plain(x, stacked, mid))
    p = _qtransition(rng, dev, c, 6, 16)
    _equal(q8.transition_block_int8(x, p), q8.transition_block_int8_plain(x, p))
    qb = {k: v.to(dev) for k, v in bs.quantize_basic_stage_params(_basic_blocks(rng, 2, c)).items()}
    _equal(bs.basic_stage_int8(x, qb), bs.basic_stage_int8_plain(x, qb))


def _qtransition(rng, dev, cin, cmid, cout):
    w = (rng.random((cmid, cmid, 3, 3)) - 0.5).astype(np.float32)
    (s1, b1), (s2, b2), (s3, b3), (sp, bp) = (_bn(rng, dev, c) for c in (cmid, cmid, cout, cout))
    p = dict(w_reduce=(rng.random((cin, cmid)) - 0.5).astype(np.float32), s_reduce=s1,
             b_reduce=b1, w9_mid=direct_filter(w), s_mid=s2, b_mid=b2,
             w_expand=(rng.random((cmid, cout)) - 0.5).astype(np.float32), s_expand=s3,
             b_expand=b3, w_proj=(rng.random((cin, cout)) - 0.5).astype(np.float32),
             s_proj=sp, b_proj=bp)
    return {k: v.to(dev) for k, v in q8.quantize_transition_params(p).items()}


@pytest.mark.parametrize("n,h,w,cin,cmid,cout", [
    (3, 15, 15, 68, 20, 130), (8, 7, 7, 300, 40, 90), (1, 14, 14, 64, 32, 128),
    (2, 9, 8, 256, 300, 70), (8, 14, 14, 128, 64, 256),
])
def test_transition_int8_odd_maps_and_batches(dev, n, h, w, cin, cmid, cout):
    rng = np.random.default_rng(h * w + cin + cout + 1)
    p = _qtransition(rng, dev, cin, cmid, cout)
    x = _r(rng, dev, n, h, w, cin).abs()
    _agree(q8.transition_block_int8(x, p), q8.transition_block_int8_plain(x, p), rtol=1e-3)


def test_int8_wrappers_reject_what_the_kernels_do_not_take(dev):
    rng = np.random.default_rng(2)
    x = _r(rng, dev, 8, 12)
    w_q, s_w = _q(rng, dev, 12, 8)
    s, b = _bn(rng, dev, 8)
    with pytest.raises(TypeError):
        q8.conv1x1_bn_int8(x, w_q.float(), s_w, s, b, True)          # weights not int8
    x10, w10 = x[:, :10].contiguous(), w_q[:10].contiguous()         # K % 4: padded, taken
    assert torch.equal(q8.conv1x1_bn_int8(x10, w10, s_w, s, b, True),
                       q8.conv1x1_bn_int8_plain(x10, w10, s_w, s, b, True))
    with pytest.raises(ValueError):
        q8.conv1x1_bn_int8(x, w_q, s_w[:4], s, b, True)               # s_w not per channel
    stacked = _qstacked(rng, dev, 2, 16, 8)
    xs = _r(rng, dev, 1, 7, 7, 16)
    with pytest.raises(TypeError):
        q8.resnet_stage_int8(xs, dict(stacked, u2_mid_bf16=stacked["u2_mid_bf16"].float()),
                             "winograd2")
    with pytest.raises(ValueError):
        q8.resnet_stage_int8(xs, dict(stacked, w_expand_q=stacked["w_expand_q"][:, :, :8]))
    p = _qtransition(rng, dev, 16, 8, 32)
    with pytest.raises(TypeError):
        q8.transition_block_int8(xs, dict(p, w_proj_q=p["w_proj_q"].float()))


# --- the basic family ------------------------------------------------------


def _basic_blocks(rng, nb, c):
    blocks = []
    for _ in range(nb):
        b = {}
        for leg in ("a", "b"):
            w = ((rng.random((c, c, 3, 3)) - 0.5) * 0.2).astype(np.float32)
            b[f"w9_{leg}"] = direct_filter(w)
            b[f"s_{leg}"] = (rng.random(c) * 0.5 + 0.25).astype(np.float32)
            b[f"b_{leg}"] = (rng.random(c) - 0.5).astype(np.float32)
        blocks.append(b)
    return blocks


# (N, H=W, C, blocks): N=3, one block (ResNet-18's run), channels off 64 and
# 128, conv5_x's 7x7x512 at two blocks (29 K splits in the f32 plan), K
# splits with a ragged last range, C = 6 (the f32 kernel's 4-byte copies);
# the first image all zero where N > 1 (every row's scale 1).
BASIC_SHAPES = [(3, 7, 40, 1), (1, 7, 512, 2), (2, 5, 20, 3), (8, 7, 36, 2), (1, 9, 68, 1),
                (2, 5, 6, 2)]


@pytest.mark.parametrize("n,hw,c,nb", BASIC_SHAPES)
def test_basic_stage_edges_and_batches(dev, n, hw, c, nb):
    rng = np.random.default_rng(n * hw + c + nb)
    stacked = {k: v.to(dev) for k, v in bs.stack_basic_stage_params(_basic_blocks(rng, nb, c)).items()}
    x = _r(rng, dev, n, hw, hw, c).abs()
    if n > 1:
        x[0] = 0.0
    _agree(bs.basic_stage_fused(x, stacked), bs.basic_stage_fused_plain(x, stacked))


def _basic_f32(rng, dev, n, hw, c, nb):
    stacked = {k: v.to(dev) for k, v in bs.stack_basic_stage_params(_basic_blocks(rng, nb, c)).items()}
    x = _r(rng, dev, n, hw, hw, c).abs()
    if n > 1:
        x[0] = 0.0
    return x, stacked


# The served f32 basic stage (N, H=W, C, blocks): ResNet-34's conv5_x run at
# N=1 and N=8 and ResNet-18's one block, on the 3xTF32 tensor cores: within
# the f32 bar of the twin, two calls equal to the bit, and within the bar
# under every split the sweep may pick (one split too).
@pytest.mark.parametrize("n,hw,c,nb", [(1, 7, 512, 2), (8, 7, 512, 2), (1, 7, 512, 1)])
def test_basic_stage_served_shapes(dev, n, hw, c, nb):
    x, stacked = _basic_f32(np.random.default_rng(n + nb + 7), dev, n, hw, c, nb)
    ref = bs.basic_stage_fused_plain(x, stacked)
    first = bs.basic_stage_fused(x, stacked)
    _agree(first, ref)
    assert torch.equal(first, bs.basic_stage_fused(x, stacked))
    plan = bs.basic_stage_plan(n, hw, hw, c, _build.sm_count(dev))
    for want in (1, 2, 8, 16, 64):
        conv = split_k(9 * c, want, TRANSITION_STEP, TRANSITION_STEP)
        _agree(bs.basic_stage_fused_planned(x, stacked, plan._replace(conv=conv)), ref)


def test_basic_stage_entry_refuses_a_plan_it_does_not_take(dev):
    """csrc/basic_stage.cu's entry refuses a grid larger than it holds
    resident, a split off the tile's k step and one that leaves K
    uncovered."""
    x, stacked = _basic_f32(np.random.default_rng(5), dev, 1, 7, 64, 1)
    plan = bs.basic_stage_plan(1, 7, 7, 64, _build.sm_count(dev))
    assert plan.conv.splits > 1
    _agree(bs.basic_stage_fused_planned(x, stacked, plan), bs.basic_stage_fused_plain(x, stacked))
    for bad in (plan._replace(blocks=4 * plan.blocks),
                plan._replace(conv=plan.conv._replace(chunk=plan.conv.chunk + 16)),
                plan._replace(conv=plan.conv._replace(splits=1))):
        with pytest.raises(RuntimeError):
            bs.basic_stage_fused_planned(x, stacked, bad)


def _basic_int8(rng, dev, n, hw, c, nb):
    q = {k: v.to(dev) for k, v in bs.quantize_basic_stage_params(_basic_blocks(rng, nb, c)).items()}
    x = _r(rng, dev, n, hw, hw, c).abs()
    if n > 1:
        x[0] = 0.0
    return x, q


@pytest.mark.parametrize("n,hw,c,nb", BASIC_SHAPES)
def test_basic_stage_int8_edges_and_batches(dev, n, hw, c, nb):
    x, q = _basic_int8(np.random.default_rng(n * hw + c + nb + 1), dev, n, hw, c, nb)
    _equal(bs.basic_stage_int8(x, q), bs.basic_stage_int8_plain(x, q))


# The served int8 basic stage (N, H=W, C, blocks): ResNet-34's conv5_x run at
# N=1 and N=8 and ResNet-18's one block, under the plan's split and unsplit:
# equal to the twin, and two calls equal to the bit.
@pytest.mark.parametrize("n,hw,c,nb", [(1, 7, 512, 2), (8, 7, 512, 2), (1, 7, 512, 1)])
def test_basic_stage_int8_served_shapes(dev, n, hw, c, nb):
    x, q = _basic_int8(np.random.default_rng(n + nb), dev, n, hw, c, nb)
    ref = bs.basic_stage_int8_plain(x, q)
    first = bs.basic_stage_int8(x, q)
    _equal(first, ref)
    assert torch.equal(first, bs.basic_stage_int8(x, q))
    plan = bs.basic_stage_int8_plan(n, hw, hw, c, _build.sm_count(dev))
    _equal(bs.basic_stage_int8_planned(x, q, plan._replace(splits=1, chunk=plan.kp)), ref)


def test_basic_stage_int8_entry_refuses_a_plan_it_does_not_take(dev):
    """csrc/basic_stage_int8.cu's entry refuses a grid larger than it holds
    resident, a split off the s8 tile's stage and one that leaves K
    uncovered."""
    x, q = _basic_int8(np.random.default_rng(5), dev, 1, 7, 64, 1)
    plan = bs.basic_stage_int8_plan(1, 7, 7, 64, _build.sm_count(dev))
    assert plan.splits > 1
    for bad in (plan._replace(blocks=4 * plan.blocks), plan._replace(chunk=plan.chunk + 32),
                plan._replace(splits=1)):
        with pytest.raises(RuntimeError):
            bs.basic_stage_int8_planned(x, q, bad)


# (N, H, W, Cin, Cout): one output tile over one group of Cin off 128, over
# two 128-channel groups, the quantized V stash at 14x14x256 and at N=8,
# odd maps, a Cout below one column block, Cin 13 (read a channel at a
# time); eight groups at Cin 1024, whose shared memory leaves one block an
# SM.
@pytest.mark.parametrize("n,h,w,cin,cout", [
    (3, 7, 7, 72, 96), (2, 9, 5, 256, 128), (1, 14, 14, 256, 256), (8, 14, 14, 256, 256),
    (1, 28, 28, 128, 128), (3, 6, 5, 40, 20), (2, 5, 7, 13, 36), (1, 7, 7, 1024, 64),
])
@pytest.mark.parametrize("relu", [True, False])
def test_winograd_int8_branches_and_edges(dev, n, h, w, cin, cout, relu):
    rng = np.random.default_rng(h * w + cin + cout + relu)
    x, u_q, s_u, s, b = _winograd_int8(rng, dev, n, h, w, cin, cout)
    _equal(q8.conv3x3_bn_winograd_int8(x, u_q, s_u, s, b, relu),
           q8.conv3x3_bn_winograd_int8_plain(x, u_q, s_u, s, b, relu))


def _winograd_int8(rng, dev, n, h, w, cin, cout):
    """Seeded int8 Winograd operands; the first image all zero where N > 1."""
    x = _r(rng, dev, n, h, w, cin).abs()
    if n > 1:
        x[0] = 0.0
    wt = ((rng.random((cout, cin, 3, 3)) - 0.5) * 0.2).astype(np.float32)
    u_q, s_u = (torch.as_tensor(a, device=dev)
                for a in q8.quantize_winograd_filter(transforms.transform_filter(wt, m=2)))
    s, b = _bn(rng, dev, cout)
    return x, u_q, s_u, s, b


# The served int8 Winograds (N, H, W, Cin, Cout): ResNet-34's 28x28x128 (one
# output tile) and 14x14x256 (the stash) at N=1 and N=8, both legs (ReLU or
# not), on the plan's grid and on one block an SM: equal to the twin, two
# calls equal to the bit.
@pytest.mark.parametrize("n,h,w,cin,cout", [(1, 28, 28, 128, 128), (1, 14, 14, 256, 256),
                                            (8, 28, 28, 128, 128), (8, 14, 14, 256, 256)])
@pytest.mark.parametrize("relu", [True, False])
def test_winograd_int8_served_shapes(dev, n, h, w, cin, cout, relu):
    x, u_q, s_u, s, b = _winograd_int8(np.random.default_rng(h + cin + relu), dev, n, h, w,
                                       cin, cout)
    ref = q8.conv3x3_bn_winograd_int8_plain(x, u_q, s_u, s, b, relu)
    first = q8.conv3x3_bn_winograd_int8(x, u_q, s_u, s, b, relu)
    _equal(first, ref)
    assert torch.equal(first, q8.conv3x3_bn_winograd_int8(x, u_q, s_u, s, b, relu))
    sms = _build.sm_count(dev)
    plan = q8.winograd_int8_plan(n, h, w, cin, cout, sms)
    one = plan._replace(blocks=min(plan.items(), sms))
    _equal(q8.conv3x3_bn_winograd_int8_planned(x, u_q, s_u, s, b, relu, one), ref)


# Cin past one span of K (WINO_INT8_CHUNK), 14x14 at N=1 and N=2: nine
# 128-channel groups at Cout 128 (the group branch) and the stash at Cin
# 2048 -> 256, both on the plan's spans: equal to the twin, two calls equal
# to the bit.
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("cin,cout", [(1152, 128), (2048, 256)])
def test_winograd_int8_takes_any_cin(dev, n, cin, cout):
    x, u_q, s_u, s, b = _winograd_int8(np.random.default_rng(cin + n), dev, n, 14, 14, cin, cout)
    plan = q8.winograd_int8_plan(n, 14, 14, cin, cout, _build.sm_count(dev))
    assert plan.chunk < plan.kp
    ref = q8.conv3x3_bn_winograd_int8_plain(x, u_q, s_u, s, b, True)
    first = q8.conv3x3_bn_winograd_int8(x, u_q, s_u, s, b, True)
    _equal(first, ref)
    assert torch.equal(first, q8.conv3x3_bn_winograd_int8(x, u_q, s_u, s, b, True))


# Spans at narrow widths, through explicit plans of 128-channel spans: two
# groups at Cout 128, the stash at Cout 256, one group of an odd Cin (200,
# its last span 96 of the padded 224) with ReLU and without; equal to the
# twin. A span off the scale group or past WINO_INT8_CHUNK is refused.
@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 9, 5, 256, 128), (1, 14, 14, 256, 256),
                                            (3, 6, 5, 200, 72)])
@pytest.mark.parametrize("relu", [True, False])
def test_winograd_int8_spans_at_narrow_widths(dev, n, h, w, cin, cout, relu):
    x, u_q, s_u, s, b = _winograd_int8(np.random.default_rng(cin + cout + relu), dev, n, h, w,
                                       cin, cout)
    plan = q8.winograd_int8_plan(n, h, w, cin, cout, _build.sm_count(dev))
    spans = plan._replace(chunk=q8.WINO_INT8_GROUP)
    _equal(q8.conv3x3_bn_winograd_int8_planned(x, u_q, s_u, s, b, relu, spans),
           q8.conv3x3_bn_winograd_int8_plain(x, u_q, s_u, s, b, relu))
    for bad in (plan._replace(chunk=96), plan._replace(chunk=2 * q8.WINO_INT8_CHUNK)):
        with pytest.raises(RuntimeError):
            q8.conv3x3_bn_winograd_int8_planned(x, u_q, s_u, s, b, relu, bad)


def test_winograd_int8_entry_refuses_a_plan_it_does_not_take(dev):
    """csrc/winograd_int8.cu's entry refuses a grid larger than it holds
    resident and a padded Cin off the MMA's depth."""
    n, h, w, cin, cout = 1, 14, 14, 64, 64
    x, u_q, s_u, s, b = _winograd_int8(np.random.default_rng(6), dev, n, h, w, cin, cout)
    plan = q8.winograd_int8_plan(n, h, w, cin, cout, _build.sm_count(dev))
    for bad in (plan._replace(blocks=8 * _build.sm_count(dev)), plan._replace(kp=plan.kp + 32),
                plan._replace(kp=plan.kp - 32)):
        with pytest.raises(RuntimeError):
            q8.conv3x3_bn_winograd_int8_planned(x, u_q, s_u, s, b, True, bad)


@pytest.mark.parametrize("n,h,w,cin,cout", [(3, 7, 9, 13, 70), (1, 56, 56, 64, 64), (2, 6, 6, 20, 33)])
@pytest.mark.parametrize("relu", [True, False])
def test_winograd_bf16_filter_edges(dev, n, h, w, cin, cout, relu):
    """The int8 tier's F(2,3) on bf16 filters (precision "bf16", the FP64
    route) equals its float64 twin to the bit."""
    rng = np.random.default_rng(h * w + cin + cout + 2 * relu)
    x = _r(rng, dev, n, h, w, cin)
    wt = (rng.random((cout, cin, 3, 3)) - 0.5).astype(np.float32)
    u = torch.as_tensor(transforms.transform_filter(wt, m=2), device=dev).to(torch.bfloat16)
    s, b = _bn(rng, dev, cout)
    _equal(conv3x3_bn_winograd(x, u, s, b, relu, "bf16"), winograd2_mid_plain(x, u, s, b, relu))


def test_basic_wrappers_reject_what_the_kernels_do_not_take(dev):
    rng = np.random.default_rng(4)
    stacked = {k: v.to(dev) for k, v in bs.stack_basic_stage_params(_basic_blocks(rng, 2, 8)).items()}
    x = _r(rng, dev, 1, 5, 5, 8)
    with pytest.raises(TypeError):
        bs.basic_stage_fused(x, dict(stacked, w9_a=stacked["w9_a"].double()))
    q = {k: v.to(dev) for k, v in bs.quantize_basic_stage_params(_basic_blocks(rng, 1, 6)).items()}
    x6 = _r(rng, dev, 1, 5, 5, 6)                                       # C % 4: padded, taken
    assert torch.equal(bs.basic_stage_int8(x6, q), bs.basic_stage_int8_plain(x6, q))
    u_q = torch.zeros(16, 8, 192, dtype=torch.int8, device=dev)
    s_u, sb = torch.ones(16, 192, device=dev), torch.ones(192, device=dev)
    with pytest.raises(ValueError):
        q8.conv3x3_bn_winograd_int8(x, u_q, s_u, sb, sb)                # Cout 192 > 128
    with pytest.raises(TypeError):
        q8.conv3x3_bn_winograd_int8(x, u_q[..., :64].float(), s_u[:, :64].contiguous(),
                                    sb[:64], sb[:64])                   # filter not int8
    u4 = torch.zeros(36, 8, 4, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        conv3x3_bn_winograd(x, u4, sb[:4], sb[:4], precision="bf16")    # bf16 at F(4,3)


# --- the split-K pointwise and int8 direct kernels ---------------------------

# (P, K, N): the served small-P products (the heads at N=1 and N=8, conv5_x's
# reduce, ResNet-34's strided conv5_x and conv4_x entries), one whose K is
# not a multiple of its split chunk, and one at a single split.
POINTWISE_SPLIT_SHAPES = [(1, 2048, 1000), (8, 2048, 1000), (49, 2048, 512), (49, 2304, 512),
                          (196, 1152, 256), (49, 2000, 512), (3136, 64, 256)]


@pytest.mark.parametrize("p,k,n", POINTWISE_SPLIT_SHAPES)
def test_pointwise_split_k_shapes(dev, p, k, n):
    plan = split_plan(p, k, n, _build.sm_count(dev))
    if (p, k, n) == (49, 2000, 512):
        assert plan.splits > 1 and k % plan.chunk
    if (p, k, n) == (3136, 64, 256):
        assert plan.splits == 1
    rng = np.random.default_rng(p + k + n)
    x, w = _r(rng, dev, p, k), _r(rng, dev, k, n)
    s, b = _bn(rng, dev, n)
    _agree(conv1x1_bn(x, w, s, b, p > 8), conv1x1_bn_plain(x, w, s, b, p > 8))


@pytest.mark.parametrize("p,k,n", [(1, 2048, 1000), (49, 2304, 512)])
def test_pointwise_split_k_repeats_to_the_bit(dev, p, k, n):
    rng = np.random.default_rng(k + n)
    x, w = _r(rng, dev, p, k), _r(rng, dev, k, n)
    s, b = _bn(rng, dev, n)
    first = conv1x1_bn(x, w, s, b, False)
    again = conv1x1_bn(x, w, s, b, False)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


# (N, H, W, Cin, Cout): ResNet-34's int8 entry b-leg (K split ~16 ways),
# ResNet-50's int8 projection 3x3 (49 row tiles), and K = 36 (Cin 4,
# zero-padded to the MMA's 32-byte depth) with an all-zero image.
@pytest.mark.parametrize("n,h,w,cin,cout,relu", [
    (1, 7, 7, 512, 512, False), (1, 56, 56, 64, 64, True), (2, 5, 7, 4, 70, True),
])
def test_direct_int8_equals_its_twin(dev, n, h, w, cin, cout, relu):
    rng = np.random.default_rng(h * w + cin + cout)
    x = _r(rng, dev, n, h, w, cin)
    if n > 1:
        x[0] = 0.0
    w9_q, s_w9 = _q(rng, dev, 9 * cin, cout)
    s, b = _bn(rng, dev, cout)
    out = q8.conv3x3_bn_int8(x, w9_q, s_w9, s, b, relu)
    ref = q8.conv3x3_bn_int8_plain(x, w9_q, s_w9, s, b, relu)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() == 0.0


# --- the f32 Winograd and stage on the tensor cores -------------------------

# The served f32 Winograd convs (N, H, W, Cin, Cout, m), ResNet-50's
# projection and ResNet-34's identity 3x3s at N=1 and N=8, and the F(4,3)
# check shape: the plan's items fill a wave, the call agrees with its twin
# and repeats to the bit.
@pytest.mark.parametrize("n,h,w,cin,cout,m", [
    (1, 56, 56, 64, 64, 2), (1, 28, 28, 128, 128, 2), (1, 14, 14, 256, 256, 2),
    (1, 14, 14, 128, 128, 4), (8, 56, 56, 64, 64, 2), (8, 14, 14, 256, 256, 2),
])
def test_winograd_served_shapes(dev, n, h, w, cin, cout, m):
    rng = np.random.default_rng(n * h + cin + m)
    x = _r(rng, dev, n, h, w, cin)
    wt = (rng.random((cout, cin, 3, 3)) - 0.5).astype(np.float32)
    u = torch.as_tensor(transforms.transform_filter(wt, m=m), device=dev)
    s, b = _bn(rng, dev, cout)
    sms = _build.sm_count(dev)
    plan = winograd_plan(n, h, w, cin, cout, m, sms)
    assert plan.items(winograd_tiles(n, h, w, m), cout, (m + 2) ** 2) >= sms
    first = conv3x3_bn_winograd(x, u, s, b)
    _agree(first, conv3x3_bn_winograd_plain(x, u, s, b))
    assert torch.equal(first, conv3x3_bn_winograd(x, u, s, b))


# Ragged Cin and Cout (Cin 3 and 13, V's rows zero-padded to 4; Cout 70
# and 33 take the 4-byte copies) under the wrapper's plan, and under a plan
# that splits Cin into ranges of WINOGRAD_STEP multiples with a ragged last
# one.
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("n,hw,cin,cout", [(2, 10, 3, 70), (1, 7, 13, 33), (1, 9, 200, 68)])
def test_winograd_ragged_channels_and_split_cin(dev, m, n, hw, cin, cout):
    rng = np.random.default_rng(hw * cin + cout + m)
    x = _r(rng, dev, n, hw, hw, cin)
    wt = (rng.random((cout, cin, 3, 3)) - 0.5).astype(np.float32)
    u = torch.as_tensor(transforms.transform_filter(wt, m=m), device=dev)
    s, b = _bn(rng, dev, cout)
    ref = conv3x3_bn_winograd_plain(x, u, s, b, relu=False)
    _agree(conv3x3_bn_winograd(x, u, s, b, relu=False), ref)
    split = split_k(cin, 3, WINOGRAD_STEP, WINOGRAD_STEP)
    plan = winograd_plan(n, hw, hw, cin, cout, m, _build.sm_count(dev))._replace(
        splits=split.splits, chunk=split.chunk)
    if cin == 200:
        assert plan.splits == 3 and cin % plan.chunk
    _agree(conv3x3_bn_winograd_planned(x, u, s, b, False, plan), ref)


# The served f32 stages (conv2_x and conv3_x on the F(2,3) mid, conv4_x on
# the direct mid) at N=1, conv2_x and conv4_x at N=8, and the block at
# mode 9: each agrees with its twin, and two calls are equal to the bit.
@pytest.mark.parametrize("n,hw,cio,cmid,nb,mid", [
    (1, 56, 256, 64, 2, "winograd2"), (1, 28, 512, 128, 3, "winograd2"),
    (1, 14, 1024, 256, 5, "direct"), (8, 56, 256, 64, 2, "winograd2"),
    (8, 14, 1024, 256, 5, "direct"), (1, 28, 512, 128, 1, "winograd2"),
])
def test_stage_served_shapes(dev, n, hw, cio, cmid, nb, mid):
    rng = np.random.default_rng(n + hw + nb)
    stacked = _stacked(rng, dev, nb, cio, cmid)
    x = _r(rng, dev, n, hw, hw, cio)
    first = resnet_stage_fused(x, stacked, mid)
    _agree(first, resnet_stage_fused_plain(x, stacked, mid))
    assert torch.equal(first, resnet_stage_fused(x, stacked, mid))


# --- the stem on the FP64 tensor cores, the int8 transition on s8 mma.sync --

def _stem_case(rng, dev, n, h, w, cin, c):
    x = _r(rng, dev, n, h, w, cin)
    w192 = torch.as_tensor(stem_filter_s2d((rng.random((c, cin, 7, 7)) - 0.5).astype(np.float32)),
                           device=dev)
    s, b = _bn(rng, dev, c)
    return x, w192, s, b


# The served stem (224x224x3 -> 56x56x64) at N=1 and N=8: "f32" within the
# f32 bar, "bf16" (the int8 tiers' stem, exact FP64 sums) equal to its twin.
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 8])
def test_stem_served_shape(dev, n, precision):
    x, w192, s, b = _stem_case(np.random.default_rng(n), dev, n, 224, 224, 3, 64)
    out = stem_fused(x, w192, s, b, precision)
    ref = stem_fused_plain(x, w192, s, b, precision)
    if precision == "bf16":
        _equal(out, ref)
    else:
        _agree(out, ref)


@pytest.mark.parametrize("n,h,w,cin,c", [
    (2, 30, 30, 3, 16), (1, 33, 31, 3, 64), (1, 17, 18, 4, 24),
])
def test_stem_bf16_equals_its_twin_on_odd_images(dev, n, h, w, cin, c):
    x, w192, s, b = _stem_case(np.random.default_rng(h * w + c + 2), dev, n, h, w, cin, c)
    _equal(stem_fused(x, w192, s, b, "bf16"), stem_fused_plain(x, w192, s, b, "bf16"))


# The served int8 transitions (56->28, 28->14, 14->7 at N=1; 14->7 at N=8),
# odd maps, and channel counts off multiples of 4 (padded by the wrapper):
# equal to the twin, and two calls equal to the bit.
@pytest.mark.parametrize("n,h,w,cin,cmid,cout", [
    (1, 56, 56, 256, 128, 512), (1, 28, 28, 512, 256, 1024), (1, 14, 14, 1024, 512, 2048),
    (8, 14, 14, 1024, 512, 2048), (3, 15, 15, 68, 20, 130), (2, 9, 8, 256, 300, 70),
    (8, 7, 7, 300, 40, 90), (2, 7, 5, 6, 10, 18),
])
def test_transition_int8_equals_its_twin(dev, n, h, w, cin, cmid, cout):
    rng = np.random.default_rng(h * w + cin + cmid + cout)
    p = _qtransition(rng, dev, cin, cmid, cout)
    x = _r(rng, dev, n, h, w, cin).abs()
    first = q8.transition_block_int8(x, p)
    _equal(first, q8.transition_block_int8_plain(x, p))
    assert torch.equal(first, q8.transition_block_int8(x, p))


# -- the bf16w tier: the bf16 instantiations against their plain twins ------
BF16 = torch.bfloat16


def _bf16w(layer):
    """A layer's weights in bfloat16 (the bf16w tier's storage), BN as it is."""
    return {k: v.to(BF16) if k.startswith(("w", "u2")) else v for k, v in layer.items()}


# The head (N 1000) on the GEMV at P = 1 and 8 and on the MMA tiles just
# above (P = 9); N off multiples of 8 and odd (the 2-byte B path); K off
# multiples of 16; served 1x1s of the entry block at 56x56 and of conv5_x.
@pytest.mark.parametrize("p,k,n", [
    (1, 2048, 1000), (8, 2048, 1000), (9, 2048, 1000), (70, 130, 60), (5, 64, 33),
    (65, 100, 33), (3, 70, 40), (65, 70, 40), (3136, 64, 256), (49, 2048, 512),
])
def test_pointwise_bf16w(dev, p, k, n):
    rng = np.random.default_rng(p + k + n)
    x, w = _r(rng, dev, p, k), _r(rng, dev, k, n).to(BF16)
    s, b = _bn(rng, dev, n)
    for relu in (False, True):
        first = conv1x1_bn(x, w, s, b, relu)
        _agree(first, conv1x1_bn_plain(x, w, s, b, relu))
        assert torch.equal(first, conv1x1_bn(x, w, s, b, relu))


@pytest.mark.parametrize("n,h,w,cin,c", [
    (1, 224, 224, 3, 64), (8, 224, 224, 3, 64), (2, 30, 30, 3, 16), (1, 33, 31, 3, 64),
])
def test_stem_bf16w(dev, n, h, w, cin, c):
    x, w192, s, b = _stem_case(np.random.default_rng(h * w + c + 3), dev, n, h, w, cin, c)
    w192 = w192.to(BF16)
    _agree(stem_fused(x, w192, s, b, "bf16w"), stem_fused_plain(x, w192, s, b, "bf16w"))


# Ragged channels (Cmid off multiples of 8: element-wise B loads), one
# block and two and three, both mids, the served conv2_x/conv3_x/conv4_x and
# conv5_x (the bf16w gate fuses it) at N=1 and N=8.
@pytest.mark.parametrize("n,hw,cio,cmid,nb,mid", [
    (1, 7, 70, 20, 3, "direct"), (3, 9, 70, 20, 1, "winograd2"), (2, 9, 144, 300, 2, "direct"),
    (1, 29, 72, 24, 2, "winograd2"), (1, 56, 256, 64, 2, "winograd2"),
    (1, 28, 512, 128, 3, "winograd2"), (1, 14, 1024, 256, 5, "direct"),
    (1, 14, 1024, 256, 1, "direct"), (1, 7, 2048, 512, 2, "direct"),
    (8, 7, 2048, 512, 2, "direct"), (8, 14, 1024, 256, 5, "direct"),
])
def test_stage_bf16w(dev, n, hw, cio, cmid, nb, mid):
    rng = np.random.default_rng(n * hw + cio + cmid + nb)
    stacked = _bf16w(_stacked(rng, dev, nb, cio, cmid))
    x = _r(rng, dev, n, hw, hw, cio)
    first = resnet_stage_fused(x, stacked, mid)
    _agree(first, resnet_stage_fused_plain(x, stacked, mid))
    assert torch.equal(first, resnet_stage_fused(x, stacked, mid))


@pytest.mark.parametrize("n,h,w,cin,cmid,cout", [
    (3, 15, 15, 70, 20, 130), (2, 9, 8, 256, 300, 70), (1, 56, 56, 256, 128, 512),
    (1, 28, 28, 512, 256, 1024), (1, 14, 14, 1024, 512, 2048), (8, 14, 14, 1024, 512, 2048),
])
def test_transition_bf16w(dev, n, h, w, cin, cmid, cout):
    rng = np.random.default_rng(h * w + cin + cout + 1)
    p = _transition(rng, dev, cin, cmid, cout)
    p["wep"], p["bep"] = fuse_transition_weights(p)
    p = _bf16w(p)
    x = _r(rng, dev, n, h, w, cin)
    first = transition_block_fused(x, p)
    _agree(first, transition_block_fused_plain(x, p))
    assert torch.equal(first, transition_block_fused(x, p))


# The served ResNet-34 3x3s at N=1 and N=8 (F(2,3) split Cin at 28x28x128
# and 14x14x256), Cout off multiples of 8 (60, 70, 130: the element-wise U
# loads), Cin 3 and 70, maps the tile does not divide.
@pytest.mark.parametrize("n,h,w,cin,cout", [
    (1, 56, 56, 64, 64), (8, 56, 56, 64, 64), (1, 28, 28, 128, 128), (8, 28, 28, 128, 128),
    (1, 14, 14, 256, 256), (8, 14, 14, 256, 256), (2, 9, 7, 70, 60), (1, 15, 13, 3, 70),
    (3, 10, 10, 64, 130), (1, 12, 12, 256, 64),
])
def test_winograd_bf16w(dev, n, h, w, cin, cout):
    rng = np.random.default_rng(h * w + cin + cout + 4)
    x = _r(rng, dev, n, h, w, cin)
    wt = (rng.random((cout, cin, 3, 3)) - 0.5).astype(np.float32)
    u = torch.as_tensor(transforms.transform_filter(wt, m=2), device=dev).to(BF16)
    s, b = _bn(rng, dev, cout)
    for relu in (True, False):
        first = conv3x3_bn_winograd(x, u, s, b, relu, "bf16w")
        _agree(first, conv3x3_bn_winograd_plain(x, u, s, b, relu))
        assert torch.equal(first, conv3x3_bn_winograd(x, u, s, b, relu, "bf16w"))


# The served conv5_x entry b-leg at N=1 and N=8, Cout 60, 70 and 130, Cin 3
# and 70 (the 4-byte im2col copies), K split with a ragged last range.
@pytest.mark.parametrize("n,hw,cin,cout", [
    (1, 7, 512, 512), (8, 7, 512, 512), (2, 9, 70, 60), (1, 7, 3, 70), (3, 6, 64, 130),
    (1, 14, 256, 256),
])
def test_direct_bf16w(dev, n, hw, cin, cout):
    rng = np.random.default_rng(hw + cin + cout + 5)
    x = _r(rng, dev, n, hw, hw, cin)
    w9 = torch.as_tensor(direct_filter((rng.random((cout, cin, 3, 3)) - 0.5).astype(np.float32)),
                         device=dev).to(BF16)
    s, b = _bn(rng, dev, cout)
    for relu in (True, False):
        first = conv3x3_bn_direct(x, w9, s, b, relu)
        _agree(first, conv3x3_bn_direct_plain(x, w9, s, b, relu))
        assert torch.equal(first, conv3x3_bn_direct(x, w9, s, b, relu))


# conv5_x's run at N=1 and N=8 (ResNet-34: two blocks; ResNet-18: one),
# channels off multiples of 8 (70, 130: element-wise B loads), C = 3.
@pytest.mark.parametrize("n,hw,c,nb", [
    (1, 7, 512, 2), (8, 7, 512, 2), (1, 7, 512, 1), (3, 6, 70, 2), (2, 5, 130, 1),
    (1, 6, 3, 2),
])
def test_basic_stage_bf16w(dev, n, hw, c, nb):
    rng = np.random.default_rng(n * hw + c + nb + 6)
    stacked = {k: v.to(dev) for k, v in bs.stack_basic_stage_params(_basic_blocks(rng, nb, c)).items()}
    stacked = _bf16w(stacked)
    x = _r(rng, dev, n, hw, hw, c)
    first = bs.basic_stage_fused(x, stacked)
    _agree(first, bs.basic_stage_fused_plain(x, stacked))
    assert torch.equal(first, bs.basic_stage_fused(x, stacked))


def test_bf16w_refuses_an_activation_that_is_not_f32(dev):
    """A bfloat16 weight takes a float32 activation, on every bf16w entry."""
    rng = np.random.default_rng(5)
    x = _r(rng, dev, 1, 7, 7, 16)
    s, b = _bn(rng, dev, 8)
    with pytest.raises(ValueError, match="float32 activation"):
        conv1x1_bn(x.double(), _r(rng, dev, 16, 8).to(BF16), s, b, True)
    with pytest.raises(ValueError, match="float32 activation"):
        resnet_stage_fused(x.double(), _bf16w(_stacked(rng, dev, 1, 16, 8)))
    p = _transition(rng, dev, 16, 8, 32)
    p["wep"], p["bep"] = fuse_transition_weights(p)
    with pytest.raises(ValueError, match="float32 activation"):
        transition_block_fused(x.double(), _bf16w(p))
    img, w192, s64, b64 = _stem_case(rng, dev, 1, 32, 32, 3, 16)
    with pytest.raises(ValueError, match="float32 activation"):
        stem_fused(img.double(), w192.to(BF16), s64, b64, "bf16w")
    u = _r(rng, dev, 16, 16, 8).to(BF16)
    with pytest.raises(ValueError, match="float32 activation"):
        conv3x3_bn_winograd(x.double(), u, s, b, True, "bf16w")
    with pytest.raises(ValueError, match="float32 activation"):
        conv3x3_bn_direct(x.double(), _r(rng, dev, 9 * 16, 8).to(BF16), s, b)
    basic = _bf16w({k: v.to(dev) for k, v in
                    bs.stack_basic_stage_params(_basic_blocks(rng, 1, 16)).items()})
    with pytest.raises(ValueError, match="float32 activation"):
        bs.basic_stage_fused(x.double(), basic)


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4, 5])
def test_bench_run_case_is_strict_and_in_parity(dev, mode):
    """The benchmark CLI's layer modes on the card: every path within its
    bar of the float64 golden (strict: a breach raises), TF32 off, and a
    device time from graph replays for every path the mode has."""
    from winograd_tpu_torch.bench.cli import run_case

    r = run_case(mode, iterations=5, warmup=1)
    assert r["parity_ok"] and r["tf32"] is False and r["backend"] == "cuda"
    assert r["max_error_cudnn"] <= 1e-4
    for path in ("cuda", "cudnn", "int8", "bf16w") + (("direct", "winograd_f43")
                                                     if mode < 2 else ()):
        assert r[f"{path}_device_us"] > 0, path


def test_bench_graph_agrees_with_eager_event_timing(dev):
    """bench_graph's device time per call is within 20% of 20 eager calls
    back to back between two CUDA events, for a kernel long enough (about a
    millisecond) that the host's launch time hides behind it."""
    from winograd_tpu_torch.utils.timing import bench_graph

    rng = np.random.default_rng(6)
    x, w = _r(rng, dev, 25088, 1024), _r(rng, dev, 1024, 1024)
    s, b = _bn(rng, dev, 1024)

    def call():
        return conv1x1_bn(x, w, s, b, True)

    graph_us = bench_graph(call)
    for _ in range(3):
        call()
    a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(20):
        call()
    e.record()
    torch.cuda.synchronize()
    eager_us = 1e3 * a.elapsed_time(e) / 20
    assert abs(graph_us - eager_us) <= 0.2 * eager_us, (graph_us, eager_us)


# --- the stem's prepared-input entry -----------------------------------------


@pytest.mark.parametrize("n,h,w,cin,c", [(1, 224, 224, 3, 64), (8, 224, 224, 3, 64),
                                         (2, 30, 30, 3, 16), (1, 33, 31, 5, 24)])
@pytest.mark.parametrize("precision", ["f32", "bf16w", "bf16"])
def test_stem_pre_entry(dev, n, h, w, cin, c, precision):
    """csrc/stem.cu's prepared-input entry: within the f32 bound of its plain
    version (equal to it at "bf16", exact FP64 sums of bf16 products), and
    equal to the raw-image entry on the same image to the bit (the same
    staged patch, the same K order)."""
    x, w192, s, b = _stem_case(np.random.default_rng(h * w + c + n), dev, n, h, w, cin, c)
    if precision == "bf16w":
        w192 = w192.to(BF16)
    xb = stem_prepare_input(x.cpu(), precision).to(dev)
    out = stem_fused_pre(xb, w192, s, b, h, w, precision)
    ref = stem_fused_pre_plain(xb, w192, s, b, h, w, precision)
    if precision == "bf16":
        _equal(out, ref)
    else:
        _agree(out, ref)
    assert torch.equal(out, stem_fused(x, w192, s, b, precision))


# --- the serving engines' CUDA graphs ------------------------------------------


@dataclasses.dataclass(frozen=True)
class _TinyR50(ResNet50Config):
    stages = ((64, 16, 8, 1), (128, 32, 4, 1))
    img: int = 32
    stem_c: int = 16
    num_classes: int = 24


@dataclasses.dataclass(frozen=True)
class _TinyBasic(BasicNetConfig):
    stages = ((16, 8, 1), (32, 4, 2))
    img: int = 32
    stem_c: int = 16
    num_classes: int = 16


def _tiny_engine(dev, family, tier="f32"):
    if family == "resnet50":
        cfg = _TinyR50("tiny_r50")
        return ResNet50Engine(init_resnet50_params(cfg, seed=3, device="cpu"), tier=tier,
                              device=dev), cfg
    cfg = _TinyBasic("tiny_basic")
    params = basicnet_params(init_basicnet_arrays(cfg, seed=3), cfg, "cpu")
    return ResNetBasicEngine(params, tier=tier, device=dev), cfg


def _tiny_images(seed, n, img=32):
    return (np.random.default_rng(seed).random((n, img, img, 3)) - 0.5).astype(np.float32)


@pytest.mark.parametrize("family", ["resnet50", "basic"])
@pytest.mark.parametrize("tier", ["f32", "bf16w", "int8"])
def test_engine_replay_equals_the_eager_forward(dev, family, tier):
    """A graph replay computes what the tier's forward computes eagerly, to
    the bit, at N=1 and N=2; a single image is served as N=1."""
    engine, cfg = _tiny_engine(dev, family, tier)
    for n in (1, 2):
        x = _tiny_images(n, n)
        eager = engine._forward(torch.as_tensor(x, device=dev), engine._params, dev)
        for _ in range(2):  # the capturing request, then a replay alone
            assert torch.equal(engine(x), eager)
    single = engine(x[0])
    assert tuple(single.shape) == (cfg.num_classes,) and torch.equal(single, engine(x[:1])[0])


@pytest.mark.parametrize("family", ["resnet50", "basic"])
def test_engine_serve_pre_equals_the_raw_route(dev, family):
    engine, cfg = _tiny_engine(dev, family)
    x = _tiny_images(9, 2)
    xb = engine.prepare_input(x)
    assert xb.device.type == "cpu"
    assert torch.equal(engine.serve_pre(xb, img=cfg.img), engine(x))
    assert torch.equal(engine.serve_pre(engine.prepare_input(x[0]), img=cfg.img)[0], engine(x[0]))


def test_engine_result_survives_later_requests(dev):
    """engine(x) returns a tensor of its own: the next request's replay
    overwrites the graph's output buffer, not the result handed out."""
    engine, _ = _tiny_engine(dev, "resnet50")
    a, b = _tiny_images(1, 1), _tiny_images(2, 1)
    first = engine(a)
    kept = first.clone()
    second = engine(b)
    torch.cuda.synchronize()
    assert torch.equal(first, kept) and not torch.equal(first, second)
    assert torch.equal(engine(a), kept)


def test_engine_captures_each_shape_once_and_replays_count_nothing(dev):
    engine, _ = _tiny_engine(dev, "resnet50")
    from winograd_tpu_torch.engine import CAPTURE_PASSES

    _build.reset_counts()
    engine(_tiny_images(1, 1))
    first = dict(_build.LAUNCHES)
    per_forward = {k: v // CAPTURE_PASSES for k, v in first.items()}
    assert first and all(v == CAPTURE_PASSES * per_forward[k] for k, v in first.items())
    assert len(engine._graphs) == 1
    engine(_tiny_images(2, 1))
    engine(torch.as_tensor(_tiny_images(3, 1), device=dev))  # a device tensor, same graph
    assert dict(_build.LAUNCHES) == first and len(engine._graphs) == 1
    engine(_tiny_images(4, 3))  # a new batch shape: a new graph
    assert len(engine._graphs) == 2
    assert dict(_build.LAUNCHES) == {k: 2 * v for k, v in first.items()}
    engine(_tiny_images(5, 3))
    assert dict(_build.LAUNCHES) == {k: 2 * v for k, v in first.items()}
    assert engine.replays == 5  # every request, the capturing ones too, a replay


def test_engine_capture_failure_raises_and_never_serves_eagerly(dev):
    """A forward that cannot be captured (here one that reads a value on the
    host) raises, naming the request, at every request: no eager serving."""
    engine, _ = _tiny_engine(dev, "resnet50")
    forward = engine._forward

    def host_synced(x, params, device):
        out = forward(x, params, device)
        out.sum().item()
        return out

    stream = torch.cuda.current_stream()
    engine._forward = host_synced
    for _ in range(2):
        with pytest.raises(RuntimeError, match=r"cannot be captured in a CUDA graph"):
            engine(_tiny_images(1, 1))
        assert torch.cuda.current_stream() == stream
    assert not engine._graphs
    # Later requests capture into a fresh pool.
    engine._forward = forward
    x = _tiny_images(1, 1)
    assert torch.equal(engine(x), forward(torch.as_tensor(x, device=dev), engine._params, dev))


# --- training: kernels/vjp.py on the card ---------------------------------------


def _rand_block(rng, cio, cmid, cout=None, proj=False):
    """A bottleneck's trainable parameters (raw w_mid), numpy."""
    cout = cout or cio
    f = lambda *shape: (rng.random(shape) - 0.5).astype(np.float32)  # noqa: E731
    bn = lambda c: (0.8 + 0.4 * rng.random(c)).astype(np.float32)  # noqa: E731
    p = {"w_reduce": f(cio, cmid), "s_reduce": bn(cmid), "b_reduce": f(cmid),
         "w_mid": f(cmid, cmid, 3, 3), "s_mid": bn(cmid), "b_mid": f(cmid),
         "w_expand": f(cmid, cout), "s_expand": bn(cout), "b_expand": f(cout)}
    if proj:
        p.update(w_proj=f(cio, cout), s_proj=bn(cout), b_proj=f(cout))
    return p


def _train_case(name, rng):
    """(function(x, tree), x, tree) of a training Function, numpy inputs."""
    from winograd_tpu_torch.kernels import vjp

    f = lambda *shape: (rng.random(shape) - 0.5).astype(np.float32)  # noqa: E731
    bn = lambda c: (0.8 + 0.4 * rng.random(c)).astype(np.float32)  # noqa: E731
    prec = "bf16w" if name.endswith("_bf16w") else None
    base = name.removesuffix("_bf16w")
    if base in ("pointwise", "winograd2", "winograd4", "direct"):
        shape = (2, 14, 14, 64) if base == "pointwise" else (1, 14, 14, 64)
        w = f(64, 32) if base == "pointwise" else f(32, 64, 3, 3)
        tree = {"w": w, "s": bn(32), "b": f(32)}
        fn = {"pointwise": lambda x, p: vjp.conv1x1_bn_train(x, p["w"], p["s"], p["b"], True,
                                                             prec),
              "winograd2": lambda x, p: vjp.conv3x3_bn_winograd_train(x, p["w"], p["s"], p["b"],
                                                                      True, 2, prec),
              "winograd4": lambda x, p: vjp.conv3x3_bn_winograd_train(x, p["w"], p["s"], p["b"],
                                                                      False, 4),
              "direct": lambda x, p: vjp.conv3x3_bn_direct_train(x, p["w"], p["s"], p["b"], True,
                                                                 prec)}[base]
        return fn, f(*shape), tree
    if base == "stem":
        return (lambda x, p: vjp.stem_train_fused(x, p, prec), f(1, 40, 40, 3),
                {"w7_stem": f(16, 3, 7, 7), "s_stem": bn(16), "b_stem": f(16)})
    if base == "block":
        return (lambda x, p: vjp.bottleneck_block_train_fused(x, p, prec), f(1, 28, 28, 64),
                _rand_block(rng, 64, 32))
    if base == "transition":
        return (lambda x, p: vjp.transition_block_train_fused(x, p, prec), f(1, 14, 14, 64),
                _rand_block(rng, 64, 32, 128, proj=True))
    if base == "projection":
        return (lambda x, p: vjp.projection_block_train_fused(x, p, prec), f(1, 28, 28, 32),
                _rand_block(rng, 32, 16, 64, proj=True))
    if base in ("stage28", "stage7"):
        hw = 28 if base == "stage28" else 7
        return (lambda x, p: vjp.resnet_stage_train_streamed(x, p, prec), f(1, hw, hw, 64),
                [_rand_block(rng, 64, 32) for _ in range(2)])
    blocks = [{f"{k}_{leg}": v for leg in ("a", "b")
               for k, v in (("w", f(64, 64, 3, 3)), ("s", bn(64)), ("b", f(64)))}
              for _ in range(2)]
    return (lambda x, p: vjp.basic_stage_train_streamed(x, p, prec), f(1, 7, 7, 64), blocks)


def _train_grads(fn, x, tree, device):
    """fn's output and the gradients of sum(out^2) with respect to x and every
    leaf of tree, on `device`."""
    from winograd_tpu_torch.utils.tree import tree_leaves, tree_map

    xt = torch.as_tensor(x, device=device).requires_grad_()
    tt = tree_map(lambda a: torch.as_tensor(a, device=device).requires_grad_(), tree)
    out = fn(xt, tt)
    return [out.detach()] + list(torch.autograd.grad((out * out).sum(), [xt, *tree_leaves(tt)]))


TRAIN_CASES = ["pointwise", "winograd2", "winograd4", "direct", "stem", "block", "transition",
               "projection", "stage28", "stage7", "basic_stage", "pointwise_bf16w",
               "winograd2_bf16w", "direct_bf16w", "stem_bf16w", "block_bf16w",
               "transition_bf16w", "stage7_bf16w", "basic_stage_bf16w"]


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_train_function_agrees_with_its_plain_version(dev, name):
    """Each training Function (its forward the kernel, its 3x3 data gradient
    a kernel launch) against the same Function on the CPU (the plain
    versions, the same float32 arithmetic; at bf16w the plain bf16w
    products): the output and every gradient within 1e-4 * max(1, max|ref|),
    launching kernels and only kernels of the right family."""
    fn, x, tree = _train_case(name, np.random.default_rng(len(name)))
    _build.reset_counts()
    got = _train_grads(fn, x, tree, dev)
    launched = set(_build.LAUNCHES)
    want = _train_grads(fn, x, tree, "cpu")
    assert launched and len(got) == len(want)
    assert name.endswith("_bf16w") == any(k.endswith("_bf16w") for k in launched)
    for g, r in zip(got, want):
        _agree(g.cpu(), r)


def test_train_step_replays_as_it_runs_eagerly(dev):
    """One SGD step (models/train.py) captured in a CUDA graph and replayed
    from the same starting weights updates them as an eager step does."""
    from winograd_tpu_torch.models.resnet50 import init_resnet50_arrays
    from winograd_tpu_torch.models.train import (
        make_resnet50_train_step, trainable_resnet50_params,
    )
    from winograd_tpu_torch.utils.timing import capture_graph
    from winograd_tpu_torch.utils.tree import tree_leaves, tree_map

    tree = trainable_resnet50_params(init_resnet50_arrays(_TinyR50("tiny_r50"), seed=3))
    start = tree_map(lambda a: torch.as_tensor(a, device=dev), tree)
    x = torch.as_tensor(_tiny_images(7, 2), device=dev)
    labels = torch.tensor([1, 5], device=dev)
    step = make_resnet50_train_step(lr=1e-2)

    eager_p = tree_map(torch.clone, start)
    eager_m = tree_map(torch.zeros_like, start)
    _, _, eager_loss = step(eager_p, eager_m, x, labels)

    p = tree_map(torch.clone, start)
    m = tree_map(torch.zeros_like, start)
    graph, loss = capture_graph(lambda: step(p, m, x, labels)[2], what="the train step")
    with torch.no_grad():
        for a, b in zip(tree_leaves(p) + tree_leaves(m),
                        tree_leaves(start) + [torch.zeros_like(t) for t in tree_leaves(start)]):
            a.copy_(b)
    graph.replay()
    _agree(loss, eager_loss)
    for a, b in zip(tree_leaves(p) + tree_leaves(m), tree_leaves(eager_p) + tree_leaves(eager_m)):
        _agree(a, b)


# -- depth and batch: ResNet-152's longest runs and every family at N=32 ----
# The stage kernel's persistent launch at ResNet-152's conv4_x (35 identity
# blocks, the direct mid) and conv3_x (7 blocks, F(2,3) mid), at every tier.
@pytest.mark.parametrize("n,hw,cio,cmid,nb,mid", [
    (1, 14, 1024, 256, 35, "direct"), (1, 28, 512, 128, 7, "winograd2"),
])
@pytest.mark.parametrize("tier", ["f32", "bf16w", "int8"])
def test_stage_at_resnet152_depth(dev, n, hw, cio, cmid, nb, mid, tier):
    rng = np.random.default_rng(nb + cmid)
    x = _r(rng, dev, n, hw, hw, cio).abs()
    if tier == "int8":
        q = _qstacked(rng, dev, nb, cio, cmid)
        _equal(q8.resnet_stage_int8(x, q, mid), q8.resnet_stage_int8_plain(x, q, mid))
        return
    stacked = _stacked(rng, dev, nb, cio, cmid)
    if tier == "bf16w":
        stacked = _bf16w(stacked)
    _agree(resnet_stage_fused(x, stacked, mid), resnet_stage_fused_plain(x, stacked, mid))


# Every kernel family at the N=32 shapes of ResNet-50 and ResNet-18/34
# (bench modes 27 and 28): the stem, the entry block's 1x1s and F(2,3) at
# 56x56, each stage's widest run, the transitions, the conv5_x 3x3 and the
# head; against the plain versions at the f32 bar, the int8 kernels and the
# "bf16" routes equal to theirs.
N32 = 32


@pytest.mark.parametrize("precision", ["f32", "bf16w", "bf16"])
def test_stem_at_n32(dev, precision):
    rng = np.random.default_rng(32)
    x = _r(rng, dev, N32, 224, 224, 3)
    w192 = torch.as_tensor(stem_filter_s2d((rng.random((64, 3, 7, 7)) - 0.5).astype(np.float32)),
                           device=dev)
    if precision == "bf16w":
        w192 = w192.to(BF16)
    s, b = _bn(rng, dev, 64)
    check = _equal if precision == "bf16" else _agree
    check(stem_fused(x, w192, s, b, precision), stem_fused_plain(x, w192, s, b, precision))
    if precision != "bf16":
        xb = stem_prepare_input(x.cpu(), precision).to(dev)
        _agree(stem_fused_pre(xb, w192, s, b, 224, 224, precision),
               stem_fused_pre_plain(xb, w192, s, b, 224, 224, precision))


@pytest.mark.parametrize("p,k,n", [(N32 * 56 * 56, 64, 256), (N32 * 56 * 56, 256, 64),
                                   (N32 * 7 * 7, 2048, 512), (N32, 2048, 1000)])
@pytest.mark.parametrize("tier", ["f32", "bf16w", "int8"])
def test_pointwise_at_n32(dev, p, k, n, tier):
    rng = np.random.default_rng(p + k + n)
    x = _r(rng, dev, p, k).abs()
    s, b = _bn(rng, dev, n)
    if tier == "int8":
        w_q, s_w = _q(rng, dev, k, n)
        _equal(q8.conv1x1_bn_int8(x, w_q, s_w, s, b, True),
               q8.conv1x1_bn_int8_plain(x, w_q, s_w, s, b, True))
        return
    w = _r(rng, dev, k, n)
    if tier == "bf16w":
        w = w.to(BF16)
    _agree(conv1x1_bn(x, w, s, b, True), conv1x1_bn_plain(x, w, s, b, True))


@pytest.mark.parametrize("hw,c", [(56, 64), (28, 128), (14, 256)])
@pytest.mark.parametrize("precision", ["f32", "bf16w", "bf16", "int8"])
def test_winograd_at_n32(dev, hw, c, precision):
    rng = np.random.default_rng(hw + c)
    x = _r(rng, dev, N32, hw, hw, c).abs()
    w = (rng.random((c, c, 3, 3)) - 0.5).astype(np.float32)
    s, b = _bn(rng, dev, c)
    u2 = transforms.transform_filter(w, m=2)
    if precision == "int8":
        uq, su = q8.quantize_winograd_filter(u2)
        uq, su = torch.as_tensor(uq, device=dev), torch.as_tensor(su, device=dev)
        _equal(q8.conv3x3_bn_winograd_int8(x, uq, su, s, b),
               q8.conv3x3_bn_winograd_int8_plain(x, uq, su, s, b))
        return
    u = torch.as_tensor(u2, device=dev)
    if precision == "f32":
        _agree(conv3x3_bn_winograd(x, u, s, b), conv3x3_bn_winograd_plain(x, u, s, b))
    elif precision == "bf16w":
        u = u.to(BF16)
        _agree(conv3x3_bn_winograd(x, u, s, b, True, "bf16w"),
               conv3x3_bn_winograd_plain(x, u, s, b))
    else:
        u = u.to(BF16)
        _equal(conv3x3_bn_winograd(x, u, s, b, True, "bf16"), winograd2_mid_plain(x, u, s, b))


@pytest.mark.parametrize("tier", ["f32", "bf16w", "int8"])
def test_direct_at_n32(dev, tier):
    rng = np.random.default_rng(7)
    x = _r(rng, dev, N32, 7, 7, 512).abs()
    s, b = _bn(rng, dev, 512)
    if tier == "int8":
        w9_q, s_w9 = _q(rng, dev, 9 * 512, 512)
        _equal(q8.conv3x3_bn_int8(x, w9_q, s_w9, s, b), q8.conv3x3_bn_int8_plain(x, w9_q, s_w9, s, b))
        return
    w9 = torch.as_tensor(direct_filter((rng.random((512, 512, 3, 3)) - 0.5).astype(np.float32)),
                         device=dev)
    if tier == "bf16w":
        w9 = w9.to(BF16)
    _agree(conv3x3_bn_direct(x, w9, s, b), conv3x3_bn_direct_plain(x, w9, s, b))


@pytest.mark.parametrize("hw,cio,cmid,nb,mid", [
    (56, 256, 64, 2, "winograd2"), (28, 512, 128, 3, "winograd2"), (14, 1024, 256, 5, "direct"),
    (7, 2048, 512, 2, "direct"),
])
@pytest.mark.parametrize("tier", ["f32", "bf16w", "int8"])
def test_stage_at_n32(dev, hw, cio, cmid, nb, mid, tier):
    rng = np.random.default_rng(hw + nb)
    x = _r(rng, dev, N32, hw, hw, cio).abs()
    if tier == "int8":
        q = _qstacked(rng, dev, nb, cio, cmid)
        _equal(q8.resnet_stage_int8(x, q, mid), q8.resnet_stage_int8_plain(x, q, mid))
        return
    stacked = _stacked(rng, dev, nb, cio, cmid)
    if tier == "bf16w":
        stacked = _bf16w(stacked)
    _agree(resnet_stage_fused(x, stacked, mid), resnet_stage_fused_plain(x, stacked, mid))


@pytest.mark.parametrize("hw,cin,cmid,cout", [(56, 256, 128, 512), (28, 512, 256, 1024),
                                              (14, 1024, 512, 2048)])
@pytest.mark.parametrize("tier", ["f32", "bf16w", "int8"])
def test_transition_at_n32(dev, hw, cin, cmid, cout, tier):
    rng = np.random.default_rng(hw + cin)
    x = _r(rng, dev, N32, hw, hw, cin).abs()
    if tier == "int8":
        p = _qtransition(rng, dev, cin, cmid, cout)
        _equal(q8.transition_block_int8(x, p), q8.transition_block_int8_plain(x, p))
        return
    p = _transition(rng, dev, cin, cmid, cout)
    if tier == "bf16w":
        p["wep"], p["bep"] = fuse_transition_weights(p)
        p = _bf16w(p)
    _agree(transition_block_fused(x, p), transition_block_fused_plain(x, p))


@pytest.mark.parametrize("tier", ["f32", "bf16w", "int8"])
def test_basic_stage_at_n32(dev, tier):
    rng = np.random.default_rng(512)
    if tier == "int8":
        x, q = _basic_int8(rng, dev, N32, 7, 512, 2)
        _equal(bs.basic_stage_int8(x, q), bs.basic_stage_int8_plain(x, q))
        return
    x, stacked = _basic_f32(rng, dev, N32, 7, 512, 2)
    if tier == "bf16w":
        stacked = _bf16w(stacked)
    _agree(bs.basic_stage_fused(x, stacked), bs.basic_stage_fused_plain(x, stacked))


def _full_scale_basic(rng, dev, nb, c):
    """Basic blocks with full-scale weights (uniform in +-0.5, as
    chip_smoke.py draws them) and BN folded from gamma, beta, mean in +-0.5
    and var in [5, 8): sums of 4608 terms that reach |out| ~ 20."""
    blocks = []
    for _ in range(nb):
        b = {}
        for leg in ("a", "b"):
            b[f"w9_{leg}"] = direct_filter((rng.random((c, c, 3, 3)) - 0.5).astype(np.float32))
            g, beta, mean = ((rng.random(c) - 0.5).astype(np.float32) for _ in range(3))
            var = (rng.random(c) * 3 + 5).astype(np.float32)
            b[f"s_{leg}"], b[f"b_{leg}"] = transforms.fold_batchnorm(g, beta, mean, var)
        blocks.append(b)
    return {k: v.to(dev) for k, v in bs.stack_basic_stage_params(blocks).items()}


# The f32 basic stage and transition at N=32, where their tiles fill the grid
# and the plan once left K=4608 in one range: the 3xTF32 tiles' f32 sums
# drift with the length of a walk, so no item sums more than
# TRANSITION_MAX_SUM of K (1.8e-3 against a bar of 1.76e-3 unsplit, on
# chip_smoke.py's full-scale data).
@pytest.mark.parametrize("bf16w", [False, True])
def test_long_sums_split_and_stay_within_the_bar_at_n32(dev, bf16w):
    rng = np.random.default_rng(2032)
    stacked = _full_scale_basic(rng, dev, 2, 512)
    if bf16w:
        stacked = _bf16w(stacked)
    x = _r(rng, dev, N32, 7, 7, 512)
    assert bs.basic_stage_plan(N32, 7, 7, 512, _build.sm_count(dev)).conv.chunk <= \
        TRANSITION_MAX_SUM
    _agree(bs.basic_stage_fused(x, stacked), bs.basic_stage_fused_plain(x, stacked))
    p = _transition(rng, dev, 1024, 512, 2048)
    if bf16w:
        p["wep"], p["bep"] = fuse_transition_weights(p)
        p = _bf16w(p)
    x = _r(rng, dev, N32, 14, 14, 1024)
    plan = transition_plan(N32, 14, 14, 1024, 512, 2048, _build.sm_count(dev))
    assert all(s.chunk <= TRANSITION_MAX_SUM for s in (plan.reduce, plan.mid, plan.expand))
    _agree(transition_block_fused(x, p), transition_block_fused_plain(x, p))


# --- parallel partitions: two gloo ranks on one card -----------------------------------


def test_two_rank_world_serves_every_partition_on_one_card(dev):
    from torch_parallel_ranks import cuda_world
    from winograd_tpu_torch.models.basic import init_basicnet_arrays, basicnet_arrays
    from winograd_tpu_torch.models.resnet50 import init_resnet50_arrays
    from winograd_tpu_torch.parallel import spawn_world

    _build.build_all()  # once here, not in each rank
    cfg50, cfg34 = _TinyR50("tiny_r50"), _TinyBasic("tiny_basic")
    inp = {"r50": init_resnet50_arrays(cfg50, seed=3),
           "basic": basicnet_arrays(init_basicnet_arrays(cfg34, seed=3), cfg34),
           "x": _tiny_images(7, 2)}
    ranks = spawn_world(cuda_world, 2, (inp,), timeout=300)
    res = ranks[0]
    for family in ("r50", "basic"):
        for tier in ("f32", "bf16w", "int8"):
            ref = res[f"{family}_single_{tier}"]
            scale = max(1.0, ref.abs().max().item())
            for partition in ("model", "pipe", "data"):
                got = res[f"{family}_{partition}_{tier}"]
                assert torch.equal(got, ranks[1][f"{family}_{partition}_{tier}"])
                if tier != "f32" and partition == "model":
                    plain = res[f"{family}_model_{tier}_plain"]
                    p_rtol, f_rtol = (1e-4, 5e-3) if tier == "bf16w" else (1e-3, 5e-2)
                    assert (got - plain).abs().max().item() <= p_rtol * max(
                        1.0, plain.abs().max().item())
                    f32 = res[f"{family}_single_f32"]
                    assert (got - f32).abs().max().item() <= f_rtol * max(
                        1.0, f32.abs().max().item())
                    continue
                bound = (1e-3 if tier == "int8" else 1e-4) * scale
                assert (got - ref).abs().max().item() <= bound, (family, partition, tier)


@pytest.mark.parametrize("bf16w", [False, True])
def test_nan_checks_name_the_kernel_that_launched(dev, bf16w):
    """utils/debug.py::nan_checks on the card: a clean call passes, a NaN
    input raises naming the counter the launch went under. No ReLU: the
    kernels' fused ReLU (fmaxf) maps a NaN to 0, where torch.relu keeps it."""
    from winograd_tpu_torch.utils.debug import nan_checks

    rng = np.random.default_rng(40)
    x = _r(rng, dev, 2, 7, 7, 64)
    w = _r(rng, dev, 64, 96)
    s, b = _bn(rng, dev, 96)
    if bf16w:
        w = w.bfloat16()
    with nan_checks():
        conv1x1_bn(x, w, s, b, False)
        x[1, 3, 3, 5] = float("nan")
        counter = "pointwise_bf16w" if bf16w else "pointwise"
        with pytest.raises(FloatingPointError, match=rf"^{counter}: .*\(2, 7, 7, 64\)"):
            conv1x1_bn(x, w, s, b, False)


def test_nan_checks_refuse_graph_capture(dev):
    from winograd_tpu_torch.utils.debug import nan_checks

    x = torch.ones(8, device=dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = x * 2
        with pytest.raises(RuntimeError, match="capture"):
            with nan_checks():
                pass
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, x * 2) and not _build.NAN_CHECKS
