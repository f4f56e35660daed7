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
float32; the int8 tier's F(2,3) on bf16 filters (the FP64 tile on the FP64
tensor cores) equal to its twin, at N=1, 8 and 32 under every Cout block
of its items, repeating to the bit, keeping a NaN, refusing a plan off its
geometry, and as the int8 stage's winograd2 mid under every item shape;
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
CPU and 5e-3 and 5e-2 of the f32 engine); utils/debug.py::nan_checks
naming the counter a NaN-producing launch went under (with and without the
fused ReLU), and refusing a graph capture; the wgmma tiles of the pointwise
MMA path (K split across a thread-block cluster) and the stage's GEMM
phases at every pointwise and stage shape a full-width ResNet-50 N=1
forward launches, both tiers, off the TMA route (unaligned channels, P off
64), repeating to the bit and captured in a CUDA graph; and a NaN through
the fused ReLU and max-pool of pointwise, stage, stem and Winograd, kept
where the plain versions keep it; the int8 Winograd on s8 wgmma (its items
thread-block clusters) equal to its twin at N=1, 8 and 32 under every item
shape, keeping a NaN in both branches, refusing a plan off its geometry;
the f32 and bf16w transitions on the wgmma phases within their bars at
N=1, 8 and 32 under every candidate split; the f32 and bf16w basic stage on
the same phases at N=32 under every candidate split (the unsplit 4608-long
walk too), the int8 basic stage on the folded s8 wgmma phases equal to its
twin at N=1, 8 and 32 under every candidate split, and both keeping a NaN;
the heads' GEMVs (f32, bf16w, int8: a column tile's K splits one
thread-block cluster, weights by bulk copies) at P = 1..8 under every
cluster size and tile width, a NaN kept, repeating to the bit, refusing a
plan off their geometry. Needs an NVIDIA GPU and nvcc;
skipped elsewhere. Run on the card with

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
    conv3x3_bn_direct, conv3x3_bn_direct_plain, conv3x3_bn_direct_planned, direct_filter,
    direct_plan,
)
from winograd_tpu_torch.kernels import basic_stage as bs
from winograd_tpu_torch.kernels import pointwise as pw
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
from winograd_tpu_torch.kernels.splitk import Split, split_k
from winograd_tpu_torch.kernels.winograd import (
    WINOGRAD_FP64_COLS, WINOGRAD_STEP, conv3x3_bn_winograd, conv3x3_bn_winograd_fp64_planned,
    conv3x3_bn_winograd_plain, conv3x3_bn_winograd_planned, winograd2_mid_plain,
    winograd_fp64_items, winograd_fp64_plan, winograd_plan, winograd_tiles,
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


# The served transitions at N=1, 8 and 32, f32 and bf16w, on the wgmma
# phases under the plan and under plans that change one phase's K split
# (split_k's ranges for 1, 4 and 32 wanted, whole stages of the tile):
# within the f32 bar of the plain version.
@pytest.mark.parametrize("n", [1, 8, 32])
@pytest.mark.parametrize("h,cin", [(56, 256), (28, 512), (14, 1024)])
@pytest.mark.parametrize("precision", ["f32", "bf16w"])
def test_transition_under_every_candidate_split(dev, n, h, cin, precision):
    cmid, cout = cin // 2, 2 * cin
    rng = np.random.default_rng(n + h + cin)
    p = _transition(rng, dev, cin, cmid, cout)
    wep, bep = fuse_transition_weights(p)
    wr, w9 = p["w_reduce"], p["w9_mid"]
    if precision == "bf16w":
        wr, w9, wep = wr.bfloat16(), w9.bfloat16(), wep.bfloat16()
        p = dict(p, w_reduce=wr, w9_mid=w9, wep=wep, bep=bep)
    x = _r(rng, dev, n, h, h, cin)
    ref = transition_block_fused_plain(x, p)
    args = (x, wr, p["s_reduce"], p["b_reduce"], w9, p["s_mid"], p["b_mid"], wep, bep)
    chosen = transition_plan(n, h, h, cin, cmid, cout, _build.sm_count(dev))
    plans = {chosen}
    for phase, k in (("reduce", cin), ("mid", 9 * cmid), ("expand", cmid + cin)):
        for want in (1, 4, 32):
            plans.add(chosen._replace(**{phase: split_k(k, want, TRANSITION_STEP,
                                                        TRANSITION_STEP)}))
    for plan in plans:
        _agree(transition_block_fused_planned(*args, plan), ref)


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
    K past its shared memory, a cluster grid that is not its tiles x splits,
    a cluster past the portable size or with a split off the wgmma k step,
    and a split that leaves K uncovered."""
    rng = np.random.default_rng(4)
    w_q, s_w = _q(rng, dev, 512, 64)
    s, b = _bn(rng, dev, 64)
    sms = _build.sm_count(dev)
    gemv = q8.pointwise_int8_plan(8, 512, 64, sms, "gemv")
    clus = q8.pointwise_int8_plan(100, 512, 64, sms)
    one = q8.pointwise_int8_plan(100, 256, 64, sms, "one_pass")
    for p, k, bad in ((9, 512, gemv), (100, 512, one._replace(kp=512, chunk=512)),
                      (100, 512, clus._replace(blocks=4 * clus.blocks)),
                      (100, 512, clus._replace(splits=16, chunk=32, blocks=2 * 16)),
                      (100, 512, clus._replace(splits=2, chunk=272, blocks=2 * 2)),
                      (100, 512, clus._replace(splits=1)), (8, 512, gemv._replace(chunk=32))):
        x = _r(rng, dev, p, k)
        with pytest.raises(RuntimeError):
            q8.conv1x1_bn_int8_planned(x, w_q[:k].contiguous(), s_w, s, b, True, bad)


# The served int8 1x1s at N=1, 8 and 32 on the cluster path under every
# candidate split (1 to 8 blocks a cluster), and the GEMV's heads on it too:
# equal to the twin.
@pytest.mark.parametrize("p,k,n,relu", [
    (3136, 64, 64, True), (784, 576, 128, True), (196, 1152, 256, True), (49, 2304, 512, True),
    (49, 256, 512, False), (6272, 576, 128, True), (392, 2304, 512, True),
    (25088, 1152, 256, True), (1568, 2304, 512, True), (32, 2048, 1000, False),
    (8, 2048, 1000, False), (1, 512, 1000, False),
])
def test_pointwise_int8_cluster_under_every_split(dev, p, k, n, relu):
    rng = np.random.default_rng(p + k + n + 7)
    x = _r(rng, dev, p, k).abs() if relu else _r(rng, dev, p, k)
    w_q, s_w = _q(rng, dev, k, n)
    s, b = _bn(rng, dev, n)
    ref = q8.conv1x1_bn_int8_plain(x, w_q, s_w, s, b, relu)
    sms = _build.sm_count(dev)
    for want in (1, 2, 3, 4, 8):
        plan = q8.pointwise_int8_plan(p, k, n, sms, "cluster", want)
        _equal(q8.conv1x1_bn_int8_planned(x, w_q, s_w, s, b, relu, plan), ref)


@pytest.mark.parametrize("path", ["gemv", "one_pass", "cluster"])
def test_pointwise_int8_keeps_a_nan(dev, path):
    """A NaN in a row gives that row a NaN scale on every path, as the plain
    version's torch.amax does, whichever K range (cluster block) holds it;
    an inf the same."""
    rng = np.random.default_rng(11)
    p, k, n = (6, 256, 70) if path == "gemv" else (100, 256, 70)
    x = _r(rng, dev, p, k)
    x[1, 200] = float("nan")
    x[3, 7] = float("inf")
    w_q, s_w = _q(rng, dev, k, n)
    s, b = _bn(rng, dev, n)
    ref = q8.conv1x1_bn_int8_plain(x, w_q, s_w, s, b, False)
    for want in ((1, 4) if path == "cluster" else (0,)):
        plan = q8.pointwise_int8_plan(p, k, n, _build.sm_count(dev), path, want)
        out = q8.conv1x1_bn_int8_planned(x, w_q, s_w, s, b, False, plan)
        torch.cuda.synchronize()
        nan = torch.isnan(ref)
        assert nan[1].all() and nan[3].all() and not nan[0].any()
        assert torch.equal(torch.isnan(out), nan) and torch.equal(out[~nan], ref[~nan])


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


# The served int8 stages at N=8 and N=32 too, every one of the four: the
# s8 wgmma phases, each quantizing its rows from the maxima its producers
# published, held to the bit.
@pytest.mark.parametrize("n", [8, 32])
@pytest.mark.parametrize("hw,cio,cmid,nb,mid", [
    (56, 256, 64, 2, "winograd2"), (28, 512, 128, 3, "winograd2"),
    (14, 1024, 256, 5, "direct"), (7, 2048, 512, 2, "direct"),
])
def test_stage_int8_served_shapes_in_batches(dev, n, hw, cio, cmid, nb, mid):
    rng = np.random.default_rng(n + hw + cmid)
    stacked = _qstacked(rng, dev, nb, cio, cmid)
    x = _r(rng, dev, n, hw, hw, cio).abs()
    _equal(q8.resnet_stage_int8(x, stacked, mid), q8.resnet_stage_int8_plain(x, stacked, mid))


# The winograd2 route's FP64 mid under every Cout block of its items
# (the plan's mid phase, (1, cols)), at conv2_x and conv3_x and at a Cmid
# off a multiple of 8 (U by element loads), held to the bit; the entry
# refuses a mid phase it does not take.
@pytest.mark.parametrize("n,hw,cio,cmid,nb", [(1, 56, 256, 64, 2), (1, 28, 512, 128, 3),
                                              (2, 9, 144, 20, 2)])
def test_stage_int8_winograd2_under_every_fp64_item_shape(dev, n, hw, cio, cmid, nb):
    rng = np.random.default_rng(n + hw + cmid + 5)
    stacked = _qstacked(rng, dev, nb, cio, cmid)
    x = _r(rng, dev, n, hw, hw, cio).abs()
    ref = q8.resnet_stage_int8_plain(x, stacked, "winograd2")
    chosen = q8.stage_int8_plan(n, hw, hw, cio, cmid, "winograd2",
                                q8.expand_groups(cmid, "winograd2"), _build.sm_count(dev))
    for cols in WINOGRAD_FP64_COLS:
        plan = chosen._replace(mid=Split(1, cols))
        _equal(q8.resnet_stage_int8_planned(x, stacked, "winograd2", plan), ref)
    for mid in (Split(1, 24), Split(2, 16), Split(1, 0)):
        with pytest.raises(RuntimeError):
            q8.resnet_stage_int8_planned(x, stacked, "winograd2", chosen._replace(mid=mid))


@pytest.mark.parametrize("mid,hw,cmid", [("direct", 14, 64), ("winograd2", 28, 64),
                                         ("winograd2", 14, 256)])
def test_stage_int8_keeps_a_nan_through_its_folded_quantize(dev, mid, hw, cmid):
    """A NaN in x: the row maxima its producers publish (atomicMax on the
    bits of |v|) carry it, so each row it reaches gets a NaN scale, as
    torch.amax gives the plain version: NaN exactly where the plain
    version has NaN (the grouped expand's groups too), equal elsewhere."""
    rng = np.random.default_rng(hw + cmid)
    stacked = _qstacked(rng, dev, 2, 256, cmid)
    x = _r(rng, dev, 1, hw, hw, 256).abs()
    x[0, 3, 4, 7] = float("nan")
    out = q8.resnet_stage_int8(x, stacked, mid)
    ref = q8.resnet_stage_int8_plain(x, stacked, mid)
    torch.cuda.synchronize()
    nan = torch.isnan(ref)
    assert nan.any() and not nan.all() and torch.equal(torch.isnan(out), nan)
    assert torch.equal(out[~nan], ref[~nan])


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
# N=1, 8 and 32 and ResNet-18's one block, on the 3xTF32 wgmma tiles:
# within the f32 bar of the twin, two calls equal to the bit, and within the
# bar under every split the sweep may pick (one split too).
@pytest.mark.parametrize("n,hw,c,nb", [(1, 7, 512, 2), (8, 7, 512, 2), (1, 7, 512, 1),
                                       (32, 7, 512, 2)])
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


# The 3xTF32 walk at N=32, 7x7x512 (fault C2: an unsplit K = 4608 walk on
# the mma.sync tiles read 1.81e-3 against a bar of 1.76e-3): every candidate
# split, the unsplit walk included, at f32 and bf16w, within the bar.
@pytest.mark.parametrize("bf16", [False, True])
def test_basic_stage_every_split_at_n32(dev, bf16):
    x, stacked = _basic_f32(np.random.default_rng(32 + bf16), dev, 32, 7, 512, 2)
    if bf16:
        stacked = _bf16w(stacked)
    ref = bs.basic_stage_fused_plain(x, stacked)
    plan = bs.basic_stage_plan(32, 7, 7, 512, _build.sm_count(dev))
    for want in (1, 2, 3, 4, 8, 16, 32):
        conv = split_k(9 * 512, want, TRANSITION_STEP, TRANSITION_STEP)
        _agree(bs.basic_stage_fused_planned(x, stacked, plan._replace(conv=conv)), ref)


# A NaN in x: each conv's products carry it to the outputs whose windows
# reach it (two blocks: a 9x9 patch of the second image), the ReLU keeps
# it, as in the plain version; every other output within the bar.
@pytest.mark.parametrize("bf16", [False, True])
def test_basic_stage_keeps_a_nan(dev, bf16):
    x, stacked = _basic_f32(np.random.default_rng(9), dev, 2, 7, 64, 2)
    if bf16:
        stacked = _bf16w(stacked)
    x[1, 3, 2, 5] = float("nan")
    ref = bs.basic_stage_fused_plain(x, stacked)
    out = bs.basic_stage_fused(x, stacked)
    torch.cuda.synchronize()
    nan = torch.isnan(ref)
    assert nan.any() and not nan.all() and torch.equal(torch.isnan(out), nan)
    assert (out[~nan] - ref[~nan]).abs().max().item() <= 1e-4 * max(1.0, ref[~nan].abs().max().item())


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
# N=1, 8 and 32 and ResNet-18's one block, under the plan's split and under
# every candidate split of the sweep, unsplit too: equal to the twin, and
# two calls equal to the bit; the weights' k-contiguous copies made by the
# first call and kept.
@pytest.mark.parametrize("n,hw,c,nb", [(1, 7, 512, 2), (8, 7, 512, 2), (1, 7, 512, 1),
                                       (32, 7, 512, 2)])
def test_basic_stage_int8_served_shapes(dev, n, hw, c, nb):
    x, q = _basic_int8(np.random.default_rng(n + nb), dev, n, hw, c, nb)
    ref = bs.basic_stage_int8_plain(x, q)
    first = bs.basic_stage_int8(x, q)
    _equal(first, ref)
    kept = q["w9_a_q"]._kmajor_int8[1]
    assert torch.equal(first, bs.basic_stage_int8(x, q))
    assert q["w9_a_q"]._kmajor_int8[1] is kept
    plan = bs.basic_stage_int8_plan(n, hw, hw, c, _build.sm_count(dev))
    _equal(bs.basic_stage_int8_planned(x, q, plan._replace(splits=1, chunk=plan.kp)), ref)
    for want in (2, 4, 8, 16):
        sp = split_k(plan.kp, want, q8.STAGE_INT8_STEP, q8.STAGE_INT8_STEP)
        _equal(bs.basic_stage_int8_planned(x, q, plan._replace(splits=sp.splits,
                                                               chunk=sp.chunk)), ref)


def test_basic_stage_int8_keeps_a_nan(dev):
    """A NaN in x: block 0's self-scaled im2col rows and the pixel maxima
    the epilogues publish (atomicMax on the bits of |v|) carry it, so each
    row it reaches gets a NaN scale, as torch.amax gives the plain version:
    NaN exactly where the plain version has NaN, equal elsewhere."""
    x, q = _basic_int8(np.random.default_rng(11), dev, 2, 7, 64, 2)
    x[1, 3, 2, 5] = float("nan")
    ref = bs.basic_stage_int8_plain(x, q)
    out = bs.basic_stage_int8(x, q)
    torch.cuda.synchronize()
    nan = torch.isnan(ref)
    assert nan.any() and not nan.all() and torch.equal(torch.isnan(out), nan)
    assert torch.equal(out[~nan], ref[~nan])


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
# output tile) and 14x14x256 (the stash) at N=1, 8 and 32, both legs (ReLU
# or not), on the plan's items and under every other item shape the kernel
# takes (WINO_INT8_ITEMS): equal to the twin, two calls
# equal to the bit.
@pytest.mark.parametrize("n,h,w,cin,cout", [(1, 28, 28, 128, 128), (1, 14, 14, 256, 256),
                                            (8, 28, 28, 128, 128), (8, 14, 14, 256, 256),
                                            (32, 28, 28, 128, 128), (32, 14, 14, 256, 256)])
@pytest.mark.parametrize("relu", [True, False])
def test_winograd_int8_served_shapes(dev, n, h, w, cin, cout, relu):
    x, u_q, s_u, s, b = _winograd_int8(np.random.default_rng(h + cin + relu), dev, n, h, w,
                                       cin, cout)
    ref = q8.conv3x3_bn_winograd_int8_plain(x, u_q, s_u, s, b, relu)
    first = q8.conv3x3_bn_winograd_int8(x, u_q, s_u, s, b, relu)
    _equal(first, ref)
    assert torch.equal(first, q8.conv3x3_bn_winograd_int8(x, u_q, s_u, s, b, relu))
    for tiles, cols in q8.WINO_INT8_ITEMS:
        plan = q8.winograd_int8_item(n, h, w, cin, cout, tiles, cols)
        if plan is not None:
            _equal(q8.conv3x3_bn_winograd_int8_planned(x, u_q, s_u, s, b, relu, plan), ref)


# A NaN in x is kept: its rows' max |V| is NaN (max.NaN, as torch.amax), so
# those rows' scale and every channel of their M are, in the group branch
# (Cout 128, two groups) and in the stash. The transforms skip zero
# coefficients, in the kernel as in the plain version (and the JAX kernel:
# tests/test_torch_nan.py), so the NaN positions are the plain version's
# and every other output equals it to the bit.
@pytest.mark.parametrize("cin,cout", [(256, 128), (256, 256)])
def test_winograd_int8_keeps_a_nan(dev, cin, cout):
    x, u_q, s_u, s, b = _winograd_int8(np.random.default_rng(cin + cout), dev, 1, 14, 14, cin,
                                       cout)
    x[0, 5, 6, 7] = float("nan")
    ref = q8.conv3x3_bn_winograd_int8_plain(x, u_q, s_u, s, b, True)
    out = q8.conv3x3_bn_winograd_int8(x, u_q, s_u, s, b, True)
    torch.cuda.synchronize()
    nan = torch.isnan(ref)
    assert nan.any() and not nan.all() and torch.equal(torch.isnan(out), nan)
    assert torch.equal(out[~nan], ref[~nan])


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
    """csrc/winograd_int8.cu's entry refuses a grid that is not a cluster an
    item, a padded Cin off the MMA's depth, an item shape it was not
    compiled for, and 256-channel items outside the stash."""
    n, h, w, cin, cout = 1, 14, 14, 64, 64
    x, u_q, s_u, s, b = _winograd_int8(np.random.default_rng(6), dev, n, h, w, cin, cout)
    plan = q8.winograd_int8_plan(n, h, w, cin, cout, _build.sm_count(dev))
    for bad in (plan._replace(blocks=plan.blocks + q8.WINO_INT8_CLUSTER),
                plan._replace(blocks=plan.blocks - 1), plan._replace(kp=plan.kp + 32),
                plan._replace(kp=plan.kp - 32), plan._replace(item_tiles=24),
                plan._replace(item_tiles=32), plan._replace(cols=64),
                plan._replace(cols=256)):
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


def _bf16_filter_case(rng, dev, n, h, w, cin, cout):
    x = _r(rng, dev, n, h, w, cin)
    wt = (rng.random((cout, cin, 3, 3)) - 0.5).astype(np.float32)
    u = torch.as_tensor(transforms.transform_filter(wt, m=2), device=dev).to(torch.bfloat16)
    return (x, u, *_bn(rng, dev, cout))


# The FP64 F(2,3) tile (csrc/winograd.cuh::wino_f64_tile on the FP64 tensor
# cores) at its served shape, ResNet-18/34 int8's conv2_x, at N=1, 8 and 32:
# under its plan, under every Cout block the kernels take, on a grid of one
# block an SM (each block walking several items), and again under its plan,
# equal to its twin and to itself to the bit.
@pytest.mark.parametrize("n", [1, 8, 32])
def test_winograd_bf16_filter_served_batches(dev, n):
    x, u, s, b = _bf16_filter_case(np.random.default_rng(n + 56), dev, n, 56, 56, 64, 64)
    ref = winograd2_mid_plain(x, u, s, b)
    out = conv3x3_bn_winograd(x, u, s, b, True, "bf16")
    _equal(out, ref)
    sms = _build.sm_count(dev)
    for cols in WINOGRAD_FP64_COLS:
        items = winograd_fp64_items(n, 56, 56, 64, cols)
        for blocks in (items, min(items, sms)):
            plan = winograd_fp64_plan(n, 56, 56, 64, sms)._replace(cols=cols, blocks=blocks)
            _equal(conv3x3_bn_winograd_fp64_planned(x, u, s, b, True, plan), ref)
    again = conv3x3_bn_winograd(x, u, s, b, True, "bf16")
    torch.cuda.synchronize()
    assert torch.equal(again, out)


@pytest.mark.parametrize("relu", [True, False])
def test_winograd_bf16_filter_keeps_a_nan(dev, relu):
    """A NaN in the input reaches exactly the outputs whose tiles read it,
    through the FP64 MMAs and the NaN-keeping ReLU, as in the twin."""
    x, u, s, b = _bf16_filter_case(np.random.default_rng(3), dev, 1, 14, 14, 64, 40)
    x[0, 5, 6, 7] = float("nan")
    out, ref = conv3x3_bn_winograd(x, u, s, b, relu, "bf16"), winograd2_mid_plain(x, u, s, b, relu)
    torch.cuda.synchronize()
    nan = torch.isnan(ref)
    assert nan.any() and torch.equal(torch.isnan(out), nan)
    assert torch.equal(out[~nan], ref[~nan])


def test_winograd_bf16_filter_entry_refuses_a_plan_it_does_not_take(dev):
    """csrc/winograd.cu's FP64 entry takes only the Cout blocks it was
    compiled for, 1 to `items` blocks, and a filter it can copy in 16-byte
    pieces (Cout a multiple of 8, 16-byte aligned), which the wrapper makes
    of any other."""
    n, h, w, cin, cout = 1, 14, 14, 64, 64
    x, u, s, b = _bf16_filter_case(np.random.default_rng(7), dev, n, h, w, cin, cout)
    plan = winograd_fp64_plan(n, h, w, cout, _build.sm_count(dev))
    for bad in (plan._replace(cols=24), plan._replace(cols=64), plan._replace(blocks=0),
                plan._replace(blocks=plan.blocks + 1)):
        with pytest.raises(RuntimeError):
            conv3x3_bn_winograd_fp64_planned(x, u, s, b, True, bad)
    shifted = torch.empty(u.numel() + 1, dtype=u.dtype, device=dev)[1:].view_as(u).copy_(u)
    u60 = u[..., :60].contiguous()
    for uu, ss, bb in ((shifted, s, b), (u60, s[:60], b[:60])):
        with pytest.raises(RuntimeError):
            conv3x3_bn_winograd_fp64_planned(x, uu, ss, bb, True, plan)
        _equal(conv3x3_bn_winograd(x, uu, ss, bb, True, "bf16"), winograd2_mid_plain(x, uu, ss, bb))


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


# --- the heads' GEMVs: a column tile's K splits one cluster ---------------------

def _gemv_plans(k, n, sms):
    """Every GEMV plan of a K x N product the kernels take: tiles GEMV_COLS
    and half of it wide, 1, 2, 4, 8 and 16 K splits where K allows."""
    plans = {}
    for cols in (pw.GEMV_COLS, pw.GEMV_COLS // 2):
        for want in (1, 2, 4, 8, 16):
            width, tiles, split = pw.gemv_split(k, n, sms, cols=cols, want=want)
            plans[width, split.splits] = (width, tiles, split)
    return list(plans.values())


def _same_nan_and_close(out, ref, rtol):
    torch.cuda.synchronize()
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(out), nan)
    bound = rtol * max(1.0, ref[~nan].abs().max().item())
    assert (out[~nan] - ref[~nan]).abs().max().item() <= bound


# P = 1..8 rows, K from one 4-deep row group to the R-50 head's 2048, N the
# heads' 1000 (the bulk copies), 70 and 999 (element loads), at f32, bf16w
# and int8, under every cluster size and tile width the plan may take, a
# NaN in the last row of x past one row: within the f32 bound of the plain version (int8:
# equal to it), NaNs where it has them.
@pytest.mark.parametrize("tier", ["f32", "bf16w", "int8"])
@pytest.mark.parametrize("k", [4, 60, 512, 2048])
@pytest.mark.parametrize("n", [1000, 70, 999])
def test_gemv_under_every_cluster(dev, tier, k, n):
    rng = np.random.default_rng(k + n)
    sms = _build.sm_count(dev)
    s, b = _bn(rng, dev, n)
    if tier == "int8":
        w_q, s_w = _q(rng, dev, k, n)
    else:
        w = _r(rng, dev, k, n)
        w = w.bfloat16() if tier == "bf16w" else w
    for p in range(1, pw.GEMV_MAX_ROWS + 1):
        x = _r(rng, dev, p, k)
        if p > 1:
            x[p - 1, k // 2] = float("nan")
        relu = p % 2 == 0
        for width, tiles, split in _gemv_plans(k, n, sms):
            if tier == "int8":
                plan = q8.PointwiseInt8Plan("gemv", k, width, tiles, tiles * split.splits,
                                            split.splits, split.chunk)
                out = q8.conv1x1_bn_int8_planned(x, w_q, s_w, s, b, relu, plan)
                ref = q8.conv1x1_bn_int8_plain(x, w_q, s_w, s, b, relu)
                _same_nan_and_close(out, ref, 0.0)
            else:
                plan = pw.Plan(True, width, tiles, split.splits, split.chunk)
                out = pw.conv1x1_bn_planned(x, w, s, b, relu, plan)
                _same_nan_and_close(out, conv1x1_bn_plain(x, w, s, b, relu), 1e-4)


# The heads at N=1 and N=8 under the wrappers' own plans: a launch counted
# once, two calls equal to the bit, and the plan the card was asked for
# (the wide clusters only where all of the tiles' fit at once).
@pytest.mark.parametrize("tier", ["f32", "bf16w", "int8"])
@pytest.mark.parametrize("p,k", [(1, 2048), (8, 2048), (1, 512), (8, 512)])
def test_gemv_heads_repeat_to_the_bit(dev, tier, p, k):
    rng = np.random.default_rng(p * k)
    n = 1000
    x, (s, b) = _r(rng, dev, p, k), _bn(rng, dev, n)
    if tier == "int8":
        w_q, s_w = _q(rng, dev, k, n)
        run = lambda: q8.conv1x1_bn_int8(x, w_q, s_w, s, b, False)  # noqa: E731
        counter, clusters = "pointwise_int8", pw.gemv_clusters(dev, "pointwise_int8")
        plan = q8.pointwise_int8_plan(p, k, n, _build.sm_count(dev), wide_clusters=clusters)
        assert plan.path == "gemv" or k < q8.POINTWISE_INT8_GEMV_MIN_K
    else:
        w = _r(rng, dev, k, n)
        w = w.bfloat16() if tier == "bf16w" else w
        run = lambda: conv1x1_bn(x, w, s, b, False)  # noqa: E731
        counter = "pointwise_bf16w" if tier == "bf16w" else "pointwise"
        clusters = pw.gemv_clusters(dev, "pointwise", int(tier == "bf16w"))
        plan = split_plan(p, k, n, _build.sm_count(dev), clusters)
        assert plan.gemv
    assert clusters > 0
    if plan.splits > pw.CLUSTER_MAX:
        assert clusters >= plan.tiles
    before = _build.LAUNCHES[counter]
    first = run()
    assert _build.LAUNCHES[counter] == before + 1
    again = run()
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.isfinite(first).all()


def test_gemv_entries_refuse_a_plan_they_do_not_take(dev):
    """The GEMVs' entries refuse K splits that are not a power of two, more
    than a cluster's 16, more than 8 rows, and a tile of another width."""
    rng = np.random.default_rng(5)
    k, n = 512, 1000
    s, b = _bn(rng, dev, n)
    w = _r(rng, dev, k, n)
    w_q, s_w = _q(rng, dev, k, n)
    good = pw.Plan(True, pw.GEMV_COLS, 8, 4, 128)
    for p, bad in ((4, good._replace(splits=3, chunk=192)),
                   (4, good._replace(splits=32, chunk=16)),
                   (9, good), (4, good._replace(tile=96, tiles=11))):
        x = _r(rng, dev, p, k)
        for wt in (w, w.bfloat16()):
            with pytest.raises(RuntimeError):
                pw.conv1x1_bn_planned(x, wt, s, b, False, bad)
        plan = q8.PointwiseInt8Plan("gemv", k, bad.tile, bad.tiles, bad.tiles * bad.splits,
                                    bad.splits, bad.chunk)
        with pytest.raises(RuntimeError):
            q8.conv1x1_bn_int8_planned(x, w_q, s_w, s, b, False, plan)
    x = _r(rng, dev, 4, k)
    _agree(pw.conv1x1_bn_planned(x, w, s, b, False, good), conv1x1_bn_plain(x, w, s, b, False))


# (N, H, W, Cin, Cout): ResNet-34's int8 entry b-leg at N = 1, 8 and 32 (K
# split 8, 8 and 2 ways), ResNet-50's int8 projection 3x3 (49 row tiles), K =
# 36 (Cin 4, zero-padded to the MMA's 32-byte depth) with an all-zero image,
# the "model" partition's shards (Cin or Cout 16 at 56x56x64) and Cin off
# multiples of 4 (the wrapper's padded route).
@pytest.mark.parametrize("n,h,w,cin,cout,relu", [
    (1, 7, 7, 512, 512, False), (1, 56, 56, 64, 64, True), (2, 5, 7, 4, 70, True),
    (8, 7, 7, 512, 512, True), (32, 7, 7, 512, 512, False), (1, 56, 56, 16, 64, True),
    (1, 56, 56, 64, 16, True), (2, 5, 7, 13, 70, True), (3, 9, 6, 3, 33, False),
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


def test_direct_entries_refuse_a_plan_they_do_not_take(dev):
    """csrc/direct.cu and csrc/direct_int8.cu refuse a tile width off theirs,
    more splits than a cluster holds, a split off the tile's stage, a split
    that leaves K uncovered, a grid that is not tiles x splits and a padded
    K past its alignment."""
    rng = np.random.default_rng(6)
    x = _r(rng, dev, 1, 7, 7, 64)
    w9 = torch.as_tensor(direct_filter((rng.random((64, 64, 3, 3)) - 0.5).astype(np.float32)),
                         device=dev)
    s, b = _bn(rng, dev, 64)
    sms = _build.sm_count(dev)
    plan = direct_plan(1, 7, 7, 64, 64, sms)
    for bad in (plan._replace(tile=128), plan._replace(splits=18, chunk=32),
                plan._replace(splits=2, chunk=300), plan._replace(splits=1, chunk=288)):
        with pytest.raises(RuntimeError):
            conv3x3_bn_direct_planned(x, w9, s, b, True, bad)
    w9_q, s_w9 = _q(rng, dev, 9 * 64, 64)
    p8 = q8.direct_int8_plan(1, 7, 7, 64, 64, sms)
    for bad in (p8._replace(tile=256), p8._replace(splits=18, chunk=32, blocks=18 * p8.tiles),
                p8._replace(splits=2, chunk=300, blocks=2 * p8.tiles),
                p8._replace(splits=1, chunk=288, blocks=p8.tiles),
                p8._replace(blocks=2 * p8.blocks), p8._replace(kp=608, chunk=608, splits=1,
                                                               blocks=p8.tiles)):
        with pytest.raises(RuntimeError):
            q8.conv3x3_bn_int8_planned(x, w9_q, s_w9, s, b, True, bad)


# The int8 direct 3x3 under every split of its cluster (1-16; past 8 a
# non-portable cluster) and both tile widths at the served b-leg, and on the
# 56x56x64 map: equal to the twin.
@pytest.mark.parametrize("n,hw,c", [(1, 7, 512), (8, 7, 512), (1, 56, 64)])
def test_direct_int8_under_every_split(dev, n, hw, c):
    rng = np.random.default_rng(n + hw + c)
    x = _r(rng, dev, n, hw, hw, c)
    w9_q, s_w9 = _q(rng, dev, 9 * c, c)
    s, b = _bn(rng, dev, c)
    ref = q8.conv3x3_bn_int8_plain(x, w9_q, s_w9, s, b, True)
    sms = _build.sm_count(dev)
    seen = set()
    for cols in q8.POINTWISE_INT8_CLUSTER_COLS:
        for want in range(1, q8.DIRECT_INT8_CLUSTER_MAX + 1):
            plan = q8.direct_int8_plan(n, hw, hw, c, c, sms, want, cols)
            if plan in seen:
                continue
            seen.add(plan)
            _equal(q8.conv3x3_bn_int8_planned(x, w9_q, s_w9, s, b, True, plan), ref)
    assert len(seen) >= 8


# A NaN in x: the nine im2col rows that gather it get a NaN scale and NaN
# outputs, where the plain version puts them; every other output is equal.
@pytest.mark.parametrize("n,hw,c", [(2, 7, 512), (1, 9, 16)])
def test_direct_int8_keeps_a_nan(dev, n, hw, c):
    rng = np.random.default_rng(hw + c + 3)
    x = _r(rng, dev, n, hw, hw, c)
    x[0, 3, 4, 5] = float("nan")
    w9_q, s_w9 = _q(rng, dev, 9 * c, c)
    s, b = _bn(rng, dev, c)
    for relu in (True, False):
        out = q8.conv3x3_bn_int8(x, w9_q, s_w9, s, b, relu)
        ref = q8.conv3x3_bn_int8_plain(x, w9_q, s_w9, s, b, relu)
        torch.cuda.synchronize()
        nan = torch.isnan(ref)
        assert nan[0, 2:5, 3:6].all() and nan.sum().item() == 9 * c
        assert torch.equal(torch.isnan(out), nan) and torch.equal(out[~nan], ref[~nan])


# The f32 and bf16w direct 3x3 at the served 7x7x512 under every split of
# its cluster, 1 (the unsplit 4608-long walk) to 8 and 16 (a non-portable
# cluster), at N = 1, 8 and 32: within the bar of the plain version, and
# each plan repeats to the bit.
@pytest.mark.parametrize("n", [1, 8, 32])
@pytest.mark.parametrize("bf16w", [False, True])
def test_direct_under_every_split(dev, n, bf16w):
    rng = np.random.default_rng(n + 40 * bf16w)
    x = _r(rng, dev, n, 7, 7, 512)
    w9 = torch.as_tensor(direct_filter((rng.random((512, 512, 3, 3)) - 0.5).astype(np.float32)),
                         device=dev)
    if bf16w:
        w9 = w9.to(torch.bfloat16)
    s, b = _bn(rng, dev, 512)
    ref = conv3x3_bn_direct_plain(x, w9, s, b, True)
    chosen = direct_plan(n, 7, 7, 512, 512, _build.sm_count(dev))
    splits = set()
    for want in (*range(1, 9), 16):
        sp = split_k(9 * 512, want, 32, 32)
        plan = chosen._replace(splits=sp.splits, chunk=sp.chunk)
        first = conv3x3_bn_direct_planned(x, w9, s, b, True, plan)
        _agree(first, ref)
        assert torch.equal(first, conv3x3_bn_direct_planned(x, w9, s, b, True, plan))
        splits.add(sp.splits)
    assert splits == {*range(1, 9), 16}


# --- the f32 Winograd and stage on the tensor cores -------------------------

# The served f32 Winograd convs (N, H, W, Cin, Cout, m), ResNet-50's
# projection and ResNet-34's identity 3x3s at N=1 and N=8, and the F(4,3)
# check shape: the plan's items fill a wave, the call agrees with its twin
# and repeats to the bit.
@pytest.mark.parametrize("n,h,w,cin,cout,m", [
    (1, 56, 56, 64, 64, 2), (1, 28, 28, 128, 128, 2), (1, 14, 14, 256, 256, 2),
    (1, 14, 14, 128, 128, 4), (8, 56, 56, 64, 64, 2), (8, 28, 28, 128, 128, 2),
    (8, 14, 14, 256, 256, 2),
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


# The served transitions at N=8 and N=32, odd maps, and Cin / Cmid of 13,
# 1024 and 2048, each under its plan, under every phase split to walks of
# 128 to 1024 (transition_int8_plan's max_walk), and on copies of its
# weights (their k-contiguous copies made anew, kept ones reused): equal to
# the twin.
@pytest.mark.parametrize("n,h,w,cin,cmid,cout", [
    (8, 56, 56, 256, 128, 512), (8, 28, 28, 512, 256, 1024), (32, 14, 14, 1024, 512, 2048),
    (32, 28, 28, 512, 256, 1024), (1, 13, 11, 13, 13, 40), (2, 7, 9, 2048, 13, 64),
    (1, 15, 13, 64, 1024, 96), (1, 7, 7, 1024, 2048, 128),
])
def test_transition_int8_under_every_plan(dev, n, h, w, cin, cmid, cout):
    rng = np.random.default_rng(h * w + cin + cmid + cout + 3)
    p = _qtransition(rng, dev, cin, cmid, cout)
    x = _r(rng, dev, n, h, w, cin).abs()
    ref = q8.transition_block_int8_plain(x, p)
    _equal(q8.transition_block_int8(x, p), ref)
    _equal(q8.transition_block_int8(x, p), ref)                   # the kept copies
    _equal(q8.transition_block_int8(x, {k: v.clone() for k, v in p.items()}), ref)
    if cin % 4 or cmid % 4:
        return
    sms = _build.sm_count(dev)
    for walk in (128, 256, 512, 1024):
        plan = q8.transition_int8_plan(n, h, w, cin, cmid, cout, sms, walk)
        _equal(q8.transition_block_int8_planned(x, p, plan), ref)


def test_transition_int8_keeps_a_nan(dev):
    """A NaN in x lands where the plain version puts it: its row's reduce
    output, every strided im2col row that reads that pixel, and so on, at
    one split and past it."""
    rng = np.random.default_rng(21)
    p = _qtransition(rng, dev, 64, 32, 128)
    x = _r(rng, dev, 2, 14, 14, 64).abs()
    x[1, 6, 6, 5] = float("nan")
    ref = q8.transition_block_int8_plain(x, p)
    nan = torch.isnan(ref)
    assert nan.any() and not nan.all()
    sms = _build.sm_count(dev)
    for plan in (q8.transition_int8_plan(2, 14, 14, 64, 32, 128, sms),
                 q8.transition_int8_plan(2, 14, 14, 64, 32, 128, sms, 128)):
        out = q8.transition_block_int8_planned(x, p, plan)
        torch.cuda.synchronize()
        assert torch.equal(torch.isnan(out), nan) and torch.equal(out[~nan], ref[~nan])


def test_transition_int8_entry_refuses_a_plan_it_does_not_take(dev):
    """csrc/transition_int8.cu's entry refuses a grid larger than it holds
    resident, a split off the tile's 128-byte stage, one past its cap, and
    one range that is not the whole K."""
    rng = np.random.default_rng(5)
    p = _qtransition(rng, dev, 256, 64, 128)
    x = _r(rng, dev, 1, 14, 14, 256).abs()
    plan = q8.transition_int8_plan(1, 14, 14, 256, 64, 128, _build.sm_count(dev), 128)
    for bad in (plan._replace(blocks=8 * plan.blocks),
                plan._replace(mid=Split(2, 320)), plan._replace(mid=Split(18, 32)),
                plan._replace(reduce=Split(1, 128)), plan._replace(proj=Split(3, 64))):
        with pytest.raises(RuntimeError):
            q8.transition_block_int8_planned(x, p, bad)


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


# Both tensor-core routes of the Winograd (3xTF32 and bf16w wgmma) at the
# served shapes at N=1 and N=8 against a float64 golden of the same
# algebra (on the bf16-rounded U at bf16w): each stays under a tenth of the
# 1e-4 bar, as the wgmma tiles' per-stage FP32 sums keep the drift down.
@pytest.mark.parametrize("precision", ["f32", "bf16w"])
@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("hw,c", [(56, 64), (28, 128), (14, 256)])
def test_winograd_tiles_drift_under_a_tenth_of_the_bar(dev, precision, n, hw, c):
    rng = np.random.default_rng(hw + c + n)
    x = _r(rng, dev, n, hw, hw, c)
    wt = (rng.random((c, c, 3, 3)) - 0.5).astype(np.float32)
    u = torch.as_tensor(transforms.transform_filter(wt, m=2), device=dev)
    s, b = _bn(rng, dev, c)
    if precision == "bf16w":
        u = u.to(BF16)
    out = conv3x3_bn_winograd(x, u, s, b, True, precision)
    golden = conv3x3_bn_winograd_plain(x.double(), u.double(), s.double(), b.double())
    torch.cuda.synchronize()
    bar = 1e-4 * max(1.0, golden.abs().max().item())
    assert (out.double() - golden).abs().max().item() <= 0.1 * bar


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


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("bf16w", [False, True])
def test_nan_checks_name_the_kernel_that_launched(dev, bf16w, relu):
    """utils/debug.py::nan_checks on the card: a clean call passes, a NaN
    input raises naming the counter the launch went under, with the fused
    ReLU too (it keeps a NaN, as jnp.maximum and torch.relu do)."""
    from winograd_tpu_torch.utils.debug import nan_checks

    rng = np.random.default_rng(40)
    x = _r(rng, dev, 2, 7, 7, 64)
    w = _r(rng, dev, 64, 96)
    s, b = _bn(rng, dev, 96)
    if bf16w:
        w = w.bfloat16()
    with nan_checks():
        conv1x1_bn(x, w, s, b, relu)
        x[1, 3, 3, 5] = float("nan")
        counter = "pointwise_bf16w" if bf16w else "pointwise"
        with pytest.raises(FloatingPointError, match=rf"^{counter}: .*\(2, 7, 7, 64\)"):
            conv1x1_bn(x, w, s, b, relu)


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


# --- the wgmma tiles: pointwise.cu's MMA path and stage.cu's GEMM phases ----

def _served_shapes(dev, tier):
    """The pointwise and stage launch shapes of a full-width ResNet-50 N=1
    forward at the tier (kernels/_build.py::LAUNCH_SHAPES), eagerly."""
    from winograd_tpu_torch.config import ResNet50Config

    engine = ResNet50Engine(init_resnet50_params(ResNet50Config(), seed=5, device="cpu"),
                            tier=tier, device=dev)
    x = torch.as_tensor(_tiny_images(6, 1, img=224), device=dev)
    _build.reset_counts()
    engine._forward(x, engine._params, dev)
    torch.cuda.synchronize()
    suffix = "_bf16w" if tier == "bf16w" else ""
    shapes = {name: sorted(_build.LAUNCH_SHAPES[name + suffix], key=str)
              for name in ("pointwise", "stage")}
    assert shapes["pointwise"] and shapes["stage"]
    return shapes


@pytest.mark.parametrize("tier", ["f32", "bf16w"])
def test_wgmma_kernels_at_every_served_launch_shape(dev, tier):
    """Each pointwise and stage shape the served N=1 forward launches, on
    fresh seeded operands, within the f32 bar of the plain version at both
    tiers, and equal to the bit on a second call."""
    shapes = _served_shapes(dev, tier)
    rng = np.random.default_rng(7)
    for p, k, n, relu in shapes["pointwise"]:
        x, w = _r(rng, dev, p, k), _r(rng, dev, k, n)
        s, b = _bn(rng, dev, n)
        if tier == "bf16w":
            w = w.to(BF16)
        first = conv1x1_bn(x, w, s, b, relu)
        _agree(first, conv1x1_bn_plain(x, w, s, b, relu))
        assert torch.equal(first, conv1x1_bn(x, w, s, b, relu))
    for n, h, w, cio, cmid, nb, mid in shapes["stage"]:
        stacked = _stacked(rng, dev, nb, cio, cmid)
        if tier == "bf16w":
            stacked = _bf16w(stacked)
        x = _r(rng, dev, n, h, w, cio)
        first = resnet_stage_fused(x, stacked, mid)
        _agree(first, resnet_stage_fused_plain(x, stacked, mid))
        assert torch.equal(first, resnet_stage_fused(x, stacked, mid))


# Shapes off the TMA route (Cin or Cout not a multiple of 4, of 8 for bf16
# weights: element loads into the same ring) and P off multiples of 64, with
# and without a K split (the pointwise splits one cluster); the last is
# bf16-only unaligned (Cout a multiple of 4, not 8).
@pytest.mark.parametrize("bf16w", [False, True])
@pytest.mark.parametrize("p,k,n", [(100, 1030, 70), (65, 258, 33), (130, 515, 12),
                                   (77, 2052, 36)])
def test_pointwise_wgmma_unaligned(dev, bf16w, p, k, n):
    plan = split_plan(p, k, n, _build.sm_count(dev))
    assert not plan.gemv and plan.splits > 1
    rng = np.random.default_rng(p * k + n)
    x, w = _r(rng, dev, p, k), _r(rng, dev, k, n)
    s, b = _bn(rng, dev, n)
    if bf16w:
        w = w.to(BF16)
    first = conv1x1_bn(x, w, s, b, True)
    _agree(first, conv1x1_bn_plain(x, w, s, b, True))
    assert torch.equal(first, conv1x1_bn(x, w, s, b, True))


@pytest.mark.parametrize("bf16w", [False, True])
@pytest.mark.parametrize("n,hw,cio,cmid,nb", [(2, 9, 70, 20, 2), (1, 7, 300, 36, 2),
                                              (3, 5, 132, 300, 1)])
def test_stage_wgmma_unaligned(dev, bf16w, n, hw, cio, cmid, nb):
    rng = np.random.default_rng(n * hw + cio + cmid)
    stacked = _stacked(rng, dev, nb, cio, cmid)
    if bf16w:
        stacked = _bf16w(stacked)
    x = _r(rng, dev, n, hw, hw, cio)
    first = resnet_stage_fused(x, stacked, "direct")
    _agree(first, resnet_stage_fused_plain(x, stacked, "direct"))
    assert torch.equal(first, resnet_stage_fused(x, stacked, "direct"))


@pytest.mark.parametrize("bf16w", [False, True])
def test_wgmma_kernels_capture_and_replay(dev, bf16w):
    """Both kernels captured in one CUDA graph (the pointwise on a K split
    across a cluster, the stage on split phases) replay on new inputs as
    they run eagerly, to the bit."""
    rng = np.random.default_rng(11)
    w = _r(rng, dev, 2048, 512)
    s, b = _bn(rng, dev, 512)
    stacked = _stacked(rng, dev, 2, 1024, 256)
    if bf16w:
        w, stacked = w.to(BF16), _bf16w(stacked)
    xp, xs = _r(rng, dev, 49, 2048), _r(rng, dev, 1, 14, 14, 1024)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        conv1x1_bn(xp, w, s, b, True)
        resnet_stage_fused(xs, stacked, "direct")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        yp = conv1x1_bn(xp, w, s, b, True)
        ys = resnet_stage_fused(xs, stacked, "direct")
    for seed in (12, 13):
        r2 = np.random.default_rng(seed)
        xp.copy_(_r(r2, dev, 49, 2048))
        xs.copy_(_r(r2, dev, 1, 14, 14, 1024))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(yp, conv1x1_bn(xp, w, s, b, True))
        assert torch.equal(ys, resnet_stage_fused(xs, stacked, "direct"))
        _agree(ys, resnet_stage_fused_plain(xs, stacked, "direct"))


def _same_nans(out, ref):
    torch.cuda.synchronize()
    nan = torch.isnan(ref)
    assert nan.any() and torch.equal(torch.isnan(out), nan)
    ok = ~nan
    assert (out[ok] - ref[ok]).abs().max().item() <= 1e-4 * max(1.0, ref[ok].abs().max().item())


@pytest.mark.parametrize("bf16w", [False, True])
def test_fused_relu_and_max_pool_keep_a_nan(dev, bf16w):
    """One NaN in the input of the pointwise (both paths), the stage (both
    mids), the stem and the Winograd: each kernel's output has NaN exactly
    where its plain version has (the ReLU and the max-pool keep it, as
    jnp.maximum does), and agrees elsewhere."""
    rng = np.random.default_rng(21)
    for p in (3, 98):
        x, w = _r(rng, dev, p, 256), _r(rng, dev, 256, 96)
        s, b = _bn(rng, dev, 96)
        w = w.to(BF16) if bf16w else w
        x[p // 2, 5] = float("nan")
        _same_nans(conv1x1_bn(x, w, s, b, True), conv1x1_bn_plain(x, w, s, b, True))
    for mid, hw in (("direct", 14), ("winograd2", 28)):
        stacked = _stacked(rng, dev, 2, 256, 64)
        stacked = _bf16w(stacked) if bf16w else stacked
        x = _r(rng, dev, 1, hw, hw, 256)
        x[0, 3, 4, 7] = float("nan")
        _same_nans(resnet_stage_fused(x, stacked, mid), resnet_stage_fused_plain(x, stacked, mid))
    x, w192, s, b = _stem_case(rng, dev, 1, 64, 64, 3, 64)
    x[0, 20, 31, 1] = float("nan")
    precision = "bf16w" if bf16w else "f32"
    w192 = w192.to(BF16) if bf16w else w192
    _same_nans(stem_fused(x, w192, s, b, precision), stem_fused_plain(x, w192, s, b, precision))
    u = torch.as_tensor(transforms.transform_filter(
        (rng.random((64, 64, 3, 3)) - 0.5).astype(np.float32), m=2), device=dev)
    u = u.to(BF16) if bf16w else u
    s, b = _bn(rng, dev, 64)
    x = _r(rng, dev, 1, 28, 28, 64)
    x[0, 9, 14, 3] = float("nan")
    _same_nans(conv3x3_bn_winograd(x, u, s, b, True, precision),
               conv3x3_bn_winograd_plain(x, u, s, b, True))
