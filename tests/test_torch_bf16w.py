"""The port's bf16w serving tier against winograd_tpu at precision="bf16w",
at narrow widths: the plain split_dot, each kernel module with a bf16w
instantiation (pointwise, stem, stage with a Winograd and a direct mid,
transition, the Winograd F(2,3), the direct 3x3, the basic stage), the
whole tiny ResNet-50 and basic-family forwards, the bf16 casts of the
weights, the stage route, the Winograd wrapper's precisions and the
engines. JAX runs in Pallas interpret mode; the port runs its plain twins
in float32 on the CPU. Inputs are made from a seed with numpy.

Bounds: one module within 1e-5 * max(1, max|jax|) of the JAX op (the same
bf16 weights and hi/lo split; the sums' order and, for the stem and the
per-layer F(2,3), exact products against the JAX split, differ), the
forward within 1e-4 * max(1, max|jax|); both within BF16W_RTOL (modules)
or BF16W_RTOL_BACKBONE (the forward) * max(1, max|golden|) of the f32
model's float64 golden. The cast equals jnp.astype(bfloat16) bit for bit."""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from winograd_tpu.config import BasicNetConfig as JaxBasicNetConfig
from winograd_tpu.config import BlockConfig
from winograd_tpu.config import ResNet50Config as JaxResNet50Config
from winograd_tpu.config import TransitionConfig
from winograd_tpu.datagen.generate import (
    _block_params_random, _transition_params_random, block_params_list, make_block_case,
)
from winograd_tpu.datagen.generate import make_basicnet_case
from winograd_tpu.kernels.basic_stage import basic_stage_fused_pallas
from winograd_tpu.kernels.basic_stage import stack_basic_stage_params as jax_basic_stack
from winograd_tpu.kernels.direct import conv3x3_bn_direct_pallas, split_dot
from winograd_tpu.kernels.pointwise import conv1x1_bn_pallas
from winograd_tpu.kernels.stage import resnet_stage_fused_pallas
from winograd_tpu.kernels.stage import stack_stage_params as jax_stack
from winograd_tpu.kernels.stem import stem_fused_pallas
from winograd_tpu.kernels.transition import fuse_transition_weights as jax_fuse
from winograd_tpu.kernels.transition import transition_block_fused_pallas
from winograd_tpu.kernels.winograd import conv3x3_bn_winograd_pallas
from winograd_tpu.models import basic as jb
from winograd_tpu.models.resnet50 import init_resnet50_params as jax_init
from winograd_tpu.models.resnet50 import resnet50_forward_pallas
from winograd_tpu_torch.config import BF16W_RTOL, BF16W_RTOL_BACKBONE
from winograd_tpu_torch.engine import ResNet50Engine, ResNetBasicEngine
from winograd_tpu_torch.kernels import _build, transforms
from winograd_tpu_torch.kernels import basic_stage as basic_stage_module
from winograd_tpu_torch.kernels import stage as stage_module
from winograd_tpu_torch.kernels import transition as transition_module
from winograd_tpu_torch.kernels.basic_stage import (
    basic_stage_fused, basic_stage_fused_plain, stack_basic_stage_params,
)
from winograd_tpu_torch.kernels.direct import (
    conv3x3_bn_direct, conv3x3_bn_direct_plain, direct_filter,
)
from winograd_tpu_torch.kernels.pointwise import conv1x1_bn, conv1x1_bn_plain, split_dot_bf16w
from winograd_tpu_torch.kernels.splitk import H100_SMS
from winograd_tpu_torch.kernels.stage import (
    STAGE_KEYS, resnet_stage_fused, resnet_stage_fused_plain, stack_stage_params,
)
from winograd_tpu_torch.kernels.stem import stem_fused, stem_fused_plain
from winograd_tpu_torch.kernels.transition import (
    fuse_transition_weights, transition_block_fused, transition_block_fused_plain,
)
from winograd_tpu_torch.kernels.winograd import (
    conv3x3_bn_winograd, conv3x3_bn_winograd_plain, winograd2_mid_plain,
)
from winograd_tpu_torch.models import basic as tb
from winograd_tpu_torch.models import resnet
from winograd_tpu_torch.models.convert import (
    cast_basicnet_bf16w, cast_bf16w, params_from_jax,
)
from winograd_tpu_torch.models.resnet50 import resnet50_forward

MODULE_RTOL = 1e-5
FORWARD_RTOL = 1e-4
BF16 = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class _TinyR50(JaxResNet50Config):
    stages = ((64, 16, 8, 1), (128, 32, 4, 2))
    img: int = 32
    stem_c: int = 16
    num_classes: int = 24


def _close(out, ref, rtol):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    err = np.abs(out - ref).max()
    assert err <= rtol * max(1.0, np.abs(ref).max()), err


def _rand(rng, *shape):
    return (rng.random(shape) - 0.5).astype(np.float32)


def _bn(rng, c):
    return (rng.random(c) * 0.5 + 0.25).astype(np.float32), _rand(rng, c)


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _bits(t):
    return t.contiguous().view(torch.int16).numpy()


def _jax_bits(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16)).view(np.int16)


def _bf16w(layer):
    """A layer's weights in bfloat16, its BN as it is."""
    return {k: v.to(BF16) if k.startswith(("w", "u2")) else v for k, v in layer.items()}


def test_split_dot_matches_jax_split_dot():
    rng = np.random.default_rng(0)
    for rows in (5, 196):                      # JAX's skinny form, and its two dots
        a, b = _rand(rng, rows, 256), _rand(rng, 256, 72)
        b16 = jnp.asarray(b).astype(jnp.bfloat16)
        ref = split_dot(jnp.asarray(a), b16, "bf16w")
        out = split_dot_bf16w(_t(a), _t(b, BF16))
        _close(out.numpy(), ref, MODULE_RTOL)
        _close(out.numpy(), a.astype(np.float64) @ b, BF16W_RTOL)
    with pytest.raises(ValueError, match="float32 activation"):
        split_dot_bf16w(_t(a).double(), _t(b, BF16))
    with pytest.raises(ValueError, match="bfloat16"):
        split_dot_bf16w(_t(a), _t(b))


@pytest.mark.parametrize("p,k,n,relu", [(6, 96, 40, False), (70, 64, 48, True)])
def test_pointwise_matches_jax(p, k, n, relu):
    rng = np.random.default_rng(p + k)
    x, w = _rand(rng, p, k), _rand(rng, k, n)
    s, b = _bn(rng, n)
    ref = conv1x1_bn_pallas(*map(jnp.asarray, (x, w, s, b)), relu=relu, precision="bf16w")
    out = conv1x1_bn(_t(x), _t(w, BF16), _t(s), _t(b), relu)
    _close(out.numpy(), ref, MODULE_RTOL)
    gold = conv1x1_bn_plain(*(_t(a).double() for a in (x, w, s, b)), relu)
    _close(out.numpy(), gold.numpy(), BF16W_RTOL)
    with pytest.raises(ValueError, match="float32 activation"):
        conv1x1_bn(_t(x).double(), _t(w, BF16), _t(s), _t(b), relu)


def test_stem_matches_jax():
    from winograd_tpu_torch.models.convert import stem_filter_s2d

    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 32, 30, 3)
    w192 = stem_filter_s2d(_rand(rng, 16, 3, 7, 7))
    s, b = _bn(rng, 16)
    ref = stem_fused_pallas(*map(jnp.asarray, (x, w192, s, b)), precision="bf16w")
    out = stem_fused(_t(x), _t(w192, BF16), _t(s), _t(b), precision="bf16w")
    _close(out.numpy(), ref, MODULE_RTOL)
    gold = stem_fused_plain(*(_t(a).double() for a in (x, w192, s, b)))
    _close(out.numpy(), gold.numpy(), BF16W_RTOL)
    with pytest.raises(ValueError, match="precision"):            # bf16 weights are bf16w's
        stem_fused(_t(x), _t(w192, BF16), _t(s), _t(b), precision="f32")


def test_entry_winograd_on_bf16_filters_matches_jax():
    """The entry block's F(2,3) at bf16w runs the Winograd wrapper's "bf16w"
    precision (the bf16w products, csrc/winograd.cu's bf16w entry on the
    card)."""
    rng = np.random.default_rng(5)
    x = np.abs(_rand(rng, 1, 10, 12, 16))
    u = transforms.transform_filter(_rand(rng, 24, 16, 3, 3), m=2)
    s, b = _bn(rng, 24)
    ref = conv3x3_bn_winograd_pallas(jnp.asarray(x), jnp.asarray(u).astype(jnp.bfloat16),
                                     jnp.asarray(s), jnp.asarray(b), precision="bf16w")
    out = conv3x3_bn_winograd(_t(x), _t(u, BF16), _t(s), _t(b), precision="bf16w")
    _close(out.numpy(), ref, MODULE_RTOL)
    gold = conv3x3_bn_winograd_plain(*(_t(a).double() for a in (x, u, s, b)))
    _close(out.numpy(), gold.numpy(), BF16W_RTOL)


@pytest.mark.parametrize("n,h,w,c,relu", [
    (2, 9, 7, 16, True),
    (1, 32, 32, 64, False),             # JAX's lane-packed 64-channel kernel
    (1, 6, 10, 72, True),
])
def test_winograd_matches_jax(n, h, w, c, relu):
    rng = np.random.default_rng(h * w + c)
    x = _rand(rng, n, h, w, c)
    u = transforms.transform_filter(_rand(rng, c, c, 3, 3), m=2)
    s, b = _bn(rng, c)
    ref = conv3x3_bn_winograd_pallas(jnp.asarray(x), jnp.asarray(u).astype(jnp.bfloat16),
                                     jnp.asarray(s), jnp.asarray(b), relu=relu,
                                     precision="bf16w")
    out = conv3x3_bn_winograd(_t(x), _t(u, BF16), _t(s), _t(b), relu, "bf16w")
    _close(out.numpy(), ref, MODULE_RTOL)
    gold = conv3x3_bn_winograd_plain(*(_t(a).double() for a in (x, u, s, b)), relu)
    _close(out.numpy(), gold.numpy(), BF16W_RTOL)


def test_winograd_precisions_and_refusals():
    """precision names the arithmetic of a bfloat16 u: "bf16" stays the int8
    tier's float64 algebra (winograd2_mid_plain) to the bit, "bf16w" the
    bf16w products; any other pairing of u and precision is refused."""
    rng = np.random.default_rng(6)
    x = _t(_rand(rng, 1, 6, 6, 8))
    u = _t(transforms.transform_filter(_rand(rng, 12, 8, 3, 3), m=2))
    u16 = u.to(BF16)
    s, b = (_t(a) for a in _bn(rng, 12))
    exact = conv3x3_bn_winograd(x, u16, s, b, precision="bf16")
    assert torch.equal(exact, winograd2_mid_plain(x, u16, s, b))
    assert torch.equal(conv3x3_bn_winograd(x, u16, s, b, precision="bf16w"),
                       conv3x3_bn_winograd_plain(x, u16, s, b))
    assert torch.equal(conv3x3_bn_winograd(x, u, s, b), conv3x3_bn_winograd_plain(x, u, s, b))
    for uu, precision in ((u16, "f32"), (u, "bf16"), (u, "bf16w")):
        with pytest.raises(ValueError, match="precision"):
            conv3x3_bn_winograd(x, uu, s, b, precision=precision)
    with pytest.raises(ValueError, match="unknown"):
        conv3x3_bn_winograd(x, u16, s, b, precision="int8")
    u4 = _t(transforms.transform_filter(_rand(rng, 12, 8, 3, 3), m=4)).to(BF16)
    with pytest.raises(ValueError, match="F\\(2,3\\)"):
        conv3x3_bn_winograd(x, u4, s, b, precision="bf16w")
    with pytest.raises(ValueError, match="float32 activation"):
        conv3x3_bn_winograd(x.double(), u16, s, b, precision="bf16w")


@pytest.mark.parametrize("n,hw,cin,cout,relu", [(2, 7, 24, 40, True), (1, 5, 20, 12, False)])
def test_direct_matches_jax(n, hw, cin, cout, relu):
    rng = np.random.default_rng(hw + cin + cout)
    x = _rand(rng, n, hw, hw, cin)
    w9 = direct_filter(_rand(rng, cout, cin, 3, 3))
    s, b = _bn(rng, cout)
    ref = conv3x3_bn_direct_pallas(jnp.asarray(x), jnp.asarray(w9).astype(jnp.bfloat16),
                                   jnp.asarray(s), jnp.asarray(b), relu=relu, precision="bf16w")
    out = conv3x3_bn_direct(_t(x), _t(w9, BF16), _t(s), _t(b), relu)
    _close(out.numpy(), ref, MODULE_RTOL)
    gold = conv3x3_bn_direct_plain(*(_t(a).double() for a in (x, w9, s, b)), relu)
    _close(out.numpy(), gold.numpy(), BF16W_RTOL)
    with pytest.raises(ValueError, match="float32 activation"):
        conv3x3_bn_direct(_t(x).double(), _t(w9, BF16), _t(s), _t(b), relu)


def _basic_blocks(rng, c, nb):
    blocks = []
    for _ in range(nb):
        blk = {}
        for leg in ("a", "b"):
            blk[f"w9_{leg}"] = direct_filter(_rand(rng, c, c, 3, 3))
            blk[f"s_{leg}"], blk[f"b_{leg}"] = _bn(rng, c)
        blocks.append(blk)
    return blocks


@pytest.mark.parametrize("nb", [1, 2])
def test_basic_stage_matches_jax(nb):
    rng = np.random.default_rng(10 + nb)
    blocks = _basic_blocks(rng, 24, nb)
    x = np.abs(_rand(rng, 2, 5, 6, 24))
    ref = basic_stage_fused_pallas(jnp.asarray(x), jax_basic_stack(blocks), precision="bf16w")
    stacked = stack_basic_stage_params([{k: _t(v) for k, v in blk.items()} for blk in blocks])
    stacked16 = _bf16w(stacked)
    assert stacked16["w9_a"].dtype == BF16 and stacked16["s_a"].dtype == torch.float32
    out = basic_stage_fused(_t(x), stacked16)
    _close(out.numpy(), ref, MODULE_RTOL)
    gold = basic_stage_fused_plain(_t(x).double(), {k: v.double() for k, v in stacked.items()})
    _close(out.numpy(), gold.numpy(), BF16W_RTOL)
    with pytest.raises(ValueError, match="float32 activation"):
        basic_stage_fused(_t(x).double(), stacked16)


def _stage_case(cio, cmid, hw, nb, seed):
    cfg = BlockConfig("t", c_io=cio, c_mid=cmid, hw=hw, blocks=nb)
    case = make_block_case(cfg, seed=seed)
    return case, block_params_list(cfg, case)


@pytest.mark.parametrize("cio,cmid,hw,nb,mid", [
    (32, 16, 28, 1, "winograd2"),
    (64, 32, 7, 1, "direct"),
    (64, 32, 7, 2, "direct"),
])
def test_stage_matches_jax(cio, cmid, hw, nb, mid):
    """The stage kernel's bf16w instantiation: the F(2,3) mid at 28x28 (bf16
    u2, V split hi/lo), the direct mid at 7x7, one block and two."""
    case, blocks = _stage_case(cio, cmid, hw, nb, seed=cio + hw + nb)
    x = np.asarray(case["x"], np.float32)[None]
    ref = resnet_stage_fused_pallas(jnp.asarray(x), jax_stack(blocks), precision="bf16w",
                                    mid_algo=mid)
    ours = [{k: _t(blk[k]) for k in STAGE_KEYS + ("u2_mid",)} for blk in blocks]
    stacked16 = stack_stage_params([_bf16w(blk) for blk in ours])
    assert stacked16["w_reduce"].dtype == BF16 and stacked16["s_reduce"].dtype == torch.float32
    out = resnet_stage_fused(_t(x), stacked16, mid)
    _close(out.numpy(), ref, MODULE_RTOL)
    gold = resnet_stage_fused_plain(
        _t(x).double(), {k: v.double() for k, v in stack_stage_params(ours).items()}, mid)
    _close(out.numpy(), gold.numpy(), BF16W_RTOL)


def test_transition_matches_jax():
    rng = np.random.default_rng(8)
    t = _transition_params_random(rng, TransitionConfig("t", 32, 16, 64, hw=9), bn_scale=0.5)
    x = np.abs(_rand(rng, 2, 9, 9, 32))
    ref = transition_block_fused_pallas(jnp.asarray(x), jax.tree.map(jnp.asarray, t),
                                        precision="bf16w")
    p32 = {k: _t(v) for k, v in t.items() if k != "w_mid"}
    p32["wep"], p32["bep"] = fuse_transition_weights(p32)
    out = transition_block_fused(_t(x), _bf16w(p32))
    _close(out.numpy(), ref, MODULE_RTOL)
    gold = transition_block_fused_plain(_t(x).double(), {k: v.double() for k, v in p32.items()})
    _close(out.numpy(), gold.numpy(), BF16W_RTOL)
    # Without the fused artifact, bf16 weights fold in float32 to a bf16 wep.
    alone = _bf16w({k: v for k, v in p32.items() if k not in ("wep", "bep")})
    assert fuse_transition_weights(alone)[0].dtype == BF16


def test_tiny_resnet50_forward_matches_jax():
    cfg = _TinyR50("tiny_resnet50")
    tree = jax_init(cfg, seed=3)
    x = (np.random.default_rng(0).random((2, cfg.img, cfg.img, 3)) - 0.5).astype(np.float32)
    ref = resnet50_forward_pallas(jnp.asarray(x), jax.tree.map(jnp.asarray, tree),
                                  precision="bf16w")
    params = cast_bf16w(params_from_jax(tree, device="cpu"))
    out = resnet50_forward(x, params, device="cpu", precision="bf16w")
    _close(out.numpy(), ref, FORWARD_RTOL)
    gold = resnet50_forward(x, params_from_jax(tree, "cpu", torch.float64), device="cpu")
    _close(out.numpy(), gold.numpy(), BF16W_RTOL_BACKBONE)
    with pytest.raises(ValueError, match="bf16w"):               # f32 weights at bf16w
        resnet50_forward(x, params_from_jax(tree, device="cpu"), device="cpu",
                         precision="bf16w")


@dataclasses.dataclass(frozen=True)
class _TinyBasic(JaxBasicNetConfig):
    """tests/test_torch_basicnet.py's _TinyRoutes: 96x96 images -> 24x24
    after the stem; stage 0 (16 channels) F(2,3), stage 1 (72, entry to
    12x12) F(2,3), stage 2 (80, entry to 6x6) the entry's b-leg direct and
    two identity blocks in one basic-stage launch (fused from
    BASIC_MIN_CHANNELS)."""

    stages = ((16, 24, 1), (72, 12, 2), (80, 6, 3))
    img: int = 96
    stem_c: int = 16
    num_classes: int = 16


BASIC_MIN_CHANNELS = 76


@pytest.fixture(scope="module")
def tiny_basic():
    cfg = _TinyBasic("tiny_basic_bf16w")
    case = make_basicnet_case(cfg, seed=5)
    jparams = jb.attach_fused_stage_artifacts(jb.basicnet_params(case, cfg), BASIC_MIN_CHANNELS)
    params = tb.attach_fused_stage_artifacts(tb.basicnet_params(case, cfg, device="cpu"),
                                             BASIC_MIN_CHANNELS)
    return cfg, case, jparams, params


def test_tiny_basicnet_forward_matches_jax(tiny_basic):
    _, case, jparams, params = tiny_basic
    ref = jb.basicnet_forward_pallas(jnp.asarray(case["x"]), jparams, precision="bf16w")
    p16 = cast_basicnet_bf16w(params)
    assert [st.get("fused") is not None for st in p16["stages"]] == [False, False, True]
    out = tb.basicnet_forward(case["x"], p16, device="cpu", precision="bf16w")
    _close(out.numpy(), ref, FORWARD_RTOL)
    _close(out.numpy(), case["golden"], BF16W_RTOL_BACKBONE)
    with pytest.raises(ValueError, match="bf16w"):               # f32 weights at bf16w
        tb.basicnet_forward(case["x"], params, device="cpu", precision="bf16w")
    with pytest.raises(ValueError, match="bf16w"):               # bf16 weights at f32
        tb.basicnet_forward(case["x"], p16, device="cpu")


def test_cast_basicnet_bf16w_rounds_as_jax_astype(tiny_basic):
    _, _, jparams, params = tiny_basic
    p16 = cast_basicnet_bf16w(params)
    for name in ("stem", "head"):
        for k, v in p16[name].items():
            if k in ("w192_stem", "w_fc"):
                np.testing.assert_array_equal(_bits(v), _jax_bits(jparams[name][k]), err_msg=k)
            want = BF16 if k in ("w192_stem", "w_fc") else torch.float32
            assert v.dtype == want, k
    for ours, theirs in zip(p16["stages"], jparams["stages"]):
        for blk, jblk in zip([ours["entry"]] + ours["blocks"], [theirs["entry"]] + theirs["blocks"]):
            if blk is None:
                continue
            for k, v in blk.items():
                if k.startswith(("w_", "w9_", "u2_")):
                    np.testing.assert_array_equal(_bits(v), _jax_bits(jblk[k]), err_msg=k)
                else:
                    assert v.dtype == torch.float32, k
    fused = p16["stages"][2]["fused"]
    jfused = jax_basic_stack(jparams["stages"][2]["blocks"])
    for k in ("w9_a", "w9_b"):
        np.testing.assert_array_equal(_bits(fused[k]), _jax_bits(jfused[k]))
        assert p16["stages"][2]["blocks"][1][k].data_ptr() == fused[k][1].data_ptr()
    assert fused["s_a"].dtype == torch.float32
    assert params["head"]["w_fc"].dtype == torch.float32          # the caller's stay f32


def test_cast_bf16w_rounds_as_jax_astype():
    cfg = _TinyR50("tiny_resnet50")
    tree = jax_init(cfg, seed=7)
    p16 = cast_bf16w(params_from_jax(tree, device="cpu"))
    np.testing.assert_array_equal(_bits(p16["stem"]["w192_stem"]),
                                  _jax_bits(tree["stem"]["w192_stem"]))
    np.testing.assert_array_equal(_bits(p16["proj"]["u2_mid"]), _jax_bits(tree["proj"]["u2_mid"]))
    np.testing.assert_array_equal(_bits(p16["head"]["w_fc"]), _jax_bits(tree["head"]["w_fc"]))
    stage = p16["stages"][1]
    jax_stacked = jax_stack(tree["stages"][1]["blocks"])
    for key in ("w_reduce", "w9_mid", "u2_mid", "w_expand"):
        np.testing.assert_array_equal(_bits(stage["stacked"][key]), _jax_bits(jax_stacked[key]))
        assert stage["blocks"][1][key].data_ptr() == stage["stacked"][key][1].data_ptr()
    wep, bep = jax_fuse(jax.tree.map(jnp.asarray, tree["stages"][1]["transition"]))
    np.testing.assert_array_equal(_bits(stage["transition"]["wep"]), _jax_bits(wep))
    np.testing.assert_array_equal(stage["transition"]["bep"].numpy(), np.asarray(bep))
    for layer in (p16["stem"], p16["proj"], p16["head"], stage["transition"], stage["stacked"]):
        for k, v in layer.items():
            assert v.dtype == (BF16 if k.startswith(("w", "u2")) else torch.float32), k


def _meta_blocks(cio, cmid, nb):
    e = lambda *shape: torch.empty(*shape, device="meta")  # noqa: E731
    return [dict(w_reduce=e(cio, cmid), w9_mid=e(9 * cmid, cmid)) for _ in range(nb)]


@pytest.mark.parametrize("cio,cmid,nb,f32,bf16w", [
    (256, 64, 2, "fused_stage", "fused_stage"),        # conv2_x
    (1024, 256, 5, "fused_stage", "fused_stage"),      # conv4_x
    (2048, 512, 2, "per_block", "fused_stage"),        # conv5_x: the bf16w gate takes it
    (1024, 256, 1, "per_block", "fused_stage"),        # one block
    (4096, 1024, 2, "per_block", "per_block"),         # past the bf16w gate too
])
def test_stage_algo_at_bf16w(cio, cmid, nb, f32, bf16w):
    blocks = _meta_blocks(cio, cmid, nb)
    assert resnet.stage_algo(blocks) == f32
    assert resnet.stage_algo(blocks, "f32") == f32
    assert resnet.stage_algo(blocks, "bf16w") == bf16w


def test_bf16w_stage_raises_where_the_route_is_per_block():
    rng = np.random.default_rng(2)
    blocks = [_bf16w({k: _t(v) for k, v in _block_params_random(rng, 16, c, bn_scale=0.5).items()})
              for c in (8, 4)]                          # two geometries: per_block
    with pytest.raises(ValueError, match="fused stage"):
        resnet.resnet_stage(torch.zeros(1, 4, 4, 16), blocks, precision="bf16w")
    with pytest.raises(ValueError, match="cast_bf16w"):
        resnet.resnet_stage(torch.zeros(1, 4, 4, 16), blocks, precision="f32")


def test_engine_serves_bf16w_and_basic_engine_refuses_it(tiny_basic):
    """Both engines serve bf16w: ResNet50Engine and ResNetBasicEngine cast
    the caller's f32 weights once and serve the bf16w forward (the name is
    from when the basic engine refused the tier)."""
    cfg = _TinyR50("tiny_resnet50")
    tree = jax_init(cfg, seed=3)
    params = params_from_jax(tree, device="cpu")
    engine = ResNet50Engine(params, tier="bf16w", device="cpu")
    p = engine._params
    assert p["stem"]["w192_stem"].dtype == BF16 and p["stem"]["s_stem"].dtype == torch.float32
    assert p["head"]["w_fc"].dtype == BF16 and p["head"]["b_fc"].dtype == torch.float32
    for stage in p["stages"]:
        assert stage["stacked"]["w_reduce"].dtype == BF16
        assert stage["stacked"]["s_expand"].dtype == torch.float32
    assert params["head"]["w_fc"].dtype == torch.float32          # the caller's stay f32
    x = (np.random.default_rng(1).random((cfg.img, cfg.img, 3)) - 0.5).astype(np.float32)
    want = resnet50_forward(x, cast_bf16w(params), device="cpu", precision="bf16w")
    np.testing.assert_array_equal(engine(x).numpy(), want.numpy())
    with pytest.raises(ValueError, match="tier"):
        ResNet50Engine(params, tier="fp8", device="cpu")
    _, case, _, basic = tiny_basic
    engine = ResNetBasicEngine(basic, tier="bf16w", device="cpu")
    p = engine._params
    assert p["stem"]["w192_stem"].dtype == BF16 and p["head"]["w_fc"].dtype == BF16
    assert p["stages"][2]["fused"]["w9_a"].dtype == BF16
    assert p["stages"][2]["fused"]["s_b"].dtype == torch.float32
    want = tb.basicnet_forward(case["x"], cast_basicnet_bf16w(basic), device="cpu",
                               precision="bf16w")
    np.testing.assert_array_equal(engine(case["x"]).numpy(), want.numpy())
    with pytest.raises(ValueError, match="tier"):
        ResNetBasicEngine(basic, tier="fp8", device="cpu")


def test_bf16w_wrappers_launch_the_bf16w_entries_under_the_f32_plans(monkeypatch):
    """On the card, bfloat16 weights launch each kernel's bf16w entry with
    the same plan and shape integers as its f32 entry, counted under
    "<kernel>_bf16w" (meta tensors and a recorded launch stand in for it)."""
    calls = []
    monkeypatch.setattr(_build, "check_tensors", lambda *t, **k: None)
    monkeypatch.setattr(_build, "check_operands", lambda *t, **k: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(_build, "ptr", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(stage_module, "_workspace_floats", lambda *a, **k: 1)
    monkeypatch.setattr(transition_module, "_workspace_floats", lambda *a, **k: 1)
    monkeypatch.setattr(basic_stage_module, "_workspace_floats", lambda *a, **k: 1)

    def launch(name, entry, shape, device, *args, counter=None):
        calls.append((entry, counter, [a.value for a in args if isinstance(a, ctypes.c_int)]))
    monkeypatch.setattr(_build, "launch", launch)

    def e(*shape, dtype=torch.float32):
        return torch.empty(*shape, device="meta", dtype=dtype)

    cio, cmid = 2048, 512
    stage = dict(w_reduce=e(2, cio, cmid), s_reduce=e(2, 1, cmid), b_reduce=e(2, 1, cmid),
                 w9_mid=e(2, 9 * cmid, cmid), s_mid=e(2, 1, cmid), b_mid=e(2, 1, cmid),
                 w_expand=e(2, cmid, cio), s_expand=e(2, 1, cio), b_expand=e(2, 1, cio))
    trans = dict(w_reduce=e(1024, cmid), s_reduce=e(cmid), b_reduce=e(cmid),
                 w9_mid=e(9 * cmid, cmid), s_mid=e(cmid), b_mid=e(cmid),
                 wep=e(cmid + 1024, cio), bep=e(1, cio))
    runs = {
        "pointwise": lambda p: conv1x1_bn(e(1, 2048), p["w"], e(1000), e(1000), False),
        "stage": lambda p: resnet_stage_fused(e(1, 7, 7, cio), p, "direct"),
        "transition": lambda p: transition_block_fused(e(1, 14, 14, 1024), p),
        "stem": lambda p: stem_fused(e(1, 224, 224, 3), p["w192"], e(64), e(64),
                                     "bf16w" if p["w192"].dtype == BF16 else "f32"),
        "winograd": lambda p: conv3x3_bn_winograd(e(1, 28, 28, 128), p["u2"], e(128), e(128),
                                                  True, "bf16w" if p["u2"].dtype == BF16 else "f32"),
        "direct": lambda p: conv3x3_bn_direct(e(1, 7, 7, 512), p["w9"], e(512), e(512), True),
        "basic_stage": lambda p: basic_stage_fused(e(1, 7, 7, 512), p),
    }
    basic = dict(w9_a=e(2, 9 * 512, 512), w9_b=e(2, 9 * 512, 512),
                 **{k: e(2, 1, 512) for k in ("s_a", "b_a", "s_b", "b_b")})
    params = {"pointwise": {"w": e(2048, 1000)}, "stage": stage, "transition": trans,
              "stem": {"w192": e(192, 64)}, "winograd": {"u2": e(16, 128, 128)},
              "direct": {"w9": e(9 * 512, 512)}, "basic_stage": basic}
    for kernel, run in runs.items():
        calls.clear()
        run(params[kernel])
        run(_bf16w(params[kernel]))
        (f32_entry, f32_counter, f32_ints), (entry, counter, ints) = calls
        assert (f32_counter, counter) == (None, f"{kernel}_bf16w")
        if kernel == "stem":                      # one entry; its last integer is the precision
            assert entry == f32_entry and ints[:-1] == f32_ints[:-1]
            assert (f32_ints[-1], ints[-1]) == (0, 2)
        else:
            assert entry == f32_entry + "_bf16w" and ints == f32_ints
