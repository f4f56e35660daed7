"""The port's bf16w serving tier against winograd_tpu at precision="bf16w",
at narrow widths: the plain split_dot, each kernel module with a bf16w
instantiation (pointwise, stem, stage with a Winograd and a direct mid,
transition), the entry block's F(2,3) on bf16 filters, the whole tiny
ResNet-50 forward, the bf16 cast of the weights, the stage route and the
engine. JAX runs in Pallas interpret mode; the port runs its plain twins in
float32 on the CPU. Inputs are made from a seed with numpy.

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

from winograd_tpu.config import BlockConfig
from winograd_tpu.config import ResNet50Config as JaxResNet50Config
from winograd_tpu.config import TransitionConfig
from winograd_tpu.datagen.generate import (
    _block_params_random, _transition_params_random, block_params_list, make_block_case,
)
from winograd_tpu.kernels.direct import split_dot
from winograd_tpu.kernels.pointwise import conv1x1_bn_pallas
from winograd_tpu.kernels.stage import resnet_stage_fused_pallas
from winograd_tpu.kernels.stage import stack_stage_params as jax_stack
from winograd_tpu.kernels.stem import stem_fused_pallas
from winograd_tpu.kernels.transition import fuse_transition_weights as jax_fuse
from winograd_tpu.kernels.transition import transition_block_fused_pallas
from winograd_tpu.kernels.winograd import conv3x3_bn_winograd_pallas
from winograd_tpu.models.resnet50 import init_resnet50_params as jax_init
from winograd_tpu.models.resnet50 import resnet50_forward_pallas
from winograd_tpu_torch.config import BF16W_RTOL, BF16W_RTOL_BACKBONE
from winograd_tpu_torch.engine import ResNet50Engine, ResNetBasicEngine
from winograd_tpu_torch.kernels import _build, transforms
from winograd_tpu_torch.kernels import stage as stage_module
from winograd_tpu_torch.kernels import transition as transition_module
from winograd_tpu_torch.kernels.pointwise import conv1x1_bn, conv1x1_bn_plain, split_dot_bf16w
from winograd_tpu_torch.kernels.splitk import H100_SMS
from winograd_tpu_torch.kernels.stage import (
    STAGE_KEYS, resnet_stage_fused, resnet_stage_fused_plain, stack_stage_params,
)
from winograd_tpu_torch.kernels.stem import stem_fused, stem_fused_plain
from winograd_tpu_torch.kernels.transition import (
    fuse_transition_weights, transition_block_fused, transition_block_fused_plain,
)
from winograd_tpu_torch.kernels.winograd import conv3x3_bn_winograd, conv3x3_bn_winograd_plain
from winograd_tpu_torch.models import resnet
from winograd_tpu_torch.models.convert import cast_bf16w, params_from_jax
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
    """The entry block's F(2,3) at bf16w is the F(2,3) on bf16 filters
    (kernels/winograd.py's FP64 route, csrc/winograd.cu on the card)."""
    rng = np.random.default_rng(5)
    x = np.abs(_rand(rng, 1, 10, 12, 16))
    u = transforms.transform_filter(_rand(rng, 24, 16, 3, 3), m=2)
    s, b = _bn(rng, 24)
    ref = conv3x3_bn_winograd_pallas(jnp.asarray(x), jnp.asarray(u).astype(jnp.bfloat16),
                                     jnp.asarray(s), jnp.asarray(b), precision="bf16w")
    out = conv3x3_bn_winograd(_t(x), _t(u, BF16), _t(s), _t(b))
    _close(out.numpy(), ref, MODULE_RTOL)
    gold = conv3x3_bn_winograd_plain(*(_t(a).double() for a in (x, u, s, b)))
    _close(out.numpy(), gold.numpy(), BF16W_RTOL)


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


def test_engine_serves_bf16w_and_basic_engine_refuses_it():
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ResNetBasicEngine({}, tier="bf16w", device="cpu")
    with pytest.raises(ValueError, match="tier"):
        ResNet50Engine(params, tier="fp8", device="cpu")


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
    }
    params = {"pointwise": {"w": e(2048, 1000)}, "stage": stage, "transition": trans,
              "stem": {"w192": e(192, 64)}}
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
