"""The port's basic family (ResNet-18/34) as a whole against the JAX package:
a tiny basic net whose routes cover every kernel of the slice (F(2,3) on
f32 and on bf16 filters, the int8 Winograd, the direct 3x3s, the pointwise
kernels and both basic-stage kernels), built by datagen's
make_basicnet_case -> basicnet_params on both sides, through
basicnet_forward / basicnet_forward_int8 (CPU, plain versions) against
basicnet_forward_pallas / basicnet_forward_int8 (Pallas interpret mode) and
the case's float64 golden; the seeded init, the converters, the engine,
the reference ops, and the route each gate picks at full width.

Bounds: f32 within 1e-4 * max(1, max|ref|) of JAX and of the golden; the
two int8 forwards within 1e-3 * max(1, max|ref|) (chained quantizations,
see tests/test_torch_quantized.py); each against the golden within
INT8_RTOL_BACKBONE (5e-2) * max(1, max|golden|). The reference ops in
float64 against winograd_tpu/ops/reference.py within its float32 rounding
of the result."""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from winograd_tpu.config import BasicNetConfig as JaxBasicNetConfig
from winograd_tpu.datagen.generate import make_basicnet_case
from winograd_tpu.models import basic as jb
from winograd_tpu.ops import reference
from winograd_tpu_torch.config import (
    INT8_RTOL_BACKBONE, PARITY_ATOL, BasicNetConfig, ResNet34Config,
)
from winograd_tpu_torch.engine import ResNetBasicEngine
from winograd_tpu_torch.models import basic as tb
from winograd_tpu_torch.models.convert import (
    basicnet_params_from_jax, cast_basicnet_bf16w, params_to, qbasicnet_params_from_jax,
)
from winograd_tpu_torch.ops import torch_ops
from winograd_tpu_torch.parallel import make_mesh, make_pipe_mesh
from torch_parallel_ranks import one_rank_world

CHAINED_RTOL = 1e-3
F32_RTOL = 2 ** -23  # the float64 golden model rounds its output to float32
MIN_CHANNELS = 76   # stage 2 (80 channels) stacks its run, stage 1 (72) does not


@dataclasses.dataclass(frozen=True)
class _TinyRoutes(JaxBasicNetConfig):
    """96x96 images -> 24x24 after the stem. Stage 0 (16 channels, 24x24):
    F(2,3), on bf16 filters at int8; stage 1 (72, entry to 12x12): F(2,3),
    the int8 Winograd over one group of 72 input channels; stage 2 (80,
    entry to 6x6): the entry's b-leg direct, two identity blocks in one
    basic-stage launch."""

    stages = ((16, 24, 1), (72, 12, 2), (80, 6, 3))
    img: int = 96
    stem_c: int = 16
    num_classes: int = 16


def _err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape and np.isfinite(out).all()
    return np.abs(out - ref).max() / max(1.0, np.abs(ref).max())


@pytest.fixture(scope="module")
def tiny():
    cfg = _TinyRoutes("tiny_basic_routes")
    case = make_basicnet_case(cfg, seed=5)
    jparams = jb.attach_fused_stage_artifacts(jb.basicnet_params(case, cfg), MIN_CHANNELS)
    x = jnp.asarray(case["x"])
    return dict(
        cfg=cfg, case=case, jparams=jparams,
        ref=np.asarray(jb.basicnet_forward_pallas(x, jparams)),
        qjparams=jb.quantize_basicnet(jparams),
        params=tb.attach_fused_stage_artifacts(tb.basicnet_params(case, cfg, device="cpu"),
                                               MIN_CHANNELS),
    )


def test_init_basicnet_arrays_equal_datagen_key_for_key():
    cfg = _TinyRoutes("tiny")
    case = make_basicnet_case(cfg, seed=3)
    ours = tb.init_basicnet_arrays(cfg, seed=3)
    assert sorted(ours) == sorted(k for k in case if not k.startswith("golden"))
    for k, v in ours.items():
        assert v.dtype == case[k].dtype and v.shape == case[k].shape, k
        np.testing.assert_array_equal(v, case[k], err_msg=k)


def test_tiny_basicnet_f32_matches_jax_and_golden(tiny):
    assert [st.get("fused") is not None for st in tiny["params"]["stages"]] == [False, False, True]
    out = tb.basicnet_forward(tiny["case"]["x"], tiny["params"], device="cpu").numpy()
    assert _err(out, tiny["ref"]) <= PARITY_ATOL
    assert _err(out, tiny["case"]["golden"]) <= PARITY_ATOL


def test_tiny_basicnet_int8_matches_jax_and_golden(tiny):
    ref = np.asarray(jb.basicnet_forward_int8(jnp.asarray(tiny["case"]["x"]), tiny["qjparams"]))
    out = tb.basicnet_forward_int8(tiny["case"]["x"], tb.quantize_basicnet(tiny["params"]),
                                   device="cpu").numpy()
    assert _err(out, ref) <= CHAINED_RTOL
    assert _err(out, tiny["case"]["golden"]) < INT8_RTOL_BACKBONE
    assert _err(ref, tiny["case"]["golden"]) < INT8_RTOL_BACKBONE


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    elif tree is not None:
        yield prefix, tree


def _bits(t):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _jax_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_params_match_jax_tensor_for_tensor_and_are_stored_once(tiny):
    ours = dict(_leaves(tiny["params"]))
    theirs = dict(_leaves(basicnet_params_from_jax(
        jax.tree.map(np.asarray, tiny["jparams"]), device="cpu")))
    assert sorted(ours) == sorted(theirs) == sorted(dict(_leaves(tiny["jparams"])))
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k].numpy(), err_msg=k)
    q_ours = dict(_leaves(tb.quantize_basicnet(tiny["params"])))
    q_jax = dict(_leaves(jax.tree.map(np.asarray, tiny["qjparams"])))
    q_conv = dict(_leaves(qbasicnet_params_from_jax(jax.tree.map(np.asarray, tiny["qjparams"]),
                                                    device="cpu")))
    assert sorted(q_ours) == sorted(q_jax) == sorted(q_conv)
    for k, v in q_ours.items():
        a, b = _bits(v), _jax_bits(q_jax[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
        np.testing.assert_array_equal(a, _bits(q_conv[k]), err_msg=k)
    for params in (tiny["params"], params_to(tiny["params"], "cpu", torch.float64),
                   tb.quantize_basicnet(tiny["params"])):
        st = params["stages"][2]
        key = "w9_b" if "w9_b" in st["fused"] else "w9_b_q"
        assert st["blocks"][1][key].data_ptr() == st["fused"][key][1].data_ptr()
        assert st["blocks"][0]["s_a"].shape == (80,)


def test_engine_serves_both_tiers_on_request(tiny, tmp_path):
    x = tiny["case"]["x"]
    f32 = ResNetBasicEngine(tiny["params"], device="cpu")
    out = f32(x)
    assert _err(out.numpy(), tiny["ref"]) <= PARITY_ATOL
    assert f32.classify(np.stack([x, x])).tolist() == [int(out.argmax())] * 2
    int8 = ResNetBasicEngine(tiny["params"], tier="int8", device="cpu")
    assert _err(int8(x).numpy(), tiny["case"]["golden"]) < INT8_RTOL_BACKBONE
    with pytest.raises(TypeError, match="Mesh"):
        ResNetBasicEngine(tiny["params"], device="cpu", mesh=object())
    with pytest.raises(ValueError, match="needs a mesh"):
        ResNetBasicEngine(tiny["params"], device="cpu", partition="model")
    # Under a mesh (one rank in this process; larger ones in
    # tests/test_torch_parallel_classifier.py, tests/test_torch_pipeline.py):
    # the partitions serve the single-device logits, eagerly.
    with one_rank_world(tmp_path):
        for partition, mesh in (("data", make_mesh(1, 1, device="cpu")),
                                ("model", make_mesh(1, 1, device="cpu")),
                                ("pipe", make_pipe_mesh(1, device="cpu"))):
            engine = ResNetBasicEngine(tiny["params"], device="cpu", mesh=mesh,
                                       partition=partition)
            assert _err(engine(x[None]).numpy()[0], out.numpy()) <= PARITY_ATOL, partition
            assert engine.replays == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ResNetBasicEngine(tiny["params"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tb.basicnet_params(tiny["case"], tiny["cfg"])


def test_reference_ops_match_the_float64_golden_model():
    rng = np.random.default_rng(8)
    x = rng.random((2, 7, 9, 12)) - 0.5
    w = {k: rng.random(s) - 0.5 for k, s in (("w_a", (12, 12, 3, 3)), ("w_b", (12, 12, 3, 3)),
                                            ("w_da", (20, 12, 3, 3)), ("w_db", (20, 20, 3, 3)),
                                            ("w_proj", (12, 20)))}
    bn = {k: rng.random(c) + 0.5 for k, c in (("s_a", 12), ("b_a", 12), ("s_b", 12), ("b_b", 12),
                                              ("s_da", 20), ("b_da", 20), ("s_db", 20),
                                              ("b_db", 20), ("s_p", 20), ("b_p", 20))}
    t = {k: torch.from_numpy(v) for k, v in {**w, **bn}.items()}
    block = dict(w_a=t["w_a"], s_a=t["s_a"], b_a=t["b_a"], w_b=t["w_b"], s_b=t["s_b"], b_b=t["b_b"])
    for i in range(2):
        ref = reference.basic_block(x[i], w["w_a"], bn["s_a"], bn["b_a"], w["w_b"], bn["s_b"],
                                    bn["b_b"])
        out = torch_ops.basic_block(torch.from_numpy(x), block)[i].numpy()
        np.testing.assert_allclose(out, ref, rtol=F32_RTOL, atol=0)
    entry = dict(w_a=t["w_da"], s_a=t["s_da"], b_a=t["b_da"], w_b=t["w_db"], s_b=t["s_db"],
                 b_b=t["b_db"], w_proj=t["w_proj"], s_proj=t["s_p"], b_proj=t["b_p"])
    ref = reference.downsample_basic_block(
        x[0], w["w_da"], bn["s_da"], bn["b_da"], w["w_db"], bn["s_db"], bn["b_db"],
        w["w_proj"], bn["s_p"], bn["b_p"])
    out = torch_ops.downsample_basic_block(torch.from_numpy(x[:1]), entry)[0].numpy()
    assert out.shape == (4, 5, 20)
    np.testing.assert_allclose(out, ref, rtol=F32_RTOL, atol=0)


# --- the route each gate picks at full width --------------------------------

# Per forward (the chip_smoke.py counts): name -> launches.
ROUTES = {
    ("resnet34", "f32"): {"stem": 1, "winograd": 24, "pointwise": 7, "direct": 1, "basic_stage": 1},
    ("resnet18", "f32"): {"stem": 1, "winograd": 10, "pointwise": 7, "direct": 1, "basic_stage": 1},
    ("resnet34", "int8"): {"stem_bf16": 1, "winograd_bf16": 6, "winograd_int8": 18,
                           "pointwise_int8": 7, "direct_int8": 1, "basic_stage_int8": 1},
    ("resnet18", "int8"): {"stem_bf16": 1, "winograd_bf16": 4, "winograd_int8": 6,
                           "pointwise_int8": 7, "direct_int8": 1, "basic_stage_int8": 1},
    ("resnet34", "bf16w"): {"stem_bf16w": 1, "winograd_bf16w": 24, "pointwise_bf16w": 7,
                            "direct_bf16w": 1, "basic_stage_bf16w": 1},
    ("resnet18", "bf16w"): {"stem_bf16w": 1, "winograd_bf16w": 10, "pointwise_bf16w": 7,
                            "direct_bf16w": 1, "basic_stage_bf16w": 1},
}


def _full_width_shapes(cfg):
    """The basic family's parameter shapes at cfg's widths, as a nested
    {"stem", "stages", "head"} of shape tuples."""
    def conv(c_in, c_out, u2=True):
        d = {"w9": (9 * c_in, c_out), "s": (c_out,), "b": (c_out,)}
        return dict(d, u2=(16, c_in, c_out)) if u2 else d

    def block(legs):
        return {f"{k}_{leg}": v for leg, d in legs.items() for k, v in d.items()}

    stages, prev = [], cfg.stem_c
    for c, _hw, n in cfg.stages:
        entry = None
        if prev != c:
            entry = dict(block({"a": conv(prev, c, u2=False), "b": conv(c, c)}),
                         w_proj=(prev, c), s_proj=(c,), b_proj=(c,))
            n -= 1
        stages.append({"entry": entry,
                       "blocks": [block({"a": conv(c, c), "b": conv(c, c)}) for _ in range(n)]})
        prev = c
    return {"stem": {"w192_stem": (192, cfg.stem_c), "s_stem": (cfg.stem_c,),
                     "b_stem": (cfg.stem_c,)},
            "stages": stages, "head": {"w_fc": (prev, cfg.num_classes), "b_fc": (cfg.num_classes,)}}


def _tree(shapes, make):
    if isinstance(shapes, dict):
        return {k: _tree(v, make) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(v, make) for v in shapes]
    return None if shapes is None else make(shapes)


def _stub_routes(monkeypatch, taken):
    """Replace every kernel wrapper the two packages' basic-family forwards
    call with one that records its route and returns zeros of the output
    shape."""
    import winograd_tpu.kernels.basic_stage as jbs
    import winograd_tpu.kernels.direct as jdirect
    import winograd_tpu.kernels.quantized as jq
    import winograd_tpu.models.resnet50 as jr50

    def bf16w(args, kwargs):
        """The bf16w tier's call: the JAX package names its precision, the
        port passes bfloat16 weights (or names it)."""
        values = list(args) + list(kwargs.values())
        values += [v for a in values if isinstance(a, dict) for v in a.values()]
        return any(isinstance(v, str) and v == "bf16w"
                   or isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16 for v in values)

    def rec(name, out_shape, zeros):
        def stub(x, *args, **kwargs):
            taken[f"{name}_bf16w" if bf16w(args, kwargs) else name] += 1
            return zeros(out_shape(x, *args, **kwargs))
        return stub

    def cout(idx):
        return lambda x, *a, **k: tuple(x.shape[:-1]) + (a[idx].shape[-1],)

    def same(x, *a, **k):
        return tuple(x.shape)

    def stem_shape(x, p, *a, **k):
        return (x.shape[0], x.shape[1] // 4, x.shape[2] // 4, p["s_stem"].shape[0])

    def head_shape(x, p, *a, **k):
        return (x.shape[0], p["b_fc"].shape[0])

    def bf16_or(name):
        return lambda u: f"{name}_bf16" if u.dtype in (torch.bfloat16, jnp.bfloat16) else name

    tz, jz = torch.zeros, jnp.zeros

    def wino(zeros):
        """The port names the precision of a bfloat16 u ("bf16w" or the int8
        tier's "bf16"); the JAX package passes a bfloat16 u at the int8 tier
        and an f32 u at bf16w, both at precision="bf16w"."""
        def stub(x, u, *args, **kwargs):
            precision = kwargs.get("precision", args[3] if len(args) > 3 else None)
            if zeros is tz:
                name = {"bf16w": "winograd_bf16w", "bf16": "winograd_bf16"}.get(precision,
                                                                                 "winograd")
            else:
                name = bf16_or("winograd")(u)
                if name == "winograd" and precision == "bf16w":
                    name = "winograd_bf16w"
            taken[name] += 1
            return zeros(tuple(x.shape[:-1]) + (u.shape[-1],))
        return stub

    def stem(zeros):
        def stub(x, p, precision=None, *a, **k):
            taken[{"bf16": "stem_bf16", "int8": "stem_bf16",
                   "bf16w": "stem_bf16w"}.get(precision, "stem")] += 1
            return zeros(stem_shape(x, p))
        return stub

    for mod, name, stub in (
        (tb, "stem", stem(tz)), (tb, "head", rec("pointwise", head_shape, tz)),
        (tb, "head_int8", rec("pointwise_int8", head_shape, tz)),
        (tb, "conv1x1_bn", rec("pointwise", cout(0), tz)),
        (tb, "conv3x3_bn_winograd", wino(tz)), (tb, "conv3x3_bn_direct", rec("direct", cout(0), tz)),
        (tb, "basic_stage_fused", rec("basic_stage", same, tz)),
        (tb, "conv1x1_bn_int8", rec("pointwise_int8", cout(0), tz)),
        (tb, "conv3x3_bn_int8", rec("direct_int8", cout(0), tz)),
        (tb, "conv3x3_bn_winograd_int8", rec("winograd_int8", cout(0), tz)),
        (tb, "basic_stage_int8", rec("basic_stage_int8", same, tz)),
        (jb, "stem_pallas", stem(jz)), (jb, "head_pallas", rec("pointwise", head_shape, jz)),
        (jr50, "_head_int8", rec("pointwise_int8", head_shape, jz)),
        (jb, "conv1x1_bn_pallas", rec("pointwise", cout(0), jz)),
        (jb, "conv3x3_bn_winograd_pallas", wino(jz)),
        (jdirect, "conv3x3_bn_direct_pallas", rec("direct", cout(0), jz)),
        (jbs, "basic_stage_fused_pallas", rec("basic_stage", same, jz)),
        (jq, "conv1x1_bn_int8_pallas", rec("pointwise_int8", cout(0), jz)),
        (jq, "conv3x3_bn_int8_pallas", rec("direct_int8", cout(0), jz)),
        (jq, "conv3x3_bn_winograd_int8_pallas", rec("winograd_int8", cout(0), jz)),
        (jbs, "basic_stage_int8_pallas", rec("basic_stage_int8", same, jz)),
    ):
        monkeypatch.setattr(mod, name, stub)


@pytest.mark.parametrize("model,tier", list(ROUTES))
def test_route_choice_matches_jax_gates_at_full_width(monkeypatch, model, tier):
    """Arithmetic on shapes only: a full-width ResNet-34 / ResNet-18 forward
    of the port and of the JAX package, each kernel wrapper stubbed, take
    the same routes, with the per-forward launch counts chip_smoke.py
    checks on the card. No kernel runs."""
    cfg = ResNet34Config("resnet34") if model == "resnet34" else BasicNetConfig("resnet18")
    shapes = _full_width_shapes(cfg)
    ours = tb.attach_fused_stage_artifacts(
        _tree(shapes, lambda s: torch.zeros(()).expand(s)))
    theirs = jb.attach_fused_stage_artifacts(
        _tree(shapes, lambda s: np.broadcast_to(np.float32(0), s)))
    assert [st.get("fused") is not None for st in ours["stages"]] == [False, False, False, True]
    taken = collections.Counter()
    _stub_routes(monkeypatch, taken)
    x = np.zeros((1, cfg.img, cfg.img, 3), np.float32)
    if tier == "f32":
        tb.basicnet_forward(x, ours, device="cpu")
    elif tier == "bf16w":
        tb.basicnet_forward(x, cast_basicnet_bf16w(ours), device="cpu", precision="bf16w")
    else:
        tb.basicnet_forward_int8(x, tb.quantize_basicnet(ours), device="cpu")
    port = dict(taken)
    taken.clear()
    if tier == "int8":
        jb.basicnet_forward_int8(jnp.asarray(x), jb.quantize_basicnet(theirs))
    else:
        jb.basicnet_forward_pallas(jnp.asarray(x), theirs,
                                   precision="bf16w" if tier == "bf16w" else None)
    assert port == dict(taken) == ROUTES[(model, tier)]
