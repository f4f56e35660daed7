"""The kernels one forward launches on each rank of chip_smoke.py's
parallel phase, counted on the CPU: the counts that script pins on the
card (EXPECTED_PER_FORWARD* for "data", EXPECTED_TP for "model",
EXPECTED_PIPE for "pipe").

Every kernel wrapper's plain version is replaced by a stub that counts the
launch the wrapper would make on the card, under the wrapper's counter
name (kernels/_build.py::launch: "<kernel>_bf16w" on bfloat16 weights, the
stem at "bf16" and the F(2,3) on bf16 filters under their f32 names), and
returns zeros of the output's shape, so full-width ResNet-50 and ResNet-34
run at the cost of their shapes. The stubs are first held to the
single-device forwards' counts (EXPECTED_PER_FORWARD*), which
tests/test_torch_resnet50.py and tests/test_torch_basicnet.py pin by
another route. "data" is the single-device forward on each rank's batch
shard. "model" runs make_resnet50_tp_fn and make_basicnet_tp_fn on a one-rank mesh in this
process: a rank's launches depend on the block structure and not on the
model axis (each layer is one launch on its shard at any axis; the head is
one launch sharded or whole). "pipe" runs each rank's group of the
FLOP-balanced partition (parallel/pipeline.py::rank_groups) of a four-rank
pipe on its boundary shape; no world is needed for it. No kernel runs."""

import collections
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from torch_parallel_ranks import one_rank_world
from winograd_tpu_torch.config import ResNet34Config, ResNet50Config
from winograd_tpu_torch.kernels import basic_stage, direct, pointwise, quantized, stage, stem
from winograd_tpu_torch.kernels import transition, winograd
from winograd_tpu_torch.models.basic import (
    basicnet_forward, basicnet_forward_int8, basicnet_params, cast_basicnet_bf16w,
    init_basicnet_arrays, quantize_basicnet,
)
from winograd_tpu_torch.models.convert import cast_bf16w
from winograd_tpu_torch.models.resnet50 import (
    init_resnet50_params, quantize_resnet50, resnet50_forward, resnet50_forward_int8,
)
from winograd_tpu_torch.parallel import make_basicnet_tp_fn, make_mesh, make_resnet50_tp_fn
from winograd_tpu_torch.parallel.pipeline import (
    _basicnet_segments, _classifier_segments, rank_groups,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIERS = ("f32", "bf16w", "int8")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bf16(t) -> bool:
    return isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16


def _stub_plain_versions(monkeypatch, taken):
    """Replace each kernel's plain version with a counting stub that returns
    zeros of its output's shape."""
    def stub(name, shape_of, weight_of=None):
        def fn(x, *args, **kwargs):
            w = weight_of(*args) if weight_of else None
            taken[f"{name}_bf16w" if _bf16(w) else name] += 1
            return torch.zeros(shape_of(x, *args), dtype=torch.float32)
        return fn

    def cout(x, w, *a):
        return tuple(x.shape[:-1]) + (w.shape[-1],)

    def half(x, c):
        return (x.shape[0], -(-x.shape[1] // 2), -(-x.shape[2] // 2), c)

    def stem_shape(x, w192, *a):
        return (x.shape[0], -(-x.shape[1] // 4), -(-x.shape[2] // 4), w192.shape[1])

    def stem_fn(x, w192, scale, bias, precision="f32"):
        taken["stem_bf16w" if precision == "bf16w" else "stem"] += 1
        return torch.zeros(stem_shape(x, w192))

    first = lambda *a: a[0]  # noqa: E731
    for mod, name, fn in (
        (pointwise, "conv1x1_bn_plain", stub("pointwise", cout, first)),
        (direct, "conv3x3_bn_direct_plain", stub("direct", cout, first)),
        (winograd, "conv3x3_bn_winograd_plain", stub("winograd", cout, first)),
        (winograd, "winograd2_mid_plain", stub("winograd", cout)),
        (stem, "stem_fused_plain", stem_fn),
        (stage, "resnet_stage_fused_plain",
         stub("stage", lambda x, *a: x.shape, lambda s, *a: s["w_reduce"])),
        (transition, "transition_block_fused_plain",
         stub("transition", lambda x, p: half(x, p["w_expand"].shape[1]),
              lambda p: p["w_reduce"])),
        (quantized, "conv1x1_bn_int8_plain", stub("pointwise_int8", cout)),
        (quantized, "conv3x3_bn_int8_plain", stub("direct_int8", cout)),
        (quantized, "conv3x3_bn_winograd_int8_plain", stub("winograd_int8", cout)),
        (quantized, "resnet_stage_int8_plain", stub("stage_int8", lambda x, *a: x.shape)),
        (quantized, "transition_block_int8_plain",
         stub("transition_int8", lambda x, q: half(x, q["w_expand_q"].shape[1]))),
        (basic_stage, "basic_stage_fused_plain",
         stub("basic_stage", lambda x, *a: x.shape, lambda s, *a: s["w9_a"])),
        (basic_stage, "basic_stage_int8_plain", stub("basic_stage_int8", lambda x, *a: x.shape)),
    ):
        monkeypatch.setattr(mod, name, fn)


@pytest.fixture(scope="module")
def full_width():
    """Full-width ResNet-50 and ResNet-34, seeded, at every tier, CPU."""
    r50 = init_resnet50_params(ResNet50Config("resnet50"), seed=0, device="cpu")
    cfg34 = ResNet34Config("resnet34")
    r34 = basicnet_params(init_basicnet_arrays(cfg34, seed=0), cfg34, "cpu")
    return {"resnet50": {"f32": r50, "bf16w": cast_bf16w(r50), "int8": quantize_resnet50(r50)},
            "resnet34": {"f32": r34, "bf16w": cast_basicnet_bf16w(r34),
                         "int8": quantize_basicnet(r34)}}


@pytest.fixture(scope="module")
def smoke():
    return _chip_smoke()


def _single(model, tier, params, x):
    if model == "resnet50":
        if tier == "int8":
            return resnet50_forward_int8(x, params, device="cpu")
        return resnet50_forward(x, params, device="cpu", precision=tier)
    if tier == "int8":
        return basicnet_forward_int8(x, params, device="cpu")
    return basicnet_forward(x, params, device="cpu", precision=tier)


def _expected_data(smoke, model, tier):
    suffix = {"f32": "", "bf16w": "_BF16W", "int8": "_INT8"}[tier]
    basic = "_BASIC" if model == "resnet34" else ""
    return getattr(smoke, f"EXPECTED_PER_FORWARD{basic}{suffix}")


@pytest.mark.parametrize("model", ["resnet50", "resnet34"])
@pytest.mark.parametrize("tier", TIERS)
def test_data_partition_launches_the_single_device_forward(monkeypatch, full_width, smoke,
                                                           model, tier):
    taken = collections.Counter()
    _stub_plain_versions(monkeypatch, taken)
    out = _single(model, tier, full_width[model][tier], np.zeros((1, 224, 224, 3), np.float32))
    assert tuple(out.shape) == (1, 1000)
    assert dict(taken) == _expected_data(smoke, model, tier)


@pytest.mark.parametrize("model", ["resnet50", "resnet34"])
def test_model_partition_launches_per_rank(monkeypatch, tmp_path, full_width, smoke, model):
    build = make_resnet50_tp_fn if model == "resnet50" else make_basicnet_tp_fn
    taken = collections.Counter()
    _stub_plain_versions(monkeypatch, taken)
    with one_rank_world(tmp_path):
        mesh = make_mesh(1, 1, device="cpu")
        for tier in TIERS:
            fn = build(mesh, full_width[model]["f32"], tier)
            taken.clear()
            out = fn(np.zeros((1, 224, 224, 3), np.float32))
            assert tuple(out.shape) == (1, 1000)
            assert dict(taken) == smoke.EXPECTED_TP[(model, tier)], tier


@pytest.mark.parametrize("model", ["resnet50", "resnet34"])
@pytest.mark.parametrize("tier", TIERS)
def test_pipe_partition_launches_per_rank(monkeypatch, full_width, smoke, model, tier):
    segments = _classifier_segments if model == "resnet50" else _basicnet_segments
    segs, make_run, head_fn, classes = segments(full_width[model][tier], 224, tier)
    taken = collections.Counter()
    _stub_plain_versions(monkeypatch, taken)
    counts = []
    for group, entry in rank_groups(segs, make_run, head_fn, 4):
        taken.clear()
        group(torch.zeros((1,) + (entry or (224, 224, 3))))
        counts.append(dict(taken))
    assert counts == smoke.EXPECTED_PIPE[(model, tier)]
    # The ranks together launch no more than the single device's forward
    # and a launch more for each identity run cut between two ranks.
    single = _expected_data(smoke, model, tier)
    total = collections.Counter()
    for c in counts:
        total.update(c)
    assert sum(total.values()) <= sum(single.values()) + 3
