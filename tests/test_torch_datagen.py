"""The port's data generator against the JAX package's: the same seed gives
the same arrays, float64 golden included, and the same artifact files byte
for byte; the files read back equal. The tiny model configs are injected as
CASES[990] into both packages, as tests/test_bench.py injects its train
config."""

import dataclasses
import pathlib

import numpy as np
import pytest

from winograd_tpu import config as jax_config
from winograd_tpu.datagen import generate as jax_generate
from winograd_tpu_torch import config
from winograd_tpu_torch.datagen import generate


def _assert_cases_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4, 5, 6, 9, 11, 22])
def test_make_case_matches_jax_package(mode):
    _assert_cases_equal(generate.make_case(mode, seed=mode + 3),
                        jax_generate.make_case(mode, seed=mode + 3))


def _tiny_r50(base):
    @dataclasses.dataclass(frozen=True)
    class TinyR50(base):
        stages = ((64, 16, 8, 1), (128, 32, 4, 2))
        img: int = 32
        stem_c: int = 16
        num_classes: int = 24

    return TinyR50("tiny_r50", batch=2)


def _tiny_basic(base):
    @dataclasses.dataclass(frozen=True)
    class TinyBasic(base):
        stages = ((16, 8, 1), (32, 4, 2))
        img: int = 32
        stem_c: int = 16
        num_classes: int = 16

    return TinyBasic("tiny_basic")


def _tiny_backbone(base):
    @dataclasses.dataclass(frozen=True)
    class TinyBackbone(base):
        stages = ((64, 16, 8, 1), (128, 32, 4, 2))

    return TinyBackbone("tiny_backbone", batch=2)


TINY = {"resnet50": (_tiny_r50, "ResNet50Config"), "basic": (_tiny_basic, "BasicNetConfig"),
        "backbone": (_tiny_backbone, "BackboneConfig")}


@pytest.fixture
def tiny_mode(request):
    """Mode 990 as the named tiny config in both packages' CASES."""
    make, base = TINY[request.param]
    jax_config.CASES[990] = make(getattr(jax_config, base))
    config.CASES[990] = make(getattr(config, base))
    yield 990
    del jax_config.CASES[990], config.CASES[990]


@pytest.mark.parametrize("tiny_mode", sorted(TINY), indirect=True)
def test_make_case_matches_jax_package_at_tiny_models(tiny_mode):
    _assert_cases_equal(generate.make_case(tiny_mode, seed=5),
                        jax_generate.make_case(tiny_mode, seed=5))


def test_seed_determinism():
    a = generate.make_case(0, seed=7)
    assert np.array_equal(a["x"], generate.make_case(0, seed=7)["x"])
    assert not np.array_equal(a["x"], generate.make_case(0, seed=8)["x"])


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4, 5])
def test_writers_match_jax_package_byte_for_byte(tmp_path, mode):
    """generate_all's per-case writers give the JAX package's file set, byte
    for byte, and load_case reads the case back equal."""
    cfg = config.CASES[mode]
    writer = "_write_winograd_files" if cfg.kind == "winograd3x3" else "_write_pointwise_files"
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    ours.mkdir()
    theirs.mkdir()
    case = generate.make_case(mode, seed=mode)
    getattr(generate, writer)(str(ours), cfg, case)
    getattr(jax_generate, writer)(str(theirs), jax_config.CASES[mode],
                                  jax_generate.make_case(mode, seed=mode))
    names = sorted(p.name for p in ours.iterdir())
    assert names == sorted(p.name for p in theirs.iterdir())
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name
    loaded = generate.load_case(mode, str(ours))
    for k, v in loaded.items():
        assert np.array_equal(v, case[k]), k
    _assert_cases_equal(loaded, jax_generate.load_case(mode, str(theirs)))


def test_load_case_regenerates_bench_only_cases_from_the_recorded_seed(tmp_path):
    """Mode 22 is made in memory; load_case makes it from meta.json's seed
    plus the mode, as generate_all's on-disk cases are."""
    (pathlib.Path(tmp_path) / "meta.json").write_text('{"seed": 4}')
    _assert_cases_equal(generate.load_case(22, str(tmp_path)), generate.make_case(22, seed=26))
