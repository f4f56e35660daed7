"""The port's benchmark surface against the JAX package's, on the CPU: the
case table, FLOP counts, protocol and bars; run_case's parity on the layer
modes, the stem and tiny model configs at every tier, the training modes'
branches at tiny configs; mode 2's row against the JAX CLI's; the hard
failure on a breach; the unported modes; the
protocol of bench_loop and bench_graph; the CLI's flags. On the CPU every
kernel runs as its plain version and no device time is given."""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from winograd_tpu import config as jax_config
from winograd_tpu.bench.cli import run_case as jax_run_case
from winograd_tpu_torch import config
from winograd_tpu_torch.bench import cli
from winograd_tpu_torch.bench.cli import main, run_case
from winograd_tpu_torch.datagen import generate
from winograd_tpu_torch.utils.checker import ParityError, output_checker
from winograd_tpu_torch.utils.timing import bench_graph, bench_loop


@pytest.mark.parametrize("mode", sorted(jax_config.CASES))
def test_cases_match_jax_package(mode):
    """Same class (by name, down its bases), fields, stages, on_disk and
    nominal FLOPs as the JAX package's case."""
    ours, theirs = config.CASES[mode], jax_config.CASES[mode]
    assert [c.__name__ for c in type(ours).__mro__] == [c.__name__ for c in type(theirs).__mro__]
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert getattr(ours, "stages", None) == getattr(theirs, "stages", None)
    assert getattr(ours, "on_disk", True) == getattr(theirs, "on_disk", True)
    assert config.case_flops(ours) == jax_config.case_flops(theirs)
    assert config.case_config(mode) is ours


def test_protocol_and_bars_match_jax_package():
    assert set(config.CASES) == set(jax_config.CASES)
    for name in ("BENCH_ITERATIONS", "BENCH_WARMUP", "PARITY_ATOL", "BN_EPS", "BF16W_RTOL",
                 "BF16W_RTOL_BACKBONE", "INT8_RTOL", "INT8_RTOL_BACKBONE"):
        assert getattr(config, name) == getattr(jax_config, name), name
    assert config.stem_entry_flops(224, 64, 64, 256) == jax_config.stem_entry_flops(224, 64, 64, 256)
    assert config.H100_PEAK_FLOPS == 989e12


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4, 5, 22])
def test_run_case_parity_on_the_cpu(mode):
    r = run_case(mode, iterations=2, warmup=1, device="cpu")
    assert r["parity_ok"]
    assert r["backend"] == "cpu" and r["tf32"] is False
    assert r["max_error_cuda"] <= config.PARITY_ATOL
    assert r["max_error_cudnn"] <= config.PARITY_ATOL
    assert r["int8_rel_error"] < config.INT8_RTOL and r["bf16w_rel_error"] < config.BF16W_RTOL
    # No device time, no MFU and no card on the CPU.
    assert r["cuda_device_us"] is None and r["cudnn_device_us"] is None
    assert r["mfu_cuda"] is None and r["device_name"] is None
    assert r["iterations"] == 1 and r["cuda_mean_us"] > 0 and r["cudnn_chained_us"] > 0
    if mode in (0, 1):
        assert r["max_error_direct"] <= config.PARITY_ATOL
        assert r["max_error_winograd_f43"] <= config.PARITY_ATOL
    if mode == 22:
        assert r["max_error_direct"] <= config.PARITY_ATOL  # the s2d route


@dataclasses.dataclass(frozen=True)
class _TinyR50(config.ResNet50Config):
    stages = ((64, 16, 8, 1), (128, 32, 4, 2))
    img: int = 32
    stem_c: int = 16
    num_classes: int = 24


@dataclasses.dataclass(frozen=True)
class _TinyBasic(config.BasicNetConfig):
    stages = ((16, 8, 1), (32, 4, 2))
    img: int = 32
    stem_c: int = 16
    num_classes: int = 16


@dataclasses.dataclass(frozen=True)
class _TinyBackbone(config.BackboneConfig):
    stages = ((64, 16, 8, 1), (128, 32, 4, 2))


TINY = {"resnet50": _TinyR50("tiny_r50"), "resnet50_b2": _TinyR50("tiny_r50_b2", batch=2),
        "basic": _TinyBasic("tiny_basic"), "backbone_b2": _TinyBackbone("tiny_backbone", batch=2)}


@pytest.mark.parametrize("name", sorted(TINY))
def test_run_case_parity_at_tiny_models(name):
    """The model branches (classifier, basic family, backbone) at every tier:
    f32, int8 and bf16w each within its bar of the golden."""
    config.CASES[990] = TINY[name]
    try:
        r = run_case(990, iterations=2, warmup=1, device="cpu")
    finally:
        del config.CASES[990]
    assert r["parity_ok"]
    assert r["max_error_cuda"] <= config.PARITY_ATOL
    assert r["max_error_cudnn"] <= config.PARITY_ATOL
    assert r["int8_rel_error"] < config.INT8_RTOL_BACKBONE
    assert r["bf16w_rel_error"] < config.BF16W_RTOL_BACKBONE


@pytest.mark.parametrize("name", ["resnet50", "basic", "backbone_b2", "stem"])
def test_pre_route_is_parity_checked_on_the_cpu(name, capsys):
    """The classifiers and the stem (mode 22) also serve the prepared-input
    route, checked against the golden at the f32 bar; on the CPU it has no
    device time. A backbone has no such route."""
    if name == "stem":
        r = run_case(22, iterations=2, warmup=1, device="cpu")
        label = config.CASES[22].name
    else:
        config.CASES[990] = TINY[name]
        try:
            r = run_case(990, iterations=2, warmup=1, device="cpu")
        finally:
            del config.CASES[990]
        label = TINY[name].name
    assert r["parity_ok"] and r["pre_device_us"] is None
    checked = [line for line in capsys.readouterr().err.splitlines() if f"[{label}/pre]" in line]
    assert len(checked) == (0 if name == "backbone_b2" else 1), checked
    assert all("max_error=" in line for line in checked), checked


def _renamed(key: str) -> str:
    return key.replace("pallas", "cuda").replace("xla", "cudnn")


def test_mode2_row_matches_the_jax_cli():
    ours = run_case(2, iterations=2, warmup=1, device="cpu")
    theirs = jax_run_case(2, iterations=2, warmup=1)
    assert set(ours) == {_renamed(k) for k in theirs} | {"device_name", "power_limit_w", "tf32"}
    for key in ("name", "flops", "mode", "iterations", "parity_ok"):
        assert ours[key] == theirs[key], key
    for key in theirs:
        if key.startswith("max_error") and theirs[key] is not None:
            assert abs(ours[_renamed(key)] - theirs[key]) <= 1e-4, key
    for key in ("int8_rel_error", "bf16w_rel_error"):
        assert abs(ours[key] - theirs[key]) <= 1e-4, key


def _corrupt(monkeypatch):
    real = cli.make_case

    def corrupted(mode, seed=0):
        case = real(mode, seed)
        case["golden"] = case["golden"] + 1.0
        return case

    monkeypatch.setattr(cli, "make_case", corrupted)


def test_parity_breach_raises(monkeypatch):
    _corrupt(monkeypatch)
    with pytest.raises(ParityError):
        run_case(2, iterations=2, warmup=1, device="cpu")


def test_parity_breach_makes_the_cli_exit_nonzero(monkeypatch, capsys):
    _corrupt(monkeypatch)
    assert main(["2", "--iterations", "2", "--warmup", "1", "--device", "cpu"]) != 0
    assert "PARITY FAILURE" in capsys.readouterr().err


def test_no_strict_reports_a_breach_without_raising(monkeypatch):
    _corrupt(monkeypatch)
    r = run_case(2, iterations=2, warmup=1, strict=False, device="cpu")
    assert not r["parity_ok"] and r["max_error_cuda"] > 0.5


@dataclasses.dataclass(frozen=True)
class _TinyTrainBackbone(config.TrainConfig):
    stages = ((32, 8, 8, 1), (64, 16, 4, 1))


@dataclasses.dataclass(frozen=True)
class _TinyTrainR50(config.FullTrainConfig):
    stages = ((32, 16, 8, 1), (64, 16, 4, 1))
    img: int = 32
    stem_c: int = 16
    num_classes: int = 16


@dataclasses.dataclass(frozen=True)
class _TinyTrainBasic(config.BasicTrainConfig):
    stages = ((16, 16, 2), (32, 8, 2))
    img: int = 32
    stem_c: int = 16
    num_classes: int = 16


TINY_TRAIN = {17: _TinyTrainBackbone("tiny_backbone_trainstep"),
              19: _TinyTrainR50("tiny_r50_trainstep"),
              25: _TinyTrainBasic("tiny_basic_trainstep")}


@pytest.mark.parametrize("mode", sorted(TINY_TRAIN))
def test_train_modes_on_the_cpu(mode):
    """Modes 17, 19 and 25's branches at a tiny config of the same class: the
    train forwards within the f32 bar of the golden, the bf16w forward
    within its tier's, the step scalar within 1e-3 of the cuDNN autograd
    step's and the bf16w step's within BF16W_TRAIN_GRAD_RTOL; no int8
    column, no device time."""
    config.CASES[990] = TINY_TRAIN[mode]
    try:
        r = run_case(990, iterations=2, warmup=1, device="cpu")
    finally:
        del config.CASES[990]
    assert r["parity_ok"]
    assert r["max_error_cuda"] <= config.PARITY_ATOL and r["max_error_cudnn"] <= config.PARITY_ATOL
    assert r["train_grad_rel_error"] < 1e-3
    assert r["train_bf16w_grad_rel_error"] < config.BF16W_TRAIN_GRAD_RTOL
    assert r["bf16w_rel_error"] < config.BF16W_RTOL_BACKBONE
    assert r["int8_rel_error"] is None and r["int8_device_us"] is None
    assert r["cuda_device_us"] is None and r["cuda_mean_us"] > 0


# Modes 20, 21, 27 and 28 at narrow widths: each mode's own config class,
# depth (conv3_x and conv4_x blocks) and batch, on a 32x32 image.
_NARROW_R50 = ((32, 8, 8, 2), (64, 16, 4, 3), (128, 16, 2, 5), (256, 32, 1, 2))


def _narrow(mode):
    cfg = config.CASES[mode]
    if isinstance(cfg, config.BasicNetConfig):
        stages = tuple((16 * 2 ** i, 8 // 2 ** i, st[-1]) for i, st in enumerate(cfg.stages))
    else:
        stages = tuple((*narrow[:3], st[-1]) for narrow, st in zip(_NARROW_R50, cfg.stages))

    @dataclasses.dataclass(frozen=True)
    class _Narrow(type(cfg)):
        pass

    _Narrow.stages = stages
    return _Narrow(cfg.name, img=32, stem_c=16, num_classes=16)


@pytest.mark.parametrize("mode", [20, 21, 27, 28])
def test_depth_and_batch_modes_run_at_a_narrow_width(monkeypatch, mode):
    """The modes that were refused before the port ran them: run_case at the
    mode's own depth and batch, narrow widths (the CASES entry cut here, not
    in config.py), every path parity_ok; the batch runs whole."""
    narrow = _narrow(mode)
    assert [st[-1] for st in narrow.stages] == [st[-1] for st in config.CASES[mode].stages]
    assert narrow.batch == config.CASES[mode].batch
    monkeypatch.setitem(config.CASES, mode, narrow)
    r = run_case(mode, iterations=2, warmup=1, device="cpu")
    assert r["parity_ok"] and r["mode"] == mode and r["name"] == narrow.name
    assert r["max_error_cuda"] <= config.PARITY_ATOL and r["max_error_cudnn"] <= config.PARITY_ATOL
    assert r["int8_rel_error"] < config.INT8_RTOL_BACKBONE
    assert r["bf16w_rel_error"] < config.BF16W_RTOL_BACKBONE


def test_every_mode_of_the_case_table_is_offered(capsys):
    """No mode of CASES is refused: the parser takes each, and 'all' runs
    them all (here, modes past the last exit through an unknown mode)."""
    with pytest.raises(SystemExit) as exc:
        main([str(max(config.CASES) + 1), "--device", "cpu"])
    assert exc.value.code == 2
    assert str(sorted(config.CASES)) in capsys.readouterr().err


def test_bench_loop_protocol():
    calls = []

    def fn():
        calls.append(1)
        return torch.zeros(8)

    r = bench_loop("x", fn, iterations=10, warmup=2)
    assert r.iterations == 8 and r.warmup == 2
    assert len(r.per_iteration_us) == 10
    assert len(calls) == 10 + 10  # the timed calls, then the chained ones
    assert r.mean_us == pytest.approx(float(np.mean(r.per_iteration_us[2:])))
    assert r.min_us == min(r.per_iteration_us[2:]) and r.device_us is None


def test_bench_graph_gives_no_device_time_on_the_cpu():
    assert bench_graph(lambda x: x + 1, torch.zeros(4)) is None


def test_output_checker_counts_nan_and_reads_a_shifted_window():
    b = np.zeros((2, 2, 3), np.float32)
    a = np.zeros((4, 4, 3), np.float32)
    a[1, 1, 0] = np.nan
    res = output_checker(a, b, length=2, channels=3, shift=1)
    assert res.error_count == 1 and res.total == 12 and not res.ok()
    assert output_checker(b, b).ok()


def test_cli_json_output_and_data_dir(tmp_path):
    """--json on --device cpu, from a --data-dir written by the datagen's
    writer for mode 3, with a --profile trace."""
    generate._write_pointwise_files(str(tmp_path), config.CASES[3], generate.make_case(3, seed=3))
    proc = subprocess.run(
        [sys.executable, "-m", "winograd_tpu_torch.bench", "3", "--iterations", "2",
         "--warmup", "1", "--json", "--device", "cpu", "--data-dir", str(tmp_path),
         "--profile", str(tmp_path / "prof")],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    (row,) = json.loads(proc.stdout)
    assert row["mode"] == 3 and row["parity_ok"] and row["bench_seed"] == 0
    assert row["seconds"] > 0 and row["launches"] == {}  # the plain versions launch nothing
    assert (tmp_path / "prof" / "mode3.json").stat().st_size > 0


def _fake_run_case(ran, fail=()):
    """A stand-in for run_case that records the modes it ran and fails the
    modes in `fail` (KeyboardInterrupt: the sweep is interrupted there)."""
    def fake(mode, *args, **kwargs):
        if mode in fail:
            raise KeyboardInterrupt
        ran.append(mode)
        return {"mode": mode, "name": config.CASES[mode].name, "parity_ok": True,
                "cuda_device_us": None, "cuda_mean_us": 1.0, "cudnn_device_us": None,
                "cudnn_mean_us": 1.0, "max_error_cuda": 0.0}
    return fake


def _rows(path):
    with open(path) as f:
        return {r["mode"]: r for r in json.load(f)}


def test_resume_finishes_an_interrupted_sweep_without_rerunning(monkeypatch, tmp_path):
    """An 'all' sweep interrupted at mode 10 leaves modes 0-9 in the file,
    written after each mode; the restarted sweep runs only the rest."""
    path = str(tmp_path / "sweep.json")
    ran = []
    monkeypatch.setattr(cli, "run_case", _fake_run_case(ran, fail=(10,)))
    with pytest.raises(KeyboardInterrupt):
        main(["all", "--device", "cpu", "--resume", path])
    assert ran == list(range(10)) and sorted(_rows(path)) == ran
    done = list(ran)
    ran.clear()
    monkeypatch.setattr(cli, "run_case", _fake_run_case(ran))
    assert main(["all", "--device", "cpu", "--resume", path]) == 0
    assert ran == [m for m in sorted(config.CASES) if m not in done]
    assert sorted(_rows(path)) == sorted(config.CASES)


def test_resume_reruns_unusable_rows_and_keeps_other_modes(monkeypatch, tmp_path, capsys):
    """A recorded row stands for its mode only with parity_ok, the same
    iterations and the same seed; a narrower call keeps every other mode's
    row; a mode that fails stays missing and fails the sweep."""
    path = tmp_path / "sweep.json"
    base = {"parity_ok": True, "bench_iterations": 100, "bench_seed": 0, "name": "recorded"}
    path.write_text(json.dumps([
        {**base, "mode": 2}, {**base, "mode": 3, "parity_ok": False},
        {**base, "mode": 4, "bench_iterations": 5}, {**base, "mode": 5, "bench_seed": 1},
        {**base, "mode": 9}]))
    ran = []
    monkeypatch.setattr(cli, "run_case", _fake_run_case(ran))
    for mode in (2, 3, 4, 5):
        assert main([str(mode), "--device", "cpu", "--resume", str(path), "--json"]) == 0
        (row,) = json.loads(capsys.readouterr().out)
        assert (row["name"] == "recorded") == (mode == 2), row
    assert ran == [3, 4, 5]
    rows = _rows(path)
    assert sorted(rows) == [2, 3, 4, 5, 9] and rows[9]["name"] == "recorded"
    assert all(rows[m]["bench_iterations"] == 100 and rows[m]["parity_ok"] for m in (3, 4, 5))
    monkeypatch.setattr(cli, "run_case", lambda *a, **k: (_ for _ in ()).throw(
        ParityError("breach")))
    assert main(["6", "--device", "cpu", "--resume", str(path)]) == 1
    assert "SWEEP INCOMPLETE: missing modes [6]" in capsys.readouterr().err
    assert 6 not in _rows(path) and not (tmp_path / "sweep.json.tmp").exists()
