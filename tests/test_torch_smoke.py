"""The benchmark CLI's --smoke on the CPU: every kernel family's call runs
through its plain version at the JAX package's smoke geometries, and a
family whose output leaves its bar fails the run, named (run_smoke). On the
card the same call launches the kernels; with no card, --smoke on the
default device raises rather than run on the CPU."""

import pytest
import torch

from winograd_tpu_torch.bench.cli import main
from winograd_tpu_torch.kernels import quantized

FAMILIES = (
    "winograd_f23", "winograd_f43", "winograd_f23_bf16w", "winograd_f23_bf16", "winograd_int8",
    "direct3x3", "direct3x3_bf16w", "direct3x3_int8", "pointwise", "pointwise_bf16w",
    "pointwise_int8", "block", "stage", "stage_bf16w", "stage_int8", "stage_winograd2_28",
    "transition", "transition_bf16w", "transition_int8", "basic_stage", "basic_stage_bf16w",
    "basic_stage_int8", "stem", "stem_pre", "stem_bf16w", "stem_pre_bf16w", "stem_int8", "head",
    "block_train_vjp", "transition_train_vjp",
)


def test_smoke_runs_every_family_and_names_the_one_that_fails(monkeypatch, capsys):
    """One family's wrapper is made to return its result off by 1e-3 (finite,
    past the int8 families' bar of equality): the run exits 1 and names it,
    and every other family ran within its bar."""
    real = quantized.conv1x1_bn_int8
    monkeypatch.setattr(quantized, "conv1x1_bn_int8", lambda *a, **k: real(*a, **k) + 1e-3)
    assert main(["--smoke", "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    lines = {line.split("]")[1].split(":")[0].strip(): line
             for line in err.splitlines() if line.strip().startswith("[smoke]")}
    assert sorted(lines) == sorted(FAMILIES)
    assert "FAIL" in lines["pointwise_int8"]
    assert all(" ok " in line for name, line in lines.items() if name != "pointwise_int8"), err
    assert "SMOKE FAILURES: ['pointwise_int8']" in err


def test_smoke_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--smoke"])
