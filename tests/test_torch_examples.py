"""examples/train_and_deploy_torch.py stays runnable: at --tiny on the CPU it
trains (the loss falls over three SGD steps), checkpoints and serves the
trained set at every tier (about 5 s)."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_train_and_deploy_torch_tiny_on_the_cpu():
    r = subprocess.run(
        [sys.executable, "examples/train_and_deploy_torch.py", "--tiny", "--steps", "3",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    losses = [float(v) for v in re.findall(r"step \d+: loss ([0-9.]+)", r.stdout)]
    assert len(losses) == 3 and losses[-1] < losses[0], r.stdout
    for tier in ("f32", "bf16w", "int8"):
        assert f"deployed {tier} classes" in r.stdout, r.stdout
