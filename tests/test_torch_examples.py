"""The port's examples stay runnable on the CPU:
examples/train_and_deploy_torch.py at --tiny trains (the loss falls over
three SGD steps), checkpoints and serves the trained set at every tier
(about 5 s); examples/serve_torch_checkpoint_torch.py --demo serves tiny
bottleneck and basic ResNets from .pth files and from checkpoint
directories within the tier's bar of the modules' own forwards."""

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


def test_serve_torch_checkpoint_torch_demo_on_the_cpu():
    r = subprocess.run(
        [sys.executable, "examples/serve_torch_checkpoint_torch.py", "--demo", "--device", "cpu",
         "--tier", "bf16w"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    for family in ("bottleneck", "basic"):
        for source in ("pth", "checkpoint_dir"):
            line = next(x for x in r.stdout.splitlines()
                        if x.startswith(f"demo[{family}/{source}]: engine="))
            assert "tier=bf16w device=cpu" in line and line.endswith(" ok"), r.stdout
