"""The port stands alone: importing every module of winograd_tpu_torch loads
neither jax nor winograd_tpu, chip_smoke.py has no import statement of
either, and the port's entry points refuse to run on the CPU unless the
caller asks for it."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pathlib, sys
pkg = pathlib.Path("winograd_tpu_torch")
names = sorted(
    ".".join(p.with_suffix("").parts).removesuffix(".__init__")
    for p in pkg.rglob("*.py")
)
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "winograd_tpu"))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_jax_package():
    res = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    count, bad = res.stdout.split(" ", 1)
    assert int(count) >= 15, res.stdout
    assert bad.strip() == "[]", res.stdout


def test_chip_smoke_imports_no_jax_and_no_jax_package():
    """chip_smoke.py imports inside main(), so importing it proves nothing:
    every import statement of its source is checked instead."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    modules = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            modules += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "chip_smoke.py runs from the repository root"
            modules.append(node.module)
    tops = {m.split(".")[0] for m in modules}
    assert "winograd_tpu_torch" in tops and "torch" in tops, modules
    assert not tops & {"jax", "jaxlib", "winograd_tpu"}, modules


def test_entry_points_refuse_cpu_unless_asked():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device is valid")
    from winograd_tpu_torch.engine import ResNet50Engine
    from winograd_tpu_torch.models.resnet50 import init_resnet50_params, resnet50_forward
    from winograd_tpu_torch.config import ResNet50Config

    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_resnet50_params(ResNet50Config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResNet50Engine({})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet50_forward(torch.zeros(32, 32, 3), {"head": {"w_fc": torch.zeros(1, 1)}})


def test_kernel_wrappers_reject_non_cpu_non_cuda_tensors():
    import torch

    from winograd_tpu_torch.kernels.pointwise import conv1x1_bn

    x = torch.zeros(4, 8, device="meta")
    w = torch.zeros(8, 8, device="meta")
    s = torch.zeros(8, device="meta")
    with pytest.raises(ValueError):
        conv1x1_bn(x, w, s, s, relu=True)
