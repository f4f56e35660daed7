"""The port stands alone: importing every module of winograd_tpu_torch loads
neither jax nor winograd_tpu (parallel/ and the parallel tests' rank
functions included), chip_smoke.py and the port's examples have no
import statement of either, and the port's entry points refuse to run on
the CPU unless the caller asks for it."""

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


_PARALLEL_PROBE = """
import importlib, sys
sys.path.insert(0, "tests")
for name in ("winograd_tpu_torch.parallel", "winograd_tpu_torch.parallel.mesh",
             "winograd_tpu_torch.parallel.data_parallel",
             "winograd_tpu_torch.parallel.tensor_parallel",
             "winograd_tpu_torch.parallel.pipeline", "torch_parallel_ranks"):
    importlib.import_module(name)
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "winograd_tpu")))
"""


def test_parallel_package_and_its_test_ranks_import_no_jax():
    """parallel/ (the ranks of a world import it) and the rank functions of
    the parallel tests, which spawned ranks import by name, load neither
    jax nor winograd_tpu."""
    res = subprocess.run(
        [sys.executable, "-c", _PARALLEL_PROBE], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout


def _imported_modules(script):
    """Every module an import statement of `script` names."""
    tree = ast.parse((ROOT / script).read_text())
    modules = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            modules += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{script} runs from the repository root"
            modules.append(node.module)
    return modules


def test_chip_smoke_imports_no_jax_and_no_jax_package():
    """chip_smoke.py imports inside main(), so importing it proves nothing:
    every import statement of its source is checked instead."""
    modules = _imported_modules("chip_smoke.py")
    tops = {m.split(".")[0] for m in modules}
    assert "winograd_tpu_torch" in tops and "torch" in tops, modules
    assert not tops & {"jax", "jaxlib", "winograd_tpu"}, modules


@pytest.mark.parametrize("script", ["examples/train_and_deploy_torch.py",
                                    "examples/serve_torch_checkpoint_torch.py"])
def test_examples_import_no_jax_and_no_jax_package(script):
    modules = _imported_modules(script)
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
    from winograd_tpu_torch.bench.cli import main, run_case

    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_case(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["0"])
    from winograd_tpu_torch.engine import (
        BackboneEngine, BottleneckEngine, ResNetBasicEngine, engine_from_torch,
    )
    from winograd_tpu_torch.models.basic import basicnet_forward_pre
    from winograd_tpu_torch.models.checkpoint import load_checkpoint_dir
    from winograd_tpu_torch.models.resnet50 import resnet50_forward_pre

    # Every constructor refuses before it reads its file or builds anything.
    refused = [
        lambda: BottleneckEngine([]), lambda: BackboneEngine([]),
        lambda: BottleneckEngine.from_checkpoint("missing.npz"),
        lambda: resnet50_forward_pre(torch.zeros(1, 38, 38, 4), {}),
        lambda: basicnet_forward_pre(torch.zeros(1, 38, 38, 4), {}),
        lambda: engine_from_torch("missing.pth"),
        lambda: load_checkpoint_dir("missing"),
        lambda: main(["--smoke"]),
    ]
    for cls in (ResNet50Engine, ResNetBasicEngine):
        refused += [lambda cls=cls: cls.from_case({}, None),
                    lambda cls=cls: cls.from_checkpoint("missing.npz"),
                    lambda cls=cls: cls.from_torch("missing.pth"),
                    lambda cls=cls: cls.from_torch({})]
    for call in refused:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_kernel_wrappers_reject_non_cpu_non_cuda_tensors():
    import torch

    from winograd_tpu_torch.kernels.pointwise import conv1x1_bn

    x = torch.zeros(4, 8, device="meta")
    w = torch.zeros(8, 8, device="meta")
    s = torch.zeros(8, device="meta")
    with pytest.raises(ValueError):
        conv1x1_bn(x, w, s, s, relu=True)
