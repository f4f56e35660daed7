"""torchvision-format ResNet checkpoints into the port, on the CPU.

build_torch_reference_resnet builds a module with torchvision's names
(torchvision itself is not installed) and seeded weights and BatchNorm
statistics; its eval forward, torch's own CPU convolutions, is the
independent reference. Held:

* the trainable parameters the port imports equal the JAX package's leaf
  by leaf (the same numpy arithmetic, to the bit), bottleneck and basic;
* from_torch logits within 1e-4 * max(1, max|ref|) of the module's eval
  forward, bf16w within BF16W_RTOL_BACKBONE and int8 within
  INT8_RTOL_BACKBONE of it, for ResNet50Engine and ResNetBasicEngine;
* the .pth round trip through torch.save, DataParallel's "module." prefix
  and the {"state_dict": ...} wrapping included;
* engine_from_torch picks the family's engine, and resnet_family and the
  importers refuse what is not a torchvision ResNet.
"""

import jax
import numpy as np
import pytest
import torch

from winograd_tpu.models import import_torch as jit_
from winograd_tpu_torch.config import BF16W_RTOL_BACKBONE, INT8_RTOL_BACKBONE, PARITY_ATOL
from winograd_tpu_torch.engine import ResNet50Engine, ResNetBasicEngine, engine_from_torch
from winograd_tpu_torch.models import import_torch as tit

MODELS = {
    "bottleneck": dict(layers=(2, 2, 2, 2)),
    "basic": dict(layers=(2, 2, 1, 1), stem_c=8, planes=(8, 16, 16, 32), block="basic"),
}
ENGINES = {"bottleneck": ResNet50Engine, "basic": ResNetBasicEngine}


def _model(family, seed):
    return tit.build_torch_reference_resnet(seed=seed, **MODELS[family])


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape and np.isfinite(out).all()
    return np.abs(out - ref).max() / max(1.0, np.abs(ref).max())


def _forward(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()


def _images(seed, n, img=64):
    return np.random.default_rng(seed).standard_normal((n, img, img, 3)).astype(np.float32)


@pytest.mark.parametrize("family", sorted(MODELS))
def test_train_params_equal_jax(family):
    sd = _model(family, seed=1).state_dict()
    convert = {"bottleneck": "resnet_train_params_from_torch",
               "basic": "basicnet_train_params_from_torch"}[family]
    ours = dict(_leaves(getattr(tit, convert)(sd)))
    theirs = dict(_leaves(jax.tree.map(np.asarray, getattr(jit_, convert)(sd))))
    assert sorted(ours) == sorted(theirs)
    for k, v in ours.items():
        if v is None:
            assert theirs[k] is None, k
            continue
        assert v.dtype == theirs[k].dtype and v.shape == theirs[k].shape, k
        np.testing.assert_array_equal(v, theirs[k], err_msg=k)


@pytest.mark.parametrize("family", sorted(MODELS))
def test_from_torch_matches_the_module_at_every_tier(family):
    model = _model(family, seed=3)
    x = _images(4, 2)
    ref = _forward(model, x)
    sd = model.state_dict()
    engine = ENGINES[family].from_torch(sd, device="cpu")
    assert _rel(engine(x), ref) <= PARITY_ATOL
    assert engine.classify(x[0]).shape == ()
    assert _rel(ENGINES[family].from_torch(sd, tier="bf16w", device="cpu")(x), ref) \
        < BF16W_RTOL_BACKBONE
    assert _rel(ENGINES[family].from_torch(sd, tier="int8", device="cpu")(x), ref) \
        < INT8_RTOL_BACKBONE


@pytest.mark.parametrize("family", sorted(MODELS))
def test_pth_round_trip_and_engine_from_torch(family, tmp_path):
    model = _model(family, seed=2)
    wrapped = {"state_dict": {f"module.{k}": v for k, v in model.state_dict().items()}}
    path = tmp_path / "ckpt.pth"
    torch.save(wrapped, path)
    assert sorted(tit.load_torch_checkpoint(str(path))) == sorted(model.state_dict())
    x = _images(5, 1)
    engine = engine_from_torch(path, device="cpu")
    assert type(engine) is ENGINES[family]
    assert tit.resnet_family(model.state_dict()) == family
    assert _rel(engine(x), _forward(model, x)) <= PARITY_ATOL
    assert torch.equal(engine(x), ENGINES[family].from_torch(str(path), device="cpu")(x))


def test_non_resnet_state_dicts_are_refused():
    with pytest.raises(ValueError, match="not a torchvision-format ResNet"):
        tit.resnet_family({"features.0.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="not a torchvision-format ResNet"):
        engine_from_torch({"fc.weight": torch.zeros(2, 2)}, device="cpu")
    with pytest.raises(ValueError, match="BasicBlock"):
        tit.resnet_train_params_from_torch(_model("basic", seed=0).state_dict())
    with pytest.raises(ValueError, match="Bottleneck"):
        tit.basicnet_train_params_from_torch(_model("bottleneck", seed=0).state_dict())
