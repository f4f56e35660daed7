"""Train a ResNet-50 with the PyTorch/CUDA port, checkpoint it, serve it at
every tier.

    python examples/train_and_deploy_torch.py               # the card, full ResNet-50
    python examples/train_and_deploy_torch.py --tiny --device cpu

The twin of examples/train_and_deploy.py for winograd_tpu_torch. Every
train step's forward runs the kernels serving runs (kernels/vjp.py; on the
CPU their plain versions), SGD with momentum updates the trainable set
(raw filters, folded BN) in place (models/train.py); the checkpoint stores
that set (models/checkpoint.py::save_model), and
ResNet50Engine.from_checkpoint derives the serving layouts and serves it at
f32, bf16w and int8. --tiny trains a toy geometry, which runs in seconds on
the CPU.
"""

import argparse
import dataclasses
import os
import sys
import tempfile

# Runnable without installing the package: put the repo root first.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) runs the kernels; cpu their plain versions")
    ap.add_argument("--train-tier", default="f32", choices=("f32", "bf16w"),
                    help="bf16w trains through the bf16w kernels (f32 master weights)")
    args = ap.parse_args(argv)

    import torch

    from winograd_tpu_torch.config import CASES, ResNet50Config
    from winograd_tpu_torch.engine import ResNet50Engine
    from winograd_tpu_torch.kernels import _build
    from winograd_tpu_torch.models.checkpoint import save_model
    from winograd_tpu_torch.models.resnet50 import init_resnet50_arrays
    from winograd_tpu_torch.models.train import (
        make_resnet50_train_step, trainable_resnet50_params,
    )
    from winograd_tpu_torch.utils.tree import tree_map

    if args.tiny:
        @dataclasses.dataclass(frozen=True)
        class _Tiny(ResNet50Config):
            stages = ((32, 16, 8, 1), (64, 16, 4, 1))
            img: int = 32
            stem_c: int = 16
            num_classes: int = 16

        cfg = _Tiny("example_tiny")
    else:
        cfg = CASES[16]  # the real ResNet-50

    device = _build.require_device(args.device)
    params = tree_map(lambda a: torch.as_tensor(a, device=device),
                      trainable_resnet50_params(init_resnet50_arrays(cfg, seed=0)))
    momentum = tree_map(torch.zeros_like, params)
    step = make_resnet50_train_step(lr=1e-2,
                                    precision=None if args.train_tier == "f32" else "bf16w")

    gen = torch.Generator().manual_seed(0)
    images = torch.randn(4, cfg.img, cfg.img, 3, generator=gen).to(device)
    labels = torch.arange(4, device=device) % cfg.num_classes
    for i in range(args.steps):
        params, momentum, loss = step(params, momentum, images, labels)
        print(f"step {i}: loss {loss.item():.4f}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "resnet50.npz")
        save_model(path, params)
        for tier in ("f32", "bf16w", "int8"):
            engine = ResNet50Engine.from_checkpoint(path, tier=tier, device=device)
            print(f"deployed {tier} classes:", engine.classify(images).tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
