"""Serve a torchvision-format ResNet checkpoint with the PyTorch/CUDA port.

    python examples/serve_torch_checkpoint_torch.py resnet50.pth --tier bf16w
    python examples/serve_torch_checkpoint_torch.py --demo               # the card
    python examples/serve_torch_checkpoint_torch.py --demo --device cpu  # plain versions

The twin of examples/serve_torch_checkpoint.py for winograd_tpu_torch. Any
torchvision ResNet state_dict works, bottleneck (50/101/152) or basic
(18/34): engine_from_torch infers the block family and depth, folds BN and
derives every kernel layout once at load, and serves at --tier f32, bf16w
or int8. --demo builds tiny random bottleneck and basic ResNets in torch,
round-trips each through a .pth file and through a checkpoint directory of
its trainable set (models/checkpoint.py::save_checkpoint_dir, served by
from_checkpoint), and holds both engines' logits to the module's own
forward at the tier's bar (f32 1e-4, bf16w 5e-3, int8 5e-2, each times
max(1, max|ref|)); it exits 1 if either misses it.
"""

import argparse
import os
import sys
import tempfile

# Runnable without installing the package: put the repo root first.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BARS = {"f32": 1e-4, "bf16w": 5e-3, "int8": 5e-2}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint", nargs="?", help=".pt/.pth state_dict file")
    ap.add_argument("--tier", default="f32", choices=sorted(BARS))
    ap.add_argument("--demo", action="store_true",
                    help="self-contained demo with tiny random models")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) runs the kernels; cpu their plain versions")
    args = ap.parse_args(argv)

    import torch

    from winograd_tpu_torch.engine import (
        ResNet50Engine, ResNetBasicEngine, engine_from_torch,
    )
    from winograd_tpu_torch.kernels import _build
    from winograd_tpu_torch.models.checkpoint import save_checkpoint_dir
    from winograd_tpu_torch.models.import_torch import (
        basicnet_train_params_from_torch, build_torch_reference_resnet,
        resnet_train_params_from_torch,
    )

    device = _build.require_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not args.demo:
        if not args.checkpoint:
            ap.error("give a checkpoint path or --demo")
        engine = engine_from_torch(args.checkpoint, tier=args.tier, device=device)
        x = torch.zeros(1, 224, 224, 3)
        print(f"{type(engine).__name__} tier={args.tier} classes:",
              engine.classify(x).tolist())
        return 0

    demos = {
        "bottleneck": (build_torch_reference_resnet((2, 2, 2, 2), seed=0),
                       ResNet50Engine, resnet_train_params_from_torch),
        "basic": (build_torch_reference_resnet((2, 2), stem_c=16, planes=(16, 32), classes=16,
                                               seed=1, block="basic"),
                  ResNetBasicEngine, basicnet_train_params_from_torch),
    }
    gen = torch.Generator().manual_seed(0)
    failed = False
    with tempfile.TemporaryDirectory() as tmp:
        for family, (model, engine_cls, trainable) in demos.items():
            sd = model.state_dict()
            pth = os.path.join(tmp, f"{family}.pth")
            torch.save(sd, pth)
            ckpt = os.path.join(tmp, f"{family}_ckpt")
            save_checkpoint_dir(ckpt, trainable(sd))
            x = torch.randn(2, 64, 64, 3, generator=gen)
            with torch.no_grad():
                ref = model.to(device)(x.to(device).permute(0, 3, 1, 2)).double()
            bar = BARS[args.tier] * max(1.0, ref.abs().max().item())
            for source, engine in (
                    ("pth", engine_from_torch(pth, tier=args.tier, device=device)),
                    ("checkpoint_dir", engine_cls.from_checkpoint(ckpt, tier=args.tier,
                                                                  device=device))):
                err = (engine(x).double() - ref).abs().max().item()
                ok = err <= bar
                failed |= not ok
                print(f"demo[{family}/{source}]: engine={type(engine).__name__} "
                      f"tier={args.tier} device={device.type} max abs err vs torch {err:.2e} "
                      f"(bar {bar:.2e}) {'ok' if ok else 'FAIL'}")
                print(f"demo[{family}/{source}]: classes = {engine.classify(x).tolist()}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
