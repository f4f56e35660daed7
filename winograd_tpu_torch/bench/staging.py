"""How a host request reaches the serving engine's graph: a pageable copy
against a pinned staging buffer.

    python -m winograd_tpu_torch.bench.staging [--reps 10] [--reps8 4]

Needs one CUDA card. Full-width ResNet-50 (seeded weights) at the f32 tier,
served through ResNet50Engine's graphs (engine.py). For N=1 and N=8 numpy
images it times, on the host clock to a synchronize, two ways of serving
the same request:

* "pageable": engine(images), which copies from the numpy array's pageable
  memory into the graph's input buffer (the engine's own route);
* "pinned": the caller copies the images into a pinned buffer reused from
  request to request, sends it to the card without blocking, and the
  engine copies device to device into the graph's input.

Each is run in turns (pageable, pinned, pinned, pageable), `reps` requests
a turn at N=1 and `reps8` at N=8, after one request of each shape that
captures its graph. Prints one JSON line with the medians in ms, the
card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from winograd_tpu_torch.bench.cli import card
from winograd_tpu_torch.config import ResNet50Config
from winograd_tpu_torch.engine import ResNet50Engine
from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.models.resnet50 import init_resnet50_params


def measure(engine: ResNet50Engine, images: np.ndarray, reps: int, reps8: int) -> dict:
    """Median ms of a request from pageable memory and from a reused pinned
    buffer, N=1 and N=8, in turns."""
    out = {}
    for n, turn_reps in ((1, reps), (8, reps8)):
        host = images[:n]
        pinned = torch.empty(host.shape, pin_memory=True)

        def staged():
            pinned.copy_(torch.from_numpy(host))
            return engine(pinned.to(engine.device, non_blocking=True))

        engine(host)
        torch.cuda.synchronize()
        times = {"pageable": [], "pinned": []}
        for turn in ("pageable", "pinned", "pinned", "pageable"):
            for _ in range(turn_reps):
                t0 = time.perf_counter()
                engine(host) if turn == "pageable" else staged()
                torch.cuda.synchronize()
                times[turn].append(time.perf_counter() - t0)
        for kind, ts in times.items():
            out[f"n{n}_{kind}_ms_median"] = 1e3 * statistics.median(ts)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10, help="N=1 requests a turn")
    ap.add_argument("--reps8", type=int, default=4, help="N=8 requests a turn")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("staging: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    _build.build_all()
    cfg = ResNet50Config()
    engine = ResNet50Engine(init_resnet50_params(cfg, seed=0, device=dev), device=dev)
    images = np.random.default_rng(1).standard_normal((8, cfg.img, cfg.img, 3)).astype(np.float32)
    name, power = card(0)
    print(json.dumps({"phase": "staging", "model": "resnet50", "tier": "f32",
                      **measure(engine, images, args.reps, args.reps8), "replays": engine.replays,
                      "device_name": name, "power_limit_w": power}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
