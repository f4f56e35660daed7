#!/usr/bin/env python3
"""Variants of the FP64 F(2,3) tile (csrc/winograd.cuh::wino_f64_tile) on one
CUDA card: the MMA's depth (mma_f64.cuh's m16n8k4, m16n8k8, m16n8k16) and
the int8 stage's winograd2 mid inlined or called.

    python3 tools/chip_fp64_tile.py [--variants as_is,k8,k16,noinline] [--only NAME,...]

Run from the repository root on a machine with a CUDA card and nvcc. Each
variant is a copy of this checkout's package under build/fp64_tile/<name>/
with one line of its sources edited ("as_is": none; "k8", "k16": winograd.cuh's
kF64K; "noinline": stage_int8.cu's winograd2_mid __noinline__ where it is
__forceinline__). The variants then run tools/chip_split_sweep.py's A/B turn
(--wrappers, each in a process of its own that builds its copy's kernels)
in turns forward and back (as_is, k8, ..., then ..., k8, as_is), on the
sweep's seeded inputs, at the shapes of the kernels --only keeps (default
winograd_bf16,stage_int8: the int8 tiers' bf16-filter 3x3 at N = 1, 8, 32
and the int8 stage's served shapes). The card's name and power limit come
first, then each variant's registers and spills (tools/chip_ptxas.py
--root on its copy, csrc/winograd.cu and csrc/stage_int8.cu: one JSON line
per kernel and per function compiled apart, with its "variant"), then one
JSON line per shape: each variant's two device ms (20 calls in one CUDA
graph, the median of 20 replays, inputs in L2) and whether every call
equalled its plain twin.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
EDITS = {  # variant: (source, the line as committed, the line in the copy)
    "as_is": None,
    "k8": ("winograd.cuh", "constexpr int kF64K = 4;", "constexpr int kF64K = 8;"),
    "k16": ("winograd.cuh", "constexpr int kF64K = 4;", "constexpr int kF64K = 16;"),
    "noinline": ("stage_int8.cu", "__device__ __forceinline__ void winograd2_mid(",
                 "__device__ __noinline__ void winograd2_mid("),
}


def make_copy(name: str) -> pathlib.Path:
    """build/fp64_tile/<name>/winograd_tpu_torch: the package with the
    variant's edit."""
    root = ROOT / "build" / "fp64_tile" / name
    pkg = root / "winograd_tpu_torch"
    if pkg.exists():
        shutil.rmtree(pkg)
    shutil.copytree(ROOT / "winograd_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    edit = EDITS[name]
    if edit:
        source, old, new = edit
        path = pkg / "csrc" / source
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"chip_fp64_tile: {old!r} is not once in {source}")
        path.write_text(text.replace(old, new))
    return root


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(EDITS))
    ap.add_argument("--only", default="winograd_bf16,stage_int8")
    args = ap.parse_args()
    names = [v for v in args.variants.split(",") if v]
    unknown = set(names) - set(EDITS)
    if unknown:
        raise SystemExit(f"chip_fp64_tile: unknown variants {sorted(unknown)}")
    import torch

    if not torch.cuda.is_available():
        print("chip_fp64_tile: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    roots = {name: make_copy(name) for name in names}
    for name, root in roots.items():
        run = subprocess.run([sys.executable, str(ROOT / "tools" / "chip_ptxas.py"),
                              "winograd,stage_int8", "--root", str(root)],
                             capture_output=True, text=True)
        sys.stderr.write(run.stderr[-4000:])
        for line in run.stdout.splitlines():
            r = json.loads(line)
            if "sass" not in r:
                print(json.dumps({"variant": name, **r}), flush=True)
    sweep = ROOT / "tools" / "chip_split_sweep.py"
    times, good, ok = {}, {}, True
    for turn, name in enumerate(names + names[::-1]):
        run = subprocess.run([sys.executable, str(sweep), "--wrappers", str(roots[name]),
                              "--only", args.only], capture_output=True, text=True)
        sys.stderr.write(run.stderr[-4000:])
        ok &= run.returncode == 0
        for line in run.stdout.splitlines():
            if line.startswith("{"):
                r = json.loads(line)
                key = (r["kernel"], tuple(r["shape"]))
                times.setdefault(key, {}).setdefault(name, []).append(r["ms"])
                good[(key, name)] = good.get((key, name), True) and r["agrees"]
    for (kernel, shape), by in times.items():
        print(json.dumps({"kernel": kernel, "shape": shape, "ms": by,
                          "agrees": {n: good[((kernel, shape), n)] for n in by}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
