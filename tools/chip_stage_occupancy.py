#!/usr/bin/env python3
"""Stage kernel at one vs two resident blocks per SM, on one CUDA card.

    python3 tools/chip_stage_occupancy.py

Run from the repository root on a machine with a CUDA card and nvcc. Builds
winograd_tpu_torch/csrc/stage.cu twice under build/winograd_tpu_torch/ab/:
with its cooperative grid capped at one 128-thread block per SM ("one")
and as committed, at two ("two"; kMaxBlocksPerSm). Prints each build's
register and spill lines, then for each stage shape of the served
ResNet-50 at N=1 and N=8 (and the conv5_x geometry) the device ms per call
of both builds, timed in turns one, two, two, one (10 calls in one CUDA
graph, the median of 10 replays between CUDA events), after holding each
against the plain twin within 1e-4 * max(1, max|plain|).
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import statistics
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CASES = [  # (N, H=W, Cio, Cmid, blocks)
    (1, 56, 256, 64, 2), (1, 28, 512, 128, 3), (1, 14, 1024, 256, 5),
    (8, 56, 256, 64, 2), (8, 28, 512, 128, 3), (8, 14, 1024, 256, 5),
    (1, 7, 2048, 512, 2),
]
COMMITTED = "constexpr int kMaxBlocksPerSm = 2;"
VARIANTS = {"one": "constexpr int kMaxBlocksPerSm = 1;", "two": COMMITTED}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_stage_occupancy: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    from winograd_tpu_torch.kernels import _build, stage, transforms
    from winograd_tpu_torch.kernels.direct import direct_filter

    libs = {}
    for tag, bounds in VARIANTS.items():
        d = _build.BUILD_DIR / "ab" / tag
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        src = (d / "stage.cu").read_text()
        if COMMITTED not in src:
            raise RuntimeError("stage.cu no longer declares the blocks an SM this tool edits")
        (d / "stage.cu").write_text(src.replace(COMMITTED, bounds))
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                              str(d / "libstage.so"), str(d / "stage.cu")],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(res.stderr)
        print(json.dumps({"build": tag, "ptxas": [
            line.strip() for line in res.stderr.splitlines() if "registers" in line or "spill" in line]}))
        libs[tag] = ctypes.CDLL(str(d / "libstage.so"))
        libs[tag].wt_error_string.restype = ctypes.c_char_p

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def r(*shape):
        return torch.as_tensor((rng.random(shape) - 0.5).astype(np.float32), device=dev)

    def stacked(nb, cio, cmid):
        blocks = []
        for _ in range(nb):
            w = (rng.random((cmid, cmid, 3, 3)) - 0.5).astype(np.float32)
            blocks.append(dict(
                w_reduce=r(cio, cmid), s_reduce=r(cmid), b_reduce=r(cmid),
                u2_mid=torch.as_tensor(transforms.transform_filter(w, m=2), device=dev),
                w9_mid=torch.as_tensor(direct_filter(w), device=dev), s_mid=r(cmid),
                b_mid=r(cmid), w_expand=r(cmid, cio), s_expand=r(cio), b_expand=r(cio)))
        return stage.stack_stage_params(blocks)

    def device_ms(fn, calls=10, reps=10):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / calls)
        return statistics.median(times)

    data = {c: (r(c[0], c[1], c[1], c[2]), stacked(c[4], c[2], c[3])) for c in CASES}
    ms = {}
    for tag in ("one", "two", "two", "one"):
        _build._LIBS["stage"] = libs[tag]
        stage._workspace_floats.cache_clear()
        for case, (x, st) in data.items():
            out, ref = stage.resnet_stage_fused(x, st), stage.resnet_stage_fused_plain(x, st)
            err = (out - ref).abs().max().item()
            if err > 1e-4 * max(1.0, ref.abs().max().item()):
                raise RuntimeError(f"{tag} {case}: max abs err {err}")
            ms.setdefault((tag, case), []).append(
                device_ms(lambda x=x, st=st: stage.resnet_stage_fused(x, st)))
    for case in CASES:
        print(json.dumps({"case": case, "one_ms": ms[("one", case)], "two_ms": ms[("two", case)]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
