#!/usr/bin/env python3
"""Where the int8 stage kernel's time goes, phase by phase, on one CUDA card.

    python3 tools/chip_stage_timeline.py [--root DIR]

Run from the repository root on a machine with a CUDA card and nvcc. It
builds a copy of DIR's winograd_tpu_torch/csrc/stage_int8.cu (default: this
checkout's; DIR may be an unpacked `git archive` of another commit under
build/) in which thread 0 of block 0 reads %globaltimer once before the
first block's phases and again after every grid barrier of the kernel body
(the K-split barriers inside a GEMM phase are not stamped), and calls DIR's
resnet_stage_int8 wrapper on that library at the served shapes. Each line
gives the kernel's stamped span and the spans between stamps in
microseconds: a phase's span is its slowest block's work plus the barrier.
First, the grid barrier alone (grid_sync.cuh, 256 threads a block): its
cost per crossing at one and two blocks an SM. The card's name and power
limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
SHAPES = [  # (N, H, W, Cio, Cmid, blocks, mid): the served stages, and conv4_x at N=8
    (1, 56, 56, 256, 64, 2, "winograd2"), (1, 28, 28, 512, 128, 3, "winograd2"),
    (1, 14, 14, 1024, 256, 5, "direct"), (1, 7, 7, 2048, 512, 2, "direct"),
    (8, 14, 14, 1024, 256, 5, "direct"),
]
STAMP = ("{ if (blockIdx.x == 0 && threadIdx.x == 0) { unsigned long long t; "
         "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); "
         "if (g_stamps < 1024) g_stamp[g_stamps++] = t; } }")
BARRIER_BENCH = r'''
#include "common.cuh"
#include "grid_sync.cuh"
__global__ void __launch_bounds__(256) barrier_kernel(unsigned int* bar, int iters) {
  for (int i = 0; i < iters; ++i) wt::grid_sync(bar);
}
extern "C" int barrier_bench(unsigned int* bar, int blocks, int iters, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&bar, &iters};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(barrier_kernel), dim3(blocks), dim3(256), args, 0, s));
}
'''
READ_STAMPS = r'''
extern "C" int read_stamps(unsigned long long* host, int* n) {
  cudaError_t e = cudaMemcpyFromSymbol(n, g_stamps, sizeof(int));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(host, g_stamp, sizeof(unsigned long long) * 1024);
  const int zero = 0;
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_stamps, &zero, sizeof(int));
  return static_cast<int>(e);
}
'''


def stamped_source(src: str) -> str:
    """stage_int8.cu with a stamp before the blocks' loop and after every
    grid barrier of the kernel body, and a C entry that reads the stamps."""
    include = '#include "winograd.cuh"\n'
    loop = "  for (int blk = 0; blk < a.B; ++blk) {\n    const float* act"
    if include not in src or loop not in src:
        raise SystemExit("stage_int8.cu does not have the layout this tool stamps")
    src = src.replace("wt::grid_sync(a.bar);", "{ wt::grid_sync(a.bar); STAMP }")
    src = src.replace(include, include + "__device__ unsigned long long g_stamp[1024];\n"
                      "__device__ int g_stamps;\n#define STAMP " + STAMP + "\n", 1)
    return src.replace(loop, "  STAMP\n" + loop, 1) + READ_STAMPS


def build(root: pathlib.Path, out: pathlib.Path):
    """The barrier benchmark and the stamped stage library, built together."""
    from winograd_tpu_torch.kernels import _build

    csrc = root / "winograd_tpu_torch" / "csrc"
    out.mkdir(parents=True, exist_ok=True)
    (out / "barrier.cu").write_text(BARRIER_BENCH)
    (out / "stage_stamped.cu").write_text(stamped_source((csrc / "stage_int8.cu").read_text()))
    procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
                               str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name in ("barrier", "stage_stamped")]
    for proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed:\n{log}")
    libs = [ctypes.CDLL(str(out / f"lib{name}.so")) for name in ("barrier", "stage_stamped")]
    for lib in libs:
        for fn in ("barrier_bench", "read_stamps"):
            if hasattr(lib, fn):
                getattr(lib, fn).restype = ctypes.c_int
    libs[1].wt_error_string.restype = ctypes.c_char_p
    return libs


def barrier_us(lib, dev, blocks: int) -> float:
    import torch

    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    ms = []
    for iters in (1, 101):
        for _ in range(3):  # the last of three
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            err = lib.barrier_bench(ctypes.c_void_p(bar.data_ptr()), blocks, iters, stream)
            b.record()
            torch.cuda.synchronize()
            if err:
                raise SystemExit(f"barrier_bench: CUDA error {err}")
        ms.append(a.elapsed_time(b))
    return 1e3 * (ms[1] - ms[0]) / 100


def stage_case(rng, dev, n, h, w, cio, cmid, nb):
    """Seeded quantized stage params and a ReLU'd input."""
    import torch

    from winograd_tpu_torch.kernels import quantized as q8
    from winograd_tpu_torch.kernels import transforms
    from winograd_tpu_torch.kernels.direct import direct_filter

    def rand(*shape):
        return (rng.random(shape) - 0.5).astype(np.float32)

    blocks = []
    for _ in range(nb):
        wm = rand(cmid, cmid, 3, 3)
        blocks.append(dict(
            w_reduce=rand(cio, cmid), s_reduce=rand(cmid) + 0.5, b_reduce=rand(cmid),
            u2_mid=transforms.transform_filter(wm, m=2), w9_mid=direct_filter(wm),
            s_mid=rand(cmid) + 0.5, b_mid=rand(cmid), w_expand=rand(cmid, cio),
            s_expand=rand(cio) + 0.5, b_expand=rand(cio)))
    qs = {k: v.to(dev) for k, v in q8.quantize_stage_params(blocks).items()}
    return torch.as_tensor(np.abs(rand(n, h, w, cio)), device=dev), qs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=pathlib.Path, default=ROOT,
                    help="the checkout whose kernel and wrapper are timed")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("chip_stage_timeline: needs a CUDA device", file=sys.stderr)
        return 1
    from winograd_tpu_torch.kernels import _build
    from winograd_tpu_torch.kernels import quantized as q8

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    bench, stage = build(root, ROOT / "build" / "stage_timeline" / root.name)
    sms = _build.sm_count(dev)
    for per_sm in (1, 2):
        print(json.dumps({"barrier_us": barrier_us(bench, dev, per_sm * sms),
                          "blocks": per_sm * sms}), flush=True)
    _build._LIBS["stage_int8"] = stage  # the wrapper launches the stamped library
    q8._workspace_words.cache_clear()
    rng = np.random.default_rng(0)
    stamps, count = (ctypes.c_ulonglong * 1024)(), ctypes.c_int(0)
    ok = True
    for n, h, w, cio, cmid, nb, mid in SHAPES:
        x, qs = stage_case(rng, dev, n, h, w, cio, cmid, nb)
        ref = q8.resnet_stage_int8_plain(x, qs, mid)
        for _ in range(3):  # the last of three calls
            torch.cuda.synchronize()
            if stage.read_stamps(stamps, ctypes.byref(count)):
                raise SystemExit("read_stamps failed")
            y = q8.resnet_stage_int8(x, qs, mid)
            torch.cuda.synchronize()
            if stage.read_stamps(stamps, ctypes.byref(count)):
                raise SystemExit("read_stamps failed")
        ok &= bool(torch.equal(y, ref))
        ts = [stamps[i] for i in range(count.value)]
        print(json.dumps({"shape": [n, h, w, cio, cmid, nb, mid], "root": str(root),
                          "stamped_us": (ts[-1] - ts[0]) / 1e3,
                          "spans_us": [round((b - a) / 1e3, 2) for a, b in zip(ts, ts[1:])],
                          "equal_to_twin": bool(torch.equal(y, ref))}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
