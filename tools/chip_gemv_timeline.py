#!/usr/bin/env python3
"""Where a launch of the heads' f32 GEMV (csrc/pointwise.cu on
csrc/gemv_cluster.cuh) spends its time, on one CUDA card.

    python3 tools/chip_gemv_timeline.py [--root DIR]

Run from the repository root on a machine with a CUDA card and nvcc. It
copies DIR's winograd_tpu_torch/csrc (default: this checkout's) to
build/gemv_timeline/src, stamps the copy (thread 0 of every block reads
%globaltimer at the GEMV's phases: its start, the mbarriers made, the
block's barrier after them, its first copies asked for, the first and the
last stage of weights arrived, the walk done, the cluster's blocks all
started, the partial sums pushed, the cluster barrier passed, the end),
builds it with a small C++ driver and runs the R-50 head (P = 1, K = 2048,
N = 1000: 128-column tiles, 16 splits) and the R-34 head (K = 512, 8
splits). For each it prints the card's name and power limit first, then
one JSON line with the launch's device us (20 launches in one CUDA graph,
the median of 20 replays between CUDA events) and the stamped launch's span
(first block's start to last block's end, ns), and one line a phase: its
min, median and max over the blocks, in ns from the first block's start.
Then the floor of a launch: an empty 256-thread kernel on the head's grid
in clusters of 16, of 8, of 1 and with no cluster attribute, the same graph
timing. The stamped launch is one eager launch after the graph's replays
(its weights in L2 from them).
"""

from __future__ import annotations

import argparse
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "gemv_timeline"

PHASES = ("start", "mbar_init", "begin_sync", "issued", "stage0", "last_stage", "walked",
          "cwait", "pushed", "csync", "end")
STAMPS = len(PHASES)

MACRO = f"""
__device__ unsigned long long g_stamps[4096 * {STAMPS}];
__device__ __forceinline__ unsigned long long gtime() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
#define STAMP(i) do {{ if (threadIdx.x == 0) \\
  g_stamps[(blockIdx.y * gridDim.x + blockIdx.x) * {STAMPS} + (i)] = gtime(); }} while (0)
"""

# (file, text after which a stamp goes, phase); each text must occur once.
PATCHES = (
    ("gemv_cluster.cuh", '      asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");\n',
     "mbar_init"),
    ("gemv_cluster.cuh", "    __syncthreads();\n    for (int s = 0; s < kStages && s < stages(); ++s)\n",
     None),
    ("gemv_cluster.cuh", "    if (kVec) slab.wait(s);\n", "last_stage"),
    ("pointwise.cu", "  wt::cluster_arrive_relaxed();  // this block has started "
     "(waited for before the pushes)\n", "start"),
    ("pointwise.cu", "  if (kVec) slab.begin();\n", "issued"),
    ("pointwise.cu", "      [&](int s, int r0, int rows) {\n", "stage0"),
    ("pointwise.cu", "  // The row groups' sums meet in the idle ring, then add in group order.\n",
     "walked"),
    ("pointwise.cu", "  wt::cluster_wait();  // every block of the cluster has started\n", "cwait"),
)

DRIVER = r"""
#include "src/pointwise.cu"
#include <stdio.h>
#include <algorithm>
#include <vector>

extern "C" int read_stamps(unsigned long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(unsigned long long) * n);
}

template <class F>
float graph_us(F launch, cudaStream_t st) {
  cudaGraph_t g;
  cudaGraphExec_t ge;
  cudaStreamBeginCapture(st, cudaStreamCaptureModeGlobal);
  for (int i = 0; i < 20; ++i) launch();
  cudaStreamEndCapture(st, &g);
  cudaGraphInstantiate(&ge, g, 0);
  cudaGraphLaunch(ge, st);
  cudaStreamSynchronize(st);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  std::vector<float> us;
  for (int r = 0; r < 20; ++r) {
    cudaEventRecord(e0, st);
    cudaGraphLaunch(ge, st);
    cudaEventRecord(e1, st);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    us.push_back(ms * 1000.f / 20);
  }
  std::sort(us.begin(), us.end());
  return us[10];
}

__global__ void empty_kernel(int* q) {
  extern __shared__ unsigned char sm[];
  if (q != nullptr && threadIdx.x == 9999) q[0] = sm[0];
}

int main() {
  const int N = 1000, kStamps = STAMPS_N;
  const char* names[] = {PHASE_NAMES};
  cudaStream_t st;
  cudaStreamCreate(&st);
  for (int K : {2048, 512}) {
    const int splits = K == 2048 ? 16 : 8, tile = 128, chunk = K / splits, tiles = 8;
    float *x, *w, *sc, *bi, *out;
    cudaMalloc(&x, K * 4);
    cudaMalloc(&w, (size_t)K * N * 4);
    cudaMalloc(&sc, N * 4);
    cudaMalloc(&bi, N * 4);
    cudaMalloc(&out, N * 4);
    cudaMemset(x, 0, K * 4);
    cudaMemset(w, 0, (size_t)K * N * 4);
    cudaMemset(sc, 0, N * 4);
    cudaMemset(bi, 0, N * 4);
    auto launch = [&] {
      pointwise_conv1x1_bn(x, w, sc, bi, out, 1, K, N, 0, 1, tile, splits, chunk, st);
    };
    const float us = graph_us(launch, st);
    launch();
    cudaStreamSynchronize(st);
    const int blocks = tiles * splits;
    std::vector<unsigned long long> h(blocks * kStamps);
    read_stamps(h.data(), blocks * kStamps);
    unsigned long long t0 = ~0ull, t1 = 0;
    for (int b = 0; b < blocks; ++b) {
      t0 = std::min(t0, h[b * kStamps]);
      t1 = std::max(t1, h[b * kStamps + kStamps - 1]);
    }
    printf("{\"shape\": [1, %d, %d], \"cols\": %d, \"splits\": %d, \"graph_us\": %.3f, "
           "\"span_ns\": %llu, \"error\": \"%s\"}\n",
           K, N, tile, splits, us, t1 - t0, cudaGetErrorString(cudaGetLastError()));
    for (int i = 0; i < kStamps; ++i) {
      std::vector<long long> v;
      for (int b = 0; b < blocks; ++b) v.push_back((long long)(h[b * kStamps + i] - t0));
      std::sort(v.begin(), v.end());
      printf("{\"shape\": [1, %d, %d], \"phase\": \"%s\", \"min_ns\": %lld, \"median_ns\": %lld, "
             "\"max_ns\": %lld}\n", K, N, names[i], v[0], v[v.size() / 2], v.back());
    }
    cudaFree(x); cudaFree(w); cudaFree(sc); cudaFree(bi); cudaFree(out);
  }
  cudaFuncSetAttribute(empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 100000);
  cudaFuncSetAttribute(empty_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  const int cases[][3] = {{8, 16, 16}, {16, 8, 8}, {8, 16, 1}, {8, 16, 0}};
  for (auto& c : cases) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c[0], c[1]);
    cfg.blockDim = dim3(256);
    cfg.dynamicSmemBytes = 70000;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = c[2];
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = c[2] > 0 ? 1 : 0;
    int* q = nullptr;
    const float us = graph_us([&] { cudaLaunchKernelEx(&cfg, empty_kernel, q); }, st);
    printf("{\"empty_grid\": [%d, %d], \"cluster\": %d, \"graph_us\": %.3f, \"error\": \"%s\"}\n",
           c[0], c[1], c[2], us, cudaGetErrorString(cudaGetLastError()));
  }
  return 0;
}
"""


def stamped_copy(root: pathlib.Path) -> None:
    src = OUT / "src"
    if src.exists():
        shutil.rmtree(src)
    shutil.copytree(root / "winograd_tpu_torch" / "csrc", src)
    header = src / "gemv_cluster.cuh"
    text = header.read_text().replace('#include "wgmma_tile.cuh"\n',
                                      '#include "wgmma_tile.cuh"\n' + MACRO, 1)
    header.write_text(text)
    for name, after, phase in PATCHES:
        path = src / name
        text = path.read_text()
        if text.count(after) != 1:
            raise SystemExit(f"chip_gemv_timeline: {name} lacks the anchor {after!r}")
        if phase is None:  # the block's barrier after the mbarriers
            stamp = after.replace("    __syncthreads();\n",
                                  f"    __syncthreads();\n    STAMP({PHASES.index('begin_sync')});\n")
            text = text.replace(after, stamp)
        elif phase == "last_stage":
            text = text.replace(after, after + f"    if (s == stages - 1) STAMP({PHASES.index(phase)});\n")
        elif phase == "stage0":
            text = text.replace(after, after + f"        if (s == 0) STAMP({PHASES.index(phase)});\n")
        else:
            text = text.replace(after, after + f"  STAMP({PHASES.index(phase)});\n")
        path.write_text(text)
    gemv = src / "pointwise.cu"
    text = gemv.read_text()
    push, sync = "    gv::push(recv, i, per, split, sum);\n  }\n", "  wt::cluster_sync();\n"
    end = "    a.out[static_cast<size_t>(p) * a.N + n] = a.relu ? wt::relu(y) : y;\n  }\n}\n"
    for anchor in (push + "  // This block's share", end):
        if text.count(anchor) != 1:
            raise SystemExit("chip_gemv_timeline: pointwise.cu's epilogue changed")
    text = text.replace(push, push + f"  STAMP({PHASES.index('pushed')});\n")
    i = text.index(push)
    j = text.index(sync, i)
    text = text[:j + len(sync)] + f"  STAMP({PHASES.index('csync')});\n" + text[j + len(sync):]
    text = text.replace(end, end[:-2] + f"  STAMP({PHASES.index('end')});\n}}\n")
    gemv.write_text(text)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=pathlib.Path, default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from winograd_tpu_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    stamped_copy(args.root.resolve())
    driver = DRIVER.replace("STAMPS_N", str(STAMPS)).replace(
        "PHASE_NAMES", ", ".join(f'"{p}"' for p in PHASES))
    (OUT / "driver.cu").write_text(driver)
    nvcc = _build._nvcc()
    links = [f"-L{d}" for d in _build._stub_dirs(nvcc)] + list(_build.LINK_FLAGS)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    build = subprocess.run([nvcc, *flags, "-o", str(OUT / "driver"), str(OUT / "driver.cu"),
                            *links], capture_output=True, text=True)
    if build.returncode != 0:
        print(build.stdout + build.stderr, file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    run = subprocess.run([str(OUT / "driver")], capture_output=True, text=True, timeout=300)
    sys.stdout.write(run.stdout)
    sys.stderr.write(run.stderr)
    return run.returncode


if __name__ == "__main__":
    sys.exit(main())
