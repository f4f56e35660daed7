#!/usr/bin/env python3
"""What the compiler made of the port's kernels: registers, spills and
shared memory of every kernel instantiation, and the tensor-core
instructions in each library's SASS.

    python3 tools/chip_ptxas.py [NAME,...] [--root DIR]   # default: every csrc/*.cu

Run from the repository root on a machine with nvcc (the CUDA toolkit's
cuobjdump beside it); no card is needed. Each csrc/<NAME>.cu is compiled
with kernels/_build.py's flags plus -Xptxas -v into a scratch library under
build/ptxas/, all at once (--root DIR: DIR's winograd_tpu_torch/csrc, for
example a copy that tools/chip_fp64_tile.py edited, into DIR's build/ptxas/,
so that runs on other roots may go side by side); then one JSON line per kernel entry
({"library", "kernel", "registers", "spill_stores", "spill_loads",
"stack", "smem"}; smem the static shared memory, 0 where a kernel has
none), one per device function compiled apart (__noinline__: {"library",
"function", "spill_stores", "spill_loads", "stack"}, its registers the
kernel's) and one per library counting its SASS instructions by opcode
family ("HGMMA": floating-point wgmma, "IGMMA": integer wgmma, "HMMA",
"IMMA" and "DMMA": mma.sync, "UTMALDG": TMA loads). For the libraries whose
products are wgmma (WGMMA_ONLY: libwinograd_int8, libstage_int8,
libtransition_int8, libbasic_stage_int8, libdirect_int8 and libpointwise_int8
on s8 wgmma, the last two through csrc/wgmma_s8_cluster.cuh; libtransition,
libstage, libbasic_stage, libdirect and libpointwise on 3xTF32 and bf16
wgmma, the last two through csrc/wgmma_cluster.cuh) one more line says
whether the SASS
holds that wgmma and no mma.sync (libpointwise_int8 keeps its one-pass
form's mma.sync: only its wgmma is checked), and for the heads' GEMVs
(BULK: libpointwise and libpointwise_int8, csrc/gemv_cluster.cuh) whether
it holds their bulk copies ("UBLKCP"); the exit code is 1 where it does
not. A kernel line has "gemv": true for the GEMVs' instantiations.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
OPCODES = ("HGMMA", "IGMMA", "HMMA", "IMMA", "DMMA", "UTMALDG", "UBLKCP")
# The libraries whose products must be wgmma: (the wgmma opcode the SASS
# must hold, the mma.sync opcode it must not, or None).
WGMMA_ONLY = {"winograd_int8": ("IGMMA", "IMMA"), "transition": ("HGMMA", "HMMA"),
              "stage": ("HGMMA", "HMMA"), "stage_int8": ("IGMMA", "IMMA"),
              "transition_int8": ("IGMMA", "IMMA"), "pointwise_int8": ("IGMMA", None),
              "basic_stage": ("HGMMA", "HMMA"), "basic_stage_int8": ("IGMMA", "IMMA"),
              "direct": ("HGMMA", "HMMA"), "direct_int8": ("IGMMA", "IMMA"),
              "pointwise": ("HGMMA", "HMMA")}
# The libraries whose GEMVs read their weights by 1D bulk copies.
BULK = ("pointwise", "pointwise_int8")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="?", default="")
    ap.add_argument("--root", type=pathlib.Path, default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from winograd_tpu_torch.kernels import _build

    csrc = args.root.resolve() / "winograd_tpu_torch" / "csrc"
    names = args.names.split(",") if args.names else list(_build.KERNELS)
    nvcc = _build._nvcc()
    out = args.root.resolve() / "build" / "ptxas"
    out.mkdir(parents=True, exist_ok=True)
    links = [f"-L{d}" for d in _build._stub_dirs(nvcc)] + list(_build.LINK_FLAGS)
    procs = {name: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out / f"lib{name}.so"),
         str(csrc / f"{name}.cu"), *links],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name in names}
    ok = True
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc failed for {name}.cu:\n{log}", file=sys.stderr)
            ok = False
            continue
        kernel, props, fn = None, {}, None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                kernel = m.group(1)
                continue
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = m.group(1)
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m and fn:
                props[fn] = tuple(map(int, m.groups()))
                fn = None
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                smem = re.search(r"(\d+) bytes smem", line)
                stack, stores, loads = props.pop(kernel, (0, 0, 0))
                print(json.dumps({"library": name, "kernel": kernel, "gemv": "gemv" in kernel,
                                  "registers": int(m.group(1)), "spill_stores": stores,
                                  "spill_loads": loads, "stack": stack,
                                  "smem": int(smem.group(1)) if smem else 0}), flush=True)
                kernel = None
        for fn, (stack, stores, loads) in props.items():   # functions called, not inlined
            print(json.dumps({"library": name, "function": fn, "spill_stores": stores,
                              "spill_loads": loads, "stack": stack}), flush=True)
        cuobjdump = pathlib.Path(nvcc).with_name("cuobjdump")
        sass = subprocess.run([str(cuobjdump), "-sass", str(out / f"lib{name}.so")],
                              capture_output=True, text=True).stdout
        counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in OPCODES}
        hgmma = sorted({m.group(0) for m in re.finditer(r"[HI]GMMA\.[A-Za-z0-9.]+", sass)})
        print(json.dumps({"library": name, "sass": counts, "hgmma_forms": hgmma}), flush=True)
        if name in WGMMA_ONLY:
            want, not_want = WGMMA_ONLY[name]
            good = counts[want] > 0 and (not_want is None or counts[not_want] == 0)
            ok &= good
            print(json.dumps({"library": name, "wgmma_only": good, want: counts[want],
                              **({not_want: counts[not_want]} if not_want else {})}), flush=True)
        if name in BULK:
            good = counts["UBLKCP"] > 0
            ok &= good
            print(json.dumps({"library": name, "bulk_copies": good, "UBLKCP": counts["UBLKCP"]}),
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
