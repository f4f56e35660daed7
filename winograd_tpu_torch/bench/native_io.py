"""The native host library (utils/native.py) against numpy on the benchmark
CLI's data files.

    python -m winograd_tpu_torch.bench.native_io [--data-dir DIR] [--reps N]

DIR is a python -m winograd_tpu_torch.datagen directory; without one the
datagen writes its files into a temporary directory under build/ first.
Prints one JSON line: the library's path and, for each operation, the
median seconds of the native path and of numpy over N turns. Host code
only: no device is used.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import sys
import tempfile
import time

import numpy as np

from winograd_tpu_torch.utils import checker, io, native


def bench(data_dir: str, reps: int = 5) -> dict:
    """Median seconds of the native path and of numpy, over `reps` turns, on
    every .bin blob of data_dir: reading them all (get_parameters, the
    threaded reader), each read alone (get_parameter), transposing each as
    (first dim, rest) and the shift-1 checker on each winograd golden
    against itself padded by one."""
    if native.load() is None:
        raise RuntimeError("the native host library could not be built (g++ missing?)")
    blobs = sorted(pathlib.Path(data_dir).glob("*.bin"))
    spec = {str(p): p.stat().st_size // 4 for p in blobs}
    if not spec:
        raise FileNotFoundError(f"no .bin blobs in {data_dir}")

    def timed(fn):
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    arrays = io.get_parameters(spec)
    for path, a in io.get_parameters_numpy(spec).items():
        if not np.array_equal(a, arrays[path]):
            raise AssertionError(f"{path}: native and numpy reads differ")
    goldens = []
    for path, a in arrays.items():
        name = os.path.basename(path)
        if name.startswith("golden_winograd_"):
            co = int(name.removesuffix(".bin").split("_")[-1])
            hw = int(round((a.size // co) ** 0.5))
            b = a.reshape(hw, hw, co)
            goldens.append((np.pad(b, ((1, 1), (1, 1), (0, 0))), b, hw, co))
    mats = [(a, a.size // 64, 64) for a in arrays.values() if a.size % 64 == 0]
    row = {"files": len(spec), "mib": sum(spec.values()) * 4 / 2**20, "reps": reps}
    for name, native_fn, numpy_fn in (
        ("read_many", lambda: io.get_parameters(spec), lambda: io.get_parameters_numpy(spec)),
        ("read_each", lambda: [io.get_parameter(p, n) for p, n in spec.items()],
         lambda: [io.get_parameter_numpy(p, n) for p, n in spec.items()]),
        ("transpose", lambda: [io.transpose(a, h, w) for a, h, w in mats],
         lambda: [io.transpose_numpy(a, h, w) for a, h, w in mats]),
        ("checker", lambda: [checker.output_checker(a, b, hw, co, shift=1)
                             for a, b, hw, co in goldens],
         lambda: [checker.output_checker_numpy(a, b, hw, co, shift=1)
                  for a, b, hw, co in goldens]),
    ):
        row[f"{name}_native_s"] = timed(native_fn)
        row[f"{name}_numpy_s"] = timed(numpy_fn)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="time the native host library against numpy")
    ap.add_argument("--data-dir", default=None,
                    help="a python -m winograd_tpu_torch.datagen directory (default: one "
                         "generated under build/)")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if args.data_dir is not None:
        row = bench(args.data_dir, args.reps)
    else:
        from winograd_tpu_torch.datagen.generate import generate_all

        native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=native.BUILD_DIR) as tmp:
            generate_all(tmp, seed=0)
            row = bench(tmp, args.reps)
    print(json.dumps({"library": str(native.library_path()), **row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
