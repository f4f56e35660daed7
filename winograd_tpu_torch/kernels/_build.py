"""Build, load and launch the CUDA kernels in csrc/.

Each csrc/<name>.cu is compiled on first use by nvcc for sm_90a into its own
shared library with a plain C interface, under build/winograd_tpu_torch/ at
the repository root, named by a hash of the csrc sources and the flags (so
an edited source rebuilds and an unchanged one loads at once). The library
is loaded with ctypes. Pointers and the stream go over as c_void_p, counts
as c_int. Every C entry returns cudaGetLastError() after its launch, and
launch() raises if that is not cudaSuccess.

There is no fallback: without nvcc, or when the build fails, this raises
with the compiler's output.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import inspect
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Dict

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "winograd_tpu_torch"
KERNELS = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# Launches per kernel, counted by launch() once the kernel was accepted, and
# per kernel the launches of each argument shape its wrapper reports. A
# kernel's bf16w instantiation counts under its own name ("<kernel>_bf16w").
LAUNCHES: collections.Counter = collections.Counter()
LAUNCH_SHAPES: Dict[str, collections.Counter] = collections.defaultdict(collections.Counter)

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(nvcc, os.X_OK):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of winograd_tpu_torch are built "
            "from csrc/ on first use and need the CUDA toolkit"
        )
    return nvcc


def _library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for csrc/<name>.cu; returns (process, temp path, final path)
    or None when the library is already built."""
    out = _library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish_build(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> float:
    """Compile every kernel library not yet built, one nvcc per source, all
    started together. Returns the wall seconds taken."""
    t0 = time.perf_counter()
    started = {name: _start_build(name) for name in KERNELS}
    for name, s in started.items():
        if s is not None:
            _finish_build(name, s)
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        started = _start_build(name)
        if started is not None:
            _finish_build(name, started)
        lib = ctypes.CDLL(str(_library_path(name)))
        lib.wt_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


# The element types a kernel operand may have: float32 activations, BN and
# scales; int8 quantized weights; bfloat16 filters (the int8 tier's F(2,3)
# mid-layer) and weights (the bf16w tier).
OPERAND_DTYPES = (torch.float32, torch.int8, torch.bfloat16)


def check_tensors(*tensors: torch.Tensor, dtype: torch.dtype = torch.float32,
                  device=None) -> None:
    """Every operand is a contiguous `dtype` tensor (one of OPERAND_DTYPES)
    on one CUDA device (`device` when given, else the first tensor's)."""
    if dtype not in OPERAND_DTYPES:
        raise TypeError(f"{dtype} is not a kernel operand type {OPERAND_DTYPES}")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"kernel operands must be {dtype}, got {t.dtype}")
    dev = tensors[0].device if device is None else torch.device(device)
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"kernel operands must share one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def check_operands(scale: torch.Tensor, bias: torch.Tensor, cout: int,
                   *tensors: torch.Tensor) -> None:
    """check_tensors, and the folded BN is one (scale, bias) pair per output
    channel."""
    if scale.shape != (cout,) or bias.shape != (cout,):
        raise ValueError(
            f"scale {tuple(scale.shape)} and bias {tuple(bias.shape)} must be ({cout},)")
    check_tensors(scale, bias, *tensors)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def cint(v) -> ctypes.c_int:
    return ctypes.c_int(int(v))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (the K-split plans aim at
    one or two work items per SM)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _sm_count(index)


def reset_counts() -> None:
    LAUNCHES.clear()
    LAUNCH_SHAPES.clear()


def check_error(lib: ctypes.CDLL, what: str, err: int) -> None:
    """Raise if a C entry of `lib` returned a CUDA error code."""
    if err != 0:
        msg = lib.wt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def launch(name: str, entry: str, shape: tuple, device: torch.device, *args,
           counter: str | None = None) -> None:
    """Call the C entry `entry` of library `name` with `device` current, on
    its current stream; raise if the launch was refused, else count it under
    `counter` (default `name`) and its argument `shape`."""
    lib = library(name)
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        err = getattr(lib, entry)(*args, stream)
    check_error(lib, f"{name}.{entry}", err)
    counter = counter or name
    LAUNCHES[counter] += 1
    LAUNCH_SHAPES[counter][shape] += 1


# Set by utils/debug.py::nan_checks: while true, every public kernel wrapper
# checks its output for non-finite values after the call (checked below).
NAN_CHECKS = False


def _bf16w_call(fn, args, kwargs) -> bool:
    """Whether a call of a wrapper with a bf16w instantiation runs it, by
    the wrappers' rule: at precision "bf16w" where the wrapper takes a
    precision ("bf16", the stem's and the F(2,3)'s bf16 inputs, runs the
    f32 entry's counter), else on a bfloat16 weight (or one of a params
    dict's)."""
    bound = inspect.signature(fn).bind(*args, **kwargs)
    bound.apply_defaults()
    if "precision" in bound.arguments:
        return bound.arguments["precision"] == "bf16w"

    def bf16(v):
        if isinstance(v, dict):
            return any(bf16(u) for u in v.values())
        return isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16

    return any(bf16(v) for v in bound.arguments.values())


def checked(counter: str, bf16w_counter: str | None = None):
    """Decorator of a public kernel wrapper whose launches count under
    `counter` (and under `bf16w_counter` at bf16w, where it has that
    instantiation). Under NAN_CHECKS the output is checked after the call,
    and the first non-finite one raises FloatingPointError naming the
    counter of the kernel that produced it and the argument's shape: on a
    CUDA tensor the counter the call launched under, on a CPU tensor the one
    its plain version stands for. The check synchronizes, so it refuses to
    run while a CUDA graph is captured."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not NAN_CHECKS:
                return fn(*args, **kwargs)
            if capturing():
                raise RuntimeError("nan_checks cannot check a kernel's output while a CUDA "
                                   "graph is captured (the check synchronizes)")
            before = collections.Counter(LAUNCHES)
            out = fn(*args, **kwargs)
            bad = int((~torch.isfinite(out)).sum())
            if bad:
                launched = [k for k in LAUNCHES if LAUNCHES[k] != before[k]]
                if launched:
                    name = launched[-1]
                elif bf16w_counter and _bf16w_call(fn, args, kwargs):
                    name = bf16w_counter
                else:
                    name = counter
                x = (args or tuple(kwargs.values()))[0]
                raise FloatingPointError(
                    f"{name}: {bad} non-finite value(s) in the output {tuple(out.shape)} of "
                    f"{fn.__name__} on an argument of shape {tuple(x.shape)}")
            return out
        return call
    return wrap


def capturing() -> bool:
    """Whether this thread's current CUDA stream is capturing a graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def check_bf16w(x: torch.Tensor) -> None:
    """A bf16 weight takes a float32 activation (the bf16w tier splits it
    into two bf16 halves); anything else is refused."""
    if x.dtype != torch.float32:
        raise ValueError(f"bfloat16 weights take a float32 activation, got {x.dtype}")


def require_device(device) -> torch.device:
    """Resolve an entry point's device. CUDA is the default and must exist;
    the CPU runs only when the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device
