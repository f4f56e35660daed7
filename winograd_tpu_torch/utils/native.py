"""ctypes bindings of the port's native host library (native/winotpu.cpp).

The twin of winograd_tpu/utils/native.py. The library is the reference's
host layer (util.c) in C++: raw float32 blob reads and writes, a threaded
reader of many blobs, the host transpose, the shift-aware output checker
and a microsecond clock. g++ builds it at first use into build/
winograd_tpu_torch/ at the repository root (git-ignored), named by a hash of
the source, the flags and the machine, and it is loaded with ctypes. Where g++ is
missing or the build fails, load() returns None and utils/io.py,
utils/checker.py and utils/timing.py take their numpy path, as the JAX
package's do: this is host code, with no device in it.

CALLS counts, by entry point, the calls the native path served, so that a
run can show whether the library served it (the benchmark CLI's rows,
chip_smoke.py). bench/native_io.py times it against numpy.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import platform
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "native" / "winotpu.cpp"
BUILD_DIR = SOURCE.parent.parent.parent / "build" / "winograd_tpu_torch"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

# Calls served by the native path, by entry point.
CALLS: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_F32P = ctypes.POINTER(ctypes.c_float)
_LL = ctypes.c_longlong


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join((platform.machine(), *FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libwinotpu-{h.hexdigest()[:16]}.so"


def _build(out: pathlib.Path) -> bool:
    """g++ the source into out (through a temporary file, so concurrent
    processes never load a partial library); False where it cannot."""
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([gxx, *FLAGS, str(SOURCE), "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def load() -> Optional[ctypes.CDLL]:
    """The library, built first if needed; None where it cannot be built or
    loaded (tried once a process)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = library_path()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            return None
        lib.wt_time_us.restype = ctypes.c_uint64
        lib.wt_time_us.argtypes = []
        lib.wt_read_f32.restype = _LL
        lib.wt_read_f32.argtypes = [ctypes.c_char_p, _F32P, _LL]
        lib.wt_write_f32.restype = _LL
        lib.wt_write_f32.argtypes = [ctypes.c_char_p, _F32P, _LL]
        lib.wt_transpose_f32.restype = None
        lib.wt_transpose_f32.argtypes = [_F32P, _F32P, _LL, _LL]
        lib.wt_read_many_f32.restype = _LL
        lib.wt_read_many_f32.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                         ctypes.POINTER(_F32P), ctypes.POINTER(_LL), _LL, _LL]
        lib.wt_output_checker.restype = _LL
        lib.wt_output_checker.argtypes = [
            _F32P, _F32P,
            _LL,  # len (spatial side of b)
            _LL,  # channels
            _LL,  # shift
            _LL,  # spatial side of a
            ctypes.c_double,  # tolerance
            ctypes.POINTER(ctypes.c_double),  # out: max error
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def f32p(a):
    """A contiguous float32 numpy array's data as a float*."""
    return a.ctypes.data_as(_F32P)
