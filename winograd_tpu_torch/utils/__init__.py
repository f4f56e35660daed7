"""Host utility layer: blob IO, timing, differential checking, debugging
(copies of winograd_tpu/utils/{io,timing,checker,native,debug}.py, on numpy,
PyTorch and the port's native host library, native/winotpu.cpp)."""

from winograd_tpu_torch.utils import debug
from winograd_tpu_torch.utils.checker import CheckResult, ParityError, output_checker
from winograd_tpu_torch.utils.io import get_parameter, save_parameter, transpose
from winograd_tpu_torch.utils.timing import (
    BenchResult,
    Timer,
    bench_graph,
    bench_loop,
    get_time_microseconds64,
)

__all__ = [
    "debug",
    "get_parameter",
    "save_parameter",
    "transpose",
    "get_time_microseconds64",
    "Timer",
    "BenchResult",
    "bench_loop",
    "bench_graph",
    "output_checker",
    "CheckResult",
    "ParityError",
]
