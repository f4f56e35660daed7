"""Timing and the benchmark protocol.

The twin of winograd_tpu/utils/timing.py. The reference times a kernel
launch with a microsecond wall clock and a device synchronize, 100 times,
the first 2 discarded. bench_loop keeps that protocol:
torch.cuda.synchronize() plays the part of cudaDeviceSynchronize (and of
jax.block_until_ready in the JAX package), and a chained measurement,
`iterations` calls back to back and one synchronize, amortizes the host's
dispatch. bench_graph gives the device time per call: the calls captured
in one CUDA graph and replayed between CUDA events, so no host time is in
it. It takes the place of the JAX package's bench_scan, whose two-length
slope cancelled the dispatch floor of a remote TPU. capture_graph is the one
capture both bench_graph and the serving engines (engine.py) go through.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, List, Optional, Tuple

import torch

from winograd_tpu_torch.config import BENCH_ITERATIONS, BENCH_WARMUP
from winograd_tpu_torch.utils import native


def get_time_microseconds64() -> int:
    """Microsecond wall clock (CLOCK_REALTIME): the native host library's
    wt_time_us where it loads (utils/native.py), else time.time_ns."""
    lib = native.load()
    if lib is None:
        return time.time_ns() // 1000
    native.CALLS["wt_time_us"] += 1
    return int(lib.wt_time_us())


class Timer:
    """Context-manager stopwatch in microseconds."""

    def __enter__(self):
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.elapsed_us = (time.perf_counter_ns() - self.start) / 1e3
        return False


@dataclasses.dataclass
class BenchResult:
    name: str
    mean_us: float          # per-iteration mean over timed iterations
    min_us: float
    iterations: int
    warmup: int
    per_iteration_us: List[float]
    chained_us: float       # per-call time of `iterations` calls and one synchronize
    device_us: Optional[float] = None  # per-call device time (bench_graph); None on the CPU

    def __str__(self) -> str:
        device = "n/a" if self.device_us is None else f"{self.device_us:.1f} us"
        return (
            f"{self.name}: mean {self.mean_us:.1f} us, min {self.min_us:.1f} us, "
            f"chained {self.chained_us:.1f} us, device {device} "
            f"over {self.iterations} iters"
        )


def _wait(result) -> None:
    """Wait for the device work that produced `result` (a tensor or a list
    of them); nothing to wait for on the CPU."""
    first = result[0] if isinstance(result, (list, tuple)) else result
    if isinstance(first, torch.Tensor) and first.is_cuda:
        torch.cuda.synchronize(first.device)


def bench_loop(
    name: str,
    fn: Callable[[], torch.Tensor],
    iterations: int = BENCH_ITERATIONS,
    warmup: int = BENCH_WARMUP,
) -> BenchResult:
    """The reference protocol: `iterations` calls, each followed by a
    synchronize and timed on the host clock, the first `warmup` discarded,
    the mean of the rest (launch overhead included, like the reference's
    timed region). Then `iterations` calls back to back and one
    synchronize, divided by `iterations`: the per-call time once the host's
    dispatch overlaps the device."""
    if iterations < 1:
        raise ValueError(f"iterations must be >= 1, got {iterations}")
    warmup = max(0, min(warmup, iterations - 1))  # always keep >= 1 timed call
    times: List[float] = []
    for _ in range(iterations):
        t0 = time.perf_counter_ns()
        _wait(fn())
        times.append((time.perf_counter_ns() - t0) / 1e3)
    timed = times[warmup:]

    t0 = time.perf_counter_ns()
    _wait([fn() for _ in range(iterations)])
    chained_us = (time.perf_counter_ns() - t0) / 1e3 / iterations

    return BenchResult(
        name=name,
        mean_us=sum(timed) / len(timed),
        min_us=min(timed),
        iterations=len(timed),
        warmup=warmup,
        per_iteration_us=times,
        chained_us=chained_us,
    )


# Graphs whose capture failed. PyTorch's allocator keeps an entry that
# refers to such a graph, so it is kept alive; its pool stays recording and
# is not captured into again.
_FAILED_GRAPHS: List[torch.cuda.CUDAGraph] = []


def capture_graph(
    fn: Callable,
    warmup: int = 1,
    calls: int = 1,
    pool=None,
    what: str = "the path",
) -> Tuple[torch.cuda.CUDAGraph, object]:
    """fn() captured `calls` times into one CUDA graph, in the memory pool
    `pool` (a private one when None), after `warmup` eager calls on a side
    stream: those build the kernels' libraries and host plans, so nothing is
    built or loaded inside the capture. Returns the graph and the last
    captured call's output. A capture that fails (a host synchronize, a copy
    from pageable host memory) raises a RuntimeError naming `what` and the
    reason, after restoring the current stream; the caller must not capture
    into `pool` again."""
    stream = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(stream)
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    stream.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, pool=pool):
            for _ in range(calls):
                out = fn()
    except RuntimeError as e:
        # A failed capture leaves the capture stream current.
        torch.cuda.set_stream(stream)
        _FAILED_GRAPHS.append(graph)
        raise RuntimeError(f"{what} cannot be captured in a CUDA graph: {e}") from e
    return graph, out


def bench_graph(
    fn: Callable,
    x: Optional[torch.Tensor] = None,
    calls: int = 20,
    replays: int = 20,
) -> Optional[float]:
    """Device microseconds per call of fn(x) (of fn() without x): the
    protocol's BENCH_WARMUP eager calls, then `calls` calls captured in one
    CUDA graph (capture_graph), the median of `replays` replays between two
    CUDA events, divided by `calls`. The inputs stay in L2 between calls
    where they fit. None when x lies on the CPU. A path that cannot be
    captured raises with the capture's reason: it is never timed eagerly
    instead."""
    if x is not None and not x.is_cuda:
        return None
    thunk = fn if x is None else (lambda: fn(x))
    graph, _ = capture_graph(thunk, warmup=BENCH_WARMUP, calls=calls, what="bench_graph: the path")
    graph.replay()
    pairs = []
    for _ in range(replays):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return 1e3 * statistics.median(a.elapsed_time(b) for a, b in pairs) / calls
