"""Benchmark harness / CLI (the twin of winograd_tpu/bench)."""

from winograd_tpu_torch.bench.cli import main, run_case

__all__ = ["run_case", "main"]
