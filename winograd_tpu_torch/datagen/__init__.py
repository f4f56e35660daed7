"""Offline data and parameter generation (a copy of winograd_tpu/datagen)."""

from winograd_tpu_torch.datagen.generate import (
    generate_all,
    load_case,
    make_block_case,
    make_case,
    make_pointwise_case,
    make_winograd_case,
)

__all__ = [
    "make_winograd_case",
    "make_pointwise_case",
    "make_block_case",
    "make_case",
    "generate_all",
    "load_case",
]
