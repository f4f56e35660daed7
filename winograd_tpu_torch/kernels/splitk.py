"""How a GEMM kernel of the port splits K over blocks (plain Python, so the
CPU tests reach it).

A kernel whose output tiles are fewer than the card's SMs leaves SMs idle
and waits on one block's walk over all of K. Splitting K into ranges, one
block (or work item) each, multiplies the blocks; the partial sums are then
added in split order by the kernel (csrc/pointwise.cu, csrc/direct.cu: the
splits of a tile the blocks of one thread-block cluster, best at a power of
two of them, pow2_split).
"""

from __future__ import annotations

from typing import NamedTuple

# SMs of an H100 SXM: the number the plans aim at when the device is not
# named (the wrappers pass the card's own count).
H100_SMS = 132


class Split(NamedTuple):
    """K as `splits` ranges [s * chunk, min(K, (s + 1) * chunk))."""

    splits: int
    chunk: int


def split_k(k: int, want: int, step: int, min_chunk: int) -> Split:
    """About `want` ranges of K, each a multiple of `step` long (the kernel's
    staging step) except the last, and at least `min_chunk` long; one range
    (chunk = k) when fewer than two are wanted or fit."""
    if want < 2 or k < 2 * min_chunk:
        return Split(1, k)
    chunk = -(-k // want)
    chunk = max(min_chunk, -(-chunk // step) * step)
    splits = -(-k // chunk)
    return Split(splits, chunk) if splits > 1 else Split(1, k)



def pow2_split(k: int, want: int, step: int, min_chunk: int) -> Split:
    """split_k's ranges for the largest power of two of wanted ranges, at
    most `want`, that split K into a power of two of ranges: the K splits
    of a tile that are the blocks of one cluster (csrc/wgmma_cluster.cuh,
    csrc/wgmma_s8_cluster.cuh), which an H100 runs best at 2, 4, 8 or 16."""
    w = 1 << (max(want, 1).bit_length() - 1)
    while True:
        split = split_k(k, w, step, min_chunk)
        if split.splits & (split.splits - 1) == 0:
            return split
        w //= 2
