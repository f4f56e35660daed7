"""The geometry of the fused stem kernel (csrc/stem.cu), read from its
constants (plain Python, no card needed): the warps' MMA fragments cover a
block's conv tile and channel block, the served stem (224x224x3 -> 56x56x64)
launches enough blocks at N=1 to fill the card's 132 SMs and few enough to
be resident at once two an SM, and two blocks' shared memory fit an SM at
Cin 3 and 4. The products run on the FP64 tensor cores, with no FMA loop
on the CUDA cores."""

import pathlib
import re

import pytest

from winograd_tpu_torch.kernels.splitk import H100_SMS

SOURCE = (pathlib.Path(__file__).resolve().parent.parent / "winograd_tpu_torch" / "csrc"
          / "stem.cu").read_text()
SMEM_PER_SM = 228 * 1024       # an H100 SM's shared memory, 1 KB of it reserved a block
SMEM_PER_BLOCK = 227 * 1024


def _constexpr(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, f"{name} not in stem.cu"
    return int(m.group(1))


PY, PX, CB = _constexpr("kPY"), _constexpr("kPX"), _constexpr("kCB")
WARPS_M, WARPS_N = _constexpr("kWarpsM"), _constexpr("kWarpsN")
FRAGS_M, FRAGS_N = _constexpr("kFragsM"), _constexpr("kFragsN")


def _blocks(n, h, w, c):
    po, qo = -(-h // 4), -(-w // 4)
    return -(-qo // PX) * -(-po // PY) * n * -(-c // CB)


def test_fragments_cover_the_block():
    conv_positions = (2 * PY + 1) * (2 * PX + 1)
    assert conv_positions <= WARPS_M * FRAGS_M * 16 < conv_positions + WARPS_M * 16
    assert WARPS_N * FRAGS_N * 8 == CB


def test_served_stem_fills_the_card_in_one_wave():
    blocks = _blocks(1, 224, 224, 64)
    assert blocks == 196
    assert H100_SMS <= blocks <= 2 * H100_SMS
    assert _blocks(8, 224, 224, 64) == 8 * blocks


@pytest.mark.parametrize("cin", [3, 4])
def test_two_blocks_fit_an_sm(cin):
    kp = -(-49 * cin // 4) * 4
    rows, cols = 2 * (2 * PY) + 7, 2 * (2 * PX) + 7
    staged = 8 * (kp * (CB + 4) + rows * cols * cin) + 4 * kp
    conv = 4 * (2 * PY + 1) * (2 * PX + 1) * (CB + 1)
    smem = max(staged, conv)
    assert smem <= SMEM_PER_BLOCK and 2 * (smem + 1024) <= SMEM_PER_SM
    assert "__launch_bounds__(kThreads, 2)" in SOURCE


def test_products_run_on_the_fp64_tensor_cores():
    """The stem's dmma is the shared FP64 MMA header's m16n8k4."""
    header = (pathlib.Path(__file__).resolve().parent.parent / "winograd_tpu_torch" / "csrc"
              / "mma_f64.cuh").read_text()
    assert '#include "mma_f64.cuh"' in SOURCE and "using wt::dmma;" in SOURCE
    assert "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64" in header
    assert "fmaf(" not in SOURCE and "fma(" not in SOURCE
