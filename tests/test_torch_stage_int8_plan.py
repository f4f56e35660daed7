"""The plan of csrc/stage_int8.cu (kernels/quantized.py::stage_int8_plan),
plain Python on the CPU (no card needed): its grid and each GEMM phase's K
split for the s8 wgmma tile, at the served stages at N = 1, 8 and 32 and on
ragged shapes; its constants against the kernel's; the wrapper hands the C
entry the plan (a stubbed launch); and the kernel's phases are the s8
wgmma tile's, with no quantize phase of their own."""

import ctypes
import pathlib
import re

import pytest
import torch

from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.kernels import quantized as q8
from winograd_tpu_torch.kernels.splitk import H100_SMS
from winograd_tpu_torch.kernels.winograd import winograd_fp64_plan

CSRC = pathlib.Path(q8.__file__).resolve().parent.parent / "csrc"

# The served int8 stages (H, Cio, Cmid, mid): ResNet-50's conv2_x to conv5_x.
SERVED = [(56, 256, 64, "winograd2"), (28, 512, 128, "winograd2"), (14, 1024, 256, "direct"),
          (7, 2048, 512, "direct")]


def _tiles(p, n):
    return -(-p // q8.STAGE_INT8_TILE_M) * -(-n // q8.STAGE_INT8_TILE_N)


def _check_phase(split, p, k, n, grid):
    """The padded K in `splits` ranges of `chunk` covering it once, each but
    the last a multiple of the tile's stage, at most STAGE_INT8_MAX_SPLITS;
    split only where the phase's tiles are few, and then into walks of
    about STAGE_INT8_WALK (no shorter than the rule asks)."""
    splits, chunk = split
    kp = -(-k // q8.STAGE_INT8_K_ALIGN) * q8.STAGE_INT8_K_ALIGN
    few = _tiles(p, n) * q8.STAGE_INT8_FEW_TILES < grid * q8.STAGE_INT8_WARPGROUPS
    assert 1 <= splits <= q8.STAGE_INT8_MAX_SPLITS
    assert chunk * splits >= kp and chunk * (splits - 1) < kp
    if splits == 1:
        assert chunk == kp
        assert not few or kp <= q8.STAGE_INT8_WALK or kp < 2 * q8.STAGE_INT8_STEP
        return
    assert few and chunk % q8.STAGE_INT8_STEP == 0
    assert splits <= -(-kp // q8.STAGE_INT8_WALK)


@pytest.mark.parametrize("n", [1, 8, 32])
@pytest.mark.parametrize("hw,cio,cmid,mid", SERVED)
def test_stage_int8_plan_covers_k_at_the_served_stages(n, hw, cio, cmid, mid):
    groups = q8.expand_groups(cmid, mid)
    plan = q8.stage_int8_plan(n, hw, hw, cio, cmid, mid, groups)
    assert plan.grid == q8.STAGE_INT8_BLOCKS_PER_SM * H100_SMS
    p = n * hw * hw
    _check_phase(plan.reduce, p, cio, cmid, plan.grid)
    if mid == "winograd2":   # the FP64 mid's items: (1, their Cout block)
        assert plan.mid == (1, winograd_fp64_plan(n, hw, hw, cmid, plan.grid).cols)
    else:
        _check_phase(plan.mid, p, 9 * cmid, cmid, plan.grid)
    _check_phase(plan.expand, p, cmid, cio, plan.grid)
    assert plan.phases() == (*plan.reduce, *plan.mid, *plan.expand)


@pytest.mark.parametrize("n,h,w,cio,cmid", [(2, 7, 7, 40, 12), (1, 9, 5, 1000, 300),
                                            (3, 6, 6, 100, 36), (1, 1, 1, 4096, 1024),
                                            (64, 7, 7, 2048, 512)])
@pytest.mark.parametrize("mid", ["direct", "winograd2"])
def test_stage_int8_plan_on_ragged_shapes(n, h, w, cio, cmid, mid):
    for sms in (H100_SMS, 66, 16):
        groups = q8.expand_groups(cmid, mid)
        plan = q8.stage_int8_plan(n, h, w, cio, cmid, mid, groups, sms)
        p = n * h * w
        _check_phase(plan.reduce, p, cio, cmid, plan.grid)
        if mid == "direct":
            _check_phase(plan.mid, p, 9 * cmid, cmid, plan.grid)
        _check_phase(plan.expand, p, cmid, cio, plan.grid)
        if groups > 1:
            assert plan.expand.splits == 1


def test_stage_int8_grouped_expand_does_not_split():
    """The winograd2 route's expand quantizes h2 per group of 128 channels,
    one stage of the tile each: the plan never splits it."""
    plan = q8.stage_int8_plan(1, 7, 7, 2048, 1024, "winograd2", 8)
    assert plan.expand == (1, 1024)
    assert q8.stage_int8_plan(1, 7, 7, 2048, 1024, "winograd2", 1).expand.splits > 1


def test_stage_int8_plan_follows_the_sm_count():
    small, large = (q8.stage_int8_plan(1, 14, 14, 1024, 256, "direct", 1, sms)
                    for sms in (33, H100_SMS))
    assert small.grid < large.grid
    assert small.reduce.splits <= large.reduce.splits and small.mid.splits <= large.mid.splits


def _constexpr(source, name):
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m, f"{name} not in {source}"
    return int(m.group(1))


@pytest.mark.parametrize("value,source,name", [
    (q8.STAGE_INT8_BLOCKS_PER_SM, "stage_int8.cu", "kMaxBlocksPerSm"),
    (q8.STAGE_INT8_MAX_SPLITS, "stage_int8.cu", "kSplitCap"),
    (q8.STAGE_INT8_K_ALIGN, "stage_int8.cu", "kKAlign"),
    (q8.STAGE_INT8_TILE_M, "wgmma_s8.cuh", "kBM"),
    (q8.STAGE_INT8_WARPGROUPS, "wgmma_s8.cuh", "kWarpgroups"),
    (q8.STAGE_INT8_TILE_N, "wgmma_s8.cuh", "kBN"),
    (q8.STAGE_INT8_STEP, "wgmma_s8.cuh", "kBK"),
    (q8.WINO_INT8_GROUP, "wgmma_s8.cuh", "kBK"),
])
def test_stage_int8_plan_matches_the_kernels_geometry(value, source, name):
    assert value == _constexpr(source, name)


def test_stage_int8_runs_on_the_s8_wgmma_tile():
    """stage_int8.cu's reduce, direct mid and expand are wgmma_s8.cuh's
    tiles (s8 wgmma, TMA weight loads), each phase quantizing its rows
    once, from published row maxima, each block a share, its items waiting
    on their row block's counter: no quantize phase is left, and the FP64
    F(2,3) mid publishes h2's maxima through winograd.cuh's observer."""
    src = (CSRC / "stage_int8.cu").read_text()
    assert '#include "wgmma_s8.cuh"' in src and '#include "wgmma_s8_phase.cuh"' in src
    # the folded phases, shared with csrc/transition_int8.cu since its s8 wgmma form
    phase = (CSRC / "wgmma_s8_phase.cuh").read_text()
    both = src + phase
    assert "quantize_rows_phase" not in both and "s8::gemm_phase" not in both
    assert both.count("quantize_share(") == 3 and both.count("ready(cnt, it.rb, ") == 2
    assert src.count("gemm_phase(a.") == 3 and "grouped_expand(a," in src
    assert src.count("q8::encode_kmajor(") == 3 and "MidRowMax" in src
    tile = (CSRC / "wgmma_s8.cuh").read_text()
    for ptx in ("wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8", "atomicMax",
                "CU_TENSOR_MAP_SWIZZLE_128B", "wg::tma_load("):
        assert ptx in tile
    mma = (CSRC / "mma_int8.cuh").read_text()
    assert "quantize_rows_phase" not in mma  # its last user, the int8 direct, left it


def test_stage_int8_wrapper_launches_the_plan(monkeypatch):
    """resnet_stage_int8 hands csrc/stage_int8.cu stage_int8_plan's grid (the
    last integer) and phases (an int array) for the card's SM count, in the
    workspace query and the launch alike."""
    calls = []
    monkeypatch.setattr(_build, "check_tensors", lambda *t, **k: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: 66)
    monkeypatch.setattr(_build, "ptr", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(q8, "_stage_int8_workspace", lambda *a: calls.append(("ws", a)) or 1)

    def launch(name, entry, shape, device, *args, counter=None):
        arrays = [list(a) for a in args if isinstance(a, ctypes.Array)]
        ints = [a.value for a in args if isinstance(a, ctypes.c_int)]
        calls.append((entry, ints, arrays))
    monkeypatch.setattr(_build, "launch", launch)
    e = lambda *shape: torch.empty(*shape, device="meta")  # noqa: E731
    cio, cmid, nb = 1024, 256, 3
    q = dict(w_reduce_q=e(nb, cio, cmid).to(torch.int8), w_reduce_s=e(nb, 1, cmid),
             s_reduce=e(nb, 1, cmid), b_reduce=e(nb, 1, cmid),
             w9_mid_q=e(nb, 9 * cmid, cmid).to(torch.int8), w9_mid_s=e(nb, 1, cmid),
             s_mid=e(nb, 1, cmid), b_mid=e(nb, 1, cmid),
             w_expand_q=e(nb, cmid, cio).to(torch.int8), w_expand_s=e(nb, 1, cio),
             s_expand=e(nb, 1, cio), b_expand=e(nb, 1, cio))
    q8.resnet_stage_int8(e(8, 14, 14, cio), q, "direct")
    plan = q8.stage_int8_plan(8, 14, 14, cio, cmid, "direct", 1, 66)
    [(what, query), (entry, ints, arrays)] = calls
    assert what == "ws" and entry == "resnet_stage_int8"
    assert query[-2:] == (plan.grid, plan.phases())
    assert ints[-1] == plan.grid and arrays == [list(plan.phases())]
