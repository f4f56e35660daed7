"""The work-item plan of the f32 Winograd kernel (plain Python, no card
needed): kernels/winograd.py::winograd_plan for csrc/winograd.cu and for
the F(2,3) mid of csrc/stage.cu. Its items fill a wave of SMs at every
served shape, every input channel lies in one Cin range, the plan follows
the card's SM count, the workspace holds V and the partial products, the
plan's copies of the kernels' geometry equal the constants compiled into
csrc/ (whose C entries refuse a plan that does not fit them), and both
wrappers hand the kernels this plan."""

import ctypes
import pathlib
import re

import numpy as np
import pytest

import torch

from winograd_tpu_torch.kernels import _build, stage
from winograd_tpu_torch.kernels import winograd as wg
from winograd_tpu_torch.kernels.splitk import H100_SMS

CSRC = pathlib.Path(wg.__file__).resolve().parent.parent / "csrc"

# The served f32 Winograd convs (N, H, W, Cin, Cout, m): ResNet-50's
# projection 3x3 and ResNet-34's identity 3x3s at N=1 and N=8, and the
# F(4,3) check shape (bench mode 0's 14x14x128), with the Cin splits each
# takes on 132 SMs. The first two and the N=8 28x28x128 are also the
# stage kernel's F(2,3) mids (conv2_x and conv3_x, Cin = Cout = Cmid).
SERVED = {
    (1, 56, 56, 64, 64, 2): 1, (1, 28, 28, 128, 128, 2): 2,
    (1, 14, 14, 256, 256, 2): 4, (1, 14, 14, 128, 128, 4): 2,
    (8, 56, 56, 64, 64, 2): 1, (8, 28, 28, 128, 128, 2): 1,
    (8, 14, 14, 256, 256, 2): 1,
}


def _covers_once(plan: wg.WinogradPlan, cin: int) -> None:
    """Every Cin index in one range (each but the last a multiple of the
    kernel's stage, at least WINOGRAD_MIN_CHUNK past one split), as the
    kernel walks them."""
    seen = np.zeros(cin, np.int64)
    for s in range(plan.splits):
        lo, hi = s * plan.chunk, min(cin, (s + 1) * plan.chunk)
        assert 0 <= lo < hi <= cin
        seen[lo:hi] += 1
    assert (seen == 1).all()
    if plan.splits > 1:
        assert plan.chunk % wg.WINOGRAD_STEP == 0 and plan.chunk >= wg.WINOGRAD_MIN_CHUNK


@pytest.mark.parametrize("shape", sorted(SERVED))
def test_winograd_plan_fills_a_wave(shape):
    n, h, w, cin, cout, m = shape
    a2 = (m + 2) ** 2
    plan = wg.winograd_plan(n, h, w, cin, cout, m)
    assert plan.splits == SERVED[shape]
    _covers_once(plan, cin)
    tiles = wg.winograd_tiles(n, h, w, m)
    # one item a tile position, tile block and Cout block, times the splits
    assert plan.items(tiles, cout, a2) == a2 * plan.splits * -(-tiles // 64) * -(-cout // 64)
    assert plan.items(tiles, cout, a2) >= H100_SMS             # at least one wave
    assert plan.blocks == wg.WINOGRAD_BLOCKS_PER_SM * H100_SMS
    if plan.splits > 1:    # Cin is split only while the items fall short of the blocks
        assert plan._replace(splits=1).items(tiles, cout, a2) < plan.blocks
        assert plan._replace(splits=plan.splits - 1).items(tiles, cout, a2) < plan.blocks


@pytest.mark.parametrize("n,h,w,cin,cout,m", [
    (2, 7, 7, 13, 70, 2), (1, 9, 9, 3, 33, 4), (1, 14, 14, 200, 70, 2), (3, 6, 6, 130, 16, 4),
    (1, 5, 9, 3, 5, 2), (1, 30, 30, 1000, 7, 2),
])
def test_winograd_plan_on_ragged_shapes(n, h, w, cin, cout, m):
    a2 = (m + 2) ** 2
    plan = wg.winograd_plan(n, h, w, cin, cout, m)
    _covers_once(plan, cin)
    tiles = wg.winograd_tiles(n, h, w, m)
    assert tiles == n * -(-h // m) * -(-w // m)
    at = plan.workspace(tiles, cin, cout, a2)
    kp = -(-cin // 4) * 4                  # V's rows, zero past Cin, move in 16-byte copies
    assert at.v >= 2 and at.v % 4 == 0 and at.part % 4 == 0          # behind the barrier
    assert at.v + a2 * tiles * kp <= at.part < at.v + a2 * tiles * kp + wg.WINOGRAD_ALIGN
    assert at.words == at.part + plan.splits * a2 * tiles * cout
    if cin < 2 * wg.WINOGRAD_MIN_CHUNK:
        assert plan.splits == 1 and plan.chunk == cin


def test_winograd_plan_follows_the_sm_count():
    small = wg.winograd_plan(1, 14, 14, 256, 256, 2, sms=66)
    large = wg.winograd_plan(1, 14, 14, 256, 256, 2, sms=132)
    assert small.blocks == 2 * 66 and large.blocks == 2 * 132
    assert small.splits < large.splits
    for sms in (66, 114, 132):
        plan = wg.winograd_plan(1, 28, 28, 128, 128, 2, sms=sms)
        assert plan.items(wg.winograd_tiles(1, 28, 28, 2), 128, 16) >= sms


def _constexpr(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m, f"{name} not in {source}"
    return int(m.group(1))


@pytest.mark.parametrize("value,source,name", [
    (wg.WINOGRAD_TILE, "mma_tf32.cuh", "kBM"),
    (wg.WINOGRAD_TILE, "mma_tf32.cuh", "kBN"),
    (wg.WINOGRAD_STEP, "mma_tf32.cuh", "kBK"),
    (wg.WINOGRAD_TILE, "wgmma_tile.cuh", "kBM"),
    (wg.WINOGRAD_TILE, "wgmma_tile.cuh", "kBN"),
    (wg.WINOGRAD_STEP, "wgmma_tile.cuh", "kBK"),
    (wg.WINOGRAD_BLOCKS_PER_SM, "stage.cu", "kMaxBlocksPerSm"),
])
def test_winograd_plan_matches_the_kernels_geometry(value, source, name):
    assert value == _constexpr(source, name)


def _stub_launches(monkeypatch, sms):
    """Stand-ins for the card: meta tensors pass the operand checks, the
    device has `sms` SMs, and each launch and workspace query is recorded
    with its integer arguments instead of made."""
    calls = []
    monkeypatch.setattr(_build, "check_tensors", lambda *t, **k: None)
    monkeypatch.setattr(_build, "check_operands", lambda *t, **k: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: sms)
    monkeypatch.setattr(_build, "ptr", lambda t: ctypes.c_void_p(0))

    def launch(name, entry, shape, device, *args, counter=None):
        calls.append((entry, [a.value for a in args if isinstance(a, ctypes.c_int)]))
    monkeypatch.setattr(_build, "launch", launch)

    def workspace(*args, bf16w=False):
        calls.append(("resnet_stage_workspace", list(args[1:])))
        return 1
    monkeypatch.setattr(stage, "_workspace_floats", workspace)
    return calls


@pytest.mark.parametrize("sms", [H100_SMS, 66])
@pytest.mark.parametrize("n,h,w,cin,cout,m", [
    (1, 28, 28, 128, 128, 2), (1, 14, 14, 256, 256, 2), (1, 14, 14, 128, 128, 4),
])
def test_winograd_wrapper_launches_the_plan(monkeypatch, sms, n, h, w, cin, cout, m):
    """conv3x3_bn_winograd hands csrc/winograd.cu winograd_plan's grid and
    Cin split for the card's SM count (its last three integers)."""
    calls = _stub_launches(monkeypatch, sms)
    x = torch.empty(n, h, w, cin, device="meta")
    u = torch.empty((m + 2) ** 2, cin, cout, device="meta")
    wg.conv3x3_bn_winograd(x, u, torch.empty(cout, device="meta"),
                           torch.empty(cout, device="meta"))
    plan = wg.winograd_plan(n, h, w, cin, cout, m, sms)
    [(entry, ints)] = calls
    assert entry == "winograd_conv3x3_bn"
    assert ints[-4:] == [wg.WINOGRAD_TILE, plan.blocks, plan.splits, plan.chunk]


@pytest.mark.parametrize("sms", [H100_SMS, 66])
@pytest.mark.parametrize("n,hw,cio,cmid,mid", [
    (1, 56, 256, 64, "winograd2"), (1, 28, 512, 128, "winograd2"),
    (8, 28, 512, 128, "winograd2"), (1, 14, 1024, 256, "direct"),
])
def test_stage_wrapper_passes_the_winograd_plan(monkeypatch, sms, n, hw, cio, cmid, mid):
    """resnet_stage_fused hands csrc/stage.cu's F(2,3) mid the per-layer
    Winograd's Cin split for Cmid (the kernel checks it fits and plans no
    cut of its own), in the workspace query and in the launch alike, and
    after it stage.py::stage_plan's grid (and its phases, in the query)."""
    calls = _stub_launches(monkeypatch, sms)
    e = lambda *shape: torch.empty(*shape, device="meta")  # noqa: E731
    stacked = dict(w_reduce=e(2, cio, cmid), s_reduce=e(2, 1, cmid), b_reduce=e(2, 1, cmid),
                   u2_mid=e(2, 16, cmid, cmid), w9_mid=e(2, 9 * cmid, cmid),
                   s_mid=e(2, 1, cmid), b_mid=e(2, 1, cmid), w_expand=e(2, cmid, cio),
                   s_expand=e(2, 1, cio), b_expand=e(2, 1, cio))
    stage.resnet_stage_fused(e(n, hw, hw, cio), stacked, mid)
    plan = wg.winograd_plan(n, hw, hw, cmid, cmid, 2, sms)
    [(query, q_ints), (entry, ints)] = calls
    assert (query, entry) == ("resnet_stage_workspace", "resnet_stage")
    sp = stage.stage_plan(n, hw, hw, cio, cmid, sms)
    assert q_ints == [n, hw, hw, cio, cmid, int(mid == "winograd2"), plan.splits, plan.chunk,
                      sp.grid, sp.phases()]
    assert ints[-4:] == [int(mid == "winograd2"), plan.splits, plan.chunk, sp.grid]
