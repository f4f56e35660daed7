"""The plan of csrc/winograd_int8.cu (kernels/quantized.py::
winograd_int8_plan and ::winograd_int8_item), plain Python on the CPU (no
card needed): its items (8 x 128, 16 x 128 or 32 x 256 Winograd tiles by
output channels over all 16 positions, one thread-block cluster each),
its grid (a cluster an item) and the span of K an item stages, at the
served shapes at N = 1, 8 and 32 and on ragged ones; the plan's copy of the
kernel's geometry against the source; and the wrapper hands the C entry
the plan (a stubbed launch)."""

import ctypes
import pathlib
import re

import pytest
import torch

from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.kernels import quantized as q8
from winograd_tpu_torch.kernels.splitk import H100_SMS

CSRC = pathlib.Path(q8.__file__).resolve().parent.parent / "csrc"
SRC = (CSRC / "winograd_int8.cu").read_text()

# ResNet-34's int8 Winograds (N, H, W, Cin, Cout) at N = 1, 8 and 32.
SERVED = [(n, hw, hw, c, c) for n in (1, 8, 32) for hw, c in ((28, 128), (14, 256))]


def _check(plan, n, h, w, cin, cout):
    """Every tile and output channel in one item, a cluster an item, K in
    spans of whole scale groups or one span, the block's shared memory
    within the card's."""
    tiles = n * -(-h // 2) * -(-w // 2)
    assert plan.tiles == tiles and plan.kp == -(-cin // 32) * 32
    assert (plan.item_tiles, plan.cols) in q8.WINO_INT8_ITEMS
    assert (plan.tile_blocks - 1) * plan.item_tiles < tiles <= plan.tile_blocks * plan.item_tiles
    assert (plan.col_blocks - 1) * plan.cols < cout <= plan.col_blocks * plan.cols
    assert plan.blocks == q8.WINO_INT8_CLUSTER * plan.tile_blocks * plan.col_blocks
    assert plan.chunk == plan.kp <= q8.WINO_INT8_CHUNK or (
        plan.chunk < plan.kp and plan.chunk % q8.WINO_INT8_GROUP == 0
        and plan.chunk <= q8.WINO_INT8_CHUNK)
    assert plan.smem(cin, cout) <= q8.H100_SMEM_PER_BLOCK
    assert plan.cols == 128 or q8.wino_int8_stash(cout)


# What the rule takes at the served shapes (tiles, channels, blocks an SM),
# each the fastest item shape of tools/chip_split_sweep.py's on an H100
# (PERF.md): the most items at N=1, 16-tile items two an SM at 28x28x128
# past N=1, 32 x 256 items at 14x14x256.
SERVED_ITEMS = {(1, 28): (8, 128, 2), (1, 14): (8, 128, 2), (8, 28): (16, 128, 2),
                (8, 14): (32, 256, 1), (32, 28): (16, 128, 2), (32, 14): (32, 256, 1)}


@pytest.mark.parametrize("shape", SERVED)
def test_served_plans_fill_the_card_with_the_largest_items(shape):
    """Of the item shapes whose grid fills WINO_INT8_FILL of the blocks
    the card holds, the plan takes the one with the most work an SM (the
    widest channel block, then tiles times blocks an SM); where none
    does, the most items."""
    n, h, w, cin, cout = shape
    plan = q8.winograd_int8_plan(*shape)
    _check(plan, *shape)
    assert plan.chunk == plan.kp       # the served widths stage K in one span
    per_sm = plan.blocks_per_sm(cin, cout)
    assert (plan.item_tiles, plan.cols, per_sm) == SERVED_ITEMS[(n, h)]
    candidates = [p for tiles, cols in q8.WINO_INT8_ITEMS
                  if (p := q8.winograd_int8_item(*shape, tiles, cols)) is not None]
    full = [p for p in candidates
            if p.blocks >= q8.WINO_INT8_FILL * H100_SMS * p.blocks_per_sm(cin, cout)]
    if plan in full:
        work = lambda p: (p.cols, p.item_tiles * p.blocks_per_sm(cin, cout))  # noqa: E731
        assert all(work(p) <= work(plan) for p in full)
    else:
        assert not full and plan.items() == max(p.items() for p in candidates)


def test_two_blocks_an_sm_where_registers_and_shared_memory_allow():
    """The kernel holds 128-channel items of up to 16 tiles in one span to
    128 registers (two blocks an SM where their shared memory fits); the
    plan counts its blocks an SM the same way."""
    assert "kMB == 2 && kNT <= 16 && !kSpans ? 2 : 1" in SRC
    assert q8.WINO_INT8_TWO_BLOCK_TILES == 16
    one_span = q8.winograd_int8_item(1, 28, 28, 128, 128, 16, 128)
    assert one_span.blocks_per_sm(128, 128) == 2
    assert q8.winograd_int8_item(1, 14, 14, 256, 256, 32, 256).blocks_per_sm(256, 256) == 1
    spans = q8.winograd_int8_item(1, 14, 14, 1152, 128, 8, 128)
    assert spans.chunk < spans.kp and spans.blocks_per_sm(1152, 128) == 1


@pytest.mark.parametrize("shape", SERVED + [(3, 7, 9, 13, 70), (2, 9, 5, 256, 128)])
@pytest.mark.parametrize("tiles", [8, 16, 32])
@pytest.mark.parametrize("cols", [128, 256])
def test_every_item_shape_covers_the_map(shape, tiles, cols):
    """Every item shape the kernel was compiled for (WINO_INT8_ITEMS of 8,
    16 or 32 tiles by 128 or 256 channels) gives a plan that covers the
    map, but 256 channels an item outside the stash (one scale group per
    stage needs the group branch's 128); the others give none."""
    plan = q8.winograd_int8_item(*shape, tiles, cols)
    if (tiles, cols) not in q8.WINO_INT8_ITEMS or cols > 128 and not q8.wino_int8_stash(
            shape[-1]):
        assert plan is None
        return
    assert plan is not None and (plan.item_tiles, plan.cols) == (tiles, cols)
    _check(plan, *shape)


def test_a_span_shrinks_until_the_block_fits():
    """32 tiles by 256 channels at Cin 512 do not fit one span of 512 (nor
    384) in a block's shared memory: the plan walks spans of 256."""
    plan = q8.winograd_int8_item(1, 14, 14, 512, 256, 32, 256)
    assert plan.kp == 512 and plan.chunk == 256
    for chunk in (512, 384):
        assert q8.winograd_int8_smem(32, 256, chunk, 1) > q8.H100_SMEM_PER_BLOCK
    assert plan.smem(512, 256) == q8.winograd_int8_smem(32, 256, 256, 1)


def test_item_shapes_are_the_kernels_instantiations():
    """The plan's item shapes are the (tiles, channels) pairs the C entry's
    kernel_of dispatches, and the wgmma shapes it compiles are m64nNk32 for
    those N."""
    body = SRC[SRC.index("Kernel kernel_of(int nt, int cols, bool spans)"):]
    body = body[:body.index("return nullptr;")]
    pairs = {(int(nt), int(cols)) for nt, cols in
             re.findall(r"nt == (\d+) && cols == (\d+)\) return", body)}
    assert pairs == set(q8.WINO_INT8_ITEMS)
    for t, _ in q8.WINO_INT8_ITEMS:
        assert f"wgmma.mma_async.sync.aligned.m64n{t}k32.s32.s8.s8" in SRC


def test_layout_is_the_plans_shared_memory():
    """The C entry's Layout lays a warpgroup's part out as
    winograd_int8_smem does."""
    for line in ("vq = 2 * cols * kBK;", "vf = vq + kblocks * nt * kBK;", "ldm = cols + 4;",
                 "wg_bytes = (sc + nt * gspan * 4 + 1023) / 1024 * 1024;",
                 "bytes = 1024 + kWarpgroups * wg_bytes;"):
        assert line in SRC, line
    assert q8.winograd_int8_smem(8, 128, 128, 1) == 1024 + 2 * 38912


@pytest.mark.parametrize("value,name", [
    (q8.WINO_INT8_CLUSTER, "kCluster"), (q8.WINO_INT8_STEP, "kBK"),
    (q8.WINO_INT8_CHUNK, "kChunk"), (q8.WINO_INT8_GROUP, "kGroup"),
    (q8.H100_SMEM_PER_BLOCK, "kMaxSmem"),
])
def test_plan_constants_match_the_kernel(value, name):
    m = re.search(rf"constexpr int {name} = (\d+);", SRC)
    assert m and int(m.group(1)) == value


def test_row_maxima_keep_a_nan():
    """The row maxima take max.NaN (wt::max_nan), so a row with a NaN gets
    a NaN scale, as torch.amax gives the plain version."""
    assert "wt::max_nan(" in SRC and "fmaxf(" not in SRC and "s8::abs_max4(" not in SRC


@pytest.mark.parametrize("sms", [H100_SMS, 66])
@pytest.mark.parametrize("shape", SERVED[2:])
def test_wrapper_launches_the_plan_at_n8_and_n32(monkeypatch, sms, shape):
    """conv3x3_bn_winograd_int8 hands the C entry the shape, the stash flag
    and ReLU, then winograd_int8_plan's padded Cin, item shape, span and
    grid for the card's SM count."""
    n, h, w, cin, cout = shape
    calls = []
    monkeypatch.setattr(_build, "check_tensors", lambda *t, **k: None)
    monkeypatch.setattr(_build, "check_operands", lambda *t, **k: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: sms)
    monkeypatch.setattr(_build, "ptr", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(_build, "launch", lambda name, entry, shape, device, *args, counter=None:
                        calls.append((entry, [a.value for a in args
                                              if isinstance(a, ctypes.c_int)])))
    e = lambda *shape: torch.empty(*shape, device="meta")  # noqa: E731
    u_q = torch.empty(16, cin, cout, device="meta", dtype=torch.int8)
    q8.conv3x3_bn_winograd_int8(e(n, h, w, cin), u_q, e(16, cout), e(cout), e(cout), False)
    [(entry, ints)] = calls
    assert entry == "winograd_int8_conv3x3_bn"
    assert ints == [n, h, w, cin, cout, int(cout > 128), 0,
                    *q8.winograd_int8_plan(*shape, sms).args()]
