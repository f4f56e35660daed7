"""The K-split plans of the port's redesigned GEMM kernels (plain Python, no
card needed): kernels/splitk.py::split_k, kernels/pointwise.py::split_plan
(csrc/pointwise.cu), kernels/direct.py::direct_plan (csrc/direct.cu) and
kernels/quantized.py::direct_int8_plan (csrc/direct_int8.cu) and
::transition_int8_plan (csrc/transition_int8.cu). Every K index lies in
exactly one range, every range but the last is a multiple of the kernel's
staging step, and tiles x splits reach about one wave of SMs where K
allows, never more than the kernel's blocks in flight. The plans' copies
of the kernels' geometry equal the constants compiled into the kernels
(whose C entries refuse a plan that does not fit them)."""

import pathlib
import re

import numpy as np
import pytest

from winograd_tpu_torch.kernels import direct as dr
from winograd_tpu_torch.kernels import pointwise as pw
from winograd_tpu_torch.kernels import quantized as q8
from winograd_tpu_torch.kernels.splitk import H100_SMS, Split, split_k


def _covers_once(split: Split, k: int, step: int) -> None:
    """The kernels' ranges [s * chunk, min(k, (s + 1) * chunk)) cover every
    K index once, each but the last a multiple of `step` long."""
    seen = np.zeros(k, np.int64)
    spans = [(s * split.chunk, min(k, (s + 1) * split.chunk)) for s in range(split.splits)]
    assert len(spans) == split.splits
    for lo, hi in spans:
        assert 0 <= lo < hi <= k
        seen[lo:hi] += 1
    assert (seen == 1).all()
    if split.splits > 1:
        assert split.chunk % step == 0
        assert all(hi - lo == split.chunk for lo, hi in spans[:-1])


@pytest.mark.parametrize("step,min_chunk", [(32, 32), (32, 64), (64, 128)])
def test_split_k_covers_every_k_once(step, min_chunk):
    for k in (1, 7, 36, 64, 127, 130, 576, 2000, 2048, 2304, 4608, 9999):
        for want in (0, 1, 2, 5, 16, 33, 200):
            split = split_k(k, want, step, min_chunk)
            _covers_once(split, k, step)
            if split.splits > 1:
                assert split.chunk >= min_chunk
                assert split.splits <= want
            if want < 2 or k < 2 * min_chunk:
                assert split == Split(1, k)


# The served products of csrc/pointwise.cu (P, K, N) and the split each
# takes on 132 SMs: the heads at N=1 and N=8 and the P = 49 rows split
# furthest; the large-P 1x1s and K = 128 keep one range.
SERVED_POINTWISE = {
    (1, 2048, 1000): 16, (8, 2048, 1000): 16, (1, 512, 1000): 8,
    (49, 2048, 512): 16, (49, 512, 2048): 4, (49, 2304, 512): 15, (49, 256, 512): 4,
    (196, 1152, 256): 8, (196, 128, 256): 1, (392, 2048, 512): 2, (784, 576, 128): 5,
    (784, 64, 128): 1, (3136, 64, 64): 1, (3136, 64, 256): 1,
}


@pytest.mark.parametrize("shape", sorted(SERVED_POINTWISE))
def test_pointwise_plan_fills_the_card(shape):
    p, k, n = shape
    plan = pw.split_plan(p, k, n)
    assert plan.splits == SERVED_POINTWISE[shape]
    _covers_once(plan, k, pw.SPLIT_STEP)
    assert plan.gemv == (p <= pw.GEMV_MAX_ROWS)
    if plan.gemv:
        assert plan.tiles == -(-n // pw.GEMV_COLS)
    else:
        assert plan.tiles == -(-p // pw.MMA_TILE) * -(-n // pw.MMA_TILE)
    wave = H100_SMS
    assert plan.tiles * plan.splits <= max(wave, plan.tiles)
    if plan.splits == 1:   # K too short to split, or the tiles fill half a wave
        assert (k < 2 * pw.MIN_CHUNK or 2 * plan.tiles > wave
                or not plan.gemv and k < pw.MMA_SPLIT_MIN_K)
    else:                  # about one wave, or K cut to the shortest ranges
        assert 2 * plan.tiles * plan.splits >= wave or plan.chunk == pw.MIN_CHUNK


@pytest.mark.parametrize("p,k,n", [(1, 7, 5), (65, 130, 70), (129, 4608, 33), (9, 300, 17),
                                   (8, 4096, 4096), (4000, 4608, 2048)])
def test_pointwise_plan_and_workspace_on_ragged_shapes(p, k, n):
    plan = pw.split_plan(p, k, n)
    _covers_once(plan, k, pw.SPLIT_STEP)
    words = plan.workspace_words(p, n)
    if plan.splits == 1:
        assert words == 0
    else:
        counters = words - plan.splits * p * n
        assert counters >= plan.tiles and counters % pw.COUNTER_WORDS == 0


def test_pointwise_plan_follows_the_sm_count():
    small = pw.split_plan(49, 2048, 512, sms=66)
    assert pw.split_plan(196, 128, 256).splits == 1              # below MMA_SPLIT_MIN_K
    assert small.splits == 8 and pw.split_plan(49, 2048, 512, sms=132).splits == 16


# The served f32 3x3 of csrc/direct.cu (N, H, W, Cin, Cout), 7x7x512 at N=1
# and N=8, and its split on 132 SMs: 16 ways at N=1 (8 tiles fill one wave),
# 9 at N=8 (56 tiles; no block walks more than DIRECT_MAX_CHUNK of K).
SERVED_DIRECT = {(1, 7, 7, 512, 512): 16, (8, 7, 7, 512, 512): 9}


@pytest.mark.parametrize("shape", sorted(SERVED_DIRECT))
def test_direct_plan_fills_the_card(shape):
    n, h, w, cin, cout = shape
    plan = dr.direct_plan(n, h, w, cin, cout)
    assert plan.splits == SERVED_DIRECT[shape]
    assert not plan.gemv and plan.tile == pw.MMA_TILE
    _covers_once(plan, 9 * cin, pw.SPLIT_STEP)
    assert dr.DIRECT_MIN_CHUNK <= plan.chunk <= dr.DIRECT_MAX_CHUNK
    assert plan.tiles == -(-n * h * w // pw.MMA_TILE) * -(-cout // pw.MMA_TILE)
    assert plan.tiles * plan.splits >= 0.9 * H100_SMS            # a wave, or more
    if plan.tiles * plan.splits > H100_SMS:                        # more only to cap the walk
        assert plan.chunk == dr.DIRECT_MAX_CHUNK
    assert dr.direct_plan(n, h, w, cin, cout, sms=66).splits <= plan.splits


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 5, 7, 3, 70), (1, 9, 9, 13, 65),
                                            (1, 14, 14, 256, 256), (3, 6, 6, 100, 33)])
def test_direct_plan_and_workspace_on_ragged_shapes(n, h, w, cin, cout):
    plan = dr.direct_plan(n, h, w, cin, cout)
    k, p = 9 * cin, n * h * w
    _covers_once(plan, k, pw.SPLIT_STEP)
    words = plan.workspace_words(p, cout)
    if k < pw.MMA_SPLIT_MIN_K:
        assert plan.splits == 1 and words == 0
    if plan.splits > 1:
        counters = words - plan.splits * p * cout
        assert counters >= plan.tiles and counters % pw.COUNTER_WORDS == 0


def test_direct_entry_checks_the_pointwise_geometry():
    """csrc/direct.cu runs splitk_tf32.cuh's MMA tiles, whose width and split
    step are mma_tf32.cuh's (checked against the plans above), and refuses
    a plan of another tile width."""
    src = (CSRC / "direct.cu").read_text()
    assert '#include "splitk_tf32.cuh"' in src and "tile != tc::kBM" in src
    assert "constexpr int kSplitStep = tc::kBK;" in (CSRC / "splitk_tf32.cuh").read_text()


# The served int8 3x3s of csrc/direct_int8.cu (N, H, W, Cin, Cout) and
# their splits on 132 SMs (a grid of two blocks an SM): ResNet-34's 7x7x512
# b-leg 24 ways at N=1 and 4 at N=8, ResNet-50's 56x56x64 (49 row tiles) 5
# ways at N=1 and none at N=8 (392 tiles).
SERVED_DIRECT_INT8 = {
    (1, 7, 7, 512, 512): 24, (8, 7, 7, 512, 512): 4, (1, 56, 56, 64, 64): 5,
    (8, 56, 56, 64, 64): 1,
}


@pytest.mark.parametrize("shape", sorted(SERVED_DIRECT_INT8))
def test_direct_int8_plan_fills_the_card(shape):
    n, h, w, cin, cout = shape
    plan = q8.direct_int8_plan(n, h, w, cin, cout)
    assert plan.splits == SERVED_DIRECT_INT8[shape]
    assert plan.kp == 9 * cin                     # 9 * Cin is already a multiple of 32
    _covers_once(plan, plan.kp, q8.DIRECT_INT8_STEP)
    assert plan.tiles == -(-n * h * w // 64) * -(-cout // 64)
    wave = q8.DIRECT_INT8_BLOCKS_PER_SM * H100_SMS
    assert plan.tiles * plan.splits <= max(wave, plan.tiles)
    if plan.splits > 1:
        assert 2 * plan.tiles * plan.splits >= wave


@pytest.mark.parametrize("cin,kp", [(4, 64), (12, 128), (16, 160), (20, 192), (64, 576)])
def test_direct_int8_pads_k_to_the_mma_depth(cin, kp):
    plan = q8.direct_int8_plan(2, 5, 7, cin, 70)
    assert plan.kp == kp and plan.kp % q8.DIRECT_INT8_K_ALIGN == 0 and plan.kp >= 9 * cin
    _covers_once(plan, plan.kp, q8.DIRECT_INT8_STEP)


def test_direct_int8_workspace_holds_every_part():
    plan = q8.direct_int8_plan(1, 7, 7, 512, 512)
    p, cout = 49, 512
    words = plan.workspace_words(p, cout)
    # barrier, scales, quantized rows, transposed weights, int32 partials
    least = 2 + p + p * plan.kp // 4 + cout * plan.kp // 4 + plan.splits * p * cout
    assert least <= words <= least + 4 * q8.WORKSPACE_ALIGN
    at = plan.workspace(p, cout)
    # the parts in order, each past the one before, at the 16-byte steps the
    # kernel's vector copies need (what csrc/direct_int8.cu's entry checks)
    assert 2 <= at.sx and at.sx + p <= at.aq and at.aq + p * plan.kp // 4 <= at.bt
    assert at.bt + cout * plan.kp // 4 <= at.part
    assert at.part + plan.splits * p * cout == at.words == words
    assert all(v % 4 == 0 for v in (at.aq, at.bt, at.part))
    one = q8.direct_int8_plan(2, 5, 7, 4, 70)
    assert one.splits == 1
    least = 2 + 70 + 2 * 70 * one.kp // 4                # no partial sums at one split
    assert least <= one.workspace_words(70, 70) <= least + 4 * q8.WORKSPACE_ALIGN


# The served int8 transitions (N, H, W, Cin, Cmid, Cout) and the splits of
# their reduce, mid, expand and projection on 132 SMs: at N=1 the phases
# split K towards a wave in ranges of at least 256; at N=8 the 14->7 reduce
# and last phase have a tile for most blocks and keep one range each.
SERVED_TRANSITION_INT8 = {
    (1, 56, 56, 256, 128, 512): (1, 5, 1, 1), (1, 28, 28, 512, 256, 1024): (2, 9, 1, 2),
    (1, 14, 14, 1024, 512, 2048): (4, 18, 2, 4), (8, 14, 14, 1024, 512, 2048): (1, 4, 1, 1),
}


def _transition_tiles(n, h, w, cin, cmid, cout):
    """Output tiles of the reduce, the mid and the last phase."""
    p1, p2 = n * h * w, n * -(-h // 2) * -(-w // 2)
    tile = q8.DIRECT_INT8_TILE
    return (-(-p1 // tile) * -(-cmid // tile), -(-p2 // tile) * -(-cmid // tile),
            -(-p2 // tile) * -(-cout // tile))


@pytest.mark.parametrize("shape", sorted(SERVED_TRANSITION_INT8))
def test_transition_int8_plan_fills_the_card(shape):
    plan = q8.transition_int8_plan(*shape)
    phases = (plan.reduce, plan.mid, plan.expand, plan.proj)
    assert tuple(s.splits for s in phases) == SERVED_TRANSITION_INT8[shape]
    for split, kp in zip(phases, (plan.kpr, plan.kpm, plan.kpe, plan.kpr)):
        _covers_once(split, kp, q8.DIRECT_INT8_STEP)
        assert split.splits == 1 or split.chunk >= q8.TRANSITION_INT8_MIN_CHUNK
    wave = q8.DIRECT_INT8_BLOCKS_PER_SM * H100_SMS
    assert plan.blocks == wave
    reduce, mid, last = _transition_tiles(*shape)
    assert reduce * plan.reduce.splits <= max(wave, reduce)
    assert mid * plan.mid.splits <= max(wave, mid)
    slots = plan.expand.splits + plan.proj.splits
    assert slots == 2 or last * slots <= wave   # one item a tile, or a wave of slots
    assert plan.args() == (wave,) + plan.reduce + plan.mid + plan.expand + plan.proj


@pytest.mark.parametrize("shape", [(3, 15, 15, 68, 20, 130), (2, 9, 8, 256, 300, 70),
                                   (8, 7, 7, 300, 40, 90), (2, 7, 5, 8, 12, 16)])
def test_transition_int8_plan_on_ragged_shapes(shape):
    n, h, w, cin, cmid, cout = shape
    plan = q8.transition_int8_plan(*shape)
    for kp, k in ((plan.kpr, cin), (plan.kpm, 9 * cmid), (plan.kpe, cmid)):
        assert kp % q8.DIRECT_INT8_K_ALIGN == 0 and k <= kp < k + q8.DIRECT_INT8_K_ALIGN
    for split, kp in zip((plan.reduce, plan.mid, plan.expand, plan.proj),
                         (plan.kpr, plan.kpm, plan.kpe, plan.kpr)):
        _covers_once(split, kp, q8.DIRECT_INT8_STEP)
    last = _transition_tiles(*shape)[2]
    slots = plan.expand.splits + plan.proj.splits
    assert slots == 2 or last * slots <= plan.blocks


def test_transition_int8_plan_follows_the_sm_count():
    shape = (1, 14, 14, 1024, 512, 2048)
    small, large = q8.transition_int8_plan(*shape, sms=66), q8.transition_int8_plan(*shape)
    assert small.blocks == large.blocks // 2
    assert small.mid.splits < large.mid.splits and small.reduce.splits <= large.reduce.splits


CSRC = pathlib.Path(q8.__file__).resolve().parent.parent / "csrc"


def _constexpr(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m, f"{name} not in {source}"
    return int(m.group(1))


@pytest.mark.parametrize("value,source,name", [
    (pw.GEMV_MAX_ROWS, "pointwise.cu", "kGemvMaxP"),
    (pw.GEMV_COLS, "pointwise.cu", "kGemvCols"),
    (pw.MMA_TILE, "mma_tf32.cuh", "kBM"),
    (pw.SPLIT_STEP, "mma_tf32.cuh", "kBK"),
    (q8.DIRECT_INT8_K_ALIGN, "mma_int8.cuh", "kKAlign"),
    (q8.DIRECT_INT8_TILE, "mma_int8.cuh", "kBM"),
    (q8.DIRECT_INT8_STEP, "mma_int8.cuh", "kBK"),
    (q8.DIRECT_INT8_BLOCKS_PER_SM, "transition_int8.cu", "kBlocksPerSm"),
])
def test_plans_match_the_kernels_geometry(value, source, name):
    assert value == _constexpr(source, name)


def test_transition_int8_entry_checks_the_int8_geometry():
    """The transition's C entry refuses a K split off the s8 tile's stage and
    a grid larger than its blocks an SM hold."""
    src = (CSRC / "transition_int8.cu").read_text()
    assert "constexpr int kSplitStep = s8::kBK;" in src
    assert "__launch_bounds__(s8::kThreads, kBlocksPerSm)" in src
    assert '#include "gemm_int8.cuh"' not in src
