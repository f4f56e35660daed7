"""The K-split plans of the port's redesigned GEMM kernels (plain Python, no
card needed): kernels/splitk.py::split_k, kernels/pointwise.py::split_plan
(csrc/pointwise.cu), kernels/direct.py::direct_plan (csrc/direct.cu) and
kernels/quantized.py::direct_int8_plan (csrc/direct_int8.cu),
::transition_int8_plan (csrc/transition_int8.cu) and ::pointwise_int8_plan
(csrc/pointwise_int8.cu, which also picks its path),
kernels/transition.py::transition_plan (csrc/transition.cu) and
kernels/basic_stage.py::basic_stage_plan (csrc/basic_stage.cu) and
::basic_stage_int8_plan (csrc/basic_stage_int8.cu); and
kernels/quantized.py::winograd_int8_plan (csrc/winograd_int8.cu: its work
items, the span of K an item stages, and its grid). Every K index
lies in exactly one range, every range but the last is a multiple of the
kernel's staging step, and tiles x splits reach about one wave of SMs
where K allows, never more than the kernel's blocks in flight. The plans'
copies of the kernels' geometry equal the constants compiled into the
kernels (whose C entries refuse a plan that does not fit them), and the
wrappers hand the C entries their plans."""

import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.kernels import basic_stage as bs
from winograd_tpu_torch.kernels import direct as dr
from winograd_tpu_torch.kernels import pointwise as pw
from winograd_tpu_torch.kernels import quantized as q8
from winograd_tpu_torch.kernels import transition as tr
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


# The served products of csrc/pointwise_int8.cu (P, K, N) at N=1 and N=8
# and the path and split each takes on 132 SMs: the heads on the GEMV, the
# K <= 256 1x1s in one pass a tile, the strided b-legs (K 576-2304) on the
# cooperative grid, split towards a wave of its 264 blocks.
SERVED_POINTWISE_INT8 = {
    (1, 2048, 1000): ("gemv", 16), (8, 2048, 1000): ("gemv", 16),
    (1, 512, 1000): ("gemv", 8), (8, 512, 1000): ("gemv", 8),
    (3136, 64, 64): ("one_pass", 1), (3136, 64, 256): ("one_pass", 1),
    (25088, 64, 64): ("one_pass", 1), (25088, 64, 256): ("one_pass", 1),
    (784, 64, 128): ("one_pass", 1), (196, 128, 256): ("one_pass", 1),
    (49, 256, 512): ("one_pass", 1), (6272, 64, 128): ("one_pass", 1),
    (1568, 128, 256): ("one_pass", 1), (392, 256, 512): ("one_pass", 1),
    (784, 576, 128): ("cooperative", 5), (196, 1152, 256): ("cooperative", 9),
    (49, 2304, 512): ("cooperative", 18), (6272, 576, 128): ("cooperative", 1),
    (1568, 1152, 256): ("cooperative", 2), (392, 2304, 512): ("cooperative", 4),
}


def _pointwise_int8_step(plan) -> int:
    return q8.POINTWISE_INT8_GEMV_STEP if plan.path == "gemv" else q8.DIRECT_INT8_STEP


@pytest.mark.parametrize("shape", sorted(SERVED_POINTWISE_INT8))
def test_pointwise_int8_plan_fills_the_card(shape):
    p, k, n = shape
    plan = q8.pointwise_int8_plan(p, k, n)
    assert (plan.path, plan.splits) == SERVED_POINTWISE_INT8[shape]
    _covers_once(plan, plan.kp, _pointwise_int8_step(plan))
    if plan.path == "gemv":
        assert plan.kp == k and plan.tile == q8.POINTWISE_INT8_GEMV_COLS
        assert plan.tiles == -(-n // plan.tile) and plan.blocks == plan.tiles * plan.splits
        assert plan.blocks <= H100_SMS                       # one block an SM at most
        assert 2 * plan.blocks >= H100_SMS or plan.chunk == q8.POINTWISE_INT8_GEMV_MIN_CHUNK
        return
    assert plan.kp == -(-k // 32) * 32 and plan.tile == q8.DIRECT_INT8_TILE
    assert plan.tiles == -(-p // 64) * -(-n // 64)
    if plan.path == "one_pass":                              # a tile a block, K unsplit
        assert plan.kp <= q8.POINTWISE_INT8_ONE_PASS_MAX_K
        assert plan.blocks == plan.tiles and plan.splits == 1
        return
    wave = q8.DIRECT_INT8_BLOCKS_PER_SM * H100_SMS
    assert plan.kp > q8.POINTWISE_INT8_ONE_PASS_MAX_K and plan.blocks == wave
    assert plan.tiles * plan.splits <= max(wave, plan.tiles)
    assert (plan.splits == 1 or 2 * plan.tiles * plan.splits >= wave
            or plan.chunk == q8.DIRECT_INT8_MIN_CHUNK)   # a wave, or the shortest ranges


@pytest.mark.parametrize("p,k,n", [(1, 8, 5), (65, 132, 70), (129, 4608, 33), (7, 300, 70),
                                   (100, 36, 130), (8, 4096, 4096), (9, 260, 1)])
def test_pointwise_int8_plan_covers_k_on_ragged_shapes(p, k, n):
    for path in q8.POINTWISE_INT8_PATHS:
        try:
            plan = q8.pointwise_int8_plan(p, k, n, path=path)
        except ValueError:                                   # the path does not take the shape
            assert (path == "gemv" and p > q8.POINTWISE_INT8_GEMV_MAX_ROWS
                    or path == "one_pass" and k > q8.POINTWISE_INT8_ONE_PASS_MAX_K)
            continue
        assert plan.path == path and plan.kp >= k
        assert plan.kp == k if path == "gemv" else plan.kp % q8.DIRECT_INT8_K_ALIGN == 0
        _covers_once(plan, plan.kp, _pointwise_int8_step(plan))
    with pytest.raises(ValueError):
        q8.pointwise_int8_plan(p, k, n, path="dp4a")


def test_pointwise_int8_workspace_holds_every_part():
    coop = q8.pointwise_int8_plan(49, 2304, 512)
    p, n = 49, 512
    at = coop.workspace(p, n)
    # barrier, scales, quantized rows, transposed weights, int32 partials
    assert 2 <= at.sx and at.sx + p <= at.aq and at.aq + p * coop.kp // 4 <= at.bt
    assert at.bt + n * coop.kp // 4 <= at.part and at.part + coop.splits * p * n == at.words
    assert all(v % 4 == 0 for v in (at.aq, at.bt, at.part))
    gemv = q8.pointwise_int8_plan(8, 2048, 1000)
    at = gemv.workspace(8, 1000)
    # a counter per column tile, then the int32 partials
    assert gemv.tiles <= at.part and at.part % 4 == 0 and at.words == at.part + gemv.splits * 8000
    assert q8.pointwise_int8_plan(3136, 64, 256).workspace(3136, 256).words == 0
    one = q8.pointwise_int8_plan(2, 64, 1000, path="gemv")
    assert one.splits == 1 and one.workspace(2, 1000).words == 0


def test_pointwise_int8_plan_takes_the_gemv_at_few_rows_and_follows_the_sm_count():
    for p in range(1, q8.POINTWISE_INT8_GEMV_MAX_ROWS + 1):
        assert q8.pointwise_int8_plan(p, 2048, 1000).path == "gemv"
    assert q8.pointwise_int8_plan(q8.POINTWISE_INT8_GEMV_MAX_ROWS + 1, 2048, 1000).path \
        == "cooperative"
    small, large = (q8.pointwise_int8_plan(1, 2048, 1000, sms=sms) for sms in (66, H100_SMS))
    assert small.splits == 8 and large.splits == 16 and small.blocks <= 66
    small, large = (q8.pointwise_int8_plan(49, 2304, 512, sms=sms) for sms in (66, H100_SMS))
    assert small.blocks == large.blocks // 2 and small.splits < large.splits


# The served f32 transitions (N, H, W, Cin, Cmid, Cout) and the splits of
# their reduce, mid and expand on 132 SMs (a grid of two blocks an SM): at
# N=1 every phase splits K towards a wave; at N=8 14->7 the reduce and the
# expand fill the grid with tiles and keep one range, and the walk cap of
# 512 splits the mid further than the wave asks.
SERVED_TRANSITION = {
    (1, 56, 56, 256, 128, 512): (2, 9, 2), (1, 28, 28, 512, 256, 1024): (4, 15, 4),
    (1, 14, 14, 1024, 512, 2048): (8, 29, 8), (8, 14, 14, 1024, 512, 2048): (1, 9, 1),
}


def _transition_f32_phases(n, h, w, cin, cmid, cout):
    """(P, K, N) of the reduce, the mid and the expand."""
    p1, p2 = n * h * w, n * -(-h // 2) * -(-w // 2)
    return (p1, cin, cmid), (p2, 9 * cmid, cmid), (p2, cmid + cin, cout)


@pytest.mark.parametrize("shape", sorted(SERVED_TRANSITION))
def test_transition_plan_fills_the_card(shape):
    plan = tr.transition_plan(*shape)
    splits = (plan.reduce, plan.mid, plan.expand)
    assert tuple(s.splits for s in splits) == SERVED_TRANSITION[shape]
    wave = tr.TRANSITION_BLOCKS_PER_SM * H100_SMS
    assert plan.blocks == wave and plan.args() == (wave,) + plan.reduce + plan.mid + plan.expand
    for split, (p, k, n) in zip(splits, _transition_f32_phases(*shape)):
        _covers_once(split, k, tr.TRANSITION_STEP)
        tiles = -(-p // tr.TRANSITION_TILE) * -(-n // tr.TRANSITION_TILE)
        assert split.splits <= tr.TRANSITION_MAX_SPLITS
        assert split.splits == 1 or split.chunk >= tr.TRANSITION_MIN_CHUNK
        if 2 * tiles >= wave:               # tiles fill half the grid: about a wave
            assert tiles * split.splits <= max(wave, tiles)
        else:                               # else no item walks past the cap
            assert (split.chunk <= tr.TRANSITION_MAX_WALK
                    or split.splits == tr.TRANSITION_MAX_SPLITS)
        if tiles * split.splits > max(wave, tiles):     # more items only to cap the walk
            assert -(-k // (split.splits - 1)) > tr.TRANSITION_MAX_WALK


@pytest.mark.parametrize("shape", [(3, 15, 15, 70, 20, 130), (2, 9, 8, 256, 300, 70),
                                   (3, 7, 7, 300, 40, 90), (1, 3, 3, 4, 4, 4)])
def test_transition_plan_on_ragged_shapes(shape):
    plan = tr.transition_plan(*shape)
    for split, (_, k, _) in zip((plan.reduce, plan.mid, plan.expand),
                                _transition_f32_phases(*shape)):
        _covers_once(split, k, tr.TRANSITION_STEP)


# At N=32 the tiles fill the grid and ask for no split; the sum cap still
# cuts every K longer than TRANSITION_MAX_SUM (the conv4->5 mid, 4608, in
# 3 ranges; the conv3->4 mid, 2304, in 2), which the N<=8 plans above never
# reach.
@pytest.mark.parametrize("shape,splits", [
    ((32, 56, 56, 256, 128, 512), (1, 1, 1)), ((32, 28, 28, 512, 256, 1024), (1, 2, 1)),
    ((32, 14, 14, 1024, 512, 2048), (1, 3, 1)),
])
def test_transition_plan_caps_every_sum_at_n32(shape, splits):
    plan = tr.transition_plan(*shape)
    phases = (plan.reduce, plan.mid, plan.expand)
    assert tuple(s.splits for s in phases) == splits
    for split, (_, k, _) in zip(phases, _transition_f32_phases(*shape)):
        _covers_once(split, k, tr.TRANSITION_STEP)
        assert split.chunk <= tr.TRANSITION_MAX_SUM


def test_transition_plan_follows_the_sm_count():
    shape = (1, 14, 14, 1024, 512, 2048)
    small, large = tr.transition_plan(*shape, sms=66), tr.transition_plan(*shape)
    assert small.blocks == large.blocks // 2
    assert small.reduce.splits < large.reduce.splits and small.expand.splits < large.expand.splits


# The served int8 Winograds (N, H, W, Cin, Cout) and the cooperative form's
# items: 16 positions x tile blocks of 16 x column blocks of 128; at N=1
# every item has a block of the 264-block grid to itself.
SERVED_WINOGRAD_INT8 = {
    (1, 28, 28, 128, 128): 208, (1, 14, 14, 256, 256): 128, (8, 28, 28, 128, 128): 1568,
    (8, 14, 14, 256, 256): 800,
}


@pytest.mark.parametrize("shape", sorted(SERVED_WINOGRAD_INT8))
def test_winograd_int8_plan_fills_the_card(shape):
    n, h, w, cin, cout = shape
    plan = q8.winograd_int8_plan(*shape)
    assert plan.items() == SERVED_WINOGRAD_INT8[shape]
    assert plan.kp == cin and plan.tiles == n * -(-h // 2) * -(-w // 2)
    wave = q8.WINO_INT8_BLOCKS_PER_SM * H100_SMS
    assert plan.blocks == min(plan.items(), wave)
    assert plan.chunk == plan.kp                  # one span: the served path walks no spans
    assert plan.args() == (plan.kp, q8.WINO_INT8_TILES, q8.WINO_INT8_COLS, plan.kp, plan.blocks)


# Ragged Cin (not multiples of 32 or of 4) and Cout (below one column
# block), odd maps, N=3; Cin of 256 at Cout 128 (two scale groups).
@pytest.mark.parametrize("n,h,w,cin,cout", [(3, 7, 7, 72, 96), (2, 9, 5, 256, 128),
                                            (3, 6, 5, 40, 20), (3, 7, 9, 13, 70),
                                            (1, 1, 1, 1, 1)])
def test_winograd_int8_plan_covers_ragged_shapes(n, h, w, cin, cout):
    tiles = n * -(-h // 2) * -(-w // 2)
    plan = q8.winograd_int8_plan(n, h, w, cin, cout)
    assert plan.tiles == tiles
    assert plan.kp % q8.DIRECT_INT8_K_ALIGN == 0 and cin <= plan.kp < cin + 32
    # every tile and output channel lies in one item's blocks
    assert (plan.tile_blocks - 1) * q8.WINO_INT8_TILES < tiles <= (
        plan.tile_blocks * q8.WINO_INT8_TILES)
    assert (plan.col_blocks - 1) * q8.WINO_INT8_COLS < cout <= plan.col_blocks * q8.WINO_INT8_COLS
    assert 1 <= plan.blocks == min(plan.items(), q8.WINO_INT8_BLOCKS_PER_SM * H100_SMS)
    assert q8.wino_int8_groups(256, 128) == 2 and q8.wino_int8_groups(72, 96) == 1


def test_winograd_int8_workspace_and_shared_memory():
    """The workspace holds the grid barrier and M (16, T, Cout) in f32. A
    block's shared memory (the C entry's Layout) holds one span of K and
    decides its blocks an SM."""
    plan = q8.winograd_int8_plan(8, 14, 14, 256, 256)
    assert plan.workspace_words(256) == q8.WORKSPACE_ALIGN + 16 * 392 * 256
    # V in f32, the quantized rows and columns (rows of the span + 16
    # bytes), the scales, 16-byte aligned
    rows = q8.WINO_INT8_TILES + q8.WINO_INT8_COLS
    assert q8.winograd_int8_smem(256, 1) == 16 * 256 * 4 + rows * 272 + 64
    assert q8.winograd_int8_smem(256, 2) == 16 * 256 * 4 + rows * 272 + 128
    assert plan.smem(256, 256) == q8.winograd_int8_smem(256, 1)
    assert q8.winograd_int8_plan(1, 28, 28, 256, 128).smem(256, 128) == (
        q8.winograd_int8_smem(256, 2))


# Cin past one span (WINO_INT8_CHUNK): nine 128-channel groups at Cout 128,
# the stash at Cin 2048, one group of an odd Cin, and the widest shape the
# kernel took before it walked spans (Cin 1088, one block an SM then).
@pytest.mark.parametrize("cin,cout,groups", [(1152, 128, 9), (2048, 256, 1), (1100, 64, 1),
                                             (1088, 256, 1), (4096, 128, 32)])
def test_winograd_int8_plan_walks_wide_cin_in_spans(cin, cout, groups):
    """Past WINO_INT8_CHUNK the plan stages K in spans of WINO_INT8_CHUNK, a
    multiple of the scale group: a block's shared memory stays under the
    block limit whatever Cin is, two blocks an SM fit as they do at the
    served widths, and no Cin is refused."""
    assert q8.wino_int8_groups(cin, cout) == groups
    plan = q8.winograd_int8_plan(1, 14, 14, cin, cout)
    assert plan.kp == -(-cin // 32) * 32 and plan.chunk == q8.WINO_INT8_CHUNK < plan.kp
    assert plan.chunk % q8.WINO_INT8_GROUP == 0
    smem = plan.smem(cin, cout)
    assert smem == q8.winograd_int8_smem(plan.chunk, 1 if groups == 1 else plan.chunk // 128)
    assert smem <= q8.H100_SMEM_PER_BLOCK
    assert 2 * (smem + q8.SMEM_RESERVED_PER_BLOCK) <= q8.H100_SMEM_PER_SM
    assert plan.blocks == min(plan.items(), q8.WINO_INT8_BLOCKS_PER_SM * H100_SMS)
    assert plan.args() == (plan.kp, q8.WINO_INT8_TILES, q8.WINO_INT8_COLS, plan.chunk,
                           plan.blocks)


def test_winograd_int8_plan_follows_the_sm_count():
    small, large = (q8.winograd_int8_plan(8, 28, 28, 128, 128, sms=sms) for sms in (66, H100_SMS))
    assert small.blocks == 2 * 66 and large.blocks == 2 * H100_SMS
    assert small.items() == large.items()
    few = q8.winograd_int8_plan(1, 6, 6, 64, 64, sms=H100_SMS)
    assert few.blocks == few.items() == 16 * 1 * 1                # never more blocks than items


# The served int8 basic stages (N, H, W, C) and their K split on 132 SMs:
# 4608-deep convs on 8 output tiles at N=1 split 24 ways, on 56 at N=8 4.
SERVED_BASIC_STAGE_INT8 = {(1, 7, 7, 512): 24, (8, 7, 7, 512): 4}


@pytest.mark.parametrize("shape", sorted(SERVED_BASIC_STAGE_INT8))
def test_basic_stage_int8_plan_fills_the_card(shape):
    n, h, w, c = shape
    plan = bs.basic_stage_int8_plan(*shape)
    assert plan.splits == SERVED_BASIC_STAGE_INT8[shape]
    assert plan.kp == 9 * c and plan.tiles == -(-n * h * w // 64) * -(-c // 64)
    _covers_once(plan, plan.kp, q8.DIRECT_INT8_STEP)
    wave = q8.DIRECT_INT8_BLOCKS_PER_SM * H100_SMS
    assert plan.blocks == wave
    assert plan.tiles * plan.splits <= wave and 2 * plan.tiles * plan.splits >= wave


@pytest.mark.parametrize("n,hw,c", [(3, 7, 40), (2, 5, 20), (8, 7, 36), (1, 9, 68), (1, 3, 4)])
def test_basic_stage_int8_plan_covers_k_on_ragged_shapes(n, hw, c):
    plan = bs.basic_stage_int8_plan(n, hw, hw, c)
    assert plan.kp % q8.DIRECT_INT8_K_ALIGN == 0 and 9 * c <= plan.kp < 9 * c + 32
    _covers_once(plan, plan.kp, q8.DIRECT_INT8_STEP)
    assert plan.splits == 1 or plan.chunk >= q8.DIRECT_INT8_MIN_CHUNK


def test_basic_stage_int8_plan_follows_the_sm_count():
    small, large = (bs.basic_stage_int8_plan(1, 7, 7, 512, sms=sms) for sms in (66, H100_SMS))
    assert small.blocks == large.blocks // 2 and small.splits < large.splits


# The served f32 basic stages (N, H, W, C) and their K split on 132 SMs: the
# 4608-deep convs on 8 output tiles at N=1 split 29 ways (the f32
# transition's N=1 14->7 mid, the same product), on 56 at N=8 9 (no item
# walks more than 512 of K).
SERVED_BASIC_STAGE = {(1, 7, 7, 512): 29, (8, 7, 7, 512): 9}


@pytest.mark.parametrize("shape", sorted(SERVED_BASIC_STAGE))
def test_basic_stage_plan_fills_the_card(shape):
    n, h, w, c = shape
    plan = bs.basic_stage_plan(*shape)
    assert plan.conv.splits == SERVED_BASIC_STAGE[shape]
    assert plan.args() == (plan.blocks, plan.conv.splits, plan.conv.chunk)
    _covers_once(plan.conv, 9 * c, tr.TRANSITION_STEP)
    wave = bs.BASIC_STAGE_BLOCKS_PER_SM * H100_SMS
    tiles = -(-n * h * w // tr.TRANSITION_TILE) * -(-c // tr.TRANSITION_TILE)
    assert plan.blocks == wave
    assert tiles * plan.conv.splits <= wave or plan.conv.chunk <= tr.TRANSITION_MAX_WALK
    assert 2 * tiles * plan.conv.splits >= wave


@pytest.mark.parametrize("n,hw,c", [(3, 7, 40), (2, 5, 20), (8, 7, 36), (1, 9, 68), (1, 3, 4),
                                    (2, 5, 6), (1, 7, 100)])
def test_basic_stage_plan_covers_k_on_ragged_shapes(n, hw, c):
    plan = bs.basic_stage_plan(n, hw, hw, c)
    _covers_once(plan.conv, 9 * c, tr.TRANSITION_STEP)
    assert plan.conv.splits <= tr.TRANSITION_MAX_SPLITS
    assert plan.conv.splits == 1 or plan.conv.chunk >= tr.TRANSITION_MIN_CHUNK


def test_basic_stage_plan_caps_the_sum_at_n32():
    """At N=32 the 4608-deep convs fill the grid with tiles; the sum cap
    still splits them in 3 (tests above: the N<=8 plans it leaves alone)."""
    plan = bs.basic_stage_plan(32, 7, 7, 512)
    _covers_once(plan.conv, 9 * 512, tr.TRANSITION_STEP)
    assert plan.conv.splits == 3 and plan.conv.chunk <= tr.TRANSITION_MAX_SUM


def test_basic_stage_plan_follows_the_sm_count():
    small, large = (bs.basic_stage_plan(1, 7, 7, 512, sms=sms) for sms in (66, H100_SMS))
    assert small.blocks == large.blocks // 2 and small.conv.splits < large.conv.splits
    assert bs.basic_stage_plan(8, 7, 7, 512, sms=66).blocks == 2 * 66


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

    def workspace(*args):
        calls.append(("transition_block_workspace", list(args[1:])))
        return 1
    monkeypatch.setattr(tr, "_workspace_floats", workspace)
    return calls


@pytest.mark.parametrize("sms", [H100_SMS, 66])
@pytest.mark.parametrize("p,k,n", [(1, 2048, 1000), (3136, 64, 256), (49, 2304, 512)])
def test_pointwise_int8_wrapper_launches_the_plan(monkeypatch, sms, p, k, n):
    """conv1x1_bn_int8 hands csrc/pointwise_int8.cu pointwise_int8_plan's
    path, padded K, tile, grid and split for the card's SM count (its last
    six integers)."""
    calls = _stub_launches(monkeypatch, sms)
    e = lambda *shape: torch.empty(*shape, device="meta")  # noqa: E731
    w_q = torch.empty(k, n, device="meta", dtype=torch.int8)
    q8.conv1x1_bn_int8(e(p, k), w_q, e(n), e(n), e(n), False)
    [(entry, ints)] = calls
    assert entry == "pointwise_int8_conv1x1_bn"
    assert ints[:4] == [p, k, n, 0]
    assert ints[4:] == list(q8.pointwise_int8_plan(p, k, n, sms).args())


@pytest.mark.parametrize("sms", [H100_SMS, 66])
@pytest.mark.parametrize("shape", sorted(SERVED_TRANSITION))
def test_transition_wrapper_launches_the_plan(monkeypatch, sms, shape):
    """transition_block_fused hands csrc/transition.cu transition_plan's grid
    and splits, in the workspace query and in the launch alike."""
    n, h, w, cin, cmid, cout = shape
    calls = _stub_launches(monkeypatch, sms)
    e = lambda *shape: torch.empty(*shape, device="meta")  # noqa: E731
    params = dict(w_reduce=e(cin, cmid), s_reduce=e(cmid), b_reduce=e(cmid),
                  w9_mid=e(9 * cmid, cmid), s_mid=e(cmid), b_mid=e(cmid),
                  wep=e(cmid + cin, cout), bep=e(1, cout))
    tr.transition_block_fused(e(n, h, w, cin), params)
    plan = tr.transition_plan(*shape, sms)
    [(query, q_ints), (entry, ints)] = calls
    assert (query, entry) == ("transition_block_workspace", "transition_block")
    assert q_ints == list(shape) + list(plan.args())
    assert ints == list(shape) + list(plan.args())


@pytest.mark.parametrize("sms", [H100_SMS, 66])
@pytest.mark.parametrize("shape", sorted(SERVED_WINOGRAD_INT8))
def test_winograd_int8_wrapper_launches_the_plan(monkeypatch, sms, shape):
    """conv3x3_bn_winograd_int8 hands csrc/winograd_int8.cu
    winograd_int8_plan's padded Cin, item geometry and grid for the card's
    SM count (its last four integers), after the stash flag and ReLU."""
    n, h, w, cin, cout = shape
    calls = _stub_launches(monkeypatch, sms)
    e = lambda *shape: torch.empty(*shape, device="meta")  # noqa: E731
    u_q = torch.empty(16, cin, cout, device="meta", dtype=torch.int8)
    q8.conv3x3_bn_winograd_int8(e(n, h, w, cin), u_q, e(16, cout), e(cout), e(cout), True)
    [(entry, ints)] = calls
    assert entry == "winograd_int8_conv3x3_bn"
    assert ints[:7] == [n, h, w, cin, cout, int(cout > 128), 1]
    assert ints[7:] == list(q8.winograd_int8_plan(*shape, sms).args())


@pytest.mark.parametrize("sms", [H100_SMS, 66])
@pytest.mark.parametrize("shape", sorted(SERVED_BASIC_STAGE_INT8))
def test_basic_stage_int8_wrapper_launches_the_plan(monkeypatch, sms, shape):
    """basic_stage_int8 hands csrc/basic_stage_int8.cu basic_stage_int8_plan's
    grid and split, in the workspace query and in the launch alike."""
    n, h, w, c = shape
    calls = _stub_launches(monkeypatch, sms)
    monkeypatch.setattr(bs, "_workspace_words", lambda name, entry, index, *dims: calls.append(
        (f"{entry}_workspace", list(dims))) or 1)
    e = lambda *shape: torch.empty(*shape, device="meta")  # noqa: E731
    q = {k: e(2, 1, c) for k in bs.QSTACK_KEYS}
    q["w9_a_q"] = q["w9_b_q"] = torch.empty(2, 9 * c, c, device="meta", dtype=torch.int8)
    bs.basic_stage_int8(e(n, h, w, c), q)
    plan = bs.basic_stage_int8_plan(*shape, sms)
    [(query, q_ints), (entry, ints)] = calls
    assert (query, entry) == ("basic_stage_int8_workspace", "basic_stage_int8")
    assert q_ints == [n, h, w, c, 2, plan.blocks, plan.splits, plan.chunk]
    assert ints == q_ints


@pytest.mark.parametrize("sms", [H100_SMS, 66])
@pytest.mark.parametrize("shape", sorted(SERVED_BASIC_STAGE))
def test_basic_stage_wrapper_launches_the_plan(monkeypatch, sms, shape):
    """basic_stage_fused hands csrc/basic_stage.cu basic_stage_plan's grid
    and split, in the workspace query and in the launch alike."""
    n, h, w, c = shape
    calls = _stub_launches(monkeypatch, sms)
    monkeypatch.setattr(bs, "_workspace_floats", lambda index, *dims: calls.append(
        ("basic_stage_workspace", list(dims))) or 1)
    e = lambda *shape: torch.empty(*shape, device="meta")  # noqa: E731
    stacked = {k: e(2, 1, c) for k in bs.STACK_KEYS}
    stacked["w9_a"] = stacked["w9_b"] = e(2, 9 * c, c)
    bs.basic_stage_fused(e(n, h, w, c), stacked)
    plan = bs.basic_stage_plan(*shape, sms)
    [(query, q_ints), (entry, ints)] = calls
    assert (query, entry) == ("basic_stage_workspace", "basic_stage")
    assert q_ints == [n, h, w, c, *plan.args()]
    assert ints == [n, h, w, c, 2, *plan.args()]


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
    (q8.POINTWISE_INT8_GEMV_MAX_ROWS, "pointwise_int8.cu", "kGemvMaxP"),
    (q8.POINTWISE_INT8_GEMV_COLS, "pointwise_int8.cu", "kGemvCols"),
    (q8.POINTWISE_INT8_GEMV_STEP, "pointwise_int8.cu", "kGemvStep"),
    (q8.POINTWISE_INT8_ONE_PASS_MAX_K, "pointwise_int8.cu", "kOnePassMaxK"),
    (q8.POINTWISE_INT8_PATHS.index("gemv"), "pointwise_int8.cu", "kGemv"),
    (q8.POINTWISE_INT8_PATHS.index("one_pass"), "pointwise_int8.cu", "kOnePass"),
    (q8.POINTWISE_INT8_PATHS.index("cooperative"), "pointwise_int8.cu", "kCooperative"),
    (tr.TRANSITION_TILE, "mma_tf32.cuh", "kBM"),
    (tr.TRANSITION_TILE, "mma_tf32.cuh", "kBN"),
    (tr.TRANSITION_STEP, "mma_tf32.cuh", "kBK"),
    (tr.TRANSITION_BLOCKS_PER_SM, "transition.cu", "kMaxBlocksPerSm"),
    (q8.WINO_INT8_TILES, "winograd_int8.cu", "kTiles"),
    (q8.WINO_INT8_COLS, "winograd_int8.cu", "kCols"),
    (q8.WINO_INT8_BLOCKS_PER_SM, "winograd_int8.cu", "kBlocksPerSm"),
    (q8.WINO_INT8_PAD, "winograd_int8.cu", "kPad"),
    (q8.DIRECT_INT8_BLOCKS_PER_SM, "basic_stage_int8.cu", "kBlocksPerSm"),
    (q8.WINO_INT8_CHUNK, "winograd_int8.cu", "kChunk"),
    (q8.WINO_INT8_GROUP, "winograd_int8.cu", "kGroup"),
    (bs.BASIC_STAGE_BLOCKS_PER_SM, "basic_stage.cu", "kMaxBlocksPerSm"),
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


def test_pointwise_int8_entry_checks_the_int8_geometry():
    """The int8 pointwise multiplies on mma_int8.cuh's s8 tile (the one pass
    through its warp tile, the cooperative form through its phases), splits
    the cooperative K on the tile's stage, and no longer uses gemm_int8.cuh's
    __dp4a tile."""
    src = (CSRC / "pointwise_int8.cu").read_text()
    assert '#include "mma_int8.cuh"' in src and '#include "gemm_int8.cuh"' not in src
    assert "constexpr int kSplitStep = s8::kBK;" in src
    assert "s8::mma_k32(" in src and "s8::gemm_phase(" in src


def test_transition_entry_runs_the_tf32_phases():
    """The f32 transition's three GEMMs are splitk_tf32.cuh's 3xTF32 phases,
    its grid capped at two blocks an SM; it no longer includes gemm.cuh."""
    src = (CSRC / "transition.cu").read_text()
    assert '#include "splitk_tf32.cuh"' in src and '#include "gemm.cuh"' not in src
    assert src.count("sk::gemm_phase<kVec, true>(") == 3
    assert "__launch_bounds__(tc::kThreads, kMaxBlocksPerSm)" in src
    assert "tc::Im2colA<2>{" in src


def test_basic_stage_runs_the_tf32_phases():
    """The f32 basic stage's two convs a block are splitk_tf32.cuh's 3xTF32
    phases over an implicit im2col, its grid capped at two blocks an SM;
    gemm.cuh's FFMA tile and grid_sync.cuh's scalar phase lost their last
    user and are gone."""
    src = (CSRC / "basic_stage.cu").read_text()
    assert '#include "splitk_tf32.cuh"' in src and '#include "gemm.cuh"' not in src
    assert src.count("sk::gemm_phase<kVec, true>(") == 2
    assert src.count("tc::Im2colA{") == 2
    assert "__launch_bounds__(tc::kThreads, kMaxBlocksPerSm)" in src
    assert "sk::phase_fits(" in src and "make_plan" in src and "grid_size" not in src
    assert not (CSRC / "gemm.cuh").exists()
    for gone in ("gemm_tile", "gemm_bn_tile", "kGemmSmemFloats", "Im2colCg", "PartialEpilogue",
                 "kGemmThreads", "kMaxSplits"):
        assert not any(gone in f.read_text() for f in CSRC.glob("*.c*")), gone
    sync = (CSRC / "grid_sync.cuh").read_text()
    assert "gemm_phase(" not in sync and "struct BnEpilogue" in sync


def test_winograd_int8_runs_on_the_s8_tensor_cores():
    """The int8 Winograd multiplies on s8 mma.sync (mma_int8.cuh's
    fragments), with no __dp4a left, and runs the inverse after one grid
    barrier of its one cooperative launch."""
    src = (CSRC / "winograd_int8.cu").read_text()
    assert '#include "mma_int8.cuh"' in src and "__dp4a" not in src
    assert "s8::mma(" in src and "s8::frag_a(" in src and "s8::frag_b(" in src
    assert src.count("wt::grid_sync(") == 1 and "cudaLaunchCooperativeKernel" in src


def test_basic_stage_int8_runs_the_mma_int8_phases():
    """The int8 basic stage runs mma_int8.cuh's quantize, transpose and GEMM
    phases, its split on the s8 tile's stage; gemm_int8.cuh's __dp4a tile
    has no user left and is gone."""
    src = (CSRC / "basic_stage_int8.cu").read_text()
    assert src.count("s8::quantize_rows_phase(") == 2 and src.count("s8::gemm_phase(") == 2
    assert "s8::Transpose{" in src and "constexpr int kSplitStep = s8::kBK;" in src
    gemm = (CSRC / "gemm_int8.cuh").read_text()
    assert "__dp4a" not in gemm
    for gone in ("row_scales_phase", "int8_tile", "int8_gemm_phase", "kInt8SmemBytes", "kBK8"):
        assert not any(gone in f.read_text() for f in CSRC.glob("*.c*"))
