"""The K-split plans of the port's redesigned GEMM kernels (plain Python, no
card needed): kernels/splitk.py::split_k, kernels/pointwise.py::split_plan
(csrc/pointwise.cu), kernels/direct.py::direct_plan (csrc/direct.cu, the pointwise MMA path's
rule) and kernels/quantized.py::direct_int8_plan (csrc/direct_int8.cu, the
int8 pointwise's cluster rule; more in tests/test_torch_direct_plan.py),
::transition_int8_plan (csrc/transition_int8.cu) and ::pointwise_int8_plan
(csrc/pointwise_int8.cu, which also picks its path),
kernels/transition.py::transition_plan (csrc/transition.cu) and
kernels/basic_stage.py::basic_stage_plan (csrc/basic_stage.cu) and
::basic_stage_int8_plan (csrc/basic_stage_int8.cu; its own tests are in
tests/test_torch_basic_stage_plan.py); and
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
# takes on 132 SMs: the heads at N=1 and N=8 (the GEMV, about a block an
# SM, a power of two of splits, one cluster a column tile) and the MMA
# tiles toward two blocks an SM, at most one cluster (CLUSTER_MAX) a tile;
# the 196 tiles of 3136 x 256 keep one range.
SERVED_POINTWISE = {
    (1, 2048, 1000): 16, (8, 2048, 1000): 16, (1, 512, 1000): 8, (8, 512, 1000): 8,
    (49, 2048, 512): 8, (49, 512, 2048): 8, (49, 2304, 512): 8, (49, 256, 512): 8,
    (196, 1152, 256): 8, (196, 128, 256): 4, (392, 2048, 512): 4, (784, 576, 128): 6,
    (784, 64, 128): 2, (3136, 64, 64): 2, (3136, 64, 256): 1,
}


@pytest.mark.parametrize("shape", sorted(SERVED_POINTWISE))
def test_pointwise_plan_fills_the_card(shape):
    p, k, n = shape
    plan = pw.split_plan(p, k, n)
    assert plan.splits == SERVED_POINTWISE[shape]
    _covers_once(plan, k, pw.SPLIT_STEP)
    assert plan.gemv == (p <= pw.GEMV_MAX_ROWS)
    if plan.gemv:
        assert plan.tile in (pw.GEMV_COLS, pw.GEMV_COLS // 2)
        assert plan.tiles == -(-n // plan.tile)
        assert plan.splits & (plan.splits - 1) == 0 and plan.splits <= pw.GEMV_CLUSTER_MAX
        wave, min_chunk = H100_SMS, pw.MIN_CHUNK
    else:
        assert plan.tiles == -(-p // pw.MMA_TILE) * -(-n // pw.MMA_TILE)
        wave, min_chunk = pw.MMA_BLOCKS_PER_SM * H100_SMS, pw.SPLIT_STEP
    assert plan.tiles * plan.splits <= max(wave, plan.tiles)
    if plan.splits == 1:   # K too short to split, or the tiles fill half a wave
        assert k < 2 * min_chunk or 2 * plan.tiles > wave
    else:                  # about one wave, K cut to the shortest ranges, or one cluster
        assert (2 * plan.tiles * plan.splits >= wave or plan.chunk == min_chunk
                or not plan.gemv and plan.splits == pw.CLUSTER_MAX)
    if not plan.gemv:      # the splits of a tile are one cluster
        assert plan.splits <= pw.CLUSTER_MAX
    assert not hasattr(plan, "workspace_words")   # on both paths: no workspace


@pytest.mark.parametrize("sms", [H100_SMS, 66, 264])
@pytest.mark.parametrize("p", [9, 49, 64, 65, 196, 392, 1000])
@pytest.mark.parametrize("k", [256, 300, 1024, 2304, 4608])
def test_pointwise_mma_plan_fits_one_cluster(p, k, sms):
    """On the MMA path (P above GEMV_MAX_ROWS) a tile's K splits are the
    blocks of one thread-block cluster: at most CLUSTER_MAX, covering K
    once, every range but the last a multiple of the tile's stage, no
    workspace; the GEMV's splits are one cluster too, a power of two of
    them, past CLUSTER_MAX only where the card holds the tiles' clusters
    at once."""
    for n in (33, 512, 1000):
        plan = pw.split_plan(p, k, n, sms)
        assert not plan.gemv and 1 <= plan.splits <= pw.CLUSTER_MAX
        _covers_once(plan, k, pw.SPLIT_STEP)
        assert plan.splits == 1 or plan.chunk % pw.SPLIT_STEP == 0
        assert not hasattr(plan, "workspace_words")
        if plan.tiles * pw.CLUSTER_MAX <= sms and k >= pw.CLUSTER_MAX * pw.MIN_CHUNK:
            assert plan.splits == pw.CLUSTER_MAX   # few tiles: a whole cluster each
    for wide in (None, 0, 8, 100):
        gemv = pw.split_plan(1, k, 1000, sms, wide)
        assert gemv.gemv and gemv.splits & (gemv.splits - 1) == 0
        assert gemv.splits <= pw.GEMV_CLUSTER_MAX and gemv.tiles * gemv.splits <= sms
        _covers_once(gemv, k, pw.SPLIT_STEP)
        if gemv.splits > pw.CLUSTER_MAX:
            assert wide is None or wide >= gemv.tiles


@pytest.mark.parametrize("p,k,n", [(1, 7, 5), (65, 130, 70), (129, 4608, 33), (9, 300, 17),
                                   (8, 4096, 4096), (4000, 4608, 2048)])
def test_pointwise_plan_and_workspace_on_ragged_shapes(p, k, n):
    """Every plan covers K once and takes no workspace; the GEMV's splits
    are a power of two, within its cluster."""
    plan = pw.split_plan(p, k, n)
    _covers_once(plan, k, pw.SPLIT_STEP)
    assert not hasattr(plan, "workspace_words") and not hasattr(pw, "pointwise_workspace_words")
    assert not hasattr(pw, "COUNTER_WORDS")
    if plan.gemv:
        assert plan.splits & (plan.splits - 1) == 0 and plan.splits <= pw.GEMV_CLUSTER_MAX


def test_pointwise_plan_follows_the_sm_count():
    small = pw.split_plan(1, 2048, 1000, sms=66)
    assert small.splits == 8 and pw.split_plan(1, 2048, 1000, sms=132).splits == 16
    # a card that does not hold the 8 tiles' clusters of 16 at once: twice
    # the tiles, half as wide, a portable cluster each (the same blocks)
    narrow = pw.split_plan(1, 2048, 1000, sms=132, wide_clusters=7)
    assert (narrow.tile, narrow.tiles, narrow.splits) == (pw.GEMV_COLS // 2, 16, 8)
    assert pw.split_plan(1, 2048, 1000, sms=132, wide_clusters=8).splits == 16
    assert pw.split_plan(392, 2048, 512, sms=66).splits == 2     # 56 tiles: 132 // 56
    assert pw.split_plan(392, 2048, 512, sms=132).splits == 4
    assert pw.split_plan(196, 1152, 256, sms=16).splits == 2     # 16 tiles: 32 // 16
    assert pw.split_plan(49, 2048, 512, sms=66).splits == pw.CLUSTER_MAX  # the cluster's cap
    assert pw.split_plan(49, 2048, 512, sms=132).splits == pw.CLUSTER_MAX


# The served f32 3x3 of csrc/direct.cu (N, H, W, Cin, Cout), 7x7x512 at N=1,
# 8 and 32, and its split on 132 SMs: 16 ways at N=1 (8 tiles fill the card
# at DIRECT_CLUSTER_MAX, a non-portable cluster), 8 at N=8 and N=32 (no block
# walks more than DIRECT_MAX_CHUNK of K).
SERVED_DIRECT = {(1, 7, 7, 512, 512): 16, (8, 7, 7, 512, 512): 8, (32, 7, 7, 512, 512): 8}


def _pow2(v: int) -> bool:
    return v > 0 and v & (v - 1) == 0


@pytest.mark.parametrize("shape", sorted(SERVED_DIRECT))
def test_direct_plan_fills_the_card(shape):
    n, h, w, cin, cout = shape
    plan = dr.direct_plan(n, h, w, cin, cout)
    assert plan.splits == SERVED_DIRECT[shape]
    assert not plan.gemv and plan.tile == pw.MMA_TILE
    _covers_once(plan, 9 * cin, pw.SPLIT_STEP)
    assert plan.tiles == -(-n * h * w // pw.MMA_TILE) * -(-cout // pw.MMA_TILE)
    assert _pow2(plan.splits) and plan.splits <= dr.DIRECT_CLUSTER_MAX   # one cluster
    assert plan.chunk <= dr.DIRECT_MAX_CHUNK                           # the walk's cap
    wave = pw.MMA_BLOCKS_PER_SM * H100_SMS
    assert 2 * plan.tiles * plan.splits >= min(wave, plan.tiles * dr.DIRECT_CLUSTER_MAX)
    assert dr.direct_plan(n, h, w, cin, cout, sms=66).splits <= plan.splits
    assert not hasattr(plan, "workspace_words")  # the splits meet in the cluster


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 5, 7, 3, 70), (1, 9, 9, 13, 65),
                                            (1, 14, 14, 256, 256), (3, 6, 6, 100, 33)])
def test_direct_plan_and_workspace_on_ragged_shapes(n, h, w, cin, cout):
    """The pointwise MMA path's tiles and split step whatever P (never the
    GEMV), a power of two of splits, and no workspace: the splits meet in
    the cluster."""
    plan = dr.direct_plan(n, h, w, cin, cout)
    k, p = 9 * cin, n * h * w
    _covers_once(plan, k, pw.SPLIT_STEP)
    assert not plan.gemv and plan.tile == pw.MMA_TILE
    assert _pow2(plan.splits) and plan.splits <= dr.DIRECT_CLUSTER_MAX
    assert not hasattr(plan, "workspace_words")


def test_direct_entry_checks_the_pointwise_geometry():
    """csrc/direct.cu launches wgmma_cluster.cuh's cluster GEMM, which
    pointwise.cu's MMA path also runs, on the stride-1 implicit im2col; its
    tile width and split step are wgmma_tile.cuh's (checked against the
    plans above), and it refuses a plan of another tile width."""
    src = (CSRC / "direct.cu").read_text()
    assert '#include "wgmma_cluster.cuh"' in src and "tile != wt::wg::kBM" in src
    assert "wgc::run<wgc::kClusterMax>(a, tc::Im2colA<1>{" in src
    assert "wgc::run<wgc::kClusterPortable>(a, tc::RowMajorA{" in (CSRC / "pointwise.cu").read_text()
    header = (CSRC / "wgmma_cluster.cuh").read_text()
    assert "chunk % wg::kBK == 0" in header and "splits <= kMax" in header
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in header


# The served int8 3x3s of csrc/direct_int8.cu (N, H, W, Cin, Cout) and
# their splits on 132 SMs under the int8 pointwise's cluster rule at up to
# DIRECT_INT8_CLUSTER_MAX splits, a power of two: ResNet-34's 7x7x512 b-leg
# 16 ways at N=1 (8 tiles 64 wide), 8 at N=8 (28 tiles 128 wide) and 2 at
# N=32, ResNet-50's 56x56x64 (49 row tiles 64 wide) 4 ways at N=1 and none
# at N=8 (392 tiles).
SERVED_DIRECT_INT8 = {
    (1, 7, 7, 512, 512): 16, (8, 7, 7, 512, 512): 8, (32, 7, 7, 512, 512): 2,
    (1, 56, 56, 64, 64): 4, (8, 56, 56, 64, 64): 1,
}


@pytest.mark.parametrize("shape", sorted(SERVED_DIRECT_INT8))
def test_direct_int8_plan_fills_the_card(shape):
    n, h, w, cin, cout = shape
    plan = q8.direct_int8_plan(n, h, w, cin, cout)
    assert plan.splits == SERVED_DIRECT_INT8[shape]
    rule = q8.pointwise_int8_plan(n * h * w, 9 * cin, cout, path="cluster",
                                  cap=q8.DIRECT_INT8_CLUSTER_MAX)
    assert (plan.path, plan.kp, plan.tile, plan.tiles) == (rule.path, rule.kp, rule.tile, rule.tiles)
    assert plan.kp == 9 * cin                     # 9 * Cin is already a multiple of 32
    _covers_once(plan, plan.kp, q8.POINTWISE_INT8_CLUSTER_STEP)
    assert plan.tiles == -(-n * h * w // 64) * -(-cout // plan.tile)
    assert plan.blocks == plan.tiles * plan.splits
    assert _pow2(plan.splits) and plan.splits <= q8.DIRECT_INT8_CLUSTER_MAX
    wave = q8.POINTWISE_INT8_CLUSTER_BLOCKS_PER_SM * H100_SMS
    assert plan.blocks <= max(wave, plan.tiles)
    assert plan.tile == (64 if cout <= 64 else plan.tile)   # no idle warpgroup at narrow N
    assert 2 * plan.blocks >= min(wave, plan.tiles * q8.DIRECT_INT8_CLUSTER_MAX)


@pytest.mark.parametrize("cin,kp", [(4, 64), (12, 128), (16, 160), (20, 192), (64, 576)])
def test_direct_int8_pads_k_to_the_mma_depth(cin, kp):
    plan = q8.direct_int8_plan(2, 5, 7, cin, 70)
    assert plan.kp == kp and plan.kp % q8.DIRECT_INT8_K_ALIGN == 0 and plan.kp >= 9 * cin
    assert plan.kp < 9 * cin + q8.DIRECT_INT8_K_ALIGN
    _covers_once(plan, plan.kp, q8.POINTWISE_INT8_CLUSTER_STEP)
    assert not hasattr(plan, "workspace")       # the cluster path takes no workspace


# The served int8 transitions (N, H, W, Cin, Cmid, Cout) and the splits of
# their reduce, mid, expand and projection on 132 SMs (one block of two
# warpgroups an SM): a phase splits K into walks of at most STAGE_INT8_WALK
# only where its tiles are fewer than an eighth of the warpgroups, so at
# N=1 the mids split (and 14->7's reduce and projection), past it none.
SERVED_TRANSITION_INT8 = {
    (1, 56, 56, 256, 128, 512): (1, 3, 1, 1),
    (1, 28, 28, 512, 256, 1024): (1, 5, 1, 1),
    (1, 14, 14, 1024, 512, 2048): (2, 9, 1, 2),
    (8, 56, 56, 256, 128, 512): (1, 1, 1, 1),
    (8, 28, 28, 512, 256, 1024): (1, 1, 1, 1),
    (8, 14, 14, 1024, 512, 2048): (1, 1, 1, 1),
    (32, 14, 14, 1024, 512, 2048): (1, 1, 1, 1),
}


def _transition_tiles(n, h, w, cin, cmid, cout):
    """Output tiles of the reduce, the mid and the last phase."""
    p1, p2 = n * h * w, n * -(-h // 2) * -(-w // 2)
    tile = q8.STAGE_INT8_TILE_M
    return (-(-p1 // tile) * -(-cmid // tile), -(-p2 // tile) * -(-cmid // tile),
            -(-p2 // tile) * -(-cout // tile))


@pytest.mark.parametrize("shape", sorted(SERVED_TRANSITION_INT8))
def test_transition_int8_plan_fills_the_card(shape):
    plan = q8.transition_int8_plan(*shape)
    phases = (plan.reduce, plan.mid, plan.expand, plan.proj)
    assert tuple(s.splits for s in phases) == SERVED_TRANSITION_INT8[shape]
    grid = q8.TRANSITION_INT8_BLOCKS_PER_SM * H100_SMS
    assert plan.blocks == grid
    reduce, mid, last = _transition_tiles(*shape)
    for split, kp, tiles in zip(phases, (plan.kpr, plan.kpm, plan.kpe, plan.kpr),
                                (reduce, mid, last, last)):
        _covers_once(split, kp, q8.STAGE_INT8_STEP)
        assert split.splits <= q8.TRANSITION_INT8_MAX_SPLITS
        few = tiles * q8.STAGE_INT8_FEW_TILES < grid * q8.STAGE_INT8_WARPGROUPS
        assert split.splits == 1 or few and split.chunk <= q8.STAGE_INT8_WALK
        assert not few or split.chunk <= q8.STAGE_INT8_WALK or kp < 2 * q8.STAGE_INT8_STEP
    assert plan.args() == (grid,) + plan.reduce + plan.mid + plan.expand + plan.proj


@pytest.mark.parametrize("shape", [(3, 15, 15, 68, 20, 130), (2, 9, 8, 256, 300, 70),
                                   (8, 7, 7, 300, 40, 90), (2, 7, 5, 8, 12, 16)])
def test_transition_int8_plan_on_ragged_shapes(shape):
    n, h, w, cin, cmid, cout = shape
    plan = q8.transition_int8_plan(*shape)
    for kp, k in ((plan.kpr, cin), (plan.kpm, 9 * cmid), (plan.kpe, cmid)):
        assert kp % q8.TRANSITION_INT8_K_ALIGN == 0 and k <= kp < k + q8.TRANSITION_INT8_K_ALIGN
    for split, kp in zip((plan.reduce, plan.mid, plan.expand, plan.proj),
                         (plan.kpr, plan.kpm, plan.kpe, plan.kpr)):
        _covers_once(split, kp, q8.STAGE_INT8_STEP)
    for walk in (128, 256, 1024):
        forced = q8.transition_int8_plan(*shape, max_walk=walk)
        for split, kp in zip((forced.reduce, forced.mid, forced.expand, forced.proj),
                             (plan.kpr, plan.kpm, plan.kpe, plan.kpr)):
            _covers_once(split, kp, q8.STAGE_INT8_STEP)
            capped = -(-kp // walk) > min(q8.TRANSITION_INT8_MAX_SPLITS, kp // q8.STAGE_INT8_STEP)
            assert split.splits == 1 or split.chunk <= max(walk, q8.STAGE_INT8_STEP) or capped


def test_transition_int8_plan_follows_the_sm_count():
    shape = (1, 14, 14, 1024, 512, 2048)
    small, large = q8.transition_int8_plan(*shape, sms=66), q8.transition_int8_plan(*shape)
    assert small.blocks == large.blocks // 2
    assert small.reduce.splits < large.reduce.splits and small.mid.splits <= large.mid.splits


# The served products of csrc/pointwise_int8.cu (P, K, N) at N=1, 8 and 32
# and the (path, tile width, split) each takes on 132 SMs: the heads at N=1
# and N=8 (one or eight rows, K 2048 or 512) on the GEMV, under the f32
# GEMV's rule; the one pass where its K fits over many rows (the
# K = 64 1x1s of ResNet-50's conv2_x entry block, and past N=1 more); every
# other product on the cluster path, 128 columns wide where those tiles
# fill the card, its K split towards two blocks an SM, at most a portable
# cluster (8).
SERVED_POINTWISE_INT8 = {
    (1, 2048, 1000): ("gemv", 128, 16), (8, 2048, 1000): ("gemv", 128, 16),
    (1, 512, 1000): ("gemv", 128, 8), (8, 512, 1000): ("gemv", 128, 8),
    (32, 2048, 1000): ("cluster", 64, 8), (32, 512, 1000): ("cluster", 64, 8),
    (3136, 64, 64): ("one_pass", 64, 1), (3136, 64, 256): ("one_pass", 64, 1),
    (25088, 64, 64): ("one_pass", 64, 1), (25088, 64, 256): ("cluster", 128, 1),
    (784, 64, 128): ("cluster", 64, 2), (196, 128, 256): ("cluster", 64, 4),
    (49, 256, 512): ("cluster", 64, 8), (6272, 64, 128): ("one_pass", 64, 1),
    (1568, 128, 256): ("one_pass", 64, 1), (392, 256, 512): ("cluster", 128, 8),
    (784, 576, 128): ("cluster", 128, 6), (196, 1152, 256): ("cluster", 64, 8),
    (49, 2304, 512): ("cluster", 64, 8), (6272, 576, 128): ("cluster", 128, 2),
    (1568, 1152, 256): ("cluster", 128, 5), (392, 2304, 512): ("cluster", 128, 8),
    (100352, 64, 64): ("one_pass", 64, 1), (100352, 64, 256): ("cluster", 128, 1),
    (25088, 64, 128): ("one_pass", 64, 1), (6272, 128, 256): ("cluster", 128, 1),
    (1568, 256, 512): ("one_pass", 64, 1),
}


def _pointwise_int8_step(plan) -> int:
    return q8.POINTWISE_INT8_GEMV_STEP if plan.path == "gemv" else q8.POINTWISE_INT8_CLUSTER_STEP


@pytest.mark.parametrize("shape", sorted(SERVED_POINTWISE_INT8))
def test_pointwise_int8_plan_fills_the_card(shape):
    p, k, n = shape
    plan = q8.pointwise_int8_plan(p, k, n)
    assert (plan.path, plan.tile, plan.splits) == SERVED_POINTWISE_INT8[shape]
    _covers_once(plan, plan.kp, _pointwise_int8_step(plan))
    if plan.path == "gemv":
        assert plan.kp == k and plan.tile in (q8.POINTWISE_INT8_GEMV_COLS,
                                              q8.POINTWISE_INT8_GEMV_COLS // 2)
        assert plan.tiles == -(-n // plan.tile) and plan.blocks == plan.tiles * plan.splits
        assert plan.blocks <= H100_SMS                       # one block an SM at most
        assert 2 * plan.blocks >= H100_SMS or plan.chunk == pw.MIN_CHUNK
        assert plan.splits & (plan.splits - 1) == 0 and plan.splits <= pw.GEMV_CLUSTER_MAX
        width, tiles, split = pw.gemv_split(k, n, H100_SMS)     # the f32 GEMV's rule
        assert (plan.tile, plan.tiles, plan.splits, plan.chunk) == (width, tiles, *split)
        return
    assert plan.kp == -(-k // 32) * 32
    assert plan.tiles == -(-p // 64) * -(-n // plan.tile) and plan.blocks == plan.tiles * plan.splits
    if plan.path == "one_pass":                              # a tile a block, K unsplit
        assert plan.kp <= q8.POINTWISE_INT8_ONE_PASS_MAX_K and plan.tile == q8.POINTWISE_INT8_TILE
        assert p >= q8.POINTWISE_INT8_ONE_PASS_ROWS and plan.splits == 1
        assert n <= 128 or p <= q8.POINTWISE_INT8_ONE_PASS_WIDE_ROWS
        return
    assert plan.path == "cluster" and plan.tile in q8.POINTWISE_INT8_CLUSTER_COLS
    assert plan.splits <= q8.POINTWISE_INT8_CLUSTER_MAX
    wave = q8.POINTWISE_INT8_CLUSTER_BLOCKS_PER_SM * H100_SMS
    assert plan.blocks <= max(wave, plan.tiles)             # two blocks an SM, or one split
    want = min(wave // plan.tiles, q8.POINTWISE_INT8_CLUSTER_MAX)   # towards that wave
    assert plan[5:] == split_k(plan.kp, want, q8.POINTWISE_INT8_CLUSTER_STEP,
                               q8.POINTWISE_INT8_CLUSTER_MIN_CHUNK)


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
        if path == "cluster":
            for want in (1, 2, 3, 5, 8):
                forced = q8.pointwise_int8_plan(p, k, n, path=path, want=want)
                _covers_once(forced, forced.kp, q8.POINTWISE_INT8_CLUSTER_STEP)
                assert forced.splits <= min(want, q8.POINTWISE_INT8_CLUSTER_MAX)
                assert forced.blocks == forced.tiles * forced.splits
    with pytest.raises(ValueError):
        q8.pointwise_int8_plan(p, k, n, path="dp4a")


def test_pointwise_int8_workspace_holds_every_part():
    """No path takes a workspace any more: the GEMV's and the cluster
    path's K splits keep their partials and maxima in the cluster's shared
    memory, the one pass has none; the C entry takes no workspace."""
    assert not hasattr(q8, "PointwiseInt8Workspace")
    for shape, path in (((8, 2048, 1000), "gemv"), ((1, 512, 1000), "gemv"),
                        ((784, 576, 128), "cluster"), ((49, 2304, 512), "cluster"),
                        ((32, 2048, 1000), "cluster"), ((3136, 64, 256), "one_pass")):
        plan = q8.pointwise_int8_plan(*shape)
        assert plan.path == path and not hasattr(plan, "workspace")
        assert path == "one_pass" or plan.splits > 1
    src = (CSRC / "pointwise_int8.cu").read_text()
    entry = src[src.index('extern "C" int pointwise_int8_conv1x1_bn('):]
    assert "ws_words" not in entry and "float* ws" not in entry


def test_pointwise_int8_plan_takes_the_gemv_at_few_rows_and_follows_the_sm_count():
    """The GEMV takes the heads: up to GEMV_MAX_ROWS rows over a K of at
    least GEMV_MIN_K; more rows, or a short K, take the cluster path; the
    GEMV still takes any P <= 8 when forced, and halves its tiles where
    the card does not hold the wide clusters at once."""
    assert q8.pointwise_int8_plan(1, 2048, 1000).path == "gemv"
    assert q8.pointwise_int8_plan(1, q8.POINTWISE_INT8_GEMV_MIN_K, 1000).path == "gemv"
    assert q8.pointwise_int8_plan(1, q8.POINTWISE_INT8_GEMV_MIN_K - 4, 1000).path == "cluster"
    for p in range(1, q8.POINTWISE_INT8_GEMV_MAX_ROWS + 1):
        assert q8.pointwise_int8_plan(p, 2048, 1000).path == "gemv"
        assert q8.pointwise_int8_plan(p, 256, 1000, path="gemv").path == "gemv"
    assert q8.pointwise_int8_plan(q8.POINTWISE_INT8_GEMV_MAX_ROWS + 1, 2048, 1000).path == "cluster"
    small, large = (q8.pointwise_int8_plan(1, 2048, 1000, sms=sms) for sms in (66, H100_SMS))
    assert small.splits == 8 and large.splits == 16 and small.blocks <= 66
    narrow = q8.pointwise_int8_plan(1, 2048, 1000, wide_clusters=7)
    assert (narrow.tile, narrow.tiles, narrow.splits, narrow.blocks) == (64, 16, 8, 128)
    small, large = (q8.pointwise_int8_plan(392, 2304, 512, sms=sms) for sms in (66, H100_SMS))
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


# The served int8 Winograds (N, H, W, Cin, Cout) and the cluster form's
# items (tile blocks x column blocks, one cluster of WINO_INT8_CLUSTER
# blocks each): (tiles an item, channels an item, items).
SERVED_WINOGRAD_INT8 = {
    (1, 28, 28, 128, 128): (8, 128, 25), (1, 14, 14, 256, 256): (8, 128, 14),
    (8, 28, 28, 128, 128): (16, 128, 98), (8, 14, 14, 256, 256): (32, 256, 13),
}


@pytest.mark.parametrize("shape", sorted(SERVED_WINOGRAD_INT8))
def test_winograd_int8_plan_fills_the_card(shape):
    n, h, w, cin, cout = shape
    plan = q8.winograd_int8_plan(*shape)
    assert (plan.item_tiles, plan.cols, plan.items()) == SERVED_WINOGRAD_INT8[shape]
    assert plan.kp == cin and plan.tiles == n * -(-h // 2) * -(-w // 2)
    assert plan.blocks == q8.WINO_INT8_CLUSTER * plan.items()
    assert plan.chunk == plan.kp                  # one span: the served path walks no spans
    assert plan.args() == (plan.kp, plan.item_tiles, plan.cols, plan.kp, plan.blocks)


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
    assert (plan.item_tiles, plan.cols) in q8.WINO_INT8_ITEMS and plan.cols == 128  # no stash
    # every tile and output channel lies in one item's blocks
    assert (plan.tile_blocks - 1) * plan.item_tiles < tiles <= plan.tile_blocks * plan.item_tiles
    assert (plan.col_blocks - 1) * plan.cols < cout <= plan.col_blocks * plan.cols
    assert plan.blocks == q8.WINO_INT8_CLUSTER * plan.tile_blocks * plan.col_blocks
    assert q8.wino_int8_groups(256, 128) == 2 and q8.wino_int8_groups(72, 96) == 1


def test_winograd_int8_workspace_and_shared_memory():
    """The cluster form takes no workspace: M stays in the cluster's shared
    memory. A block's shared memory (the C entry's Layout) holds, for each
    of its two positions, the two weight slots, the quantized rows, V or M
    and the scales, and decides its blocks an SM."""
    plan = q8.winograd_int8_item(8, 14, 14, 256, 256, 32, 256)
    assert not hasattr(plan, "workspace_words")
    # 32 tiles x 256 channels, K 256 in one span, one scale a row: slots
    # 2 x 256 x 128, rows 2 x 32 x 128, V 32 x 256 x 4 (M 32 x 260 x 4 is
    # larger), scales 32 x 4; each warpgroup's part 1024-aligned
    wgp = -(-(2 * 256 * 128 + 2 * 32 * 128 + 32 * 260 * 4 + 32 * 4) // 1024) * 1024
    assert q8.winograd_int8_smem(32, 256, 256, 1) == 1024 + 2 * wgp
    assert plan.smem(256, 256) == q8.winograd_int8_smem(32, 256, 256, 1)
    assert q8.winograd_int8_plan(1, 28, 28, 256, 128).smem(256, 128) == (
        q8.winograd_int8_smem(8, 128, 256, 2))


# Cin past one span (WINO_INT8_CHUNK): nine 128-channel groups at Cout 128,
# the stash at Cin 2048, one group of an odd Cin, and the widest shape the
# kernel took before it walked spans (Cin 1088).
@pytest.mark.parametrize("cin,cout,groups", [(1152, 128, 9), (2048, 256, 1), (1100, 64, 1),
                                             (1088, 256, 1), (4096, 128, 32)])
def test_winograd_int8_plan_walks_wide_cin_in_spans(cin, cout, groups):
    """Past WINO_INT8_CHUNK the plan stages K in spans of at most
    WINO_INT8_CHUNK, a multiple of the scale group: a block's shared memory
    stays under the block limit whatever Cin is, and no Cin is refused."""
    assert q8.wino_int8_groups(cin, cout) == groups
    plan = q8.winograd_int8_plan(1, 14, 14, cin, cout)
    assert plan.kp == -(-cin // 32) * 32 and plan.chunk <= q8.WINO_INT8_CHUNK < plan.kp
    assert plan.chunk % q8.WINO_INT8_GROUP == 0
    smem = plan.smem(cin, cout)
    assert smem == q8.winograd_int8_smem(plan.item_tiles, plan.cols, plan.chunk,
                                         1 if groups == 1 else plan.chunk // 128)
    assert smem <= q8.H100_SMEM_PER_BLOCK
    assert plan.blocks == q8.WINO_INT8_CLUSTER * plan.items()
    assert plan.args() == (plan.kp, plan.item_tiles, plan.cols, plan.chunk, plan.blocks)


def test_winograd_int8_plan_follows_the_sm_count():
    """Half the SMs want half the items: the plan keeps the larger items
    longer."""
    small, large = (q8.winograd_int8_plan(1, 28, 28, 128, 128, sms=sms) for sms in (66, H100_SMS))
    assert small.items() >= 66 // q8.WINO_INT8_CLUSTER and small.item_tiles > large.item_tiles
    few = q8.winograd_int8_plan(1, 6, 6, 64, 64, sms=H100_SMS)
    assert few.items() == 2 and few.item_tiles == 8   # the most items, the fewest tiles an item


# The served int8 basic stages (N, H, W, C) and their K split on 132 SMs:
# the 4608-deep convs on 8 output tiles at N=1 split into 12 ranges of 384
# (16 wanted: at most BASIC_STAGE_INT8_MAX_SPLITS), on 56 at N=8 into 4
# (224 items for 264 warpgroups), on 200 at N=32 not at all.
SERVED_BASIC_STAGE_INT8 = {(1, 7, 7, 512): 12, (8, 7, 7, 512): 4, (32, 7, 7, 512): 1}


@pytest.mark.parametrize("shape", sorted(SERVED_BASIC_STAGE_INT8))
def test_basic_stage_int8_plan_fills_the_card(shape):
    n, h, w, c = shape
    plan = bs.basic_stage_int8_plan(*shape)
    assert plan.splits == SERVED_BASIC_STAGE_INT8[shape]
    assert plan.kp == 9 * c and plan.args() == (plan.blocks, plan.splits, plan.chunk)
    _covers_once(plan, plan.kp, q8.STAGE_INT8_STEP)
    assert plan.blocks == bs.BASIC_STAGE_INT8_BLOCKS_PER_SM * H100_SMS
    tiles = -(-n * h * w // q8.STAGE_INT8_TILE_M) * -(-c // q8.STAGE_INT8_TILE_N)
    warpgroups = q8.STAGE_INT8_WARPGROUPS * plan.blocks
    assert tiles * plan.splits <= warpgroups               # one item a warpgroup, at most
    # and no chunk a stage shorter keeps to that and to the cap
    more = -(-plan.kp // (plan.chunk - q8.STAGE_INT8_STEP))
    assert more > bs.BASIC_STAGE_INT8_MAX_SPLITS or tiles * more > warpgroups


@pytest.mark.parametrize("n,hw,c", [(3, 7, 40), (2, 5, 20), (8, 7, 36), (1, 9, 68), (1, 3, 4)])
def test_basic_stage_int8_plan_covers_k_on_ragged_shapes(n, hw, c):
    plan = bs.basic_stage_int8_plan(n, hw, hw, c)
    assert plan.kp % bs.BASIC_STAGE_INT8_K_ALIGN == 0 and 9 * c <= plan.kp < 9 * c + 32
    _covers_once(plan, plan.kp, q8.STAGE_INT8_STEP)
    assert plan.splits <= bs.BASIC_STAGE_INT8_MAX_SPLITS
    assert plan.splits > 1 or plan.chunk == plan.kp    # the C entry takes one range as all of K


def test_basic_stage_int8_plan_follows_the_sm_count():
    """At N=4 (32 tiles) a card of 132 SMs has warpgroups to spare for a
    split, one of 66 has not; the grid is one block an SM either way."""
    small, large = (bs.basic_stage_int8_plan(4, 7, 7, 512, sms=sms) for sms in (66, H100_SMS))
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
    assert len(ints) == 12            # no workspace: the cluster form has none


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
    (pw.GEMV_MAX_ROWS, "gemv_cluster.cuh", "kMaxP"),
    (pw.GEMV_COLS, "pointwise.cu", "kGemvCols"),
    (pw.GEMV_CLUSTER_MAX, "gemv_cluster.cuh", "kClusterMax"),
    (pw.SPLIT_STEP, "gemv_cluster.cuh", "kStep"),
    (pw.CLUSTER_MAX, "wgmma_cluster.cuh", "kClusterPortable"),
    (dr.DIRECT_CLUSTER_MAX, "wgmma_cluster.cuh", "kClusterMax"),
    (pw.MMA_TILE, "wgmma_tile.cuh", "kBM"),
    (pw.MMA_TILE, "wgmma_tile.cuh", "kBN"),
    (pw.SPLIT_STEP, "wgmma_tile.cuh", "kBK"),
    (pw.MMA_TILE, "mma_tf32.cuh", "kBM"),
    (pw.SPLIT_STEP, "mma_tf32.cuh", "kBK"),
    (q8.DIRECT_INT8_K_ALIGN, "mma_int8.cuh", "kKAlign"),
    (q8.POINTWISE_INT8_TILE, "mma_int8.cuh", "kBM"),
    (q8.TRANSITION_INT8_BLOCKS_PER_SM, "transition_int8.cu", "kBlocksPerSm"),
    (q8.TRANSITION_INT8_MAX_SPLITS, "transition_int8.cu", "kSplitCap"),
    (q8.TRANSITION_INT8_K_ALIGN, "transition_int8.cu", "kKAlign"),
    (q8.POINTWISE_INT8_GEMV_MAX_ROWS, "gemv_cluster.cuh", "kMaxP"),
    (q8.POINTWISE_INT8_GEMV_COLS, "pointwise_int8.cu", "kGemvCols"),
    (q8.POINTWISE_INT8_GEMV_STEP, "gemv_cluster.cuh", "kStep"),
    (q8.POINTWISE_INT8_ONE_PASS_MAX_K, "pointwise_int8.cu", "kOnePassMaxK"),
    (q8.POINTWISE_INT8_CLUSTER_MAX, "wgmma_s8_cluster.cuh", "kClusterPortable"),
    (q8.DIRECT_INT8_CLUSTER_MAX, "wgmma_s8_cluster.cuh", "kClusterMax"),
    (q8.POINTWISE_INT8_CLUSTER_STEP, "wgmma_s8_cluster.cuh", "kClusterStep"),
    (q8.POINTWISE_INT8_TILE, "wgmma_s8.cuh", "kBM"),
    (q8.POINTWISE_INT8_TILE, "wgmma_s8.cuh", "kBN"),
    (q8.POINTWISE_INT8_PATHS.index("gemv"), "pointwise_int8.cu", "kGemv"),
    (q8.POINTWISE_INT8_PATHS.index("one_pass"), "pointwise_int8.cu", "kOnePass"),
    (q8.POINTWISE_INT8_PATHS.index("cluster"), "pointwise_int8.cu", "kCluster"),
    (tr.TRANSITION_TILE, "wgmma_tile.cuh", "kBM"),
    (tr.TRANSITION_TILE, "wgmma_tile.cuh", "kBN"),
    (tr.TRANSITION_STEP, "wgmma_tile.cuh", "kBK"),
    (tr.TRANSITION_BLOCKS_PER_SM, "transition.cu", "kMaxBlocksPerSm"),
    (q8.WINO_INT8_CLUSTER, "winograd_int8.cu", "kCluster"),
    (q8.WINO_INT8_STEP, "winograd_int8.cu", "kBK"),
    (q8.H100_SMEM_PER_BLOCK, "winograd_int8.cu", "kMaxSmem"),
    (2, "winograd_int8.cu", "kWarpgroups"),
    (bs.BASIC_STAGE_INT8_BLOCKS_PER_SM, "basic_stage_int8.cu", "kBlocksPerSm"),
    (q8.WINO_INT8_CHUNK, "winograd_int8.cu", "kChunk"),
    (q8.WINO_INT8_GROUP, "winograd_int8.cu", "kGroup"),
    (bs.BASIC_STAGE_BLOCKS_PER_SM, "basic_stage.cu", "kMaxBlocksPerSm"),
])
def test_plans_match_the_kernels_geometry(value, source, name):
    assert value == _constexpr(source, name)


def test_transition_int8_entry_checks_the_int8_geometry():
    """The transition's C entry refuses a K split off the s8 wgmma tile's
    stage and a grid larger than its blocks an SM hold; its phases are the
    folded s8 wgmma phases (no mma_int8.cuh, no weight transpose and no
    quantize phase in the launch)."""
    src = (CSRC / "transition_int8.cu").read_text()
    assert "g.chunk % q8::kBK == 0" in src and "g.splits <= kSplitCap" in src
    assert "__launch_bounds__(q8::kThreads, kBlocksPerSm)" in src
    assert "blocks > resident" in src and "cudaLaunchCooperativeKernel" in src
    assert '#include "gemm_int8.cuh"' not in src and '#include "mma_int8.cuh"' not in src
    assert '#include "wgmma_s8_phase.cuh"' in src and src.count("ph::gemm_phase(") == 2
    assert "Transpose" not in src and "quantize_rows_phase" not in src


def test_pointwise_int8_entry_checks_the_int8_geometry():
    """The int8 pointwise's P > 8 products are wgmma_s8_cluster.cuh's s8
    wgmma tiles whose K splits are one thread-block cluster (no cooperative
    launch, grid barrier or workspace), split on the wgmma k step; the one
    pass keeps mma_int8.cuh's warp tile; gemm_int8.cuh's __dp4a tile is not
    included."""
    src = (CSRC / "pointwise_int8.cu").read_text()
    header = (CSRC / "wgmma_s8_cluster.cuh").read_text()
    assert '#include "mma_int8.cuh"' in src and '#include "gemm_int8.cuh"' not in src
    assert '#include "wgmma_s8_cluster.cuh"' in src and '#include "cluster.cuh"' in header
    assert "q8::wgmma_s8(" in header and "cudaLaunchAttributeClusterDimension" in header
    assert "chunk % kClusterStep != 0" in header and "splits > kMax" in header
    assert "sc::run<sc::kClusterPortable>(" in src and "sc::XRows{x, P, K}" in src
    for text in (src, header):
        assert "cudaLaunchCooperativeKernel" not in text and "grid_sync" not in text
    assert "s8::mma_k32(" in src and "s8::gemm_phase(" not in src


def test_gemvs_run_in_one_cluster():
    """Both GEMVs (pointwise.cu at f32 and bf16w, pointwise_int8.cu) run a
    column tile's K splits as one thread-block cluster on
    gemv_cluster.cuh: weights by 1D bulk copies onto mbarriers, partials
    pushed through distributed shared memory to their owners (once every
    block has started) and added there in rank order, no workspace, memset,
    atomics or fence through device memory."""
    header = (CSRC / "gemv_cluster.cuh").read_text()
    assert "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes" in header
    assert "cudaLaunchAttributeClusterDimension" in header and "store_rank_u32(" in header
    assert "cudaOccupancyMaxActiveClusters" in header and "cp.async.bulk.tensor" not in header
    assert "for (int q = 1; q < splits; ++q) s += recv[q * per + j];" in header
    for name in ("pointwise.cu", "pointwise_int8.cu"):
        src = (CSRC / name).read_text()
        assert '#include "gemv_cluster.cuh"' in src and '#include "splitk_tf32.cuh"' not in src
        for gone in ("cudaMemsetAsync", "atomicAdd", "__threadfence", "ws_words", "__ldcg"):
            assert gone not in src, (name, gone)
        gemv = src[src.index("__launch_bounds__(gv::kThreads)"):]
        assert gemv.count("wt::cluster_sync();") == (1 if name == "pointwise.cu" else 2)
        assert "gv::walk<kVec, kGemvXChunk>(" in gemv and "slab.begin();" in gemv
        assert gemv.count("wt::cluster_arrive_relaxed();") == gemv.count("wt::cluster_wait();") == 1
        assert gemv.index("wt::cluster_wait();") < gemv.index("store_rank_u32(" if "int8" in name
                                                                else "gv::push(")
        assert "gv::push(recv," in gemv and "gv::gather(recv," in gemv
    for text in (header, *(f.read_text() for f in CSRC.glob("*.c*"))):
        assert "splitk_tf32" not in text and "arrive_last" not in text
        assert "reduce_splits" not in text and "bind_workspace" not in text


@pytest.mark.parametrize("name,kernel", [("pointwise.cu", "pointwise_gemv"),
                                         ("pointwise_int8.cu", "pointwise_int8_gemv")])
def test_gemv_is_one_instantiation_for_every_cluster_size(name, kernel):
    """A GEMV kernel is instantiated per weight route and tile width only:
    every cluster size of the plan, up to gemv_cluster.cuh's kClusterMax,
    launches the same kernel, whose launch sets the non-portable cluster
    opt-in once (it allows more than 8 blocks and changes nothing for 8 or
    fewer)."""
    src = (CSRC / name).read_text()
    header = (CSRC / "gemv_cluster.cuh").read_text()
    assert "template <bool kVec, int kCols" in src and not re.search(r"\bkMax\b", src)
    assert src.count(f"gv::launch<&{kernel}<") == 2
    assert "template <auto kKernel, class Args>" in header
    assert not re.search(r"\bkMax\b", header)
    launch = header[header.index("template <auto kKernel, class Args>"):]
    assert "if (e == cudaSuccess)\n      e = cudaFuncSetAttribute(kernel, " \
           "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);" in launch
    assert "gv::plan_fits(P, K, N, splits, chunk)" in src and "splits <= kClusterMax" in header


def test_transition_entry_runs_the_tf32_phases():
    """The f32 transition's three GEMMs are wgmma_phase.cuh's phases on the
    wgmma tile (3xTF32 wgmma, weights by TMA), its grid capped at two blocks
    an SM; splitk_tf32.cuh's gemm_phase is no longer its."""
    src = (CSRC / "transition.cu").read_text()
    assert '#include "wgmma_phase.cuh"' in src and '#include "gemm.cuh"' not in src
    assert src.count("ph::phase_items<kVec>(") == 3 and "gemm_phase" not in src
    assert "__launch_bounds__(wg::kThreads, kMaxBlocksPerSm)" in src
    assert "tc::Im2colA<2>{" in src and src.count("wg::encode_weights(") == 3


def test_basic_stage_runs_the_tf32_phases():
    """The f32 basic stage's two convs a block are wgmma_phase.cuh's 3xTF32
    wgmma phases over an implicit im2col (weights by TMA), its grid capped
    at two blocks an SM; splitk_tf32.cuh lost its last users and is gone
    (phase_fits moved into wgmma_phase.cuh), as are gemm.cuh's FFMA tile
    and grid_sync.cuh's scalar phase."""
    src = (CSRC / "basic_stage.cu").read_text()
    assert '#include "wgmma_phase.cuh"' in src and '#include "gemm.cuh"' not in src
    assert src.count("ph::phase_items<kVec>(") == 2 and "gemm_phase" not in src
    assert src.count("tc::Im2colA{") == 2 and src.count("wg::encode_weights(") == 2
    assert "__launch_bounds__(wg::kThreads, kMaxBlocksPerSm)" in src
    assert not (CSRC / "splitk_tf32.cuh").exists()
    assert "inline bool phase_fits(" in (CSRC / "wgmma_phase.cuh").read_text()
    assert "ph::phase_fits(" in src and "make_plan" in src and "grid_size" not in src
    assert not (CSRC / "gemm.cuh").exists()
    for gone in ("gemm_tile", "gemm_bn_tile", "kGemmSmemFloats", "Im2colCg", "PartialEpilogue",
                 "kGemmThreads", "kMaxSplits"):
        assert not any(gone in f.read_text() for f in CSRC.glob("*.c*")), gone
    sync = (CSRC / "grid_sync.cuh").read_text()
    assert "gemm_phase(" not in sync and "struct BnEpilogue" in sync


def test_winograd_int8_runs_on_the_s8_tensor_cores():
    """The int8 Winograd multiplies on s8 wgmma.mma_async (no mma.sync
    m16n8k32 and no __dp4a left) and runs the inverse behind a cluster
    barrier of its one launch: no grid barrier, no cooperative launch, no
    memset."""
    src = (CSRC / "winograd_int8.cu").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n" in src and ".s32.s8.s8" in src
    assert "__dp4a" not in src and "s8::mma(" not in src and "s8::frag_a(" not in src
    assert "grid_sync(" not in src and "cudaLaunchCooperativeKernel" not in src
    assert "cudaMemsetAsync" not in src and "cudaLaunchAttributeClusterDimension" in src
    assert src.count("cluster_sync();") == 2


def test_basic_stage_int8_runs_the_mma_int8_phases():
    """The int8 basic stage left mma_int8.cuh's quantize, transpose and
    GEMM phases for wgmma_s8_phase.cuh's folded s8 wgmma phases (no
    transpose, no quantize phase), its split on the s8 wgmma tile's stage;
    gemm_int8.cuh's __dp4a tile has no user left and is gone."""
    src = (CSRC / "basic_stage_int8.cu").read_text()
    assert '#include "mma_int8.cuh"' not in src and '#include "wgmma_s8_phase.cuh"' in src
    assert src.count("ph::gemm_phase(") == 3 and "quantize_rows_phase" not in src
    assert "Transpose" not in src and "chunk % q8::kBK == 0" in src
    gemm = (CSRC / "gemm_int8.cuh").read_text()
    assert "__dp4a" not in gemm
    for gone in ("row_scales_phase", "int8_tile", "int8_gemm_phase", "kInt8SmemBytes", "kBK8"):
        assert not any(gone in f.read_text() for f in CSRC.glob("*.c*"))
