"""The plan of csrc/stage.cu (kernels/stage.py::stage_plan), plain Python on
the CPU (no card needed): its grid, and each GEMM phase's K split for the
wgmma tile, at the served stages at N = 1, 8 and 32 and on ragged shapes;
its constants against the kernel's; and the wrapper hands the C entry the
plan (a stubbed launch)."""

import ctypes
import pathlib
import re

import pytest
import torch

from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.kernels import stage as st
from winograd_tpu_torch.kernels.splitk import H100_SMS

CSRC = pathlib.Path(st.__file__).resolve().parent.parent / "csrc"

# The served stages (N, H, W, Cio, Cmid): ResNet-50's conv2_x to conv5_x.
SERVED = [(56, 256, 64), (28, 512, 128), (14, 1024, 256), (7, 2048, 512)]


def _tiles(p, n):
    return -(-p // st.STAGE_TILE) * -(-n // st.STAGE_TILE)


def _walk(p, n, grid, max_walk=st.STAGE_MAX_WALK, full_walk=st.STAGE_FULL_WALK):
    """The walk cap of a phase: max_walk while its tiles leave blocks idle,
    full_walk once they fill the grid."""
    return max_walk if _tiles(p, n) < grid else full_walk


def _check_phase(split, p, k, n, grid, max_walk=st.STAGE_MAX_WALK,
                 full_walk=st.STAGE_FULL_WALK):
    """K in `splits` ranges of `chunk` covering it once, each but the last
    a multiple of the tile's stage and at least STAGE_MIN_CHUNK, at most
    STAGE_MAX_SPLITS; split only toward one item a block or to cap a walk."""
    splits, chunk = split
    walk = _walk(p, n, grid, max_walk, full_walk)
    assert 1 <= splits <= st.STAGE_MAX_SPLITS
    assert chunk * splits >= k and chunk * (splits - 1) < k
    if splits == 1:
        assert chunk == k
        return
    assert chunk % st.STAGE_STEP == 0 and chunk >= st.STAGE_MIN_CHUNK
    want = max(grid // _tiles(p, n), -(-k // walk))
    assert splits <= want
    # No shorter chunk of the tile's stage would reach the wanted splits
    # within the caps (the rule cuts as far as it is asked, no further).
    assert splits == min(want, k // st.STAGE_MIN_CHUNK, st.STAGE_MAX_SPLITS) or \
        -(-k // (chunk - st.STAGE_STEP)) > min(want, k // st.STAGE_MIN_CHUNK, st.STAGE_MAX_SPLITS)


@pytest.mark.parametrize("n", [1, 8, 32])
@pytest.mark.parametrize("hw,cio,cmid", SERVED)
def test_stage_plan_covers_k_at_the_served_stages(n, hw, cio, cmid):
    plan = st.stage_plan(n, hw, hw, cio, cmid)
    assert plan.grid == st.STAGE_BLOCKS_PER_SM * H100_SMS
    p = n * hw * hw
    for split, (k, cols) in zip((plan.reduce, plan.mid, plan.expand),
                                ((cio, cmid), (9 * cmid, cmid), (cmid, cio))):
        _check_phase(split, p, k, cols, plan.grid)
    assert plan.phases() == (*plan.reduce, *plan.mid, *plan.expand)


@pytest.mark.parametrize("n", [1, 8, 32])
def test_stage_plan_caps_every_walk(n):
    """No item walks more than its phase's cap of K (STAGE_MAX_WALK while
    the tiles leave blocks idle, STAGE_FULL_WALK once they fill the grid)
    where the splits and the shortest chunk allow it."""
    for hw, cio, cmid in SERVED:
        plan = st.stage_plan(n, hw, hw, cio, cmid)
        p = n * hw * hw
        for split, k, cols in zip((plan.reduce, plan.mid, plan.expand),
                                  (cio, 9 * cmid, cmid), (cmid, cmid, cio)):
            walk = _walk(p, cols, plan.grid)
            if k // st.STAGE_MIN_CHUNK >= -(-k // walk) and \
                    -(-k // walk) <= st.STAGE_MAX_SPLITS:
                assert split.chunk <= walk + st.STAGE_STEP


@pytest.mark.parametrize("n,h,w,cio,cmid", [(2, 7, 7, 40, 12), (1, 9, 5, 1000, 300),
                                            (3, 6, 6, 100, 33), (1, 1, 1, 4096, 1024),
                                            (64, 7, 7, 2048, 512)])
@pytest.mark.parametrize("walk", [256, st.STAGE_MAX_WALK, 4096])
def test_stage_plan_on_ragged_shapes(n, h, w, cio, cmid, walk):
    for sms in (H100_SMS, 66, 16):
        plan = st.stage_plan(n, h, w, cio, cmid, sms, walk, 4 * walk)
        assert plan.grid == st.STAGE_BLOCKS_PER_SM * sms
        p = n * h * w
        for split, (k, cols) in zip((plan.reduce, plan.mid, plan.expand),
                                    ((cio, cmid), (9 * cmid, cmid), (cmid, cio))):
            _check_phase(split, p, k, cols, plan.grid, walk, 4 * walk)


def test_stage_plan_follows_the_sm_count():
    small, large = (st.stage_plan(1, 14, 14, 1024, 256, sms) for sms in (33, H100_SMS))
    assert small.grid < large.grid
    assert small.reduce.splits <= large.reduce.splits
    assert small.mid.splits <= large.mid.splits


def _constexpr(source, name):
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m, f"{name} not in {source}"
    return int(m.group(1))


@pytest.mark.parametrize("value,source,name", [
    (st.STAGE_BLOCKS_PER_SM, "stage.cu", "kMaxBlocksPerSm"),
    (st.STAGE_TILE, "wgmma_tile.cuh", "kBM"),
    (st.STAGE_TILE, "wgmma_tile.cuh", "kBN"),
    (st.STAGE_STEP, "wgmma_tile.cuh", "kBK"),
])
def test_stage_plan_matches_the_kernels_geometry(value, source, name):
    assert value == _constexpr(source, name)


def test_stage_runs_its_gemm_phases_on_the_wgmma_tile():
    """stage.cu's reduce, direct mid and expand are wgmma_tile.cuh's tiles
    (wgmma, TMA weight loads), its split step the tile's stage, the next
    phase's weights issued before the barrier; the F(2,3) mid stays on
    wino_tf32.cuh, its products on the same wgmma tile, the u2 filters by
    TMA; pointwise.cu's MMA path (wgmma_cluster.cuh) is the same tile, its
    splits one cluster, with no memset before its launch."""
    src = (CSRC / "stage.cu").read_text()
    assert '#include "wgmma_tile.cuh"' in src and "sk::gemm_phase" not in src
    assert src.count("ph::phase_fits(") == 3 and "splitk" not in src
    assert "constexpr int kSplitStep = wg::kBK;" in (CSRC / "wgmma_phase.cuh").read_text()
    assert src.count("phase_items<kVec>(") == 3 and src.count("prefetch_phase<kVec>(") == 3
    assert "wtc::phase<2, kVec, true>(" in src
    assert "encode_weights(&a.map_u, wm, 16 * B, Cmid, Cmid)" in src
    wino = (CSRC / "wino_tf32.cuh").read_text()
    assert "wg::tile<kVec, true>(" in wino and "mma_tile<" not in wino
    tile = (CSRC / "wgmma_tile.cuh").read_text()
    for ptx in ("wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32",
                "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16",
                "cp.async.bulk.tensor.3d", "mbarrier.try_wait.parity"):
        assert ptx in tile
    pw = (CSRC / "pointwise.cu").read_text()
    # the MMA path, in wgmma_cluster.cuh since csrc/direct.cu runs it too
    mma = (CSRC / "wgmma_cluster.cuh").read_text()
    assert '#include "wgmma_cluster.cuh"' in pw and "wgc::run<" in pw
    assert "wg::tile<kVec, false, kPipe<BT>>(" in mma
    assert "cudaLaunchAttributeClusterDimension" in mma
    assert "cluster_sync();" in mma and "load_rank(" in mma  # csrc/cluster.cuh's
    cluster = (CSRC / "cluster.cuh").read_text()
    assert "mapa.shared::cluster" in cluster and "barrier.cluster.arrive" in cluster
    assert '#include "cluster.cuh"' in mma and "mapa.shared::cluster" not in mma + pw
    assert "cudaMemsetAsync" not in mma and "bind_workspace" not in mma


def test_stage_wrapper_launches_the_plan(monkeypatch):
    """resnet_stage_fused hands csrc/stage.cu stage_plan's grid (the last
    integer) and phases (an int array) for the card's SM count, in the
    workspace query and the launch alike."""
    calls = []
    monkeypatch.setattr(_build, "check_tensors", lambda *t, **k: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: 66)
    monkeypatch.setattr(_build, "ptr", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(st, "_workspace_floats", lambda *a: calls.append(("ws", a)) or 1)

    def launch(name, entry, shape, device, *args, counter=None):
        arrays = [list(a) for a in args if isinstance(a, ctypes.Array)]
        ints = [a.value for a in args if isinstance(a, ctypes.c_int)]
        calls.append((entry, ints, arrays))
    monkeypatch.setattr(_build, "launch", launch)
    e = lambda *shape: torch.empty(*shape, device="meta")  # noqa: E731
    cio, cmid = 1024, 256
    stacked = dict(w_reduce=e(3, cio, cmid), s_reduce=e(3, 1, cmid), b_reduce=e(3, 1, cmid),
                   w9_mid=e(3, 9 * cmid, cmid), s_mid=e(3, 1, cmid), b_mid=e(3, 1, cmid),
                   w_expand=e(3, cmid, cio), s_expand=e(3, 1, cio), b_expand=e(3, 1, cio))
    st.resnet_stage_fused(e(8, 14, 14, cio), stacked, "direct")
    plan = st.stage_plan(8, 14, 14, cio, cmid, 66)
    [(what, query), (entry, ints, arrays)] = calls
    assert what == "ws" and entry == "resnet_stage"
    assert query[-2:] == (plan.grid, plan.phases())
    assert ints[-1] == plan.grid and arrays == [list(plan.phases())]
