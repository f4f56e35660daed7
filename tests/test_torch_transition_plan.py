"""The plan of csrc/transition.cu (kernels/transition.py::transition_plan)
on the wgmma phases, plain Python on the CPU (no card needed): each phase's
K split in whole stages of the wgmma tile (kBK 32), every K index once, no
range past TRANSITION_MAX_SUM, at ResNet-50's three transitions at N = 1, 8
and 32 and on ragged shapes; the plan's copy of the tile's geometry against
wgmma_tile.cuh; the phase machinery in one header (wgmma_phase.cuh) that
the transition and the stage include; and the bf16w wrapper hands its entry
the f32 plan (a stubbed launch)."""

import ctypes
import pathlib
import re

import pytest
import torch

from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.kernels import transition as tr
from winograd_tpu_torch.kernels.splitk import H100_SMS

CSRC = pathlib.Path(tr.__file__).resolve().parent.parent / "csrc"

SERVED = [(n, hw, hw, cin, cin // 2, 2 * cin) for n in (1, 8, 32)
          for hw, cin in ((56, 256), (28, 512), (14, 1024))]
RAGGED = [(3, 15, 15, 70, 20, 130), (2, 9, 8, 256, 300, 70), (3, 7, 7, 300, 40, 90),
          (1, 3, 3, 4, 4, 4)]


def _constexpr(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m, f"{name} not in {source}"
    return int(m.group(1))


def _phases(n, h, w, cin, cmid, cout):
    """(P, K, N) of the reduce, the mid and the expand with the projection."""
    p1, p2 = n * h * w, n * -(-h // 2) * -(-w // 2)
    return (p1, cin, cmid), (p2, 9 * cmid, cmid), (p2, cmid + cin, cout)


@pytest.mark.parametrize("shape", SERVED + RAGGED)
def test_splits_are_whole_stages_of_the_wgmma_tile(shape):
    """Every range but the last is a whole number of the tile's kBK stages
    (the C entry's phase_fits), the ranges cover K once, and none sums more
    than TRANSITION_MAX_SUM of K."""
    kbk = _constexpr("wgmma_tile.cuh", "kBK")
    plan = tr.transition_plan(*shape)
    assert plan.blocks == tr.TRANSITION_BLOCKS_PER_SM * H100_SMS
    for split, (_, k, _) in zip((plan.reduce, plan.mid, plan.expand), _phases(*shape)):
        assert 1 <= split.splits <= tr.TRANSITION_MAX_SPLITS
        assert split.chunk * (split.splits - 1) < k <= split.chunk * split.splits
        assert split.splits == 1 or split.chunk % kbk == 0
        assert split.chunk <= tr.TRANSITION_MAX_SUM or split.splits == tr.TRANSITION_MAX_SPLITS


@pytest.mark.parametrize("value,name", [(tr.TRANSITION_TILE, "kBM"), (tr.TRANSITION_TILE, "kBN"),
                                        (tr.TRANSITION_STEP, "kBK")])
def test_plan_geometry_is_the_wgmma_tiles(value, name):
    assert value == _constexpr("wgmma_tile.cuh", name)


def test_phase_machinery_is_one_header():
    """The items, the prefetch before a barrier and the in-order split sum
    live in wgmma_phase.cuh, which the transition, the stage and the basic
    stage include, with the host's check of a phase's plan (phase_fits);
    no kernel keeps a copy; splitk_tf32.cuh, whose gemm_phase the basic
    stage was the last to use and whose phase_fits moved here, is gone."""
    header = (CSRC / "wgmma_phase.cuh").read_text()
    for name in ("item_of", "items_of", "phase_items", "prefetch_phase", "reduce_phase",
                 "phase_fits"):
        assert re.search(rf"\b{name}\(", header), name
    for kernel in ("transition.cu", "stage.cu", "basic_stage.cu"):
        src = (CSRC / kernel).read_text()
        assert '#include "wgmma_phase.cuh"' in src
        assert "Item item_of(" not in src and "void reduce_phase(" not in src
        assert "ph::phase_fits(" in src and '#include "splitk_tf32.cuh"' not in src
    users = sorted(f.name for f in CSRC.glob("*.cu") if "gemm_phase<" in f.read_text())
    assert users == [] and not (CSRC / "splitk_tf32.cuh").exists()


@pytest.mark.parametrize("shape", SERVED[:3])
def test_bf16w_launches_its_entry_under_the_f32_plan(monkeypatch, shape):
    """bf16 weights take transition_block_bf16w under transition_plan's grid
    and splits, the same integers as the f32 entry."""
    n, h, w, cin, cmid, cout = shape
    calls = []
    monkeypatch.setattr(_build, "check_tensors", lambda *t, **k: None)
    monkeypatch.setattr(_build, "check_operands", lambda *t, **k: None)
    monkeypatch.setattr(_build, "check_bf16w", lambda *t, **k: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(_build, "ptr", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(tr, "_workspace_floats", lambda *args: 1)
    monkeypatch.setattr(_build, "launch", lambda name, entry, shape, device, *args, counter=None:
                        calls.append((entry, counter, [a.value for a in args
                                                       if isinstance(a, ctypes.c_int)])))
    e = lambda *shape, dt=torch.float32: torch.empty(*shape, device="meta", dtype=dt)  # noqa
    bf = torch.bfloat16
    params = dict(w_reduce=e(cin, cmid, dt=bf), s_reduce=e(cmid), b_reduce=e(cmid),
                  w9_mid=e(9 * cmid, cmid, dt=bf), s_mid=e(cmid), b_mid=e(cmid),
                  wep=e(cmid + cin, cout, dt=bf), bep=e(1, cout))
    tr.transition_block_fused(e(n, h, w, cin), params)
    [(entry, counter, ints)] = calls
    assert (entry, counter) == ("transition_block_bf16w", "transition_bf16w")
    assert ints == list(shape) + list(tr.transition_plan(*shape).args())
