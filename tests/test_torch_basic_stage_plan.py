"""The basic stages' host side (plain Python and PyTorch, no card needed):
csrc/basic_stage.cu's and csrc/basic_stage_int8.cu's plans on their wgmma
tiles, the int8 kernel's folded quantization and its k-contiguous weights.

* basic_stage_plan: the convs' K split in whole stages of the 3xTF32 wgmma
  tile (wgmma_tile.cuh's kBK), covering K, no walk past
  TRANSITION_MAX_SUM, filling the grid at the served shapes (ResNet-34's
  conv5_x at N = 1, 8, 32) and at odd ones.
* basic_stage_int8_plan: the same in whole stages of the s8 wgmma tile
  (wgmma_s8.cuh's kBK), one item a warpgroup at most, and every candidate
  split of tools/chip_split_sweep.py a plan the C entry takes.
* The int8 convs' scales: each im2col row's maximum from its nine pixels'
  published maxima (kernels/quantized.py::im2col_row_max, the rule the
  kernel applies) equals quantize_rows(im2col(x))'s, bit for bit, on odd
  maps, zero rows, inf and NaN.
* The stacked weights' k-contiguous copies (basic_stage_int8_kmajor)
  against w.T padded with zeros, made once per weight and kept.
* The plans' copies of the kernels' geometry equal the sources' constants,
  and the kernels' bodies have the layout the plans assume.
Inputs are made from a seed with numpy."""

import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.kernels import basic_stage as bs
from winograd_tpu_torch.kernels import quantized as q8
from winograd_tpu_torch.kernels import transition as tr
from winograd_tpu_torch.kernels.direct import direct_filter, im2col3x3
from winograd_tpu_torch.kernels.splitk import H100_SMS, split_k

CSRC = pathlib.Path(bs.__file__).resolve().parent.parent / "csrc"

# ResNet-34's conv5_x run (N, H, W, C) at the served batches, and odd shapes
# of the card tests: C off 64 and 128, not a multiple of 4 or 8, maps not 7.
SERVED = [(1, 7, 7, 512), (8, 7, 7, 512), (32, 7, 7, 512)]
ODD = [(3, 7, 7, 40), (2, 5, 5, 20), (8, 7, 7, 36), (1, 9, 9, 68), (1, 3, 3, 4), (2, 5, 5, 8),
       (1, 7, 7, 100), (4, 7, 7, 512), (1, 13, 11, 64)]


def _covers(splits: int, chunk: int, k: int, step: int) -> None:
    """[s * chunk, min(k, (s + 1) * chunk)) cover K once, every range but
    the last whole stages of `step`; one range is all of K."""
    if splits == 1:
        assert chunk == k
        return
    assert chunk % step == 0 and chunk * (splits - 1) < k <= chunk * splits


@pytest.mark.parametrize("shape", SERVED + ODD)
def test_basic_stage_plan_splits_in_whole_wgmma_stages(shape):
    n, h, w, c = shape
    plan = bs.basic_stage_plan(*shape)
    k, tiles = 9 * c, -(-n * h * w // tr.TRANSITION_TILE) * -(-c // tr.TRANSITION_TILE)
    _covers(*plan.conv, k, tr.TRANSITION_STEP)
    assert plan.blocks == bs.BASIC_STAGE_BLOCKS_PER_SM * H100_SMS
    assert plan.conv.splits <= tr.TRANSITION_MAX_SPLITS
    assert plan.conv.chunk <= tr.TRANSITION_MAX_SUM              # the f32 walk's cap (C2)
    # the grid filled: about an item a block, unless K runs out of ranges
    # (TRANSITION_MAX_SPLITS of them, or none shorter than the least chunk)
    items = tiles * plan.conv.splits
    assert 2 * items >= plan.blocks or plan.conv.splits == tr.TRANSITION_MAX_SPLITS or (
        plan.conv.chunk < tr.TRANSITION_MIN_CHUNK + tr.TRANSITION_STEP) or (
        k < 2 * tr.TRANSITION_MIN_CHUNK)


# The served f32 splits on 132 SMs: 29 ranges of 160 at N=1 (the 8 tiles
# fill 232 of the 264 blocks), 9 walks of 512 at N=8 (56 tiles), 3 ranges
# of 1536 at N=32 (200 tiles: the cap of the sum alone splits them).
@pytest.mark.parametrize("shape,splits,chunk", [
    ((1, 7, 7, 512), 29, 160), ((8, 7, 7, 512), 9, 512), ((32, 7, 7, 512), 3, 1536)])
def test_basic_stage_plan_at_the_served_shapes(shape, splits, chunk):
    assert bs.basic_stage_plan(*shape).conv == (splits, chunk)


@pytest.mark.parametrize("shape", SERVED + ODD)
def test_basic_stage_int8_plan_splits_in_whole_s8_stages(shape):
    n, h, w, c = shape
    plan = bs.basic_stage_int8_plan(*shape)
    assert plan.kp % bs.BASIC_STAGE_INT8_K_ALIGN == 0 and 9 * c <= plan.kp < 9 * c + 32
    _covers(plan.splits, plan.chunk, plan.kp, q8.STAGE_INT8_STEP)
    assert 1 <= plan.splits <= bs.BASIC_STAGE_INT8_MAX_SPLITS
    assert plan.blocks == bs.BASIC_STAGE_INT8_BLOCKS_PER_SM * H100_SMS
    assert plan.args() == (plan.blocks, plan.splits, plan.chunk)
    # K split until the items reach the warpgroups, one item each at most
    tiles = -(-n * h * w // q8.STAGE_INT8_TILE_M) * -(-c // q8.STAGE_INT8_TILE_N)
    warpgroups = q8.STAGE_INT8_WARPGROUPS * plan.blocks
    assert tiles * plan.splits <= max(tiles, warpgroups)
    fewer = -(-plan.kp // (plan.chunk + q8.STAGE_INT8_STEP))    # the next longer chunk's splits
    assert plan.splits == 1 or tiles * fewer <= warpgroups


@pytest.mark.parametrize("want", [1, 2, 4, 8, 16, 32, 64])
def test_basic_stage_int8_sweep_candidates_fit_the_entry(want):
    """tools/chip_split_sweep.py's candidates (split_k's ranges for `want`,
    at most BASIC_STAGE_INT8_MAX_SPLITS, in whole s8 stages): every one is
    a plan the C entry takes (K covered, one range all of K)."""
    for shape in SERVED + ODD:
        plan = bs.basic_stage_int8_plan(*shape)
        sp = split_k(plan.kp, min(want, bs.BASIC_STAGE_INT8_MAX_SPLITS), q8.STAGE_INT8_STEP,
                     q8.STAGE_INT8_STEP)
        _covers(sp.splits, sp.chunk, plan.kp, q8.STAGE_INT8_STEP)
        assert sp.splits <= bs.BASIC_STAGE_INT8_MAX_SPLITS


def _map(seed, n, h, w, c, special=None):
    """An (n, h, w, c) ReLU'd map scaled per pixel over six decades, pixel
    (0, 0, 0) zero; special: "inf" or "nan" at one pixel, "zero" a whole
    image row zero."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, h, w, c)) * 10.0 ** rng.integers(-3, 3, size=(n, h, w, 1))
    x[0, 0, 0] = 0.0
    if special == "inf":
        x[-1, h // 2, w - 1, c // 2] = np.inf
    elif special == "nan":
        x[0, h - 1, w // 2, c - 1] = np.nan
    elif special == "zero":
        x[0, h // 2] = 0.0
    return torch.as_tensor(x.astype(np.float32))


def _same(a, b):
    """Equal to the bit, a NaN where the other has a NaN (any payload)."""
    a, b = a.float(), b.float()
    assert a.shape == b.shape
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    assert torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


@pytest.mark.parametrize("n,h,w,c,special", [
    (1, 7, 7, 16, None), (2, 5, 9, 12, None), (1, 5, 5, 4, "zero"), (2, 6, 7, 8, "inf"),
    (1, 9, 6, 20, "nan"), (3, 1, 4, 4, None), (1, 3, 1, 8, "nan"), (2, 2, 2, 4, "inf"),
])
def test_im2col_row_max_quantizes_as_one_pass(n, h, w, c, special):
    """Each conv's row scale is the max of its nine pixels' published
    maxima, 0 for a tap outside the map (the pad-1 SAME padding): the same
    bits as quantize_rows over the whole im2col row, which the plain
    version and x's rows (taken whole by the kernel) use."""
    x = _map(n * h * w + c, n, h, w, c, special)
    rows = im2col3x3(x).reshape(-1, 9 * c)
    folded = q8.im2col_row_max(q8.abs_bits(x).amax(dim=-1))
    assert torch.equal(folded, q8.abs_bits(rows).amax(dim=-1))
    # a tile's epilogue publishes its 64 channels' maximum, atomicMax folds them
    assert torch.equal(folded, q8.im2col_row_max(q8.row_max_in_pieces(x, 64)))
    want_q, want_s = q8.quantize_rows(rows)
    got_q, got_s = q8.quantize_with_max(rows, folded)
    _same(got_s, want_s)
    _same(got_q, want_q)


def _qstack(seed, nb, c):
    rng = np.random.default_rng(seed)
    blocks = [{f"{k}_{leg}": v for leg in ("a", "b") for k, v in (
        ("w9", direct_filter(((rng.random((c, c, 3, 3)) - 0.5) * 0.2).astype(np.float32))),
        ("s", (rng.random(c) * 0.5 + 0.25).astype(np.float32)),
        ("b", (rng.random(c) - 0.5).astype(np.float32)))} for _ in range(nb)]
    return bs.quantize_basic_stage_params(blocks)


def test_kmajor_copies_are_the_transposed_weights_padded_and_kept():
    """The kernel's (B, C, Kp) weights: each block's w.T padded with zeros,
    made at a weight's first launch and kept while it lives, made anew for
    a weight changed in place; an inference tensor copied once; a stack of
    C not a multiple of 4 copied at the padded C and kept on the caller's
    own tensor, which the wrapper's padded copy is not."""
    q = _qstack(7, 2, 12)
    kt = bs.basic_stage_int8_kmajor(q, 12)
    for leg in ("w9_a", "w9_b"):
        w_q, t = q[f"{leg}_q"], kt[f"{leg}_kt"]
        assert t.dtype == torch.int8 and tuple(t.shape) == (2, 12, 128) and t.is_contiguous()
        for b in range(2):
            assert torch.equal(t[b, :, :108], w_q[b].t()) and not t[b, :, 108:].any()
    again = bs.basic_stage_int8_kmajor(q, 12)
    assert all(again[k] is kt[k] for k in kt)                     # kept, not made again
    q["w9_b_q"][1, 0, 0] = -q["w9_b_q"][1, 0, 0] - 1               # changed in place
    changed = bs.basic_stage_int8_kmajor(q, 12)
    assert changed["w9_b_kt"] is not kt["w9_b_kt"] and changed["w9_a_kt"] is kt["w9_a_kt"]
    assert torch.equal(changed["w9_b_kt"][1, :, :108], q["w9_b_q"][1].t())
    with torch.inference_mode():  # the CLI's weights: no version counter, copied once
        frozen = {k: v.clone() for k, v in q.items()}
        once = bs.basic_stage_int8_kmajor(frozen, 12)
        assert all(bs.basic_stage_int8_kmajor(frozen, 12)[k] is once[k] for k in once)
    odd = _qstack(8, 1, 6)                                         # padded to 8 channels
    made = bs.basic_stage_int8_kmajor(odd, 8)
    padded = bs.pad_basic_stage_int8(odd, 8)
    assert tuple(made["w9_a_kt"].shape) == (1, 8, 96)
    assert torch.equal(made["w9_a_kt"][0, :, :72], padded["w9_a_q"][0].t())
    assert bs.basic_stage_int8_kmajor(odd, 8)["w9_a_kt"] is made["w9_a_kt"]


def _stub(monkeypatch, sms=66):
    calls, ptrs = [], {}
    monkeypatch.setattr(_build, "check_tensors", lambda *t, **k: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: sms)
    monkeypatch.setattr(bs, "_workspace_words", lambda *a: calls.append(("ws", a)) or 1)
    monkeypatch.setattr(_build, "ptr", lambda t: ptrs.setdefault(id(t), ctypes.c_void_p(len(ptrs))))

    def launch(name, entry, shape, device, *args, counter=None):
        calls.append((entry, [a.value for a in args if isinstance(a, ctypes.c_int)], args))
    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    return calls, ptrs


@pytest.mark.parametrize("c", [512, 6])
def test_basic_stage_int8_wrapper_launches_the_plan_and_the_kmajor_weights(monkeypatch, c):
    """basic_stage_int8 hands csrc/basic_stage_int8.cu the plan's integers
    and the stack's k-contiguous copies (the ones kept on the caller's
    weights, padded where C is not a multiple of 4) in place of the
    (B, 9C, C) weights, and makes them at the first call only."""
    calls, ptrs = _stub(monkeypatch)
    meta = lambda *s, dtype=torch.float32: torch.empty(*s, device="meta", dtype=dtype)  # noqa: E731
    q = {k: meta(2, 1, c) for k in bs.QSTACK_KEYS}
    q["w9_a_q"], q["w9_b_q"] = (meta(2, 9 * c, c, dtype=torch.int8) for _ in range(2))
    bs.basic_stage_int8(meta(1, 7, 7, c), q)
    cp = -(-c // 4) * 4
    (_, ws), (entry, ints, args) = calls
    plan = bs.basic_stage_int8_plan(1, 7, 7, cp, 66)
    assert entry == "basic_stage_int8" and ints == [1, 7, 7, cp, 2, *plan.args()]
    assert ws[-3:] == plan.args()
    kt = bs.basic_stage_int8_kmajor(q, cp)
    for leg in ("w9_a", "w9_b"):
        assert tuple(kt[f"{leg}_kt"].shape) == (2, cp, -(-9 * cp // 32) * 32)
        assert ptrs[id(kt[f"{leg}_kt"])] in args and id(q[f"{leg}_q"]) not in ptrs
    bs.basic_stage_int8(meta(1, 7, 7, c), q)
    assert bs.basic_stage_int8_kmajor(q, cp)["w9_a_kt"] is kt["w9_a_kt"]


def _constexpr(source, name):
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m, f"{name} not in {source}"
    return int(m.group(1))


@pytest.mark.parametrize("value,source,name", [
    (bs.BASIC_STAGE_INT8_BLOCKS_PER_SM, "basic_stage_int8.cu", "kBlocksPerSm"),
    (bs.BASIC_STAGE_INT8_MAX_SPLITS, "basic_stage_int8.cu", "kSplitCap"),
    (bs.BASIC_STAGE_INT8_K_ALIGN, "basic_stage_int8.cu", "kKAlign"),
    (q8.STAGE_INT8_STEP, "wgmma_s8.cuh", "kBK"),
    (q8.STAGE_INT8_TILE_M, "wgmma_s8.cuh", "kBM"),
    (q8.STAGE_INT8_WARPGROUPS, "wgmma_s8.cuh", "kWarpgroups"),
    (bs.BASIC_STAGE_BLOCKS_PER_SM, "basic_stage.cu", "kMaxBlocksPerSm"),
    (tr.TRANSITION_STEP, "wgmma_tile.cuh", "kBK"),
    (tr.TRANSITION_TILE, "wgmma_tile.cuh", "kBM"),
])
def test_basic_stage_plans_match_the_kernels_geometry(value, source, name):
    assert value == _constexpr(source, name)


def test_basic_stage_runs_the_wgmma_phases():
    """csrc/basic_stage.cu: per block, two wgmma_phase.cuh phases (their
    split sums after a grid barrier), the next conv's first weight boxes
    issued before each barrier, a grid barrier between convs; no mma.sync
    phase, and splitk_tf32.cuh is gone; the plan checked (wgmma_phase.cuh's
    phase_fits, the grid against what the card holds resident)."""
    src = (CSRC / "basic_stage.cu").read_text()
    body = src[src.index("basic_stage_kernel(const"):src.index("const void* kernel_of")]
    assert body.count("ph::phase_items<kVec>(") == 2 and body.count("ph::reduce_phase(") == 2
    assert body.count("ph::prefetch_phase<kVec>(") == 2 and body.count("wt::grid_sync(") == 2
    assert "sk::gemm_phase" not in src and "mma_tile<" not in src
    assert "ph::phase_fits(" in src and "blocks > resident" in src
    assert not (CSRC / "splitk_tf32.cuh").exists() and "splitk" not in src
    assert "inline bool phase_fits(" in (CSRC / "wgmma_phase.cuh").read_text()


def test_basic_stage_int8_runs_the_folded_s8_phases():
    """csrc/basic_stage_int8.cu: x's pixel maxima and a grid barrier, then
    per block two gemm_phase calls of wgmma_s8_phase.cuh on im2col rows
    scaled from published pixel maxima (block 0's first on x's, read
    through L1), a grid barrier between convs; no weight transpose, no
    quantize phase, one memset, the weights by TMA from the k-contiguous
    copies, each conv's first boxes issued before the barrier ahead."""
    src = (CSRC / "basic_stage_int8.cu").read_text()
    body = src[src.index("basic_stage_int8_kernel(const"):src.index("int resident_blocks()")]
    assert body.count("ph::gemm_phase(") == 3 and body.count("wt::grid_sync(a.bar);") == 3
    assert "ph::Im2colSrc<1, true>{a.x," in body and body.count("ph::Im2colSrc<1>{") == 2
    assert body.count("ph::prefetch_phase(") == 3 and "pixel_max(a.x," in body
    assert "Transpose" not in src and "quantize_rows_phase" not in src
    assert '#include "mma_int8.cuh"' not in src and src.count("cudaMemsetAsync(") == 1
    assert src.count("q8::encode_kmajor(") == 2 and "blocks > resident" in src
    mma = (CSRC / "mma_int8.cuh").read_text()
    assert "RowsCg4" not in mma and "kCg" not in mma    # no user left
