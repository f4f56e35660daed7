"""The int8 transition's and the int8 pointwise's host side (plain Python and
PyTorch, no card needed): csrc/transition_int8.cu's folded quantization, its
plan and its k-contiguous weights, and csrc/pointwise_int8.cu's cluster
path's row maxima.

* The mid's scales: the stride-2 3x3 im2col rows' maxima from h1's pixel
  maxima (kernels/quantized.py::strided_im2col_row_max, the rule the
  kernel's mid applies) equal quantize_rows(strided_im2col(h1))'s, bit for
  bit, on odd maps, zero rows, inf and NaN.
* transition_int8_plan: the grid, and every phase's split as whole stages
  of the s8 wgmma tile, at the served shapes (N = 1, 8, 32) and odd ones.
* The weights' k-contiguous copies (transition_int8_kmajor) against w.T
  padded with zeros, made once per weight.
* The cluster path: a tile's row maxima folded from its blocks' K ranges
  equal the one-pass maxima at the eleven served int8 1x1 shapes.
Inputs are made from a seed with numpy."""

import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.kernels import quantized as q8
from winograd_tpu_torch.kernels.direct import direct_filter
from winograd_tpu_torch.kernels.splitk import H100_SMS
from winograd_tpu_torch.kernels.transition import strided_im2col

CSRC = pathlib.Path(q8.__file__).resolve().parent.parent / "csrc"


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous().view(torch.int32)


def _same(a, b):
    """Equal to the bit, a NaN where the other has a NaN (any payload)."""
    a, b = a.float(), b.float()
    assert a.shape == b.shape
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    assert torch.equal(_bits(a[~nan]), _bits(b[~nan]))


def _map(seed, n, h, w, c, special=None):
    """An (n, h, w, c) ReLU'd map (h1 is a ReLU's output), scaled per pixel
    over six decades, pixel (0, 0, 0) zero; special: "inf" or "nan" at one
    pixel, "zero" a whole image row zero."""
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


@pytest.mark.parametrize("n,h,w,c,special", [
    (1, 8, 8, 16, None), (2, 7, 9, 12, None), (1, 5, 5, 4, "zero"), (2, 6, 7, 8, "inf"),
    (1, 9, 6, 20, "nan"), (3, 1, 4, 4, None), (1, 3, 1, 8, "nan"), (2, 2, 2, 4, "inf"),
])
def test_strided_im2col_row_max_quantizes_as_one_pass(n, h, w, c, special):
    """The mid's row max is the max of its nine taps' pixel maxima, 0 for a
    tap outside the map (the SAME padding of stride 2, odd maps too)."""
    h1 = _map(h * w + c, n, h, w, c, special)
    rows = strided_im2col(h1).reshape(-1, 9 * c)
    folded = q8.strided_im2col_row_max(q8.abs_bits(h1).amax(dim=-1))
    assert torch.equal(folded, q8.abs_bits(rows).amax(dim=-1))
    want_q, want_s = q8.quantize_rows(rows)
    got_q, got_s = q8.quantize_with_max(rows, folded)
    _same(got_s, want_s)
    _same(got_q, want_q)


# The served int8 transitions at N = 1, 8 and 32 and the odd shapes of the
# card tests: every phase's split whole stages of the tile, K covered once.
@pytest.mark.parametrize("shape", [
    (n, hw, hw, cin, cin // 2, 2 * cin) for n in (1, 8, 32)
    for hw, cin in ((56, 256), (28, 512), (14, 1024))] + [
    (3, 15, 15, 68, 20, 130), (1, 13, 11, 16, 16, 40), (2, 7, 9, 2048, 16, 64),
    (1, 15, 13, 64, 1024, 96), (1, 7, 7, 1024, 2048, 128)])
def test_transition_int8_plan_splits_in_whole_stages(shape):
    n, h, w, cin, cmid, cout = shape
    plan = q8.transition_int8_plan(*shape)
    assert plan.blocks == q8.TRANSITION_INT8_BLOCKS_PER_SM * H100_SMS
    for split, kp, k in ((plan.reduce, plan.kpr, cin), (plan.mid, plan.kpm, 9 * cmid),
                         (plan.expand, plan.kpe, cmid), (plan.proj, plan.kpr, cin)):
        assert kp % q8.TRANSITION_INT8_K_ALIGN == 0 and k <= kp < k + q8.TRANSITION_INT8_K_ALIGN
        assert 1 <= split.splits <= q8.TRANSITION_INT8_MAX_SPLITS
        if split.splits == 1:
            assert split.chunk == kp                   # the C entry takes one range as all of K
        else:
            assert split.chunk % q8.STAGE_INT8_STEP == 0
            assert split.chunk * (split.splits - 1) < kp <= split.chunk * split.splits


def test_transition_int8_plan_splits_only_phases_of_few_tiles():
    """At N=1 56->28 the reduce (98 tiles) and the last phase (104) fill the
    264 warpgroups without a split; the mid (26 tiles) splits into walks of
    at most STAGE_INT8_WALK."""
    plan = q8.transition_int8_plan(1, 56, 56, 256, 128, 512)
    assert plan.reduce.splits == plan.expand.splits == plan.proj.splits == 1
    assert plan.mid.splits > 1 and plan.mid.chunk <= q8.STAGE_INT8_WALK


def test_kmajor_copies_are_the_transposed_weights_padded_and_kept():
    """The kernel's k-contiguous weights: w.T padded with zeros, made at a
    weight's first launch and kept while it lives (none made again), made
    anew for a weight changed in place or for the wrapper's padded copies;
    the quantized params keep the JAX package's keys."""
    rng = np.random.default_rng(3)
    cin, cmid, cout = 20, 12, 40
    p = dict(w_reduce=rng.random((cin, cmid)) - 0.5, w9_mid=direct_filter(
        (rng.random((cmid, cmid, 3, 3)) - 0.5).astype(np.float32)),
        w_expand=rng.random((cmid, cout)) - 0.5, w_proj=rng.random((cin, cout)) - 0.5)
    p.update({k: rng.random(c).astype(np.float32) for k, c in (
        ("s_reduce", cmid), ("b_reduce", cmid), ("s_mid", cmid), ("b_mid", cmid),
        ("s_expand", cout), ("b_expand", cout), ("s_proj", cout), ("b_proj", cout))})
    q = q8.quantize_transition_params(p)
    assert not any(k.endswith("_kt") for k in q)
    kt = q8.transition_int8_kmajor(q)
    for name in q8.TRANSITION_INT8_WEIGHTS:
        w_q, t = q[f"{name}_q"], kt[f"{name}_kt"]
        k, n = w_q.shape
        kp = -(-k // q8.TRANSITION_INT8_K_ALIGN) * q8.TRANSITION_INT8_K_ALIGN
        assert t.dtype == torch.int8 and tuple(t.shape) == (n, kp) and t.is_contiguous()
        assert torch.equal(t[:, :k], w_q.t()) and not t[:, k:].any()
    again = q8.transition_int8_kmajor(q)
    assert all(again[k] is kt[k] for k in kt)                     # kept, not made again
    q["w_proj_q"][0, 0] = -q["w_proj_q"][0, 0] - 1                # changed in place
    changed = q8.transition_int8_kmajor(q)
    assert changed["w_proj_kt"] is not kt["w_proj_kt"] and changed["w_reduce_kt"] is kt["w_reduce_kt"]
    assert torch.equal(changed["w_proj_kt"][:, :cin], q["w_proj_q"].t())
    with torch.inference_mode():  # the CLI's weights: no version counter, copied once
        frozen = {k: v.clone() for k, v in q.items()}
        once = q8.transition_int8_kmajor(frozen)
        assert all(q8.transition_int8_kmajor(frozen)[k] is once[k] for k in once)
        assert torch.equal(once["w_proj_kt"], changed["w_proj_kt"])
    padded = q8.pad_transition_int8(q, 20, 16)
    made = q8.transition_int8_kmajor(padded)
    assert tuple(made["w9_mid_kt"].shape) == (16, 9 * 16 + 16)
    assert torch.equal(made["w9_mid_kt"][:, :144], padded["w9_mid_q"].t())


def _constexpr(source, name):
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m, f"{name} not in {source}"
    return int(m.group(1))


@pytest.mark.parametrize("value,source,name", [
    (q8.TRANSITION_INT8_BLOCKS_PER_SM, "transition_int8.cu", "kBlocksPerSm"),
    (q8.TRANSITION_INT8_MAX_SPLITS, "transition_int8.cu", "kSplitCap"),
    (q8.TRANSITION_INT8_K_ALIGN, "transition_int8.cu", "kKAlign"),
    (q8.STAGE_INT8_STEP, "wgmma_s8.cuh", "kBK"),
    (q8.STAGE_INT8_TILE_M, "wgmma_s8.cuh", "kBM"),
    (q8.STAGE_INT8_WARPGROUPS, "wgmma_s8.cuh", "kWarpgroups"),
])
def test_transition_int8_plan_matches_the_kernels_geometry(value, source, name):
    assert value == _constexpr(source, name)


def test_transition_int8_launch_has_two_grid_barriers_and_no_transpose():
    """The kernel body: the reduce, a barrier, the mid, a barrier, the
    expand with the projection (one more barrier only where that phase
    splits); no weight transpose, no quantize phase, one memset."""
    src = (CSRC / "transition_int8.cu").read_text()
    body = src[src.index("transition_int8_kernel(const"):src.index("int resident_blocks()")]
    assert body.count("wt::grid_sync(a.bar);") == 2
    assert body.count("ph::gemm_phase(") == 2 and "expand_and_project(" in body
    assert body.count("ph::prefetch_phase(") == 1 and "prefetch_dual(" in body
    dual = src[src.index("__device__ void expand_and_project"):src.index("__global__")]
    assert dual.count("wt::grid_sync(a.bar);") == 1 and "if (dual_fused(a))" in dual
    assert src.count("cudaMemsetAsync(") == 1 and "Transpose" not in src
    assert src.count("q8::encode_kmajor(") == 4


def test_transition_int8_wrapper_launches_the_plan_and_the_kmajor_weights(monkeypatch):
    """transition_block_int8 hands csrc/transition_int8.cu the plan's
    integers and the weights' k-contiguous copies (transition_int8_kmajor's)
    in place of the (K, N) weights."""
    calls = []
    monkeypatch.setattr(_build, "check_tensors", lambda *t, **k: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: 66)
    monkeypatch.setattr(q8, "_workspace_words", lambda *a: calls.append(("ws", a)) or 1)
    ptrs = {}
    monkeypatch.setattr(_build, "ptr", lambda t: ptrs.setdefault(id(t), ctypes.c_void_p(len(ptrs))))

    def launch(name, entry, shape, device, *args, counter=None):
        calls.append((entry, [a.value for a in args if isinstance(a, ctypes.c_int)], args))
    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    n, h, w, cin, cmid, cout = 1, 14, 14, 64, 32, 128
    meta = lambda *s, dtype=torch.float32: torch.empty(*s, device="meta", dtype=dtype)  # noqa: E731
    i8 = torch.int8
    q = {"w_reduce_q": meta(cin, cmid, dtype=i8), "w9_mid_q": meta(9 * cmid, cmid, dtype=i8),
         "w_expand_q": meta(cmid, cout, dtype=i8), "w_proj_q": meta(cin, cout, dtype=i8)}
    for k, c in (("w_reduce_s", cmid), ("s_reduce", cmid), ("b_reduce", cmid), ("w9_mid_s", cmid),
                 ("s_mid", cmid), ("b_mid", cmid), ("w_expand_s", cout), ("s_expand", cout),
                 ("b_expand", cout), ("w_proj_s", cout), ("s_proj", cout), ("b_proj", cout)):
        q[k] = meta(c)
    q8.transition_block_int8(meta(n, h, w, cin), q)
    (_, ws), (entry, ints, args) = calls
    plan = q8.transition_int8_plan(n, h, w, cin, cmid, cout, 66)
    assert entry == "transition_block_int8" and ints[-9:] == list(plan.args())
    assert ws[-9:] == (*plan.args(),)
    kt = q8.transition_int8_kmajor(q)
    for name, (k, cols) in zip(q8.TRANSITION_INT8_WEIGHTS,
                               ((64, cmid), (288, cmid), (32, cout), (64, cout))):
        assert tuple(kt[f"{name}_kt"].shape) == (cols, k)
        assert ptrs[id(kt[f"{name}_kt"])] in args and id(q[f"{name}_q"]) not in ptrs


# The served int8 1x1s (P, K, N) past the GEMV's rows (ResNet-50's and
# ResNet-34's at N=1, some at N=8 and 32) on the cluster path: its blocks
# each take the max over their own K range; the cluster's max of those is
# the one-pass row max.
@pytest.mark.parametrize("p,k,n", [
    (3136, 64, 64), (3136, 64, 256), (784, 64, 128), (196, 128, 256), (49, 256, 512),
    (784, 576, 128), (196, 1152, 256), (49, 2304, 512), (392, 2304, 512), (6272, 576, 128),
    (32, 2048, 1000),
])
def test_pointwise_int8_cluster_row_max_folds_to_one_pass(p, k, n):
    rng = np.random.default_rng(p + k)
    x = (rng.random((p, k)) - 0.5) * 10.0 ** rng.integers(-3, 3, size=(p, 1))
    x[0] = 0.0
    x[min(5, p - 1), k // 2] = np.nan
    x = torch.as_tensor(x.astype(np.float32))
    for want in (0, 2, 8):  # the plan's split, and others the kernel takes
        plan = q8.pointwise_int8_plan(p, k, n, path="cluster", want=want)
        folded = q8.row_max_in_pieces(x, plan.chunk)   # one piece a block of the cluster
        assert torch.equal(folded, q8.abs_bits(x).amax(dim=-1))
        _same(q8.quantize_with_max(x, folded)[1], q8.quantize_rows(x)[1])
