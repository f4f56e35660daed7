"""The plans of the direct 3x3 kernels on the cluster GEMMs (plain Python, no
card needed): kernels/direct.py::direct_plan (csrc/direct.cu on
csrc/wgmma_cluster.cuh, the pointwise MMA path's rule) and
kernels/quantized.py::direct_int8_plan (csrc/direct_int8.cu on
csrc/wgmma_s8_cluster.cuh, the int8 pointwise's cluster rule), at the served
shapes, the train steps' data-gradient shapes, the "model" partition's
shard shapes and ragged ones: at most a cluster of 16 splits, whole
stages of the tile but the last, K covered once, the card filled where K
allows. Then the int8 kernel's row scales as its cluster forms them (each
block's max over its K range of the implicit im2col row, the maxima then
combined) against quantize_rows(im2col3x3(x)), bit for bit; the wrappers
handing the C entries their plans; and the sources holding the cluster
kernels and none of the mma.sync machinery they replaced. Inputs are made
from a seed with numpy."""

import ctypes
import pathlib

import numpy as np
import pytest
import torch

from winograd_tpu_torch.kernels import _build
from winograd_tpu_torch.kernels import direct as dr
from winograd_tpu_torch.kernels import pointwise as pw
from winograd_tpu_torch.kernels import quantized as q8
from winograd_tpu_torch.kernels.direct import im2col3x3
from winograd_tpu_torch.kernels.splitk import H100_SMS, pow2_split

CSRC = pathlib.Path(dr.__file__).resolve().parent.parent / "csrc"

# (N, H, W, Cin, Cout): the served direct 3x3s (7x7x512 at N = 1, 8, 32; the
# int8 projection 3x3 at 56x56x64), the train steps' data gradients at each
# stage's width, the "model" partition's shards (Cin or Cout a quarter of
# the layer's), and ragged shapes.
SERVED = [(n, 7, 7, 512, 512) for n in (1, 8, 32)] + [(n, 56, 56, 64, 64) for n in (1, 8, 32)]
TRAIN = [(1, 56, 56, 64, 64), (1, 28, 28, 128, 128), (1, 14, 14, 256, 256), (1, 7, 7, 512, 512)]
SHARDS = [(1, 56, 56, 64, 16), (1, 56, 56, 16, 64), (1, 28, 28, 128, 32), (1, 28, 28, 32, 128),
          (1, 14, 14, 256, 64), (1, 7, 7, 128, 512), (1, 7, 7, 512, 128)]
RAGGED = [(2, 5, 7, 3, 70), (1, 9, 9, 13, 65), (3, 6, 6, 100, 33), (1, 4, 5, 13, 33),
          (2, 3, 3, 100, 65)]
SHAPES = SERVED + TRAIN + SHARDS + RAGGED


def _ranges(splits: int, chunk: int, k: int):
    return [(s * chunk, min(k, (s + 1) * chunk)) for s in range(splits)]


def _check_split(splits: int, chunk: int, k: int, step: int, cap: int) -> None:
    """K in `splits` ranges of `chunk`: each index once, every range but the
    last whole stages of `step`, a power of two of ranges, at most `cap`."""
    assert 1 <= splits <= cap and splits & (splits - 1) == 0
    seen = np.zeros(k, np.int64)
    for lo, hi in _ranges(splits, chunk, k):
        assert 0 <= lo < hi <= k
        seen[lo:hi] += 1
    assert (seen == 1).all()
    if splits > 1:
        assert chunk % step == 0


def _fills(tiles: int, splits: int, k: int, step: int, cap: int, sms: int) -> None:
    """tiles x splits reach about two blocks an SM where K and the cluster
    allow: within a factor two of the most ranges, a power of two, that K
    takes in whole stages (pow2_split at the cluster's cap)."""
    most = pow2_split(k, cap, step, step).splits
    assert 2 * tiles * splits >= min(2 * sms, tiles * most)


@pytest.mark.parametrize("sms", [H100_SMS, 66])
@pytest.mark.parametrize("shape", SHAPES)
def test_direct_plan_is_the_cluster_rule(shape, sms):
    """The MMA path's tiles and stages, split to fill the card and to cap
    each block's walk at DIRECT_MAX_CHUNK, a power of two of splits up to
    DIRECT_CLUSTER_MAX, no workspace."""
    n, h, w, cin, cout = shape
    plan = dr.direct_plan(n, h, w, cin, cout, sms)
    p, k = n * h * w, 9 * cin
    assert not plan.gemv and plan.tile == pw.MMA_TILE
    assert plan.tiles == -(-p // 64) * -(-cout // 64)
    _check_split(plan.splits, plan.chunk, k, pw.SPLIT_STEP, dr.DIRECT_CLUSTER_MAX)
    _fills(plan.tiles, plan.splits, k, pw.SPLIT_STEP, dr.DIRECT_CLUSTER_MAX, sms)
    assert plan.chunk <= dr.DIRECT_MAX_CHUNK or plan.splits == dr.DIRECT_CLUSTER_MAX
    if plan.tiles >= 2 * sms:                    # the tiles fill the card: the walk's cap alone
        walk = -(-k // dr.DIRECT_MAX_CHUNK)
        assert plan.splits < 2 * walk
    assert not hasattr(plan, "workspace_words")


@pytest.mark.parametrize("sms", [H100_SMS, 66])
@pytest.mark.parametrize("shape", SHAPES)
def test_direct_int8_plan_is_the_cluster_rule(shape, sms):
    n, h, w, cin, cout = shape
    cin = q8.ceil4(cin)                       # the wrapper pads Cin to a multiple of 4
    plan = q8.direct_int8_plan(n, h, w, cin, cout, sms)
    p, k = n * h * w, 9 * cin
    rule = q8.pointwise_int8_plan(p, k, cout, sms, "cluster", cap=q8.DIRECT_INT8_CLUSTER_MAX)
    assert (plan.path, plan.kp, plan.tile, plan.tiles) == (rule.path, rule.kp, rule.tile, rule.tiles)
    assert plan.tile in q8.POINTWISE_INT8_CLUSTER_COLS
    assert cout > 64 or plan.tile == 64                # no idle warpgroup at narrow N
    assert plan.kp % q8.DIRECT_INT8_K_ALIGN == 0 and k <= plan.kp < k + q8.DIRECT_INT8_K_ALIGN
    assert plan.tiles == -(-p // q8.POINTWISE_INT8_TILE) * -(-cout // plan.tile)
    assert plan.blocks == plan.tiles * plan.splits
    assert plan.blocks <= max(q8.POINTWISE_INT8_CLUSTER_BLOCKS_PER_SM * sms, plan.tiles)
    _check_split(plan.splits, plan.chunk, plan.kp, q8.POINTWISE_INT8_CLUSTER_STEP,
                 q8.DIRECT_INT8_CLUSTER_MAX)
    _fills(plan.tiles, plan.splits, plan.kp, q8.POINTWISE_INT8_CLUSTER_MIN_CHUNK,
           q8.DIRECT_INT8_CLUSTER_MAX, sms)
    assert not hasattr(plan, "workspace")
    for cols in q8.POINTWISE_INT8_CLUSTER_COLS:   # the sweep's other tile width
        other = q8.direct_int8_plan(n, h, w, cin, cout, sms, cols=cols)
        assert other.tile == cols and other.blocks == other.tiles * other.splits
        assert other.splits & (other.splits - 1) == 0


def test_pow2_split_gives_a_power_of_two():
    """splitk.py::pow2_split: the largest power of two of ranges at most
    the wanted number that split_k's rounding keeps a power of two."""
    for k in (27, 36, 117, 576, 900, 1152, 2304, 4608):
        for want in range(1, 40):
            split = pow2_split(k, want, 32, 32)
            assert split.splits & (split.splits - 1) == 0 and split.splits <= max(want, 1)
            _check_split(split.splits, split.chunk, k, 32, 64)
    assert pow2_split(576, 16, 32, 32) == (4, 160)      # 9 and 6 ranges are not powers of two
    assert pow2_split(4608, 16, 32, 32) == (16, 288)


# --- the int8 row scales as the cluster forms them ----------------------------


def _window_values(x: np.ndarray, p: int, ks: np.ndarray) -> np.ndarray:
    """Values k of im2col row p of x (N, H, W, C) as csrc/wgmma_s8_cluster.cuh's
    XIm2col loads them: the window rs = k // C, the tap (y + rs // 3 - 1,
    x + rs % 3 - 1), zero past 9 C or outside the map."""
    n_, h, w, c = x.shape
    n, q = divmod(p, h * w)
    y0, x0 = divmod(q, w)
    rs = ks // c
    y, xx = y0 + rs // 3 - 1, x0 + rs % 3 - 1
    inside = (rs < 9) & (y >= 0) & (y < h) & (xx >= 0) & (xx < w)
    out = np.zeros(ks.shape, np.float32)
    out[inside] = x[n, y[inside], xx[inside], (ks - rs * c)[inside]]
    return out


def _cluster_scales(x: np.ndarray, plan) -> torch.Tensor:
    """Each row's scale as the kernel forms it: every split's block takes
    the max of the bits of |a| over its K range [s chunk, (s + 1) chunk) of
    Kp, the cluster takes the max of those, and the scale is that max / 127
    by true division (1 for 0)."""
    n, h, w, _ = x.shape
    maxima = []
    for p in range(n * h * w):
        parts = []
        for lo, hi in _ranges(plan.splits, plan.chunk, plan.kp):
            v = torch.from_numpy(_window_values(x, p, np.arange(lo, hi)))
            parts.append(q8.abs_bits(v).amax())
        maxima.append(torch.stack(parts).amax())
    m = q8.max_of_bits(torch.stack(maxima))
    s = m / torch.full_like(m, 127.0)
    return torch.where(s == 0, torch.ones_like(s), s)


def _same(a: torch.Tensor, b: torch.Tensor) -> None:
    """Equal to the bit, a NaN where the other has a NaN."""
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    assert torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


@pytest.mark.parametrize("n,h,w,cin,want", [
    (1, 5, 7, 4, 0), (2, 3, 3, 8, 4), (1, 7, 7, 12, 3), (1, 4, 9, 16, 8), (2, 6, 5, 20, 1),
])
def test_cluster_row_scales_equal_the_plain_scales(n, h, w, cin, want):
    """Odd maps, every border row, a zero image, a row past the map's values
    scaled over six decades, an inf and a NaN: the maxima of the plan's K
    ranges, combined, give quantize_rows(im2col3x3(x))'s scales to the bit."""
    rng = np.random.default_rng(n * 100 + h * 10 + w + cin)
    x = ((rng.random((n, h, w, cin)) - 0.5)
         * 10.0 ** rng.integers(-3, 3, size=(n, h, w, 1))).astype(np.float32)
    if n > 1:
        x[1] = 0.0                                       # an image of zero rows
    x[0, 0, w - 1, cin - 1] = np.inf                     # a corner: four rows see it
    x[0, h // 2, w // 2, 0] = np.nan                     # the centre: nine rows
    x[0, h - 1, 0] = -np.abs(x[0, h - 1, 0])             # a negative pixel
    plan = q8.direct_int8_plan(n, h, w, cin, 64, want=want)
    assert (plan.splits > 1) == (want != 1)              # the ranges meet in the cluster
    _, ref = q8.quantize_rows(im2col3x3(torch.from_numpy(x)))
    _same(_cluster_scales(x, plan), ref.reshape(-1))


def test_window_values_are_im2col3x3():
    """The kernel's im2col addressing, modelled above, is im2col3x3's, zero
    past 9 C (the padded K)."""
    rng = np.random.default_rng(5)
    x = (rng.random((2, 3, 5, 8)) - 0.5).astype(np.float32)
    cols = im2col3x3(torch.from_numpy(x)).reshape(30, 72).numpy()
    ks = np.arange(96)
    for p in range(30):
        got = _window_values(x, p, ks)
        assert np.array_equal(got[:72], cols[p]) and not got[72:].any()


# --- the wrappers hand the C entries their plans --------------------------------


def _stub_launches(monkeypatch, sms):
    calls = []
    monkeypatch.setattr(_build, "check_tensors", lambda *t, **k: None)
    monkeypatch.setattr(_build, "check_operands", lambda *t, **k: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: sms)
    monkeypatch.setattr(_build, "ptr", lambda t: ctypes.c_void_p(0))

    def launch(name, entry, shape, device, *args, counter=None):
        calls.append((entry, [a.value for a in args if isinstance(a, ctypes.c_int)], counter))
    monkeypatch.setattr(_build, "launch", launch)
    return calls


@pytest.mark.parametrize("sms", [H100_SMS, 66])
@pytest.mark.parametrize("shape", [(1, 7, 7, 512, 512), (8, 7, 7, 512, 512), (1, 56, 56, 64, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_direct_wrapper_launches_the_plan(monkeypatch, sms, shape, dtype):
    """conv3x3_bn_direct hands csrc/direct.cu direct_plan's tile, splits and
    chunk after the shape and ReLU, and no workspace."""
    n, h, w, cin, cout = shape
    calls = _stub_launches(monkeypatch, sms)
    e = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    monkeypatch.setattr(_build, "check_bf16w", lambda x: None)
    dr.conv3x3_bn_direct(e(n, h, w, cin), torch.empty(9 * cin, cout, device="meta", dtype=dtype),
                         e(cout), e(cout), True)
    plan = dr.direct_plan(n, h, w, cin, cout, sms)
    [(entry, ints, counter)] = calls
    bf16w = dtype == torch.bfloat16
    assert entry == ("direct_conv3x3_bn_bf16w" if bf16w else "direct_conv3x3_bn")
    assert counter == ("direct_bf16w" if bf16w else None)
    assert ints == [n, h, w, cin, cout, 1, plan.tile, plan.splits, plan.chunk]


@pytest.mark.parametrize("sms", [H100_SMS, 66])
@pytest.mark.parametrize("shape", [(1, 7, 7, 512, 512), (1, 56, 56, 64, 64), (2, 5, 7, 13, 70)])
def test_direct_int8_wrapper_launches_the_plan(monkeypatch, sms, shape):
    """conv3x3_bn_int8 hands csrc/direct_int8.cu direct_int8_plan's padded
    K, tile, grid, splits and chunk for the padded Cin, and no workspace."""
    n, h, w, cin, cout = shape
    calls = _stub_launches(monkeypatch, sms)
    e = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    monkeypatch.setattr(q8, "pad_to", lambda t, dim, size: e(*[
        size if i == dim % t.dim() else d for i, d in enumerate(t.shape)]))
    monkeypatch.setattr(q8, "pad_windows", lambda w9, ci, co: torch.empty(
        9 * ci, co, device="meta", dtype=torch.int8))
    q8.conv3x3_bn_int8(e(n, h, w, cin), torch.empty(9 * cin, cout, device="meta",
                                                      dtype=torch.int8),
                       e(cout), e(cout), e(cout), False)
    c4 = q8.ceil4(cin)
    plan = q8.direct_int8_plan(n, h, w, c4, cout, sms)
    [(entry, ints, _)] = calls
    assert entry == "direct_int8_conv3x3_bn"
    assert ints == [n, h, w, c4, cout, 0, *plan.args()[1:]]


# --- the sources ----------------------------------------------------------------


def test_direct_kernels_are_the_cluster_kernels():
    """csrc/direct.cu and csrc/direct_int8.cu launch the cluster headers'
    kernels: no splitk_tf32.cuh, no mma_int8.cuh phase, no grid barrier, no
    cooperative launch, no workspace."""
    f32 = (CSRC / "direct.cu").read_text()
    int8 = (CSRC / "direct_int8.cu").read_text()
    assert '#include "wgmma_cluster.cuh"' in f32 and "wgc::run<wgc::kClusterMax>(" in f32
    assert '#include "wgmma_s8_cluster.cuh"' in int8 and "sc::run<sc::kClusterMax>(" in int8
    assert "sc::XIm2col{x, H, W, Cin, P}" in int8
    for src in (f32, int8):
        for gone in ('#include "splitk_tf32.cuh"', '#include "mma_int8.cuh"', "quantize_rows_phase",
                     "transpose_phase", "gemm_phase", "grid_sync", "cudaLaunchCooperativeKernel",
                     "cudaMemsetAsync", "ws_words"):
            assert gone not in src, gone


def test_the_mma_sync_gemms_are_gone():
    """The last GEMMs off mma.sync: splitk_tf32.cuh (its split-K kernel and
    launcher, then its GEMV reduction; its phase_fits now wgmma_phase.cuh's),
    mma_bf16w.cuh, mma_tf32.cuh's tile and mma_int8.cuh's phases have no
    user left and are gone; the A sources and loader stay (the wgmma
    tile's), as do the int8 pointwise's one-pass warp tile and the stage's
    weight transpose items."""
    assert not (CSRC / "mma_bf16w.cuh").exists() and not (CSRC / "splitk_tf32.cuh").exists()
    srcs = {f.name: f.read_text() for f in CSRC.glob("*.c*")}
    assert "inline bool phase_fits(" in srcs["wgmma_phase.cuh"]
    assert not any("reduce_splits" in text or "mma_kernel" in text for text in srcs.values())
    tf32 = srcs["mma_tf32.cuh"]
    for gone in ("mma_stage", "void tile(", "for_each_acc", "load_b", "kSmemBytes", "mma.sync"):
        assert gone not in tf32, gone
    assert "struct RowMajorA" in tf32 and "struct Im2colA" in tf32 and "void load_a(" in tf32
    mma8 = srcs["mma_int8.cuh"]
    for gone in ("quantize_rows_phase", "transpose_phase", "gemm_phase", "Im2colRows",
                 "void tile(", "load_stage"):
        assert gone not in mma8, gone
    assert "void mma_k32(" in mma8 and "struct Transpose" in mma8
    for name, text in srcs.items():
        assert "mma_bf16w.cuh" not in text and "mma_tile<" not in text, name
    assert "wgc::run<wgc::kClusterPortable>(" in srcs["pointwise.cu"]
    assert "sc::run<sc::kClusterPortable>(" in srcs["pointwise_int8.cu"]
