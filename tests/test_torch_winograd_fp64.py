"""The FP64 F(2,3) tile of the int8 tiers (csrc/winograd.cuh::wino_f64_tile,
behind csrc/winograd.cu's winograd_conv3x3_bn_bf16 and csrc/stage_int8.cu's
winograd2 mid), on the CPU (no card needed): its plan
(kernels/winograd.py::winograd_fp64_plan) against the geometry at every
served shape and at channel counts off the MMA fragment's multiples, and
against the constants compiled into csrc/; the wrappers hand the C entries
that plan (stubbed launches); a numpy float64 emulation of the tile's order
of sums (per position, MMA k-fragment by k-fragment, stage after stage, no
Cin split), rounded to float once, equal to winograd2_mid_plain to the bit
on seeded inputs, which guards the premise that the order does not show;
and the port's "bf16" plain version against the JAX package's op at
precision "bf16w" (the JAX int8 tier's conv2_x), in Pallas interpret mode.

Bounds: the emulation equals the plain version (0); the plain version is
within 1e-5 * max(1, max|jax|) of the JAX op, whose bf16 hi/lo split of V
with f32 sums differs from exact products by ~2^-17 relative."""

import ctypes
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from winograd_tpu.kernels.winograd import conv3x3_bn_winograd_pallas
from winograd_tpu_torch.kernels import _build, transforms
from winograd_tpu_torch.kernels import quantized as q8
from winograd_tpu_torch.kernels import winograd as wg
from winograd_tpu_torch.kernels.splitk import H100_SMS

CSRC = pathlib.Path(wg.__file__).resolve().parent.parent / "csrc"
JAX_RTOL = 1e-5

# The FP64 route's served convs (N, H, W, C): ResNet-18/34 int8's conv2_x
# and ResNet-50 int8's conv2_x mid at 56x56x64, ResNet-50 int8's conv3_x mid
# at 28x28x128, at N = 1, 8 and 32.
SERVED = [(n, hw, hw, c) for n in (1, 8, 32) for hw, c in ((56, 64), (28, 128))]
RAGGED = [(2, 7, 9, 13, 70), (1, 9, 9, 70, 13), (3, 6, 6, 20, 33), (1, 1, 1, 8, 8),
          (1, 30, 30, 64, 7)]


def _source(name: str) -> str:
    return (CSRC / name).read_text()


def _constexpr(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", _source(source))
    assert m, f"{name} not in {source}"
    return int(m.group(1))


def _check_plan(n, h, w, cout, sms=H100_SMS):
    """Every (tile, output channel) in exactly one item, the items as the
    kernels deal them (item -> tile group item // col blocks, Cout block
    item % col blocks) over a grid of one block an SM at most; the widest
    Cout block whose items reach WINOGRAD_FP64_MIN_SHARE of the SMs, none
    wider than Cout needs."""
    plan = wg.winograd_fp64_plan(n, h, w, cout, sms)
    assert plan.cols in wg.WINOGRAD_FP64_COLS and plan.cols <= max(8, -(-cout // 8) * 8)
    tiles = wg.winograd_tiles(n, h, w, 2)
    groups, col_blocks = -(-tiles // wg.WINOGRAD_FP64_TILES), -(-cout // plan.cols)
    items = groups * col_blocks
    assert items == wg.winograd_fp64_items(n, h, w, cout, plan.cols)
    assert plan.blocks == min(items, sms)
    seen = np.zeros((groups * wg.WINOGRAD_FP64_TILES, col_blocks * plan.cols), np.int64)
    for item in range(items):
        t0 = item // col_blocks * wg.WINOGRAD_FP64_TILES
        c0 = item % col_blocks * plan.cols
        seen[t0:t0 + wg.WINOGRAD_FP64_TILES, c0:c0 + plan.cols] += 1
    assert (seen[:tiles, :cout] == 1).all()
    wider = [c for c in wg.WINOGRAD_FP64_COLS if plan.cols < c <= -(-cout // 8) * 8]
    for c in wider:   # a wider block was refused only for falling short of the SMs
        assert wg.winograd_fp64_items(n, h, w, cout, c) < wg.WINOGRAD_FP64_MIN_SHARE * sms
    return plan, items


@pytest.mark.parametrize("n,h,w,c", SERVED)
def test_fp64_plan_fills_the_card_at_the_served_shapes(n, h, w, c):
    plan, items = _check_plan(n, h, w, c)
    assert items >= wg.WINOGRAD_FP64_MIN_SHARE * H100_SMS
    if n == 1:     # a narrower block only where the wide one's items fall short
        assert plan.cols == {64: 32, 128: 16}[c] and plan.blocks == items
    else:
        assert plan.cols == 32 and plan.blocks == H100_SMS
    stage = q8.stage_int8_plan(n, h, w, 4 * c, c, "winograd2", q8.expand_groups(c, "winograd2"))
    assert stage.mid == (1, wg.winograd_fp64_plan(n, h, w, c, stage.grid).cols)


@pytest.mark.parametrize("n,h,w,cin,cout", RAGGED)
@pytest.mark.parametrize("sms", [H100_SMS, 66, 16])
def test_fp64_plan_on_ragged_shapes(n, h, w, cin, cout, sms):
    _check_plan(n, h, w, cout, sms)


def test_fp64_plan_matches_the_kernels_geometry():
    """The plan's copies of the tile's geometry equal csrc's; both C entries
    take exactly the plan's Cout blocks, and one block of the int8 stage is
    one FP64 tile's block."""
    assert wg.WINOGRAD_FP64_TILES == _constexpr("winograd.cuh", "kF64Tiles")
    threads = _constexpr("winograd.cuh", "kF64Threads")
    assert threads == _constexpr("wgmma_s8.cuh", "kWarpgroups") * _constexpr(
        "wgmma_s8.cuh", "kWgThreads")
    assert _constexpr("winograd.cuh", "kF64Tiles") * _constexpr("winograd.cuh", "kF64KC") == threads
    cols = sorted(wg.WINOGRAD_FP64_COLS)
    assert sorted(map(int, re.findall(r"\bcols != (\d+)", _source("winograd.cu")))) == cols
    assert sorted(map(int, re.findall(r"wcols != (\d+)", _source("stage_int8.cu")))) == cols
    assert _constexpr("winograd.cuh", "kF64K") in (4, 8, 16)


def test_fp64_tile_runs_on_the_fp64_tensor_cores():
    """The tile's products are mma.sync .f64 (mma_f64.cuh, shared with the
    stem), not scalar FP64 FMAs: the old tile and its constants are gone."""
    tile = _source("winograd.cuh")
    assert '#include "mma_f64.cuh"' in tile and "dmma(acc[q][f], a, b)" in tile
    assert "cp_async16(" in tile and "__bfloat162float(Us[" in tile
    for old in ("wino_tile<", "kWinoTX", "kWinoCK", "wino_smem_bytes", "TA(w.x)"):
        for name in ("winograd.cuh", "winograd.cu", "stage_int8.cu"):
            assert old not in _source(name), (old, name)
    header = _source("mma_f64.cuh")
    for shape in ("m16n8k4", "m16n8k8", "m16n8k16"):
        assert f"mma.sync.aligned.{shape}.row.col.f64.f64.f64.f64" in header
    stem = _source("stem.cu")
    assert '#include "mma_f64.cuh"' in stem and "asm(" not in stem


def _stub(monkeypatch, sms):
    calls = []
    monkeypatch.setattr(_build, "check_tensors", lambda *t, **k: None)
    monkeypatch.setattr(_build, "check_operands", lambda *t, **k: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: sms)
    monkeypatch.setattr(_build, "ptr", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(q8, "_stage_int8_workspace", lambda *a: 1)

    def launch(name, entry, shape, device, *args, counter=None):
        calls.append((entry, [a.value for a in args if isinstance(a, ctypes.c_int)],
                      [list(a) for a in args if isinstance(a, ctypes.Array)]))
    monkeypatch.setattr(_build, "launch", launch)
    return calls


@pytest.mark.parametrize("sms", [H100_SMS, 66])
def test_wrappers_launch_the_fp64_plan(monkeypatch, sms):
    """conv3x3_bn_winograd at "bf16" hands winograd_conv3x3_bn_bf16 the
    plan's cols and blocks (its last two integers) for the card's SM count,
    and resnet_stage_int8 on the winograd2 route the plan's Cout block as
    its mid phase."""
    calls = _stub(monkeypatch, sms)
    e = lambda *shape, dtype=torch.float32: torch.empty(*shape, device="meta", dtype=dtype)  # noqa: E731
    n, h, w, c = 1, 28, 28, 128
    wg.conv3x3_bn_winograd(e(n, h, w, c), e(16, c, c, dtype=torch.bfloat16), e(c), e(c),
                           precision="bf16")
    plan = wg.winograd_fp64_plan(n, h, w, c, sms)
    [(entry, ints, _)] = calls
    assert entry == "winograd_conv3x3_bn_bf16" and ints[-2:] == [plan.cols, plan.blocks]
    calls.clear()
    cio, nb = 4 * c, 2
    q = dict(w_reduce_q=e(nb, cio, c, dtype=torch.int8), w_reduce_s=e(nb, 1, c),
             s_reduce=e(nb, 1, c), b_reduce=e(nb, 1, c),
             u2_mid_bf16=e(nb, 16, c, c, dtype=torch.bfloat16), w9_mid_s=e(nb, 1, c),
             s_mid=e(nb, 1, c), b_mid=e(nb, 1, c),
             w_expand_q=e(nb, c, cio, dtype=torch.int8), w_expand_s=e(nb, 1, cio),
             s_expand=e(nb, 1, cio), b_expand=e(nb, 1, cio))
    q8.resnet_stage_int8(e(n, h, w, cio), q, "winograd2")
    [(entry, _, [phases])] = calls
    assert entry == "resnet_stage_int8"
    assert phases[2:4] == [1, wg.winograd_fp64_plan(n, h, w, c, sms).cols]


def _sandwich(mat, d):
    """mat . d . mat^T over the last two axes in float64, each entry a sum
    over mat's nonzero coefficients in column order, started from zero, as
    csrc/winograd.cuh's sandwich (an FMA with a coefficient of +-1 is an
    exact product and one rounded add)."""
    def rows(m, t, axis):
        out = []
        for coeffs in m:
            s = np.zeros(np.delete(t.shape, axis), np.float64)
            for q, cf in enumerate(coeffs):
                if cf != 0.0:
                    s = cf * np.take(t, q, axis=axis) + s
            out.append(s)
        return np.stack(out, axis=axis)
    return rows(mat, rows(mat, d, -2), -1)


def _tile_emulation(x, u, scale, bias, relu, k):
    """The FP64 tile's arithmetic in numpy: V in float64; per position, M
    summed into one float64 accumulator k-fragment by k-fragment (k input
    channels a fragment, their sum by numpy; the stages of 16 channels
    follow one another, no Cin split); At M At^T; rounded to float32 once;
    BN's multiply and add rounded apart; ReLU."""
    bt, _, at = (np.asarray(m, np.float64) for m in transforms.matrices(2))
    n, h, w, cin = x.shape
    cout = u.shape[2]
    th, tw = -(-h // 2), -(-w // 2)
    xp = np.zeros((n, 2 * th + 2, 2 * tw + 2, cin), np.float64)
    xp[:, 1:h + 1, 1:w + 1] = x
    d = np.stack([np.stack([xp[:, i:i + 2 * th:2, j:j + 2 * tw:2] for j in range(4)], -1)
                  for i in range(4)], -2)                           # (n, th, tw, cin, 4, 4)
    v = _sandwich(bt, d).reshape(n * th * tw, cin, 16).transpose(2, 0, 1)   # (16, T, cin)
    u64 = u.astype(np.float64)
    acc = np.zeros((16, n * th * tw, cout), np.float64)
    for k0 in range(0, cin, k):
        acc = acc + np.matmul(v[:, :, k0:k0 + k], u64[:, k0:k0 + k])
    mm = acc.transpose(1, 2, 0).reshape(n, th, tw, cout, 4, 4)
    y = _sandwich(at, mm)                                           # (n, th, tw, cout, 2, 2)
    y = y.transpose(0, 1, 4, 2, 5, 3).reshape(n, 2 * th, 2 * tw, cout)[:, :h, :w]
    y = y.astype(np.float32) * scale + bias
    return np.maximum(y, np.float32(0)) if relu else y


@pytest.mark.parametrize("k", [4, 8, 16])
@pytest.mark.parametrize("hw,c,relu", [(56, 64, True), (28, 128, False)])
def test_order_of_the_tile_sums_does_not_show(k, hw, c, relu):
    rng = np.random.default_rng(hw + c + k)
    x = ((rng.random((1, hw, hw, c)) - 0.5) * 2).astype(np.float32)
    u16 = torch.as_tensor(transforms.transform_filter(
        ((rng.random((c, c, 3, 3)) - 0.5)).astype(np.float32), m=2)).to(torch.bfloat16)
    scale = (rng.random(c) * 0.5 + 0.25).astype(np.float32)
    bias = (rng.random(c) - 0.5).astype(np.float32)
    got = _tile_emulation(x, u16.float().numpy(), scale, bias, relu, k)
    ref = wg.winograd2_mid_plain(torch.as_tensor(x), u16, torch.as_tensor(scale),
                                 torch.as_tensor(bias), relu).numpy()
    assert got.dtype == ref.dtype == np.float32
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("n,h,w,c,relu", [(2, 9, 7, 16, True), (1, 16, 16, 64, False)])
def test_bf16_plain_matches_jax(n, h, w, c, relu):
    """The int8 tier's F(2,3) on bf16 filters: the port's plain version
    (the FP64 algebra, what the tile computes) against the JAX package's
    conv3x3_bn_winograd_pallas at precision "bf16w" (its p64 kernel at 64
    channels)."""
    rng = np.random.default_rng(h * w + c)
    x = (rng.random((n, h, w, c)) - 0.5).astype(np.float32)
    u = transforms.transform_filter((rng.random((c, c, 3, 3)) - 0.5).astype(np.float32), m=2)
    s = (rng.random(c) * 0.5 + 0.25).astype(np.float32)
    b = (rng.random(c) - 0.5).astype(np.float32)
    ref = np.asarray(conv3x3_bn_winograd_pallas(
        jnp.asarray(x), jnp.asarray(u).astype(jnp.bfloat16), jnp.asarray(s), jnp.asarray(b),
        relu=relu, precision="bf16w"), np.float64)
    out = wg.conv3x3_bn_winograd(torch.as_tensor(x), torch.as_tensor(u).to(torch.bfloat16),
                                 torch.as_tensor(s), torch.as_tensor(b), relu, "bf16").numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert np.abs(out - ref).max() <= JAX_RTOL * max(1.0, np.abs(ref).max())
