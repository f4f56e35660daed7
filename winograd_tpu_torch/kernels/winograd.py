"""Fused 3x3 conv (pad 1, stride 1) + folded BN + ReLU by Winograd F(m,3).

Port of winograd_tpu/kernels/winograd.py::conv3x3_bn_winograd_pallas (both
its kernels, _winograd_kernel and _winograd_kernel_p64). The CUDA kernel is
csrc/winograd.cu: at f32 V written once, then the per-position products on
the 3xTF32 tensor cores (csrc/wino_tf32.cuh), cut into work items by
winograd_plan; the plain
twin does the same Winograd algebra on u with this package's transform
matrices.

The wrapper's precision, as the stem's (kernels/stem.py), names the
arithmetic of an F(2,3) on a bfloat16 u:

* "bf16w", the bf16w tier's 3x3 (the JAX package's
  conv3x3_bn_winograd_pallas(precision="bf16w"): ResNet-18/34's stride-1
  3x3s and ResNet-50's entry-block 3x3 at bf16w): the f32 route's launch
  and plan with the products on the bf16 tensor cores, V split into bf16
  hi and lo halves (csrc/winograd.cu's bf16w entry); its plain twin is
  conv3x3_bn_winograd_plain on the bf16 u (_position_products).
* "bf16", the int8 tier's exact bf16-filter 3x3: the kernel runs its algebra
  in FP64, its products on the FP64 tensor cores in items cut by
  winograd_fp64_plan, and rounds each output once, and its plain twin
  (winograd2_mid_plain) does the algebra in float64, so the two agree to
  the bit, as the int8 layer it feeds needs (the JAX kernel's hi/lo split
  of V is within ~2^-17 of that).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from winograd_tpu_torch.kernels import _build, transforms
from winograd_tpu_torch.kernels.splitk import H100_SMS, split_k

# The plan of an f32 csrc/winograd.cu launch. The kernel's geometry, which
# its C entry checks every plan against (tests/test_torch_winograd_plan.py
# reads them from the sources): the work items' tile blocks and Cout blocks
# are WINOGRAD_TILE wide (the MMA tile, csrc/mma_tf32.cuh), a Cin range past
# one split is a multiple of WINOGRAD_STEP (its cp.async stage). The plan's
# own rule: a cooperative grid of WINOGRAD_BLOCKS_PER_SM blocks an SM (the
# entry refuses more than the card holds resident; csrc/stage.cu's grid
# holds as many, and its F(2,3) mid takes this plan too); a work item is one
# tile position, and Cin is split, in ranges at least WINOGRAD_MIN_CHUNK
# long, until the items reach the grid's blocks. Tuned on the served shapes
# by tools/chip_split_sweep.py (PERF.md): items of several positions were
# slower at every served shape, at N=8 by up to 30%. The workspace holds the
# grid barrier's counters, then V and the partial products, each part at a
# multiple of WINOGRAD_ALIGN words.
WINOGRAD_TILE = 64
WINOGRAD_STEP = 32
WINOGRAD_BLOCKS_PER_SM = 2
WINOGRAD_MIN_CHUNK = 64
WINOGRAD_ALIGN = 64


class WinogradWorkspace(NamedTuple):
    """Word offsets of V and of the partial products, and the words in all."""

    v: int
    part: int
    words: int


class WinogradPlan(NamedTuple):
    """How csrc/winograd.cu cuts an F(m,3) conv into work items: one tile
    position an item, Cin in `splits` ranges of `chunk`, on a cooperative
    grid of `blocks` blocks."""

    blocks: int
    splits: int
    chunk: int

    def items(self, tiles: int, cout: int, a2: int) -> int:
        """Work items: positions x splits x tile blocks x Cout blocks."""
        return a2 * self.splits * -(-tiles // WINOGRAD_TILE) * -(-cout // WINOGRAD_TILE)

    def workspace(self, tiles: int, cin: int, cout: int, a2: int) -> WinogradWorkspace:
        """The grid barrier's counters, V (a2 x tiles x cin rounded up to 4),
        then splits x a2 x tiles x cout partial products."""
        v = WINOGRAD_ALIGN
        part = v + -(-a2 * tiles * -(-cin // 4) * 4 // WINOGRAD_ALIGN) * WINOGRAD_ALIGN
        return WinogradWorkspace(v, part, part + self.splits * a2 * tiles * cout)


def winograd_tiles(n: int, h: int, w: int, m: int) -> int:
    return n * -(-h // m) * -(-w // m)


# The plan of the FP64 F(2,3) tile (csrc/winograd.cuh::wino_f64_tile), which
# runs the int8 tier's bf16-filter 3x3 (csrc/winograd.cu's
# winograd_conv3x3_bn_bf16) and the int8 stage's winograd2 mid
# (csrc/stage_int8.cu). Its geometry, which the C entries check every plan
# against (tests/test_torch_winograd_fp64.py reads it from the sources): an
# item is WINOGRAD_FP64_TILES tiles (the FP64 MMA fragment's 16 rows) x
# `cols` output channels, cols one of WINOGRAD_FP64_COLS. The plan's own
# rule: the widest Cout block (no wider than Cout rounded up to 8) whose
# items reach WINOGRAD_FP64_MIN_SHARE of the card's SMs, else the
# narrowest; the bf16-filter 3x3's grid one block an SM at most, each
# walking its items. Tuned on the served shapes by tools/chip_split_sweep.py
# (PERF.md): an SM's FP64 tensor cores take two narrow items as long as one
# twice as wide, so items past one an SM buy nothing at N=1, and wider items
# transform each input tile fewer times (at 56x56x64, 98 items of 32
# channels beat 196 of 16 by 5-14%; at 28x28x128, 104 of 16 beat 52 of 32
# and 208 of 8 by 13-20%).
WINOGRAD_FP64_TILES = 16
WINOGRAD_FP64_COLS = (32, 16, 8)
WINOGRAD_FP64_MIN_SHARE = 0.5


class WinogradFp64Plan(NamedTuple):
    """How the FP64 F(2,3) tile cuts a conv: items of WINOGRAD_FP64_TILES
    tiles x `cols` output channels, on a grid of `blocks` blocks."""

    cols: int
    blocks: int


def winograd_fp64_items(n: int, h: int, w: int, cout: int, cols: int) -> int:
    """Items of the FP64 tile: groups of 16 F(2,3) tiles x Cout blocks."""
    return -(-winograd_tiles(n, h, w, 2) // WINOGRAD_FP64_TILES) * -(-cout // cols)


@functools.lru_cache(maxsize=None)
def winograd_fp64_plan(n: int, h: int, w: int, cout: int,
                       sms: int = H100_SMS) -> WinogradFp64Plan:
    """The item shape and grid of an (n, h, w) -> cout FP64 F(2,3) conv on a
    card with `sms` SMs."""
    widest = -(-cout // 8) * 8
    fits = [c for c in WINOGRAD_FP64_COLS if c <= widest]
    cols = next((c for c in fits
                 if winograd_fp64_items(n, h, w, cout, c) >= WINOGRAD_FP64_MIN_SHARE * sms),
                WINOGRAD_FP64_COLS[-1])
    return WinogradFp64Plan(cols, min(winograd_fp64_items(n, h, w, cout, cols), sms))


@functools.lru_cache(maxsize=None)
def winograd_plan(n: int, h: int, w: int, cin: int, cout: int, m: int,
                  sms: int = H100_SMS) -> WinogradPlan:
    """The grid and the cut of an (n, h, w, cin) -> cout F(m,3) conv on a card
    with `sms` SMs."""
    blocks = WINOGRAD_BLOCKS_PER_SM * sms
    plan = WinogradPlan(blocks, 1, cin)
    items = plan.items(winograd_tiles(n, h, w, m), cout, (m + 2) ** 2)
    split = split_k(cin, -(-blocks // items), WINOGRAD_STEP, WINOGRAD_MIN_CHUNK)
    return plan._replace(splits=split.splits, chunk=split.chunk)


def tile_size(u: torch.Tensor) -> int:
    """The Winograd output tile m, inferred from u's leading dim a^2."""
    m = {36: 4, 16: 2}.get(u.shape[0])
    if m is None:
        raise ValueError(
            f"filter leading dim {u.shape[0]} is not 36 (F(4,3)) or 16 (F(2,3))"
        )
    return m


@functools.lru_cache(maxsize=None)
def winograd_matrices(m: int, dtype: torch.dtype, device: torch.device):
    """(Bt, At) as tensors, copied to the device once (so the plain version
    makes no host-to-device copy after its first call)."""
    bt, _, at = transforms.matrices(m)
    return (torch.as_tensor(bt, dtype=dtype, device=device),
            torch.as_tensor(at, dtype=dtype, device=device))


def _apply_const(mat, t: torch.Tensor, dim: int) -> torch.Tensor:
    """out[p] = sum_q mat[p][q] * t[q] along `dim`, in q order over mat's
    nonzero entries only (+-1 as adds and subtracts): a zero coefficient
    never meets a value, so a NaN reaches just the outputs that read it, as
    in the JAX kernels' constant-matrix transforms (winograd_tpu/kernels/
    winograd.py::_apply_const_matrix) and csrc's sandwich."""
    rows = []
    for coeffs in mat:
        acc = None
        for q, c in enumerate(coeffs):
            if c == 0.0:
                continue
            term = t.select(dim, q)
            term = term if c == 1.0 else -term if c == -1.0 else term * c
            acc = term if acc is None else acc + term
        rows.append(acc)
    return torch.stack(rows, dim=dim)


def _position_products(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """M[q] = V[q] U[q] at every tile position q; v: (n, th, tw, a^2, cin).
    A bfloat16 u takes the bf16w tier's products (pointwise.py::
    split_dot_bf16w's arithmetic on a float32 V): V split into bf16 hi and
    lo halves, each multiplied by u in float32."""
    if u.dtype != torch.bfloat16:
        return torch.einsum("nyxpc,pco->nyxpo", v, u)
    if v.dtype != torch.float32:
        raise ValueError(f"bfloat16 weights take a float32 activation, got {v.dtype}")
    v_hi = v.to(torch.bfloat16).float()
    v_lo = (v - v_hi).to(torch.bfloat16).float()
    uf = u.float()
    return (torch.einsum("nyxpc,pco->nyxpo", v_hi, uf)
            + torch.einsum("nyxpc,pco->nyxpo", v_lo, uf))


def conv3x3_bn_winograd_plain(x, u, scale, bias, relu: bool = True) -> torch.Tensor:
    """The Winograd algorithm in plain PyTorch: tiles, Bt d Bt^T, per-position
    products with u, At M At^T, crop, BN (+ReLU). x: (N, H, W, Cin). A
    bfloat16 u at F(2,3) runs the bf16w products (_position_products), the
    arithmetic of conv3x3_bn_winograd at "bf16w" and of the bf16w stage's
    F(2,3) mid (kernels/stage.py); at "bf16" the op is
    winograd2_mid_plain's."""
    m = tile_size(u)
    a = m + 2
    n, h, w, cin = x.shape
    cout = u.shape[2]
    th, tw = -(-h // m), -(-w // m)
    bt, _, at = (mat.tolist() for mat in transforms.matrices(m))
    # Zero pad 1 on the left/top, and on the right/bottom up to m*t + 2.
    xp = F.pad(x, (0, 0, 1, m * tw + 1 - w, 1, m * th + 1 - h))
    d = xp.unfold(1, a, m).unfold(2, a, m)              # (n, th, tw, cin, a, a)
    v = _apply_const(bt, _apply_const(bt, d, -2), -1)   # Bt d Bt^T: (n, th, tw, cin, a, a)
    v = v.permute(0, 1, 2, 4, 5, 3)
    mm = _position_products(v.reshape(n, th, tw, a * a, cin), u)
    mm = mm.reshape(n, th, tw, a, a, cout)
    y = _apply_const(at, _apply_const(at, mm, 3), 4)     # At M At^T: (n, th, tw, m, m, cout)
    y = y.permute(0, 1, 3, 2, 4, 5)
    y = y.reshape(n, th * m, tw * m, cout)[:, :h, :w]
    y = y * scale + bias
    return torch.relu(y) if relu else y


def winograd2_mid_plain(h, u2_bf16, scale, bias, relu: bool = True) -> torch.Tensor:
    """F(2,3) on a bf16 filter: the Winograd algebra in float64 (order-free
    to the last bit of h's dtype), rounded once, then BN (+ReLU), each
    multiply and add rounded on its own. h: (N, H, W, C)."""
    ones = torch.ones(u2_bf16.shape[-1], dtype=torch.float64, device=h.device)
    y = conv3x3_bn_winograd_plain(h.double(), u2_bf16.double(), ones, torch.zeros_like(ones),
                                  relu=False).to(h.dtype)
    y = y * scale + bias
    return torch.relu(y) if relu else y


# The wrapper's precisions: f32 u, and the two arithmetics of a bfloat16 u.
PRECISIONS = ("f32", "bf16", "bf16w")


@_build.checked("winograd", "winograd_bf16w")
def conv3x3_bn_winograd(x, u, scale, bias, relu: bool = True,
                        precision: str = "f32") -> torch.Tensor:
    """Fused 3x3 conv + BN (+ReLU) via Winograd F(m,3).

    x: (H, W, Cin) or (N, H, W, Cin) float32; u: (a^2, Cin, Cout) from
    transforms.transform_filter, m inferred from a^2 (36 -> F(4,3),
    16 -> F(2,3)); scale, bias: (Cout,). precision (PRECISIONS): "f32" on a
    float32 u; "bf16w" or "bf16" (the module docstring) on a bfloat16 u at
    F(2,3); any other pairing is a ValueError. CPU tensors run the plain
    version; CUDA tensors launch csrc/winograd.cu, counted as
    "winograd_bf16w" at "bf16w"."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown Winograd precision {precision!r}; choose from {PRECISIONS}")
    bf16 = u.dtype == torch.bfloat16
    if bf16 != (precision != "f32"):
        raise ValueError(f"u {u.dtype} at precision {precision!r}: a bfloat16 u takes "
                         "precision 'bf16' or 'bf16w', a float32 u 'f32'")
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    n, h, w, cin = x.shape
    if u.shape[1] != cin:
        raise ValueError(f"u {tuple(u.shape)} does not take {cin} input channels")
    m = tile_size(u)
    if bf16 and m != 2:
        raise ValueError("a bfloat16 filter takes F(2,3) only (u of 16 positions)")
    if precision == "bf16w":
        _build.check_bf16w(x)
    if x.device.type == "cpu":
        plain = winograd2_mid_plain if precision == "bf16" else conv3x3_bn_winograd_plain
        out = plain(x, u, scale, bias, relu)
    else:
        cout = u.shape[2]
        _build.check_operands(scale, bias, cout, x)
        _build.check_tensors(u, dtype=torch.bfloat16 if bf16 else torch.float32, device=x.device)
        if precision == "bf16":
            out = _winograd_fp64(x, u, scale, bias, relu)
        else:
            out = torch.empty(n, h, w, cout, device=x.device, dtype=torch.float32)
            plan = winograd_plan(n, h, w, cin, cout, m, _build.sm_count(x.device))
            out = conv3x3_bn_winograd_planned(x, u, scale, bias, relu, plan, out)
    return out[0] if squeeze else out


def _winograd_fp64(x, u, scale, bias, relu: bool) -> torch.Tensor:
    """The "bf16" launch under winograd_fp64_plan's plan. The FP64 tile
    copies its filter in 16-byte pieces: a Cout off a multiple of 8 is
    padded with zero channels (sliced off the output), an unaligned u
    copied."""
    n, h, w, _ = x.shape
    cout = u.shape[2]
    c8 = -(-cout // 8) * 8
    if c8 != cout or u.data_ptr() % 16:
        u, scale, bias = (F.pad(t, (0, c8 - cout)) for t in (u, scale, bias))
    plan = winograd_fp64_plan(n, h, w, c8, _build.sm_count(x.device))
    out = conv3x3_bn_winograd_fp64_planned(x, u, scale, bias, relu, plan)
    return out if c8 == cout else out[..., :cout].contiguous()


def conv3x3_bn_winograd_planned(x, u, scale, bias, relu: bool, plan: WinogradPlan,
                                out=None) -> torch.Tensor:
    """conv3x3_bn_winograd's tensor-core launch on CUDA tensors under an
    explicit plan (the wrapper passes winograd_plan's; tools/
    chip_split_sweep.py times others). x: (N, H, W, Cin); u float32, or
    bfloat16 for the bf16w entry, counted as "winograd_bf16w"; operands as
    conv3x3_bn_winograd checks them."""
    n, h, w, cin = x.shape
    m, cout = tile_size(u), u.shape[2]
    at = plan.workspace(winograd_tiles(n, h, w, m), cin, cout, (m + 2) ** 2)
    ws = torch.empty(at.words, device=x.device, dtype=torch.float32)
    if out is None:
        out = torch.empty(n, h, w, cout, device=x.device, dtype=torch.float32)
    c, ptr = _build.cint, _build.ptr
    bf16w = u.dtype == torch.bfloat16
    _build.launch(
        "winograd", "winograd_conv3x3_bn_bf16w" if bf16w else "winograd_conv3x3_bn",
        (n, h, w, cin, cout, m, bool(relu)), x.device,
        ptr(x), ptr(u), ptr(scale), ptr(bias), ptr(out), ptr(ws), ctypes.c_longlong(at.words),
        ctypes.c_longlong(at.v), ctypes.c_longlong(at.part), c(n), c(h), c(w), c(cin), c(cout),
        c(m), c(relu),
        c(WINOGRAD_TILE), c(plan.blocks), c(plan.splits), c(plan.chunk),
        counter="winograd_bf16w" if bf16w else None,
    )
    return out


def conv3x3_bn_winograd_fp64_planned(x, u, scale, bias, relu: bool,
                                     plan: WinogradFp64Plan) -> torch.Tensor:
    """conv3x3_bn_winograd's "bf16" launch (the FP64 tile) on CUDA tensors
    under an explicit plan (the wrapper passes winograd_fp64_plan's; tools/
    chip_split_sweep.py times others). x: (N, H, W, Cin); u (16, Cin, Cout)
    bfloat16, Cout a multiple of 8, 16-byte aligned (else the C entry
    refuses it); operands as conv3x3_bn_winograd checks them."""
    n, h, w, cin = x.shape
    cout = u.shape[2]
    out = torch.empty(n, h, w, cout, device=x.device, dtype=torch.float32)
    c, ptr = _build.cint, _build.ptr
    _build.launch(
        "winograd", "winograd_conv3x3_bn_bf16", (n, h, w, cin, cout, 2, bool(relu), "bf16"),
        x.device, ptr(x), ptr(u), ptr(scale), ptr(bias), ptr(out),
        c(n), c(h), c(w), c(cin), c(cout), c(relu), c(plan.cols), c(plan.blocks),
    )
    return out
