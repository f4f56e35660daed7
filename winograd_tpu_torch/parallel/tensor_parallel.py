"""Tensor parallelism: the Megatron recipe on the port's kernels, with
explicit all_reduce and all_gather on the mesh's "model" axis.

Port of winograd_tpu/parallel/tensor_parallel.py. Each function takes the
whole input on every rank (as a JAX caller passes one global array),
computes its rank's share with the port's kernel wrappers
(kernels/pointwise.py::conv1x1_bn, kernels/direct.py::conv3x3_bn_direct,
kernels/stem.py through models/resnet50.py::stem, kernels/quantized.py::
conv1x1_bn_int8 and ::conv3x3_bn_int8) and returns the whole result on
every rank: the batch is cut over "data" and gathered back at the end.

* A contraction-sharded (row-parallel) layer runs its kernel on the rank's
  input-channel shard with identity BN and no ReLU, the partial sums meet
  in one psum, and the BN and ReLU run after it, on the full sum.
* An output-sharded (column-parallel) layer needs no collective: its BN
  rides the shard, fused in the kernel.

A bottleneck block is reduce column-parallel (h1 lands Cmid-sharded), the
3x3 row-parallel (stride 1 through the direct kernel on the rank's Cmid
shard, whose im2col depth is 9 * Cmid / p; stride 2 as a strided im2col of
the shard through the pointwise kernel) with one psum, expand and the
projection shortcut column-parallel, the skip added on the rank's channel
shard, and one tiled all_gather re-replicating the block's output for the
next block. A basic block is conv a column-parallel and conv b
row-parallel: one psum a block and no all_gather, the projection shortcut
replicated.

The classifiers (make_resnet50_tp_fn, make_basicnet_tp_fn) compute the
stem on every model rank (its weights are small), and shard the head FC by
columns, one all_gather of logits, when the class count divides the model
axis and the tier is not int8, else run it replicated. The JAX package pads
classes to 128 lanes for the TPU and tests the padded count; the port pads
nothing, and the logits are the same either way. At "bf16w" the shards are
bfloat16 (models/convert.py's cast, which commutes with the cut) and run
the kernels' bf16w instantiations; at "int8" each weight matrix is
quantized whole (per output channel, kernels/quantized.py::
quantize_weights), then cut like its f32 twin: the column-parallel layers'
scales ride the shard, the row-parallel 3x3's stay whole, and its kernel
quantizes the rows of the rank's channel shard and dequantizes before the
psum. That is a different arithmetic from one device's int8 forward (its
rows span every channel), so the int8 TP logits are held against the
float64 golden and this module's own plain int8 forward, not against the
single-device int8 engine. Weights are cut, cast or quantized once, when a
make_* function builds its forward.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from winograd_tpu_torch.config import TIERS
from winograd_tpu_torch.kernels.direct import conv3x3_bn_direct
from winograd_tpu_torch.kernels.pointwise import conv1x1_bn
from winograd_tpu_torch.kernels.quantized import (
    _numpy, conv1x1_bn_int8, conv3x3_bn_int8, quantize_weights,
)
from winograd_tpu_torch.kernels.transition import strided_im2col
from winograd_tpu_torch.models.convert import cast_layer_bf16w
from winograd_tpu_torch.models.resnet50 import head, head_int8, stem
from winograd_tpu_torch.parallel.mesh import (
    Mesh, Spec, all_gather, axis_index, local_shard, psum,
)

__all__ = [
    "basicnet_forward_tp", "bottleneck_block_tp", "conv1x1_bn_tp_expand",
    "conv1x1_bn_tp_reduce", "conv3x3_bn_tp_direct", "make_basicnet_tp_fn",
    "make_resnet50_tp_fn", "resnet50_forward_tp", "resnet_stage_tp",
]

# Where each layer's weight is cut: a (K, N) matrix sharded on its rows
# (contraction) or its columns (outputs) over "model".
ROWS: Spec = ("model", None)
COLS: Spec = (None, "model")

# The stem's precision at each tier (models/resnet50.py's forwards).
_STEM_PRECISION = {"f32": "f32", "bf16w": "bf16w", "int8": "bf16"}


def _check_tier(tier: str) -> None:
    if tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r}; choose from {TIERS}")


def _f32(t, mesh: Mesh) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32).to(mesh.device).contiguous()


def _ones_zeros(c: int, mesh: Mesh):
    return (torch.ones(c, dtype=torch.float32, device=mesh.device),
            torch.zeros(c, dtype=torch.float32, device=mesh.device))


def _batch(x, mesh: Mesh) -> torch.Tensor:
    """This rank's batch shard over "data" of the whole input x (N, ...)."""
    return local_shard(torch.as_tensor(x, dtype=torch.float32), ("data",), mesh)


def _weight(w, spec: Spec, mesh: Mesh, tier: str, taps: int = 1):
    """This rank's shard of the (K, N) weight w under spec (ROWS or COLS) at
    `tier`: a float32 or bfloat16 tensor, or at "int8" the pair (w_q, s_w)
    of the whole matrix's per-column quantization, cut like w (s_w with the
    columns). taps=9 cuts a 3x3's (9 * C, N) direct-layout matrix per tap,
    C being the sharded contraction (direct_filter's row order, so the
    shard is the matrix of the rank's input-channel shard)."""
    s = None
    if tier == "int8":
        q, s = (torch.from_numpy(a) for a in quantize_weights(_numpy(w)))
    else:
        q = torch.as_tensor(w)
    k, n = q.shape
    q = local_shard(q.reshape(taps, k // taps, n), (None,) + tuple(spec), mesh)
    q = q.reshape(-1, q.shape[-1])
    if tier == "int8":
        return q, local_shard(s, spec[1:], mesh)
    return q.to(torch.bfloat16) if tier == "bf16w" else q.float()


def _vector(v, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of a float32 BN scale or bias, by the output spec."""
    return local_shard(torch.as_tensor(v, dtype=torch.float32), spec[1:], mesh)


def _pointwise(a: torch.Tensor, w, scale, bias, relu: bool) -> torch.Tensor:
    """The 1x1 kernel on a weight from _weight: int8 for a (w_q, s_w) pair."""
    if isinstance(w, tuple):
        return conv1x1_bn_int8(a, *w, scale, bias, relu)
    return conv1x1_bn(a, w, scale, bias, relu)


def _direct(a: torch.Tensor, w9, scale, bias, relu: bool) -> torch.Tensor:
    """The stride-1 3x3 kernel on a direct-layout weight from _weight."""
    if isinstance(w9, tuple):
        return conv3x3_bn_int8(a, *w9, scale, bias, relu)
    return conv3x3_bn_direct(a, w9, scale, bias, relu)


def _row_parallel(a: torch.Tensor, w9, stride: int, mesh: Mesh) -> torch.Tensor:
    """The partial sums of a row-parallel 3x3 on the rank's channel shard a:
    identity BN, no ReLU; stride 2 as a strided im2col through the
    pointwise kernel."""
    cout = (w9[0] if isinstance(w9, tuple) else w9).shape[1]
    ones, zeros = _ones_zeros(cout, mesh)
    if stride == 2:
        return _pointwise(strided_im2col(a), w9, ones, zeros, False)
    return _direct(a, w9, ones, zeros, False)


def _subsample(x: torch.Tensor) -> torch.Tensor:
    return x[:, ::2, ::2, :].contiguous()


def _gather_batch(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return all_gather(y, mesh, "data", dim=0)


# --- layers ----------------------------------------------------------------------------


def conv1x1_bn_tp_reduce(mesh: Mesh, x, w, scale, bias, relu: bool = True) -> torch.Tensor:
    """Contraction-sharded 1x1 conv + BN (+ReLU). x: (N, H, W, Cin), Cin cut
    over "model" and N over "data"; w: (Cin, Cout) cut on its rows. One psum
    of the partial products; BN and ReLU after it. Returns the whole
    (N, H, W, Cout) on every rank."""
    w_l = _weight(w, ROWS, mesh, "f32")
    x_l = local_shard(torch.as_tensor(x, dtype=torch.float32), ("data", None, None, "model"), mesh)
    ones, zeros = _ones_zeros(w_l.shape[1], mesh)
    y = psum(conv1x1_bn(x_l, w_l, ones, zeros, False), mesh, "model")
    y = y * _f32(scale, mesh) + _f32(bias, mesh)
    return _gather_batch(torch.relu(y) if relu else y, mesh)


def conv1x1_bn_tp_expand(mesh: Mesh, x, w, scale, bias, relu: bool = False) -> torch.Tensor:
    """Output-sharded 1x1 conv + BN (+ReLU): w (Cmid, Cout) and the BN cut
    on Cout over "model", no collective in the layer (its BN fused in the
    kernel); the rank's Cout shard is gathered back with the batch, so
    every rank returns the whole (N, H, W, Cout)."""
    w_l = _weight(w, COLS, mesh, "f32")
    y = conv1x1_bn(_batch(x, mesh), w_l, _vector(scale, COLS, mesh), _vector(bias, COLS, mesh),
                   relu)
    return _gather_batch(all_gather(y, mesh, "model", dim=-1), mesh)


def conv3x3_bn_tp_direct(mesh: Mesh, x, w9r, scale, bias, relu: bool = True) -> torch.Tensor:
    """Row-parallel 3x3 conv (pad 1, stride 1) + BN (+ReLU): x (N, H, W, Cin)
    with Cin cut over "model"; w9r the direct-layout filter as (9, Cin,
    Cout), each tap's Cin block cut alike. The direct kernel runs on the
    rank's channel shard, one psum, then BN and ReLU. Returns the whole
    (N, H, W, Cout) on every rank."""
    w9r = torch.as_tensor(w9r)
    w9_l = _weight(w9r.reshape(-1, w9r.shape[2]), ROWS, mesh, "f32", taps=9)
    x_l = local_shard(torch.as_tensor(x, dtype=torch.float32), ("data", None, None, "model"), mesh)
    y = psum(_row_parallel(x_l, w9_l, 1, mesh), mesh, "model")
    y = y * _f32(scale, mesh) + _f32(bias, mesh)
    return _gather_batch(torch.relu(y) if relu else y, mesh)


# --- bottleneck blocks -------------------------------------------------------------------


def _tp_bottleneck_params(p: Dict, mesh: Mesh, tier: str) -> Dict:
    """One bottleneck (identity, projection or transition) block's shards:
    reduce and expand (and the projection) column-parallel with their BN,
    the direct-layout 3x3 row-parallel per tap, its BN whole."""
    out = {
        "w_reduce": _weight(p["w_reduce"], COLS, mesh, tier),
        "s_reduce": _vector(p["s_reduce"], COLS, mesh),
        "b_reduce": _vector(p["b_reduce"], COLS, mesh),
        "w9_mid": _weight(p["w9_mid"], ROWS, mesh, tier, taps=9),
        "s_mid": _f32(p["s_mid"], mesh), "b_mid": _f32(p["b_mid"], mesh),
        "w_expand": _weight(p["w_expand"], COLS, mesh, tier),
        "s_expand": _vector(p["s_expand"], COLS, mesh),
        "b_expand": _vector(p["b_expand"], COLS, mesh),
    }
    if "w_proj" in p:
        out.update(w_proj=_weight(p["w_proj"], COLS, mesh, tier),
                   s_proj=_vector(p["s_proj"], COLS, mesh),
                   b_proj=_vector(p["b_proj"], COLS, mesh))
    return out


def _tp_bottleneck(h: torch.Tensor, b: Dict, stride: int, mesh: Mesh) -> torch.Tensor:
    """One block on the replicated activation h (the rank's batch shard):
    two launches and a third for the projection, the 3x3's launch, one psum
    and one all_gather. stride 2 only with the projection shortcut."""
    h1 = _pointwise(h, b["w_reduce"], b["s_reduce"], b["b_reduce"], True)
    h2 = psum(_row_parallel(h1, b["w9_mid"], stride, mesh), mesh, "model")
    h2 = torch.relu(h2 * b["s_mid"] + b["b_mid"])
    h3 = _pointwise(h2, b["w_expand"], b["s_expand"], b["b_expand"], False)
    if "w_proj" in b:
        xs = _subsample(h) if stride == 2 else h
        skip = _pointwise(xs, b["w_proj"], b["s_proj"], b["b_proj"], False)
    else:
        lo = axis_index(mesh, "model") * h3.shape[-1]
        skip = h[..., lo:lo + h3.shape[-1]]
    return all_gather(torch.relu(h3 + skip), mesh, "model", dim=-1)


def bottleneck_block_tp(mesh: Mesh, x, params: Dict) -> torch.Tensor:
    """Tensor-parallel identity bottleneck block (module docstring), one psum
    and one all_gather. params: the block in the JAX package's layout (w9_mid
    the direct filter); Cio and Cmid divide by the "model" axis. x (N, H,
    W, Cio) whole, N cut over "data"; returns the whole output."""
    b = _tp_bottleneck_params(params, mesh, "f32")
    return _gather_batch(_tp_bottleneck(_batch(x, mesh), b, 1, mesh), mesh)


def resnet_stage_tp(mesh: Mesh, x, params_list: Sequence[Dict]) -> torch.Tensor:
    """A run of identity blocks with every block's weights cut over "model",
    each block bottleneck_block_tp's recipe: per rank and block 1/p of the
    (2 Cio Cmid + 9 Cmid^2) weight words, one activation-sized psum and one
    all_gather."""
    blocks = [_tp_bottleneck_params(p, mesh, "f32") for p in params_list]
    h = _batch(x, mesh)
    for b in blocks:
        h = _tp_bottleneck(h, b, 1, mesh)
    return _gather_batch(h, mesh)


# --- classifiers -------------------------------------------------------------------------


def _tp_head(params: Dict, mesh: Mesh, tier: str):
    """The head's forward of the final feature map: replicated at "int8"
    (head_int8 on the whole quantized FC) or where the classes do not
    divide the model axis (head), else column-parallel with one all_gather
    of the logits."""
    w_fc, b_fc = params["w_fc"], params["b_fc"]
    nc = w_fc.shape[1]
    if tier == "int8":
        w_q, s_w = (torch.from_numpy(a).to(mesh.device) for a in quantize_weights(_numpy(w_fc)))
        q = {"w_fc_q": w_q, "w_fc_s": s_w, "b_fc": _f32(b_fc, mesh)}
        return lambda h: head_int8(h, q)
    if nc % mesh.shape["model"]:
        whole = {"w_fc": _weight(w_fc, (None, None), mesh, tier), "b_fc": _f32(b_fc, mesh)}
        return lambda h: head(h, whole, tier)
    w_l, b_l = _weight(w_fc, COLS, mesh, tier), _vector(b_fc, COLS, mesh)
    ones = torch.ones_like(b_l)
    return lambda h: all_gather(conv1x1_bn(h.mean(dim=(-3, -2)), w_l, ones, b_l, False),
                                mesh, "model", dim=-1)


def _stem_params(params: Dict, mesh: Mesh, tier: str) -> Dict:
    p = {k: _f32(params[k], mesh) for k in ("w192_stem", "s_stem", "b_stem")}
    return cast_layer_bf16w(p) if tier == "bf16w" else p


def _classifier_fn(mesh: Mesh, stem_p: Dict, tier: str, body: Callable,
                   head_fn: Callable) -> Callable:
    def fn(x) -> torch.Tensor:
        h = stem(_batch(x, mesh), stem_p, _STEM_PRECISION[tier])
        return _gather_batch(head_fn(body(h)), mesh)

    return fn


def make_resnet50_tp_fn(mesh: Mesh, params: Dict, precision: str = "f32") -> Callable:
    """fn(x) serving the whole bottleneck classifier (ResNet-50/101/152, any
    depth) with every block's weights cut over "model" (module docstring):
    the stem on every model rank, each block (the projection entry, the
    transitions, the identity blocks) one psum and one all_gather, the head
    column-parallel where it can be. params: the port's f32 forward
    parameters (models/resnet50.py::init_resnet50_params or
    models/convert.py::params_from_jax; every block with w9_mid), on any
    device; precision "f32", "bf16w" or "int8" (cast or quantized here,
    once). x: (N, H, W, 3), the whole request on every rank, N divisible
    by the "data" axis; fn returns the whole (N, classes) logits on every
    rank, on the mesh's device. Per rank and forward: the stem 1 launch,
    per block the pointwise kernel 2 (3 with the projection; a stride-2 3x3
    is one more) and the direct kernel 1 at stride 1, the head 1; the
    kernels' bf16w instantiations at "bf16w", their int8 ones at "int8"."""
    _check_tier(precision)
    blocks: List[tuple] = [(_tp_bottleneck_params(params["proj"], mesh, precision), 1)]
    for st in params["stages"]:
        if st.get("transition") is not None:
            blocks.append((_tp_bottleneck_params(st["transition"], mesh, precision), 2))
        blocks += [(_tp_bottleneck_params(b, mesh, precision), 1) for b in st["blocks"]]

    def body(h):
        for b, stride in blocks:
            h = _tp_bottleneck(h, b, stride, mesh)
        return h

    return _classifier_fn(mesh, _stem_params(params["stem"], mesh, precision), precision, body,
                          _tp_head(params["head"], mesh, precision))


def resnet50_forward_tp(mesh: Mesh, params: Dict, x, precision: str = "f32") -> torch.Tensor:
    """One call of make_resnet50_tp_fn (which is the serving form: it cuts
    the weights once)."""
    return make_resnet50_tp_fn(mesh, params, precision)(x)


def _tp_basic_params(p: Dict, mesh: Mesh, tier: str) -> Dict:
    """One basic block's shards: conv a (w9_a, stride-2 or stride-1 direct
    layout) column-parallel with its BN, conv b row-parallel per tap with
    its BN whole, the projection (Cin Cout words, an order under the
    3x3s') replicated."""
    out = {
        "w9_a": _weight(p["w9_a"], COLS, mesh, tier),
        "s_a": _vector(p["s_a"], COLS, mesh), "b_a": _vector(p["b_a"], COLS, mesh),
        "w9_b": _weight(p["w9_b"], ROWS, mesh, tier, taps=9),
        "s_b": _f32(p["s_b"], mesh), "b_b": _f32(p["b_b"], mesh),
    }
    if "w_proj" in p:
        out.update(w_proj=_weight(p["w_proj"], (None, None), mesh, tier),
                   s_proj=_f32(p["s_proj"], mesh), b_proj=_f32(p["b_proj"], mesh))
    return out


def _tp_basic(h: torch.Tensor, b: Dict, stride: int, mesh: Mesh) -> torch.Tensor:
    if stride == 2:
        h1 = _pointwise(strided_im2col(h), b["w9_a"], b["s_a"], b["b_a"], True)
    else:
        h1 = _direct(h, b["w9_a"], b["s_a"], b["b_a"], True)
    h2 = psum(_row_parallel(h1, b["w9_b"], 1, mesh), mesh, "model")
    h2 = h2 * b["s_b"] + b["b_b"]
    skip = _pointwise(_subsample(h), b["w_proj"], b["s_proj"], b["b_proj"], False) \
        if "w_proj" in b else h
    return torch.relu(h2 + skip)


def make_basicnet_tp_fn(mesh: Mesh, params: Dict, precision: str = "f32") -> Callable:
    """fn(x) serving the whole basic-block classifier (ResNet-18/34) with
    every block's 3x3 weights cut over "model" (module docstring): conv a
    column-parallel, conv b row-parallel, one psum a block, the block's
    output already whole (no all_gather), the stride-2 entries' projection
    replicated, the stem on every rank, the head column-parallel where it
    can be. params: the port's f32 forward parameters (models/basic.py::
    basicnet_params or models/convert.py::basicnet_params_from_jax), on any
    device; precision "f32", "bf16w" or "int8" (cast or quantized here,
    once). x and the result as make_resnet50_tp_fn's. Per rank and forward:
    the stem 1, per block the direct kernel 2 (an entry: pointwise 2, the
    strided conv a and the projection, and direct 1), the head 1."""
    _check_tier(precision)
    blocks = []
    for st in params["stages"]:
        if st.get("entry") is not None:
            blocks.append((_tp_basic_params(st["entry"], mesh, precision), 2))
        blocks += [(_tp_basic_params(b, mesh, precision), 1) for b in st["blocks"]]

    def body(h):
        for b, stride in blocks:
            h = _tp_basic(h, b, stride, mesh)
        return h

    return _classifier_fn(mesh, _stem_params(params["stem"], mesh, precision), precision, body,
                          _tp_head(params["head"], mesh, precision))


def basicnet_forward_tp(mesh: Mesh, params: Dict, x, precision: str = "f32") -> torch.Tensor:
    """One call of make_basicnet_tp_fn."""
    return make_basicnet_tp_fn(mesh, params, precision)(x)
