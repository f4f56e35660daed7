"""Pipeline parallelism: GPipe over a ("pipe",) mesh, one stage a rank.

Port of winograd_tpu/parallel/pipeline.py. M microbatches take M + P - 1
steps on P stages: at step t stage s runs microbatch t - s when that is one
of the M (the other steps are its bubble), takes its input from stage s - 1
(stage 0 from the request) and hands its output to stage s + 1 by send and
recv (the JAX package's ppermute). The last stage's outputs reach every
rank by one broadcast, which plays the part of the JAX package's final
psum, so every rank returns the whole result, as it passed the whole input.

pipelined_stage_inference splits a uniform run of blocks into P equal
stages. The classifiers (pipelined_resnet50_inference,
pipelined_basicnet_inference) are cut into segments at block granularity
(the stem with its entry block, each stride-2 transition or entry block,
each identity block, the head with the last rank), each with its nominal
FLOPs, and _balanced_partition gives each rank a contiguous group of them
that balances the FLOPs. A rank builds and runs only its own group: this
replaces the JAX package's lax.switch over every rank's branch and its
flat buffers padded to the largest boundary, since a process can run code
of its own and receive a tensor of the shape its group starts with.
Identity blocks of one stage that land on one rank still run as one run of
the single-device route (models/resnet.py::resnet_stage, models/basic.py::
basicnet_stages, the int8 stage kernels), so its route gates pick the
stage kernel for them as they would on one device, and a rank launches no
more kernels than its share of the single-device forward; a stage cut
between two ranks is one run on each. The weights stay whole on every rank
(the JAX package replicates them too): this schedule streams activations,
and cutting the weights is tensor_parallel.py's work.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from winograd_tpu_torch.config import (
    TIERS, BlockConfig, TransitionConfig, case_flops, stem_entry_flops,
)
from winograd_tpu_torch.kernels.basic_stage import basic_stage_int8
from winograd_tpu_torch.kernels.quantized import resnet_stage_int8, transition_block_int8
from winograd_tpu_torch.models.basic import (
    _small_map, basic_block_int8, basicnet_stages, downsample_basic_block,
    downsample_basic_block_int8,
)
from winograd_tpu_torch.models.downsample import (
    downsample_bottleneck_block, projection_bottleneck_block,
)
from winograd_tpu_torch.models.resnet import check_precision, resnet_stage
from winograd_tpu_torch.models.resnet50 import (
    head, head_int8, projection_block_int8, stem,
)
from winograd_tpu_torch.ops import torch_ops
from winograd_tpu_torch.parallel.mesh import Mesh, axis_index, broadcast, recv, send

__all__ = [
    "pipelined_basicnet_inference", "pipelined_resnet50_inference",
    "pipelined_stage_inference",
]


class Segment(NamedTuple):
    """A piece of a classifier the partition may put on any rank: its
    forward (None for an identity block, which runs inside its rank's run
    of the stage's blocks), its nominal FLOPs at batch 1, the (H, W, C) it
    outputs, and what it is: ("stem",), ("tr", stage) or ("blk", stage,
    block)."""

    fn: Optional[Callable]
    flops: int
    out_shape: Tuple[int, int, int]
    meta: tuple


def _gpipe(mesh: Mesh, stage_fn: Callable, x: torch.Tensor, microbatch: int,
           in_shape: Sequence[int], out_shape: Sequence[int]) -> torch.Tensor:
    """The GPipe schedule (module docstring) of this rank's stage_fn over x
    (N, ...), whole on every rank; returns the last stage's (N, *out_shape)
    on every rank. in_shape: the microbatch this rank receives."""
    n = x.shape[0]
    if n % microbatch:
        raise ValueError(f"batch {n} is not a multiple of microbatch {microbatch}")
    p, s = mesh.shape["pipe"], axis_index(mesh, "pipe")
    m = n // microbatch
    outs = torch.empty((n,) + tuple(out_shape), dtype=torch.float32, device=mesh.device)
    sends = []
    for t in range(m + p - 1):
        j = t - s
        if not 0 <= j < m:
            continue  # this stage's bubble
        rows = slice(j * microbatch, (j + 1) * microbatch)
        if s == 0:
            a = x[rows].to(mesh.device).contiguous()
        else:
            a = recv((microbatch,) + tuple(in_shape), mesh, "pipe", s - 1)
        y = stage_fn(a)
        if s == p - 1:
            outs[rows] = y
        else:
            sends.append(send(y, mesh, "pipe", s + 1))
    for req in sends:
        req.wait()
    return broadcast(outs, mesh, "pipe", p - 1)


def pipelined_stage_inference(mesh: Mesh, params_list: Sequence[Dict], x, microbatch: int,
                              block_fn: Optional[Callable] = None) -> torch.Tensor:
    """A run of bottleneck blocks as a P-stage pipeline, len(params_list) / P
    blocks a stage. x: (N, H, W, C), the whole batch on every rank, N a
    multiple of microbatch. block_fn(x, params) defaults to the plain
    block (ops/torch_ops.py::bottleneck_block, raw w_mid: the JAX
    package's XLA block); models/resnet.py::bottleneck_block pipelines the
    port's block kernel (params with w9_mid, u2_mid). Returns the whole
    output on every rank."""
    p, s = mesh.shape["pipe"], axis_index(mesh, "pipe")
    if len(params_list) % p:
        raise ValueError(f"{len(params_list)} blocks do not split over {p} stages")
    block_fn = block_fn or torch_ops.bottleneck_block
    bps = len(params_list) // p
    mine = [{k: torch.as_tensor(v).to(mesh.device) for k, v in b.items()}
            for b in params_list[s * bps:(s + 1) * bps]]

    def stage_fn(a):
        for b in mine:
            a = block_fn(a, b)
        return a

    x = torch.as_tensor(x, dtype=torch.float32)
    return _gpipe(mesh, stage_fn, x, microbatch, x.shape[1:], x.shape[1:])


def _balanced_partition(costs, k: int):
    """Split costs into k contiguous NON-EMPTY groups minimizing the max
    group sum (the pipeline's steady-state bottleneck). O(n^2 k) DP — n is
    tens of blocks. Requires len(costs) >= k (every rank gets at least one
    segment — an empty group would idle a device even on a cost tie).
    Returns group boundary indices: groups[i] = [b[i], b[i+1])."""
    n = len(costs)
    assert n >= k >= 1, (n, k)
    prefix = [0]
    for c in costs:
        prefix.append(prefix[-1] + c)
    INF = float("inf")
    # best[j][i]: minimal max-group-sum splitting the first i items into j
    # non-empty groups (valid only for i >= j).
    best = [[INF] * (n + 1) for _ in range(k + 1)]
    cut = [[0] * (n + 1) for _ in range(k + 1)]
    best[0][0] = 0.0
    for j in range(1, k + 1):
        for i in range(j, n + 1):
            for p in range(j - 1, i):
                v = max(best[j - 1][p], prefix[i] - prefix[p])
                if v < best[j][i]:
                    best[j][i], cut[j][i] = v, p
    bounds = [n]
    for j in range(k, 0, -1):
        bounds.append(cut[j][bounds[-1]])
    return bounds[::-1]


def _check_precision(precision: str) -> None:
    if precision not in TIERS:
        raise ValueError(f"unknown precision {precision!r}; choose from {TIERS}")


def _first_map(img_hw: int) -> int:
    if img_hw % 4:
        raise ValueError(f"image side {img_hw} is not a multiple of 4 (the 7x7/2 stem "
                         "and the 3x3/2 maxpool)")
    return img_hw // 4


def _classifier_segments(params: Dict, img_hw: int, precision: str = "f32"):
    """The bottleneck classifier (any depth) cut into Segments: [the stem
    and the projection entry], each stride-2 transition, each identity
    block; with make_run(si, bi, bj), the forward of the identity run
    bi..bj of stage si as one resnet_stage (or int8 stage kernel) call, and
    head_fn. Costs and boundary shapes come from the weights' shapes.
    params: the tier's parameters on the rank's device (precision "f32",
    "bf16w" from models/convert.py::cast_bf16w, "int8" from
    models/resnet50.py::quantize_resnet50). Returns (segs, make_run,
    head_fn, classes)."""
    _check_precision(precision)
    hw = _first_map(img_hw)
    int8 = precision == "int8"
    wr, we = ("w_reduce_q", "w_expand_q") if int8 else ("w_reduce", "w_expand")
    stem_c, c_mid0 = params["proj"][wr].shape
    c_io0 = params["proj"][we].shape[1]

    if int8:
        def stem_proj(a):
            return projection_block_int8(stem(a, params["stem"], "bf16"), params["proj"])

        def make_run(si, bi, bj):
            blocks = {k: v[bi:bj + 1] for k, v in params["stages"][si]["blocks"].items()}
            return lambda a: resnet_stage_int8(a, blocks)

        def transition(si):
            return lambda a: transition_block_int8(a, params["stages"][si]["transition"])

        def head_fn(a):
            return head_int8(a, params["head"])
    else:
        def stem_proj(a):
            return projection_bottleneck_block(stem(a, params["stem"], precision),
                                               params["proj"], precision)

        def make_run(si, bi, bj):
            st = params["stages"][si]
            stacked = st.get("stacked")
            if stacked is not None:
                stacked = {k: v[bi:bj + 1] for k, v in stacked.items()}
            blocks = st["blocks"][bi:bj + 1]
            return lambda a: resnet_stage(a, blocks, stacked=stacked, precision=precision)

        def transition(si):
            tp = params["stages"][si]["transition"]
            check_precision(precision, tp["w_reduce"])
            return lambda a: downsample_bottleneck_block(a, tp)

        def head_fn(a):
            return head(a, params["head"], precision)

    segs = [Segment(stem_proj, stem_entry_flops(img_hw, stem_c, c_mid0, c_io0),
                    (hw, hw, c_io0), ("stem",))]
    for si, st in enumerate(params["stages"]):
        if st.get("transition") is not None:
            c_in, c_mid = st["transition"][wr].shape
            c_out = st["transition"][we].shape[1]
            ho = -(-hw // 2)  # the kernels SAME-pad odd maps
            segs.append(Segment(transition(si),
                                case_flops(TransitionConfig("t", c_in, c_mid, c_out, hw=hw)),
                                (ho, ho, c_out), ("tr", si)))
            hw = ho
        blocks = st["blocks"]
        shapes = ([tuple(blocks[wr].shape[1:])] * blocks[wr].shape[0] if int8
                  else [tuple(b["w_reduce"].shape) for b in blocks])
        for bi, (c_io, c_mid) in enumerate(shapes):
            segs.append(Segment(None, case_flops(BlockConfig("b", c_io=c_io, c_mid=c_mid, hw=hw)),
                                (hw, hw, c_io), ("blk", si, bi)))
    classes = params["head"]["w_fc_q" if int8 else "w_fc"].shape[1]
    return segs, make_run, head_fn, classes


def _basicnet_segments(params: Dict, img_hw: int, precision: str = "f32"):
    """The basic-block classifier (ResNet-18/34) cut into Segments: [the
    stem], each stride-2 entry block, each identity block; make_run(si,
    bi, bj) runs the identity run bi..bj of stage si as the single-device
    route does (a whole small-map stage with its "fused" artifact in one
    basic-stage launch, else block by block); head_fn. params: the tier's
    parameters on the rank's device (precision "f32", "bf16w" from
    models/convert.py::cast_basicnet_bf16w, "int8" from models/basic.py::
    quantize_basicnet). Returns (segs, make_run, head_fn, classes)."""
    _check_precision(precision)
    hw = _first_map(img_hw)
    int8 = precision == "int8"
    stem_c = params["stem"]["s_stem"].shape[0]

    def whole(st, bi, bj):
        return bi == 0 and bj == len(st["blocks"]) - 1 and st.get("fused") is not None

    if int8:
        def stem_fn(a):
            return stem(a, params["stem"], "bf16")

        def entry(si):
            return lambda a: downsample_basic_block_int8(a, params["stages"][si]["entry"])

        def make_run(si, bi, bj):
            st = params["stages"][si]

            def run(a):
                if whole(st, bi, bj) and _small_map(a):
                    return basic_stage_int8(a, st["fused"])
                for b in st["blocks"][bi:bj + 1]:
                    a = basic_block_int8(a, b)
                return a

            return run

        def head_fn(a):
            return head_int8(a, params["head"])
    else:
        def stem_fn(a):
            return stem(a, params["stem"], precision)

        def entry(si):
            return lambda a: downsample_basic_block(a, params["stages"][si]["entry"], precision)

        def make_run(si, bi, bj):
            st = params["stages"][si]
            sub = {"blocks": st["blocks"][bi:bj + 1]}
            if whole(st, bi, bj):
                sub["fused"] = st["fused"]
            return lambda a: basicnet_stages(a, [sub], precision)

        def head_fn(a):
            return head(a, params["head"], precision)

    hs = img_hw // 2
    segs = [Segment(stem_fn, 2 * hs * hs * 49 * 3 * stem_c, (hw, hw, stem_c), ("stem",))]
    prev = stem_c
    for si, st in enumerate(params["stages"]):
        if st.get("entry") is not None:
            c = st["entry"]["s_b"].shape[0]
            hw = -(-hw // 2)
            segs.append(Segment(entry(si), 2 * hw * hw * (9 * prev * c + 9 * c * c + prev * c),
                                (hw, hw, c), ("tr", si)))
            prev = c
        for bi in range(len(st["blocks"])):
            segs.append(Segment(None, 2 * hw * hw * 2 * 9 * prev * prev, (hw, hw, prev),
                                ("blk", si, bi)))
    classes = params["head"]["w_fc_q" if int8 else "w_fc"].shape[1]
    return segs, make_run, head_fn, classes


def _make_group(segs: List[Segment], make_run: Callable, head_fn: Callable, i0: int,
                i1: int, with_head: bool) -> Callable:
    """The forward of segments i0..i1-1 (and the head on the last rank):
    each contiguous run of identity blocks of one stage as ONE make_run
    call, so blocks that landed on one rank run as the single-device route
    runs them."""
    plan = []
    j = i0
    while j < i1:
        meta = segs[j].meta
        if meta[0] == "blk":
            k = j
            while k + 1 < i1 and segs[k + 1].meta[0] == "blk" and segs[k + 1].meta[1] == meta[1]:
                k += 1
            plan.append(make_run(meta[1], meta[2], segs[k].meta[2]))
            j = k + 1
        else:
            plan.append(segs[j].fn)
            j += 1

    def group(a):
        for f in plan:
            a = f(a)
        return head_fn(a) if with_head else a

    return group


def rank_groups(segs: List[Segment], make_run: Callable, head_fn: Callable,
                n_stages: int) -> List[Tuple[Callable, Tuple[int, int, int]]]:
    """Each rank's (group forward, (H, W, C) it receives) of an n_stages
    pipe: the FLOP-balanced contiguous partition of the segments. Rank 0
    receives the image (its entry is None)."""
    if n_stages > len(segs):
        raise ValueError(f"a {n_stages}-rank pipe needs at least {n_stages} segments, the "
                         f"model has {len(segs)}")
    bounds = _balanced_partition([s.flops for s in segs], n_stages)
    return [(_make_group(segs, make_run, head_fn, bounds[r], bounds[r + 1],
                         r == n_stages - 1),
             None if r == 0 else segs[bounds[r] - 1].out_shape)
            for r in range(n_stages)]


def _pipelined_classifier(mesh: Mesh, x, microbatch: int, segments) -> torch.Tensor:
    segs, make_run, head_fn, classes = segments
    group, entry = rank_groups(segs, make_run, head_fn,
                               mesh.shape["pipe"])[axis_index(mesh, "pipe")]
    x = torch.as_tensor(x, dtype=torch.float32)
    return _gpipe(mesh, group, x, microbatch, entry or x.shape[1:], (classes,))


def pipelined_resnet50_inference(mesh: Mesh, params: Dict, x, microbatch: int,
                                 precision: str = "f32") -> torch.Tensor:
    """The whole bottleneck classifier (ResNet-50/101/152) as a
    heterogeneous GPipe pipeline over any pipe size (module docstring): the
    segments FLOP-balanced into contiguous rank groups, each rank running
    its own. params: the tier's forward parameters on the mesh's device
    (precision "f32"; "bf16w": models/convert.py::cast_bf16w's; "int8":
    models/resnet50.py::quantize_resnet50's), whole on every rank. x: (N,
    H, W, 3), the whole request on every rank, N a multiple of microbatch.
    Returns the whole (N, classes) logits on every rank."""
    return _pipelined_classifier(
        mesh, x, microbatch, _classifier_segments(params, torch.as_tensor(x).shape[1], precision))


def pipelined_basicnet_inference(mesh: Mesh, params: Dict, x, microbatch: int,
                                 precision: str = "f32") -> torch.Tensor:
    """The whole basic-block classifier (ResNet-18/34) as the same pipeline;
    params: the tier's forward parameters (precision "f32"; "bf16w":
    models/convert.py::cast_basicnet_bf16w's; "int8": models/basic.py::
    quantize_basicnet's) on the mesh's device. x and the result as
    pipelined_resnet50_inference's."""
    return _pipelined_classifier(
        mesh, x, microbatch, _basicnet_segments(params, torch.as_tensor(x).shape[1], precision))
