"""The rank functions of the parallel tests (tests/test_torch_parallel*.py,
tests/test_torch_pipeline.py), run in worlds of ranks that
winograd_tpu_torch.parallel.mesh.spawn_world starts on the CPU (gloo, the
spawn start method, a FileStore in a temporary directory). A spawned rank
imports this module by name, so it imports neither jax nor winograd_tpu
nor a test module: the tests compute the JAX package's references in their
own process, hand each world its inputs as numpy arrays, and compare what
the ranks return.

Each world builds its meshes once, in the same order on every rank
(new_group is collective over the world), smaller meshes being sub-groups
of the world's first ranks; a rank outside a mesh skips that mesh's cases.
Every rank returns its results keyed by case; the tests hold rank 0's
against the JAX package and every other member's against rank 0's."""

from __future__ import annotations

import concurrent.futures
import contextlib
import datetime
import os

import torch
import torch.distributed as dist

from winograd_tpu_torch.config import TIERS
from winograd_tpu_torch.engine import (
    BackboneEngine, BottleneckEngine, ResNet50Engine, ResNetBasicEngine,
)
from winograd_tpu_torch.models.basic import (
    attach_fused_stage_artifacts, cast_basicnet_bf16w, quantize_basicnet,
)
from winograd_tpu_torch.models.convert import basicnet_params_from_jax, params_from_jax
from winograd_tpu_torch.models.resnet import bottleneck_block
from winograd_tpu_torch.models.resnet50 import cast_bf16w, quantize_resnet50
from winograd_tpu_torch.parallel import (
    basicnet_forward_tp, bottleneck_block_tp, conv1x1_bn_tp_expand, conv1x1_bn_tp_reduce,
    conv3x3_bn_tp_direct, make_mesh, make_pipe_mesh, make_train_step,
    pipelined_basicnet_inference, pipelined_resnet50_inference, pipelined_stage_inference,
    resnet50_forward_tp, resnet_stage_tp, sharded_block_inference,
    sharded_block_inference_fused, spawn_world,
)
from winograd_tpu_torch.parallel.mesh import axis_index

# Seconds a collective may wait before the world fails (spawn_world's
# timeout): a world's cases take seconds; the margin is for a loaded host.
WORLD_TIMEOUT = 120.0


@contextlib.contextmanager
def world_in_background(fn, world: int, inputs: dict):
    """spawn_world(fn, world, (inputs,)) started on a thread, so the test's
    process computes the JAX package's references while the ranks run;
    yields the future of the ranks' results."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(spawn_world, fn, world, (inputs,), timeout=WORLD_TIMEOUT)


@contextlib.contextmanager
def one_rank_world(tmp_path):
    """A default process group of one gloo rank in this process, met on a
    FileStore under tmp_path, destroyed on exit."""
    os.makedirs(tmp_path, exist_ok=True)
    store = dist.FileStore(os.path.join(str(tmp_path), "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=WORLD_TIMEOUT))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _threads(world: int) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))


def _r50(tree):
    return params_from_jax(tree, device="cpu")


def _basic(tree):
    return attach_fused_stage_artifacts(basicnet_params_from_jax(tree, device="cpu"))


def _engine_outputs(cls, params, x, mesh, partition, **kw):
    out = {}
    for tier in TIERS:
        engine = cls(params, tier=tier, device="cpu", mesh=mesh, partition=partition, **kw)
        out[tier] = engine(x)
        assert engine.replays == 0
    return out


# --- tests/test_torch_parallel.py ----------------------------------------------------


def parallel_world(rank: int, world: int, inp: dict) -> dict:
    """The mesh, the block shardings' block, the data-parallel block and
    train step, the TP layers, block and stage, and the engines of runs of
    blocks under "data"."""
    _threads(world)
    m22 = make_mesh(4, 2, device="cpu")
    m14 = make_mesh(4, 4, device="cpu")
    m41 = make_mesh(4, 1, device="cpu")
    out = {"coords22": list(m22.coords), "shape22": dict(m22.shape), "names": list(m22.axis_names),
           "coords41": list(m41.coords)}
    blk, x = inp["block"], inp["block_x"]
    out["sharded_block"] = sharded_block_inference(m22, blk, x)
    fused, xf = inp["fused_block"], inp["fused_x"]
    out["sharded_block_fused"] = sharded_block_inference_fused(
        m22, {k: torch.from_numpy(v) for k, v in fused.items()}, xf)
    out["sharded_block_fused_41"] = sharded_block_inference_fused(
        m41, {k: torch.from_numpy(v) for k, v in fused.items()}, xf)
    for name, mesh, use_kernels in (("train", m22, False), ("train41", m41, False),
                                    ("train_kernels", m22, True), ("train_single", None, False)):
        params = {k: torch.tensor(v) for k, v in inp["train_params"].items()}
        momentum = {k: torch.zeros_like(v) for k, v in params.items()}
        step = make_train_step(mesh, lr=1e-2, use_kernels=use_kernels)
        losses = []
        for _ in range(2):
            params, momentum, loss = step(params, momentum, inp["train_x"], inp["train_t"])
            losses.append(loss)
        out[name] = {"losses": torch.stack(losses), "params": params}
    r = inp["reduce"]
    out["tp_reduce"] = conv1x1_bn_tp_reduce(m22, r["x"], r["w"], r["s"], r["b"], relu=True)
    out["tp_reduce4"] = conv1x1_bn_tp_reduce(m14, r["x"], r["w"], r["s"], r["b"], relu=True)
    e = inp["expand"]
    out["tp_expand"] = conv1x1_bn_tp_expand(m22, e["x"], e["w"], e["s"], e["b"], relu=False)
    out["tp_expand4"] = conv1x1_bn_tp_expand(m14, e["x"], e["w"], e["s"], e["b"], relu=False)
    d = inp["direct"]
    out["tp_direct"] = conv3x3_bn_tp_direct(m22, d["x"], d["w9r"], d["s"], d["b"], relu=True)
    out["tp_direct4"] = conv3x3_bn_tp_direct(m14, d["x"], d["w9r"], d["s"], d["b"], relu=True)
    out["tp_block"] = bottleneck_block_tp(m22, inp["tp_block_x"], inp["tp_block"])
    out["tp_block4"] = bottleneck_block_tp(m14, inp["tp_block_x"], inp["tp_block"])
    out["tp_stage"] = resnet_stage_tp(m22, inp["tp_stage_x"], inp["tp_stage"])
    stages, bx = inp["backbone"], inp["backbone_x"]
    for name, mesh in (("backbone", m22), ("backbone41", m41), ("backbone_single", None)):
        out[name] = {tier: BackboneEngine(stages, tier=tier, mesh=mesh, device="cpu")(bx)
                     for tier in TIERS}
    blocks = [inp["tp_block"], inp["tp_block"]]
    for name, mesh in (("bottleneck_engine", m22), ("bottleneck_engine_single", None)):
        out[name] = {tier: BottleneckEngine(blocks, mesh=mesh, tier=tier, device="cpu")(
            inp["tp_block_x"]) for tier in TIERS}
    return out


# --- tests/test_torch_parallel_classifier.py ------------------------------------------


def classifier_world(rank: int, world: int, inp: dict) -> dict:
    """The tensor-parallel classifiers at model axis 2 (a 2 x 2 mesh) and 4
    (1 x 4), every tier, a head whose classes do not divide the axis, and
    both classifier engines under "model" and "data" at every tier."""
    _threads(world)
    m22 = make_mesh(4, 2, device="cpu")
    m14 = make_mesh(4, 4, device="cpu")
    m41 = make_mesh(4, 1, device="cpu")
    out = {}
    r50, x = _r50(inp["r50"]), inp["r50_x"]
    for tier in TIERS:
        out[f"r50_tp_{tier}"] = resnet50_forward_tp(m22, r50, x, tier)
    out["r50_tp4_f32"] = resnet50_forward_tp(m14, r50, x, "f32")
    out["r50_odd_head"] = resnet50_forward_tp(m22, _r50(inp["r50_odd"]), inp["r50_odd_x"])
    basic, xb = _basic(inp["basic"]), inp["basic_x"]
    for tier in TIERS:
        out[f"basic_tp_{tier}"] = basicnet_forward_tp(m22, basic, xb, tier)
    out["basic_tp4_f32"] = basicnet_forward_tp(m14, basic, xb, "f32")
    for family, cls, params, xs in (("r50", ResNet50Engine, r50, x),
                                    ("basic", ResNetBasicEngine, basic, xb)):
        out[f"{family}_engine_model"] = _engine_outputs(cls, params, xs, m22, "model")
        out[f"{family}_engine_data"] = _engine_outputs(cls, params, xs, m22, "data")
        out[f"{family}_engine_data41"] = _engine_outputs(cls, params, xs, m41, "data")
        out[f"{family}_engine_single"] = _engine_outputs(cls, params, xs, None, "data")
    return out


# --- tests/test_torch_pipeline.py -----------------------------------------------------


def pipeline_world(rank: int, world: int, inp: dict) -> dict:
    """The uniform stage pipeline on 2 and 3 ranks (and its refusal of 6
    blocks on 4), the port's block kernel pipelined, the bottleneck
    classifier on pipes of 2, 3, 4 and 6 ranks at every tier, odd
    transition maps, the basic family on 2 and 3 ranks, and both engines
    under "pipe"."""
    _threads(world)
    pipes = {p: make_pipe_mesh(p, device="cpu") for p in (2, 3, 4, 6)}
    out = {}
    blocks, x = inp["stage_blocks"], inp["stage_x"]
    for p, mb in ((2, 2), (3, 1)):
        if pipes[p] is not None:
            out[f"stage_{p}"] = pipelined_stage_inference(pipes[p], blocks, x, microbatch=mb)
    if pipes[4] is not None:
        try:
            pipelined_stage_inference(pipes[4], blocks, x, microbatch=2)
        except ValueError as e:
            out["stage_4_refused"] = str(e)
    if pipes[2] is not None:
        fused = [{k: torch.from_numpy(v) for k, v in b.items()} for b in inp["fused_blocks"]]
        out["stage_fused_2"] = pipelined_stage_inference(
            pipes[2], fused, inp["fused_x"], microbatch=2, block_fn=bottleneck_block)

    deep = _r50(inp["deep"])
    tiers = {"f32": deep, "bf16w": cast_bf16w(deep), "int8": quantize_resnet50(deep)}
    xd = inp["deep_x"]
    for p, mb in ((2, 3), (3, 2), (6, 1)):
        if pipes[p] is not None:
            out[f"deep_{p}"] = pipelined_resnet50_inference(pipes[p], deep, xd, microbatch=mb)
    if pipes[4] is not None:
        for tier in ("bf16w", "int8"):
            out[f"deep_4_{tier}"] = pipelined_resnet50_inference(pipes[4], tiers[tier], xd,
                                                                  microbatch=2, precision=tier)
        out["odd_4"] = pipelined_resnet50_inference(pipes[4], _r50(inp["odd"]), inp["odd_x"],
                                                    microbatch=2)
        out["r50_engine_pipe"] = _engine_outputs(ResNet50Engine, deep, xd, pipes[4], "pipe",
                                                 microbatch=2)
    if pipes[2] is not None:
        out["deep_2_int8"] = pipelined_resnet50_inference(pipes[2], tiers["int8"], xd,
                                                          microbatch=2, precision="int8")
    basic = _basic(inp["basic"])
    btiers = {"f32": basic, "bf16w": cast_basicnet_bf16w(basic), "int8": quantize_basicnet(basic)}
    xb = inp["basic_x"]
    for p in (2, 3):
        if pipes[p] is not None:
            out[f"basic_{p}"] = pipelined_basicnet_inference(pipes[p], basic, xb, microbatch=2)
    if pipes[2] is not None:
        out["basic_2_int8"] = pipelined_basicnet_inference(pipes[2], btiers["int8"], xb,
                                                           microbatch=2, precision="int8")
    if pipes[3] is not None:
        out["basic_engine_pipe"] = _engine_outputs(ResNetBasicEngine, basic, xb, pipes[3], "pipe",
                                                   microbatch=2)
    if rank == 0:
        out["deep_single"] = _engine_outputs(ResNet50Engine, deep, xd, None, "data")
        out["basic_single"] = _engine_outputs(ResNetBasicEngine, basic, xb, None, "data")
    out["pipe_index"] = {p: axis_index(m, "pipe") for p, m in pipes.items() if m is not None}
    return out


# --- tests/test_torch_cuda.py (on the card) ----------------------------------------------


def cuda_world(rank: int, world: int, inp: dict) -> dict:
    """Two gloo ranks sharing cuda:0: the narrow classifiers under "model"
    (1 x 2), "pipe" (2 ranks) and "data" (2 x 1) at every tier, the bf16w
    and int8 "model" forwards also through the plain versions on a CPU twin
    of its mesh, and on rank 0 the single-device engines; results on the
    CPU."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meshes = {"model": make_mesh(2, 2, device=dev), "pipe": make_pipe_mesh(2, device=dev),
              "data": make_mesh(2, 1, device=dev)}
    out = {}
    for family, cls, params in (("r50", ResNet50Engine, _r50(inp["r50"])),
                                ("basic", ResNetBasicEngine, _basic(inp["basic"]))):
        x = inp["x"]
        for partition, mesh in meshes.items():
            for tier in TIERS:
                engine = cls(params, tier=tier, device=dev, mesh=mesh, partition=partition)
                out[f"{family}_{partition}_{tier}"] = engine(x).cpu()
                assert engine.replays == 0
        tp = resnet50_forward_tp if family == "r50" else basicnet_forward_tp
        for tier in ("bf16w", "int8"):
            out[f"{family}_model_{tier}_plain"] = tp(meshes["model"].to("cpu"), params, x, tier)
        if rank == 0:
            for tier in TIERS:
                out[f"{family}_single_{tier}"] = cls(params, tier=tier, device=dev)(x).cpu()
    return out
