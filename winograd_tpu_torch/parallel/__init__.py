"""The parallel layer on torch.distributed: meshes of ranks, data-parallel
inference and training, Megatron tensor parallelism and GPipe pipelines on
the port's kernels. Port of winograd_tpu/parallel/ under the port's names
(the fused route's `_pallas` suffix becomes `_fused`); one process a rank
(mesh.py::spawn_world starts a world of them)."""

from winograd_tpu_torch.parallel.data_parallel import (
    gather_train_state,
    init_train_state,
    make_train_step,
    shard_train_state,
    sharded_block_inference,
    sharded_block_inference_fused,
)
from winograd_tpu_torch.parallel.mesh import (
    Mesh,
    block_shardings,
    make_mesh,
    make_pipe_mesh,
    spawn_world,
)
from winograd_tpu_torch.parallel.pipeline import (
    pipelined_basicnet_inference,
    pipelined_resnet50_inference,
    pipelined_stage_inference,
)
from winograd_tpu_torch.parallel.tensor_parallel import (
    basicnet_forward_tp,
    bottleneck_block_tp,
    conv1x1_bn_tp_expand,
    conv1x1_bn_tp_reduce,
    conv3x3_bn_tp_direct,
    make_basicnet_tp_fn,
    make_resnet50_tp_fn,
    resnet50_forward_tp,
    resnet_stage_tp,
)

__all__ = [
    "make_mesh",
    "block_shardings",
    "sharded_block_inference",
    "sharded_block_inference_fused",
    "make_train_step",
    "init_train_state",
    "shard_train_state",
    "gather_train_state",
    "conv1x1_bn_tp_reduce",
    "conv1x1_bn_tp_expand",
    "conv3x3_bn_tp_direct",
    "bottleneck_block_tp",
    "resnet_stage_tp",
    "make_resnet50_tp_fn",
    "resnet50_forward_tp",
    "make_basicnet_tp_fn",
    "basicnet_forward_tp",
    "make_pipe_mesh",
    "pipelined_stage_inference",
    "pipelined_resnet50_inference",
    "pipelined_basicnet_inference",
    "Mesh",
    "spawn_world",
]
