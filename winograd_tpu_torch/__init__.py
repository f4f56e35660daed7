"""winograd_tpu_torch — the PyTorch/CUDA port of winograd_tpu for one NVIDIA H100.

The served path is the ResNet-50 classifier (224x224x3 image to 1000
logits) on the JAX package's fused route, through kernels hand-written in
CUDA C++ for sm_90a (csrc/) and bound with ctypes (kernels/_build.py):

* kernels/pointwise.py — 1x1 conv as a GEMM + folded BN (+ReLU); also the
  composed stride-2 3x3 (strided im2col) and the head FC.
* kernels/winograd.py — 3x3 s1 conv, Winograd F(2,3) or F(4,3) + BN + ReLU.
* kernels/direct.py — 3x3 s1 conv as an implicit GEMM + BN + ReLU.
* kernels/stem.py — 7x7/2 conv + BN + ReLU + 3x3/2 maxpool.
* kernels/stage.py — a run of identity bottlenecks in one persistent launch
  (kernels/block.py runs one block through it).
* kernels/transition.py — the stride-2 transition block in one persistent
  launch.

The bf16w serving tier (engine tier "bf16w", models/resnet50.py::
resnet50_forward(precision="bf16w"), models/basic.py::
basicnet_forward(precision="bf16w")) runs bf16w instantiations of the
pointwise, Winograd, direct, stem, stage, transition and basic-stage
kernels on bfloat16 weights (csrc/wgmma_tile.cuh's bf16 wgmma tile: the f32
activation split into two bf16 halves on the tensor cores).
The int8 serving tier of the same classifier (engine tier "int8",
models/resnet50.py::resnet50_forward_int8) runs the stem at bf16 and
kernels/quantized.py: int8 pointwise and direct 3x3 kernels, and the int8
stage and transition kernels, on the int8 tensor cores (s8 wgmma).
The basic-block family (ResNet-18/34, models/basic.py) adds the f32 and
int8 basic stages (kernels/basic_stage.py) and the int8 Winograd F(2,3).

The benchmark CLI (python -m winograd_tpu_torch.bench, bench/cli.py) runs
the JAX package's benchmark modes on the card: seeded cases and float64
goldens (datagen/, ops/reference.py, config.py's CASES), the kernels beside
the cuDNN baseline (baseline/cudnn.py), the reference's timing protocol and
CUDA-graph device times (utils/timing.py), each path checked against the
golden (utils/checker.py).

parallel/ runs the JAX package's parallel schemes on torch.distributed,
one process a rank: meshes and their collectives (parallel/mesh.py),
data parallelism and the data-parallel train step (data_parallel.py),
Megatron tensor parallelism on the kernels above (tensor_parallel.py) and
FLOP-balanced GPipe pipelines (pipeline.py); the engines' `mesh` and
`partition` serve through them.

Every kernel wrapper runs its plain PyTorch version for tensors on the CPU
(the tests) and launches the kernel for CUDA tensors; there is no fallback
between the two. The package imports neither jax nor winograd_tpu; the JAX
package stays the reference it is tested against.
"""
