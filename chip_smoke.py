#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (winograd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and nvcc.
Phases, each of which must pass (exit 1 otherwise):

1. device: a CUDA device is required (no CPU continuation); TF32 is turned
   off for cuBLAS and cuDNN so the plain versions and the library
   yardsticks compute in full float32. Prints the card's name and power
   limit as nvidia-smi reports them.
2. build: compiles csrc/*.cu with nvcc for sm_90a, one process per source.
2a. native: the native host library (utils/native.py, native/winotpu.cpp,
   built by g++ under build/) must load and serve a blob write, a threaded
   read and the shift-aware checker, each counted in native.CALLS; the line
   says where it lives and what it served.
3. serving (f32 tier): ResNet50Engine with seeded full-width weights
   answers 1 + 10 N=1 requests and 3 N=8 requests on the JAX package's
   fused route, each through the CUDA graph the engine captured for its
   shape (engine.py). The counting rule of every served run (phases 3-10
   and the serving_pre runs): counters zeroed just before; the first N=1
   request must launch each kernel exactly its count in one forward times
   engine.CAPTURE_PASSES (the warm-up and the capture; per forward: stem 1,
   pointwise 8, Winograd 1, stage 3, transition 3 and direct 2), the 10 N=1
   requests after it nothing more, the first N=8 request exactly that
   count again, the last two nothing: a replay runs no wrapper; and each
   of the 14 requests must add one to the engine's count of graph replays
   (engine.replays, printed as "replays"). One
   image's logits must agree with the same model through the plain
   versions on the CPU in float64 (the golden) within 1e-4 * max(1,
   max|golden|); every row of the N=8 logits must agree with that image's
   N=1 logits within the same bound. The line gives the replayed N=1
   latency (median of 10, host clock to a synchronize), N=8 images/s (the
   median of the 2 requests after the capturing one) and, beside them, the
   tier's model forward (models/resnet50.py, models/basic.py) called
   eagerly on its own device copy of the tier's parameters and the same
   numpy images (no graph: N=1 median of 10, N=8 of 3), and the phase's
   peak device memory.
3a. serving_pre (and serving_pre_bf16w, serving_pre_basic,
   serving_pre_basic_bf16w after phases 4a, 7 and 8a): the prepared-input
   contract on the same engine. prepare_input builds each image's stem
   operand on the host, then serve_pre answers a counted run as phase 3's
   (the stem counted as its prepared-input entry, stem_pre or
   stem_pre_bf16w); its logits must equal the raw-image route's of phase 3
   (4a, 7, 8a) to the bit, N=1 and N=8 (the entry stages the same patch in
   the same K order).
3c. throughput: engine.throughput(8) of every engine and tier, one line each.
3d. batch32 (after the profile phase of each tier of phases 3-10, on the
   same engine): one N=32 request from numpy images, counted as phase 3's
   (counters zeroed just before): it must launch each kernel its count in
   one forward times CAPTURE_PASSES, its three replays nothing, and each of
   the four requests must be a graph replay; every row of the N=32 logits
   within the N=8 bars of that image's N=1 logits (1e-4 at f32 and bf16w,
   1e-3 at int8, times max(1, max|N=1 row|)). The line gives the replayed
   N=32 latency (median of 3), engine.throughput(32) and the peak device
   memory. The batch runs whole (the JAX package's chunks of 8 are a TPU
   compile workaround).
4. profile (f32): torch.profiler over 5 N=1 and 3 N=8 requests served as in
   phase 3 (graph replays), each ended by a synchronize: device time by
   kernel name per request, and the device's idle share, 1 - device busy
   time over the host clock of the profiled requests (an upper bound for
   unprofiled serving: the profiler adds host time). Where the trace of the
   replays holds no kernel, the names and busy time come from the tier's
   eager forwards (as in phase 3), and the line says so ("kernels_from").
4a. serving_bf16w: ResNet50Engine(tier="bf16w") on the same weights (cast
   to bf16 once) and images, counted as phase 3: each forward must launch the bf16w
   instantiations, counted under their own names, stem_bf16w 1,
   pointwise_bf16w 4, stage_bf16w 4 (conv5_x too), transition_bf16w 3 and
   winograd_bf16w 1 (the entry block's F(2,3) on the bf16 tensor cores,
   every shape of it at m = 2). Logits against phase 3's float64 golden
   within BF16W_RTOL_BACKBONE
   (5e-3) * max(1, max|golden|); against the port's bf16w forward through
   the plain versions on the CPU in float32 within 1e-4 * max(1,
   max|ref|); each N=8 row against that image's N=1 logits within 1e-4 *
   max(1, max|N=1 row|).
4b. profile_bf16w: as phase 4, for the bf16w tier.
5. serving_int8: ResNet50Engine(tier="int8") on the same weights and
   images, counted as phase 3: each forward must launch stem 1 (at bf16), pointwise_int8 4,
   direct_int8 1, stage_int8 4 and transition_int8 3 times. Logits against
   the f32 golden of phase 3 within INT8_RTOL_BACKBONE (5e-2) *
   max(1, max|golden|); against the port's int8 forward through the plain
   versions on the CPU in float32 within 1e-3 * max(1, max|ref|); each N=8
   row against that image's N=1 logits within the same 1e-3 bound.
   serve_pre must refuse the int8 tier (ValueError).
6. profile_int8: as phase 4, for the int8 tier.
7. serving_basic: ResNetBasicEngine with seeded full-width ResNet-34
   weights (bench mode 24) on the same images, counted as phase 3: each
   forward must
   launch stem 1, Winograd 24, pointwise 7, direct 1 and basic_stage 1
   times; logits against the same model through the plain versions on the
   CPU in float64 within 1e-4 * max(1, max|golden|), N=8 rows against N=1
   within the same bound.
8. profile_basic: as phase 4, for phase 7.
8a. serving_basic_bf16w: ResNetBasicEngine(tier="bf16w") on phase 7's
   weights (cast to bf16 once) and images, counted as phase 3: each forward
   must launch stem_bf16w 1, winograd_bf16w 24, pointwise_bf16w 7, direct_bf16w
   1 and basic_stage_bf16w 1 times. Logits as phase 4a's bars: phase 7's
   float64 golden within 5e-3 * max(1, max|golden|), the port's bf16w
   forward through the plain versions on the CPU within 1e-4 * max(1,
   max|ref|), each N=8 row against its N=1 logits within 1e-4.
8b. profile_basic_bf16w: as phase 4, for phase 8a.
9. serving_basic_int8: ResNetBasicEngine(tier="int8") on the same weights
   and images, counted as phase 3: each forward must launch stem 1 (at
   bf16), Winograd 6 (on
   bf16 filters), winograd_int8 18, pointwise_int8 7, direct_int8 1 and
   basic_stage_int8 1 times; logits against phase 7's golden within 5e-2 *
   max(1, max|golden|), against the port's int8 forward through the plain
   versions on the CPU in float32 within 1e-3 * max(1, max|ref|), N=8 rows
   against N=1 within 1e-3; serve_pre refused.
10. profile_basic_int8: as phase 4, for phase 9.
10a. import_torch: full-width ResNet-50 and ResNet-34 with torchvision's
   names (models/import_torch.py::build_torch_reference_resnet: layers
   3-4-6-3, stem 64, planes 64/128/256/512, 1000 classes, seeded weights
   and BN statistics); each state dict through engine_from_torch at every
   tier, two images' logits against the module's own eval forward on the
   card (cuDNN and cuBLAS, TF32 off): f32 within 1e-4, bf16w within 5e-3,
   int8 within 5e-2, each times max(1, max|ref|).
10d. depth: full-width ResNet-101 (layers 3-4-23-3) and ResNet-152
   (3-8-36-3) from build_torch_reference_resnet, seeded as phase 10a's,
   through engine_from_torch at every tier, counted as phase 3's N=1 run:
   one forward must launch ResNet-50's kernels of the tier
   (EXPECTED_PER_FORWARD, _BF16W, _INT8: the deeper conv3_x and conv4_x
   runs stay one stage launch each, of 3 and 22 or 7 and 35 blocks), the 10
   replays nothing; two images' logits against the module's own eval
   forward on the card (TF32 off) within 1e-4 (f32), 5e-3 (bf16w) and
   5e-2 (int8), times max(1, max|ref|). The line gives the replayed N=1
   latency (median of 10), throughput(8), the device busy time of an N=1
   replay (torch.profiler over 5) and the peak device memory.
10b. checkpoint: models/checkpoint.py::save_model of the trainable set
   (models/train.py::trainable_*_params) of phase 3's and phase 7's
   weights into a temporary file under build/, then from_checkpoint; one
   image's logits within 1e-4 * max(1, max|ref|) of the engine's on the
   full parameters (phases 3 and 7); then the same trees as tensors on the
   card through models/checkpoint.py::save_checkpoint_dir (wait=False,
   then wait_until_finished) and load_checkpoint_dir (like the tree, onto
   the card): read back bit for bit, and from_checkpoint of the directory
   within the same bound (checkpoint_dir lines).
10c. training and training_bf16w: full-width ResNet-50 (bench mode 19's
   configuration) and ResNet-18 (mode 25's), seeded, their trainable sets
   (raw filters, folded BN), one N=1 train step each at f32 and at bf16w
   through models/resnet50.py::resnet50_forward_train and
   models/basic.py::basicnet_forward_train (kernels/vjp.py): the loss
   sum(out^2), its gradients with respect to every leaf, and the step
   scalar, the loss plus every leaf's squared norm (bench/cli.py::
   train_step). Counted as a served run (counters zeroed just before the
   step, read just after): the launches of one step must equal
   EXPECTED_TRAIN_STEP (forward and backward; derived from the code and
   listed there). Held to the same f32 step through the plain versions on
   the CPU in float64: the f32 scalar within TRAIN_RTOL (1e-3) relative and
   every f32 gradient leaf within 1e-3 * max(1, max|ref|); the bf16w scalar
   within BF16W_TRAIN_GRAD_RTOL (2e-2) of the float64 f32 scalar (its
   worst leaf is printed, not held: bf16 weights move single leaves by
   more). The line gives the step's device time replayed from a CUDA graph
   (bench_graph, as the CLI times) and eager (one step between CUDA
   events, median of 10), at f32 the cuDNN autograd step's (baseline/
   cudnn.py's forward on the same weights, TF32 off) both ways, for
   ResNet-50 one SGD step of models/train.py::make_resnet50_train_step
   (forward, backward, momentum update on a copy of the weights: its loss
   within 2 * 1e-4 (f32) or 2 * 5e-3 (bf16w) * max(1, max|logits|) of
   the cross-entropy of the cuDNN forward's logits) replayed and eager,
   the phase's peak device memory, and an eager step under torch.profiler
   (device ms by kernel name, the number of device kernels).
11. kernels: each kernel against its plain PyTorch version on the card, at
   every shape the first request of phases 3, 4a, 5, 7, 8a, 9, 3d (N=32)
   and 10d (ResNet-101 and ResNet-152: the stage at 22 and 35 blocks) and
   the counted step of each training phase gave it (recorded by shape in
   kernels/_build.py; the stem's prepared-input entry at the shapes of the
   serving_pre runs; the training's shapes include the 3x3 data gradients
   through the F(2,3) Winograd at 56x56x64, 28x28x128 and 14x14x256 and the
   direct 3x3 at 7x7x512, the f32 stage over conv5_x's two blocks and at
   one block for conv3_x and conv4_x, and the pointwise kernel on the
   stem's patch columns (12544 x 192 x 64) and the transitions' strided
   im2col columns (K = 9 Cmid)), and at shapes off the served
   N=1 lists (Winograd F(4,3) at 14x14x128; the block at bench modes 6 and
   9; the conv4_x stage and the 14->7 transition at N=8; the conv5_x stage
   geometry; the int8 stage at N=8 and at one block (mode 6); the int8
   14->7 transition at N=8; the stem at N=8 in both precisions; both basic
   stages at N=8 and at one block, the ResNet-18 run; the int8 Winograd at
   N=8, 14x14x256 and 28x28x128, and at Cin 1152 -> 128 and 2048 -> 256 on
   14x14 (WIDE_WINOGRAD_INT8: K walked in spans); the pointwise head and conv5_x reduce
   at N=8; the int8 pointwise head at N=8; the f32 and int8 direct 3x3s at
   N=8, 7x7x512; the bf16w pointwise head, the conv4_x and conv5_x bf16w
   stages, the 14->7 bf16w transition and the bf16w stem at N=8, the bf16w
   block at modes 6 and 9, the bf16w Winograd at 56x56x64, the bf16w direct
   3x3 at 7x7x512 and the bf16w basic stage at 7x7x512 at N=8; the stem's
   prepared-input entry at N=8 at "f32" and "bf16w"), on seeded
   inputs. Bound: max abs error <= 1e-4 *
   max(1, max|plain|); the int8 direct 3x3, stage, transition, pointwise,
   basic stage and Winograd (their twins' arithmetic, exact int32 sums,
   the Winograd's transforms in FP64 rounded once), the bf16 stem and the
   int8 tier's bf16-filter Winograd (exact FP64 sums of bf16 products) 0:
   equal to their twins (the int8
   basic stage and Winograd held to 0 since their redesign on the tensor
   cores, 1e-3 before). One JSON line per shape:
   error; the K split of the split-K kernels ("splits": pointwise, direct,
   direct_int8, pointwise_int8 and both basic stages, from their wrappers'
   plans, pointwise_int8 with its plan's "route", GEMV, one_pass or
   cooperative; the f32 transition's splits of its reduce, mid and expand;
   for the f32 Winograd its plan's Cin splits); the int8 Winograd's plan
   (its items' "tile_blocks" and "col_blocks", its grid's "blocks", the
   "chunk" of K an item stages at once);
   device times of the kernel, its plain version and the library call (20
   calls captured in a CUDA graph, the median of 20 replays between CUDA
   events, divided by 20: winograd_tpu_torch/utils/timing.py::bench_graph,
   which the benchmark CLI times with too; inputs stay in L2 between
   calls); "wrapper_ms",
   one eager wrapper call
   between CUDA events, host path included (median of 20 after 2
   warm-ups); and the bound: the larger of the operations' time and the
   bytes' time (H100 SXM data sheet: 67 TFLOP/s FP32 outside the tensor
   cores, 495 TFLOP/s TF32, 989 TFLOP/s BF16 and 1979 TOPS INT8 dense on
   the tensor cores, 3.35 TB/s HBM). Operations: int8 MACs x 2 at the INT8
   rate; the bf16 stem's products and the int8 stage's bf16-filter F(2,3)
   products (as two BF16 passes, the JAX kernel's hi/lo split) at the BF16
   rate; the tensor-core products of the pointwise kernel (P > 8), the
   direct 3x3, the f32 Winograd, the f32 stage, the f32 transition (their
   reduce, mid and expand) and the f32 basic stage (its 2B convs) as three
   TF32 passes (their 3xTF32 split) at the TF32 rate; the bf16w
   instantiations' products (pointwise, GEMV included, stem, stage,
   transition, Winograd, direct and basic stage) as two BF16 passes (a_hi
   and a_lo) at the BF16 rate; the
   pointwise GEMV's (P <= 8) and the other f32 GEMMs, Winograd transforms,
   epilogues (4 FLOPs an output, 5 with a residual) and int8 quantization
   (2 a quantized value) at the FP32 rate; the bf16-filter Winograd's
   products as two BF16 passes too. Bytes: each input read once
   (int8 weights 1 byte, bf16 filters and weights 2), each output written
   once. Library: torch.matmul / F.conv2d (f32; a basic stage its 2B convs;
   a bf16w row the same call as its kernel's f32 row, on the f32 weights), the
   bf16-filter Winograd F.conv2d in bf16, and for the int8 kernels
   torch._int_mm on operands quantized (the 3x3s im2col'd, the int8
   Winograd's V per position) before the timed region, summed over the
   kernel's GEMMs, rows padded to 32 where P <= 16 (the call refuses fewer
   than 17), and torch.bmm in bf16 for the F(2,3) mid's products; the
   prepared-input stem's library is cuDNN's conv with the folded BN, ReLU
   and the maxpool, in f32.
11a. bench: the benchmark CLI (python -m winograd_tpu_torch.bench) through
   its run_case, strict, at the reference's protocol (100 iterations, 2
   warm-ups), for modes 0-6, 9, 11, 16, 17, 19 and 22-25 (BENCH_MODES; 17,
   19 and 25 the training steps, no int8 column, their
   train_grad_rel_error and train_bf16w_grad_rel_error within their
   bars): the seeded
   case and its float64 golden (datagen), the in-house kernels, the cuDNN
   baseline with TF32 off, and the direct, F(4,3), int8, bf16w and pre
   (the prepared-input route, modes 16 and 22-24) columns where the mode
   has them. One JSON line per mode: its device times
   (bench_graph), host mean and chained times, max errors, tier errors,
   parity_ok and the launches by kernel of the run (counters zeroed just
   before it). A breach, TF32 on, or a path of the mode with no device time
   fails the run.
11b. parallel: one world of PARALLEL_RANKS (4) processes sharing the card
   (parallel/mesh.py::spawn_world: the spawn start method, a FileStore,
   gloo, PARALLEL_TIMEOUT_S on every collective; a rank that raises fails
   the phase), each rank running _parallel_rank: ResNet-50 and ResNet-34,
   seeded as phases 3 and 7, at every tier under partition "data" (a 4 x 1
   mesh: the batch cut over the ranks), "model" (2 x 2: every block's
   weights cut over two ranks, parallel/tensor_parallel.py) and "pipe"
   (four ranks, microbatch 1: parallel/pipeline.py), on phase 3's first
   four images (N=4), each engine served eagerly (no graph under a mesh;
   replays must stay 0). Each forward's launches, counted on each rank
   (counters zeroed just before, read just after) must equal the pinned
   counts: under "data" the single-device forward's
   (EXPECTED_PER_FORWARD*), under "model" EXPECTED_TP, under "pipe" four
   microbatches of the rank's EXPECTED_PIPE. The logits, whole on every
   rank, against the single-device engine (rank 0's, broadcast) within
   1e-4 * max(1, max|ref|) at f32 and bf16w and 1e-3 at int8; bf16w and
   int8 under "model" are their own arithmetic (every 3x3 direct on the
   bf16 or int8 weights of the filter, each rank's shard quantized apart),
   held instead to the same TP forward through the plain versions on a
   CPU twin of the mesh (1e-4, 1e-3) and to the float64 golden of image 0
   (rank 1's; 5e-3, 5e-2). One "parallel" line each, with the eager ms a
   request (median of 3, host clock to a synchronize), the launches, the
   peak device MiB and the MiB of weights each rank holds, by rank. Then
   the data-parallel train step (models/train.py::make_resnet50_train_step
   on the 4 x 1 mesh, one image a rank) against the single-device step on
   all four (rank 0): the loss relative and every gradient leaf (the
   momentum after one step) within TRAIN_RTOL (1e-3) * max(1, max|ref|),
   each rank's launches EXPECTED_TRAIN_STEP's; the line gives the first
   step's ms (fresh processes: one-time set-up in it) and the second's
   ("parallel_train" line);
   rank 0 serves ResNet-50 f32 through one-rank NCCL meshes under each
   partition, against its single-device logits within 1e-4 (the
   collectives' NCCL path; "parallel" lines with "backend": "nccl"); and
   the channel-sharded block step (parallel/data_parallel.py::
   make_train_step on the plain operators, the 2 x 2 mesh: each rank holds
   half of w_reduce, w_expand, s_expand and b_expand and the rest whole,
   shard_train_state) on the mode-6 block (14x14, Cio 1024, Cmid 256, N=4,
   seeded), two steps, TF32 off: its losses and its params gathered by
   gather_train_state against the one-device step on rank 0 within
   BLOCK_TRAIN_RTOL (1e-5) relative, every rank's share of each leaf
   BLOCK_TRAIN_FRACTION's ("parallel_block_train" line: the eager ms of
   the second step, the MiB of params and momentum a rank holds, the
   errors).
12. a "kernels" JSON line (sums over the shapes of one forward of each
   counted run, both models and all tiers, ResNet-101 and ResNet-152 and
   the N=32 requests, and per-step sums over the training phases' shapes;
   the stem row sums its f32 and bf16 shapes, the Winograd row its f32 and
   bf16-filter shapes; the bf16w instantiations
   and the stem's prepared-input entry are rows of their own,
   "<kernel>_bf16w", "stem_pre", their source the kernel's file;
   "launches" the wrappers' launches in the counted runs, the warm-up and
   capture passes, in the training phases' counted steps, and every rank's
   in phase 11b's counted forwards and train step; a replay launches no
   wrapper), the card line, and last
   {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

FP32_FLOPS = 67e12   # H100 SXM, FP32 outside the tensor cores, dense
TF32_FLOPS = 495e12  # tensor cores, dense
BF16_FLOPS = 989e12  # tensor cores, dense
INT8_OPS = 1979e12   # tensor cores, dense
HBM_BYTES_S = 3.35e12
ATOL = 1e-4
INT8_CHAINED_RTOL = 1e-3
EXPECTED_PER_FORWARD = {
    "stem": 1, "pointwise": 8, "winograd": 1, "stage": 3, "transition": 3, "direct": 2,
}
EXPECTED_PER_FORWARD_BF16W = {
    "stem_bf16w": 1, "pointwise_bf16w": 4, "winograd_bf16w": 1, "stage_bf16w": 4,
    "transition_bf16w": 3,
}
EXPECTED_PER_FORWARD_INT8 = {
    "stem": 1, "pointwise_int8": 4, "direct_int8": 1, "stage_int8": 4, "transition_int8": 3,
}
EXPECTED_PER_FORWARD_BASIC = {
    "stem": 1, "winograd": 24, "pointwise": 7, "direct": 1, "basic_stage": 1,
}
EXPECTED_PER_FORWARD_BASIC_BF16W = {
    "stem_bf16w": 1, "winograd_bf16w": 24, "pointwise_bf16w": 7, "direct_bf16w": 1,
    "basic_stage_bf16w": 1,
}
EXPECTED_PER_FORWARD_BASIC_INT8 = {
    "stem": 1, "winograd": 6, "winograd_int8": 18, "pointwise_int8": 7, "direct_int8": 1,
    "basic_stage_int8": 1,
}
# The parallel phase's launches on each rank of one forward (counted on the
# CPU by tests/test_torch_parallel_launches.py). Under "data" a rank runs
# the single-device forward on its shard (EXPECTED_PER_FORWARD*). Under
# "model" (parallel/tensor_parallel.py) every rank launches the stem once,
# each bottleneck its reduce and expand (pointwise), its 3x3 (direct at
# stride 1, pointwise on a strided im2col at stride 2) and its projection
# (pointwise), the head once; each basic block its two 3x3s (direct; an
# entry's strided conv a and projection pointwise); the tier's
# instantiations at bf16w and int8. Under "pipe" (parallel/pipeline.py, four
# ranks) each rank its group of the FLOP-balanced partition.
EXPECTED_TP = {
    ("resnet50", "f32"): {"stem": 1, "pointwise": 40, "direct": 13},
    ("resnet50", "bf16w"): {"stem_bf16w": 1, "pointwise_bf16w": 40, "direct_bf16w": 13},
    ("resnet50", "int8"): {"stem": 1, "pointwise_int8": 40, "direct_int8": 13},
    ("resnet34", "f32"): {"stem": 1, "pointwise": 7, "direct": 29},
    ("resnet34", "bf16w"): {"stem_bf16w": 1, "pointwise_bf16w": 7, "direct_bf16w": 29},
    ("resnet34", "int8"): {"stem": 1, "pointwise_int8": 7, "direct_int8": 29},
}
EXPECTED_PER_FORWARD_TABLES = {
    ("resnet50", "f32"): EXPECTED_PER_FORWARD, ("resnet50", "bf16w"): EXPECTED_PER_FORWARD_BF16W,
    ("resnet50", "int8"): EXPECTED_PER_FORWARD_INT8,
    ("resnet34", "f32"): EXPECTED_PER_FORWARD_BASIC,
    ("resnet34", "bf16w"): EXPECTED_PER_FORWARD_BASIC_BF16W,
    ("resnet34", "int8"): EXPECTED_PER_FORWARD_BASIC_INT8,
}
EXPECTED_PIPE = {
    ("resnet50", "f32"): [
        {"stem": 1, "pointwise": 3, "winograd": 1, "stage": 1, "transition": 1},
        {"stage": 1, "transition": 1}, {"stage": 1},
        {"stage": 1, "transition": 1, "pointwise": 5, "direct": 2}],
    ("resnet50", "bf16w"): [
        {"stem_bf16w": 1, "pointwise_bf16w": 3, "winograd_bf16w": 1, "stage_bf16w": 1,
         "transition_bf16w": 1},
        {"stage_bf16w": 1, "transition_bf16w": 1}, {"stage_bf16w": 1},
        {"stage_bf16w": 2, "transition_bf16w": 1, "pointwise_bf16w": 1}],
    ("resnet50", "int8"): [
        {"stem": 1, "pointwise_int8": 3, "direct_int8": 1, "stage_int8": 1,
         "transition_int8": 1},
        {"stage_int8": 1, "transition_int8": 1}, {"stage_int8": 1},
        {"stage_int8": 2, "transition_int8": 1, "pointwise_int8": 1}],
    ("resnet34", "f32"): [
        {"stem": 1, "winograd": 7, "pointwise": 2}, {"winograd": 7, "pointwise": 2},
        {"winograd": 8}, {"winograd": 2, "pointwise": 3, "direct": 1, "basic_stage": 1}],
    ("resnet34", "bf16w"): [
        {"stem_bf16w": 1, "winograd_bf16w": 7, "pointwise_bf16w": 2},
        {"winograd_bf16w": 7, "pointwise_bf16w": 2}, {"winograd_bf16w": 8},
        {"winograd_bf16w": 2, "pointwise_bf16w": 3, "direct_bf16w": 1,
         "basic_stage_bf16w": 1}],
    ("resnet34", "int8"): [
        {"stem": 1, "winograd": 6, "pointwise_int8": 2, "winograd_int8": 1},
        {"winograd_int8": 7, "pointwise_int8": 2}, {"winograd_int8": 8},
        {"winograd_int8": 2, "pointwise_int8": 3, "direct_int8": 1, "basic_stage_int8": 1}],
}
# One N=1 train step (the training phases), forward and backward: at f32 the
# forward's stem 1, pointwise 4, Winograd 1, stage 10 and transition 3
# (ResNet-50), stem 1, Winograd 10, pointwise 7, direct 1 and basic_stage 1
# (ResNet-18); the backward's rematerialized per-layer forwards and the
# 3x3s' data gradients (models/*, kernels/vjp.py): ResNet-50 pointwise 40
# (each block's reduce and expand, the transitions' four 1x1s, the
# projection's three, the stem's patch GEMM), Winograd 22 (the F(2,3) mid
# and its data gradient of conv2_x, conv3_x and conv4_x blocks and the
# projection) and direct 4 (conv5_x's mids and their data gradients);
# ResNet-18 Winograd 10 and direct 5 (data gradients; the basic stage's two
# convs rematerialized) and pointwise 1 (the stem). At bf16w the forward's
# launches move to the bf16w instantiations; the backward is f32.
_R50_BWD = {"pointwise": 40, "winograd": 22, "direct": 4}
_R18_BWD = {"winograd": 10, "direct": 5, "pointwise": 1}
EXPECTED_TRAIN_STEP = {
    ("resnet50", None): {"stem": 1, "pointwise": 44, "winograd": 23, "stage": 10,
                         "transition": 3, "direct": 4},
    ("resnet50", "bf16w"): {"stem_bf16w": 1, "pointwise_bf16w": 4, "winograd_bf16w": 1,
                            "stage_bf16w": 10, "transition_bf16w": 3, **_R50_BWD},
    ("resnet18", None): {"stem": 1, "winograd": 20, "pointwise": 8, "direct": 6,
                         "basic_stage": 1},
    ("resnet18", "bf16w"): {"stem_bf16w": 1, "winograd_bf16w": 10, "pointwise_bf16w": 7,
                            "direct_bf16w": 1, "basic_stage_bf16w": 1, **_R18_BWD},
}
# The f32 train step's scalar and every gradient leaf against the float64
# step through the plain versions: within TRAIN_RTOL * max(1, max|ref|)
# (the leaves) and relative (the scalar); the bf16w step's scalar within
# config.BF16W_TRAIN_GRAD_RTOL of the same float64 f32 step.
TRAIN_RTOL = 1e-3
SOURCES = {
    "pointwise": ("winograd_tpu/kernels/pointwise.py:67",
                  ["winograd_tpu/kernels/pointwise.py:67 _matmul_bn_kernel"]),
    "winograd": ("winograd_tpu/kernels/winograd.py:384",
                 ["winograd_tpu/kernels/winograd.py:384 _winograd_kernel",
                  "winograd_tpu/kernels/winograd.py:252 _winograd_kernel_p64"]),
    "direct": ("winograd_tpu/kernels/direct.py:97",
               ["winograd_tpu/kernels/direct.py:97 _direct_kernel"]),
    "stem": ("winograd_tpu/kernels/stem.py:59",
             ["winograd_tpu/kernels/stem.py:59 _stem_kernel"]),
    "stage": ("winograd_tpu/kernels/stage.py:129",
              ["winograd_tpu/kernels/stage.py:129 _stage_kernel",
               "winograd_tpu/kernels/stage.py:169 _stage_kernel_resident",
               "winograd_tpu/kernels/block.py:32 _block_kernel",
               "winograd_tpu/kernels/block.py:150 _block_kernel_winograd"]),
    "transition": ("winograd_tpu/kernels/transition.py:38",
                   ["winograd_tpu/kernels/transition.py:38 _transition_kernel",
                    "winograd_tpu/kernels/transition.py:119 _transition_kernel_resident"]),
    "pointwise_int8": ("winograd_tpu/kernels/quantized.py:66",
                       ["winograd_tpu/kernels/quantized.py:66 _quant_matmul_kernel"]),
    "direct_int8": ("winograd_tpu/kernels/quantized.py:149",
                    ["winograd_tpu/kernels/quantized.py:149 _direct_int8_kernel",
                     "winograd_tpu/kernels/quantized.py:183 _direct_int8_banded_kernel"]),
    "stage_int8": ("winograd_tpu/kernels/quantized.py:765",
                   ["winograd_tpu/kernels/quantized.py:765 _stage_int8_kernel",
                    "winograd_tpu/kernels/quantized.py:853 _stage_int8_kernel_resident",
                    "winograd_tpu/kernels/quantized.py:653 _block_int8_kernel"]),
    "transition_int8": ("winograd_tpu/kernels/quantized.py:941",
                        ["winograd_tpu/kernels/quantized.py:941 _transition_int8_kernel",
                         "winograd_tpu/kernels/quantized.py:1003 "
                         "_transition_int8_kernel_resident"]),
    "winograd_int8": ("winograd_tpu/kernels/quantized.py:393",
                      ["winograd_tpu/kernels/quantized.py:393 _winograd_int8_kernel"]),
    "basic_stage": ("winograd_tpu/kernels/basic_stage.py:59",
                    ["winograd_tpu/kernels/basic_stage.py:59 _basic_stage_kernel"]),
    "basic_stage_int8": ("winograd_tpu/kernels/basic_stage.py:202",
                         ["winograd_tpu/kernels/basic_stage.py:202 _basic_stage_int8_kernel"]),
}
# The stem's prepared-input entry (csrc/stem.cu's second C entry) replaces
# the TPU kernel as the JAX package's prepared-input contract calls it.
SOURCES["stem_pre"] = ("winograd_tpu/kernels/stem.py:59",
                       ["winograd_tpu/kernels/stem.py:59 _stem_kernel (its pallas_call at "
                        "stem.py:225, in stem_fused_pallas_pre, stem.py:186)"])
# The bf16w instantiations replace the same TPU kernels at precision="bf16w".
BF16W = ("pointwise", "stem", "stem_pre", "stage", "transition", "winograd", "direct",
         "basic_stage")
SOURCES.update({f"{name}_bf16w": SOURCES[name] for name in BF16W})
# A row's source file where it is not csrc/<row without _bf16w>.cu.
SOURCE_FILES = {"stem_pre": "stem", "stem_pre_bf16w": "stem"}
# The int8 Winograd past one span of K (kernels/quantized.py::
# WINO_INT8_CHUNK): nine 128-channel groups, and the stash over 2048
# channels. Checked against the twin like every shape, counted in no image.
WIDE_WINOGRAD_INT8 = [(1, 14, 14, 1152, 128, True), (1, 14, 14, 2048, 256, True)]
# The benchmark CLI's modes run in the bench phase: the reference's six
# layer cases, a block at two geometries, a transition, the stem and the
# three classifiers at N=1 (the last four with the prepared-input route).
BENCH_MODES = (0, 1, 2, 3, 4, 5, 6, 9, 11, 16, 17, 19, 22, 23, 24, 25)
PRE_MODES = (16, 22, 23, 24)
TRAIN_MODES = (17, 19, 25)
# The twin's arithmetic (quantized once a row, exact int32 sums, epilogues
# rounded as the twin rounds, the int8 Winograd's transforms in FP64 rounded
# once): the kernel equals its twin. So do the stem and the Winograd at
# "bf16" (their shapes end in the precision): exact FP64 sums of bf16
# products, rounded once.
EXACT = ("direct_int8", "stage_int8", "transition_int8", "pointwise_int8", "basic_stage_int8",
         "winograd_int8")


def _rand(rng, *shape):
    return (rng.random(shape) - 0.5).astype(np.float32)


def _winograd_transform_flops(m):
    """FLOPs of the input transform per tile and input channel, and of the
    output transform per tile and output channel, counting only the nonzero
    entries of Bt and At, as csrc/winograd.cu's sandwich() computes them
    (one FMA, two FLOPs, each)."""
    from winograd_tpu_torch.kernels import transforms

    bt, _, at = transforms.matrices(m)
    a = m + 2
    return 2 * (2 * a * np.count_nonzero(bt)), 2 * ((a + m) * np.count_nonzero(at))


def _kernel_name(key):
    """A profiler event's kernel name without namespace, template or
    arguments; PyTorch's own kernels are lumped as "pytorch_ops"."""
    if "at::native" in key:
        return "pytorch_ops"
    key = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return key.split("(")[0].split("<")[0].strip()


# The parallel phase: one world of PARALLEL_RANKS gloo ranks on the one
# card, each partition's mesh, and the collectives' timeout (seconds).
PARALLEL_RANKS = 4
PARALLEL_MESHES = {"data": (4, 1), "model": (2, 2), "pipe": (4,)}
PARALLEL_TIMEOUT_S = 600.0
# The channel-sharded block step: the mode-6 block (14x14, Cio 1024, Cmid
# 256), two steps; the share of each leaf a rank holds on the 2 x 2 mesh;
# its bar against the one-device step (the data-parallel step's in
# tests/test_torch_parallel.py).
BLOCK_TRAIN_CIO, BLOCK_TRAIN_CMID, BLOCK_TRAIN_STEPS = 1024, 256, 2
BLOCK_TRAIN_FRACTION = {"w_reduce": 0.5, "w_expand": 0.5, "s_expand": 0.5, "b_expand": 0.5,
                        "w_mid": 1.0, "s_reduce": 1.0, "b_reduce": 1.0, "s_mid": 1.0,
                        "b_mid": 1.0}
BLOCK_TRAIN_RTOL = 1e-5


def _parallel_rank(rank: int, world: int, images: np.ndarray) -> dict:
    """One rank of the parallel phase (phase 11b of the docstring): every
    partition of both classifiers at every tier, the data-parallel train
    step and the one-rank NCCL meshes, checked here; returns the rank's
    lines' numbers and the checks that failed. images: (4, 224, 224, 3)."""
    import torch

    from winograd_tpu_torch.config import (
        BF16W_RTOL_BACKBONE, INT8_RTOL_BACKBONE, TIERS, ResNet34Config, ResNet50Config,
    )
    from winograd_tpu_torch.engine import ResNet50Engine, ResNetBasicEngine
    from winograd_tpu_torch.kernels import _build
    from winograd_tpu_torch.models.basic import (
        basicnet_forward, basicnet_params, init_basicnet_arrays,
    )
    from winograd_tpu_torch.models.convert import params_from_jax
    from winograd_tpu_torch.models.resnet50 import init_resnet50_arrays, resnet50_forward
    from winograd_tpu_torch.models.train import (
        make_resnet50_train_step, trainable_resnet50_params,
    )
    from winograd_tpu_torch.parallel import (
        make_basicnet_tp_fn, make_mesh, make_pipe_mesh, make_resnet50_tp_fn,
    )
    from winograd_tpu_torch.parallel.mesh import broadcast
    from winograd_tpu_torch.utils.tree import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    meshes = {"data": make_mesh(4, 1, device=dev), "model": make_mesh(4, 2, device=dev),
              "pipe": make_pipe_mesh(4, device=dev)}
    nccl = {"data": make_mesh(1, 1, device=dev, backend="nccl"),
            "model": make_mesh(1, 1, device=dev, backend="nccl"),
            "pipe": make_pipe_mesh(1, device=dev, backend="nccl")}
    every = meshes["data"]   # all ranks on its "data" axis
    cpu_model = meshes["model"].to("cpu")
    failures, lines, nccl_lines = [], [], []

    def check(ok, what):
        if not ok:
            failures.append(f"rank {rank}: {what}")

    def from_rank(src, fn, shape, dtype=torch.float32):
        """fn() on rank src, on every rank."""
        out = fn().to(dev, dtype) if rank == src else torch.empty(shape, dtype=dtype, device=dev)
        return broadcast(out, every, "data", src)

    def err(out, ref):
        return ((out.double() - ref.double()).abs().max().item(),
                max(1.0, ref.abs().max().item()))

    def sync():
        torch.cuda.synchronize(dev)

    cfg50, cfg34 = ResNet50Config(), ResNet34Config("resnet34")
    case34 = init_basicnet_arrays(cfg34, seed=0)
    models = {
        "resnet50": (ResNet50Engine, make_resnet50_tp_fn,
                     lambda dt: params_from_jax(init_resnet50_arrays(cfg50, seed=0), "cpu", dt),
                     resnet50_forward),
        "resnet34": (ResNetBasicEngine, make_basicnet_tp_fn,
                     lambda dt: basicnet_params(case34, cfg34, "cpu", dt), basicnet_forward),
    }
    n, classes = images.shape[0], 1000
    for model, (engine_cls, tp_fn, params_of, forward) in models.items():
        params = params_of(torch.float32)
        # The float64 golden of image 0 on rank 1 while rank 0 serves the
        # single-device references.
        golden = from_rank(1, lambda: forward(images[0], params_of(torch.float64), device="cpu"),
                           (classes,), torch.float64)
        refs = {tier: from_rank(0, lambda tier=tier: engine_cls(params, tier=tier, device=dev)(
            images), (n, classes)) for tier in TIERS}
        for tier in TIERS:
            ref = refs[tier]
            # Under "model" the reduced tiers are their own arithmetic (module
            # docstring, 11b): held to the same TP forward through the plain
            # versions on the CPU, the same ranks.
            plain = None if tier == "f32" else tp_fn(cpu_model, params, tier)(images)
            for partition, mesh in meshes.items():
                sync()
                torch.cuda.reset_peak_memory_stats(dev)
                held = torch.cuda.memory_allocated(dev)
                engine = engine_cls(params, tier=tier, device=dev, mesh=mesh, partition=partition)
                weights_mib = (torch.cuda.memory_allocated(dev) - held) / 2**20
                _build.reset_counts()
                out = engine(images)
                launches = dict(_build.LAUNCHES)
                lat = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    engine(images)
                    sync()
                    lat.append(time.perf_counter() - t0)
                if partition == "data":
                    expected = EXPECTED_PER_FORWARD_TABLES[(model, tier)]
                elif partition == "model":
                    expected = EXPECTED_TP[(model, tier)]
                else:  # each of the n microbatches through the rank's group
                    expected = {k: n * v for k, v in EXPECTED_PIPE[(model, tier)][rank].items()}
                what = f"parallel {model} {tier} {partition}"
                check(launches == expected, f"{what}: launches {launches}, want {expected}")
                check(bool(torch.isfinite(out).all()) and tuple(out.shape) == (n, classes),
                      f"{what}: logits not finite or of shape {tuple(out.shape)}")
                line = {"model": model, "tier": tier, "partition": partition,
                        "eager_ms": 1e3 * statistics.median(lat), "launches": launches,
                        "peak_device_mib": torch.cuda.max_memory_allocated(dev) / 2**20,
                        "weights_mib": weights_mib, "replays": engine.replays}
                if plain is not None and partition == "model":
                    g_rtol, p_rtol = {"bf16w": (BF16W_RTOL_BACKBONE, ATOL),
                                      "int8": (INT8_RTOL_BACKBONE, INT8_CHAINED_RTOL)}[tier]
                    e_g, scale_g = err(out[0], golden)
                    e_p, scale_p = err(out.cpu(), plain)
                    check(e_g <= g_rtol * scale_g,
                          f"{what}: {e_g} from the golden > {g_rtol} * {scale_g}")
                    check(e_p <= p_rtol * scale_p,
                          f"{what}: {e_p} from the plain TP forward > {p_rtol} * {scale_p}")
                    e, scale = err(out, ref)
                    line.update(golden_err=e_g, golden_tol=g_rtol * scale_g, plain_err=e_p,
                                plain_tol=p_rtol * scale_p, one_device_err=e)
                else:
                    rtol = INT8_CHAINED_RTOL if tier == "int8" else ATOL
                    e, scale = err(out, ref)
                    check(e <= rtol * scale, f"{what}: {e} from one device > {rtol} * {scale}")
                    line.update(max_abs_err=e, tol=rtol * scale)
                check(engine.replays == 0, f"{what}: {engine.replays} graph replays under a mesh")
                lines.append(line)
                del engine, out
        if model == "resnet50" and rank == 0:
            for partition, mesh in nccl.items():
                out = engine_cls(params, device=dev, mesh=mesh, partition=partition)(images)
                e, scale = err(out, refs["f32"])
                check(e <= ATOL * scale, f"parallel nccl {partition}: {e} > {ATOL} * {scale}")
                nccl_lines.append({"model": model, "tier": "f32", "partition": partition,
                                   "max_abs_err": e, "tol": ATOL * scale})
        del params, refs

    # The data-parallel train step against the single-device step on the
    # whole batch (rank 0), from the same seeded trainable set.
    tree = trainable_resnet50_params(init_resnet50_arrays(cfg50, seed=0))
    labels = np.random.default_rng(2).integers(0, 1000, n)

    def steps(mesh, count):
        """count steps from zero momentum: the first's loss, its gradients
        (the momentum after it), its launches, and each step's seconds."""
        params = tree_map(lambda a: torch.tensor(np.asarray(a), device=dev), tree)
        momentum = tree_map(torch.zeros_like, params)
        step = make_resnet50_train_step(lr=1e-2, beta=0.9, mesh=mesh)
        seconds = []
        for i in range(count):
            _build.reset_counts()
            t0 = time.perf_counter()
            _, momentum, loss = step(params, momentum, images, labels)
            sync()
            seconds.append(time.perf_counter() - t0)
            if i == 0:
                first = loss, tree_map(torch.clone, momentum), dict(_build.LAUNCHES)
        return (*first, seconds)

    torch.cuda.reset_peak_memory_stats(dev)
    loss, grads, launches, seconds = steps(every, 2)
    train = {"launches": launches, "first_step_ms": 1e3 * seconds[0],
             "step_ms": 1e3 * seconds[1], "loss": loss.item(),
             "peak_device_mib": torch.cuda.max_memory_allocated(dev) / 2**20}
    check(launches == EXPECTED_TRAIN_STEP[("resnet50", None)],
          f"parallel train: launches {launches}, want {EXPECTED_TRAIN_STEP[('resnet50', None)]}")
    if rank == 0:
        want_loss, want_grads, _, _ = steps(None, 1)
        rel = abs(loss.item() - want_loss.item()) / max(1.0, abs(want_loss.item()))
        leaf = max(err(g, r)[0] / err(g, r)[1]
                   for g, r in zip(tree_leaves(grads), tree_leaves(want_grads)))
        check(rel <= TRAIN_RTOL and leaf <= TRAIN_RTOL,
              f"parallel train: loss {rel}, worst gradient leaf {leaf} > {TRAIN_RTOL}")
        train.update(single_loss=want_loss.item(), loss_rel_err=rel, worst_leaf_err=leaf)

    block, block_failures = _parallel_block_train(rank, meshes["model"], n)
    failures += [f"rank {rank}: {what}" for what in block_failures]
    return {"lines": lines, "nccl": nccl_lines, "train": train, "block_train": block,
            "failures": failures}


def _parallel_block_train(rank: int, mesh, n: int):
    """The channel-sharded block step of the parallel phase (11b of the
    docstring; parallel/data_parallel.py, the plain operators on `mesh`, a
    2 x 2 mesh) on the mode-6 block at N=n against the one-device step on
    rank 0, from the same seeded state, on the mesh's device. Returns the
    rank's numbers and the checks that failed."""
    import torch

    from winograd_tpu_torch.parallel import (
        gather_train_state, init_train_state, make_train_step, shard_train_state,
    )

    dev, failures = mesh.device, []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    whole, _ = init_train_state(6, BLOCK_TRAIN_CIO, BLOCK_TRAIN_CMID, device=dev)
    rng = np.random.default_rng(6)
    x, target = (rng.standard_normal((n, 14, 14, BLOCK_TRAIN_CIO)).astype(np.float32)
                 for _ in range(2))

    def steps(on):
        params = {k: v.clone() for k, v in whole.items()}
        momentum = {k: torch.zeros_like(v) for k, v in params.items()}
        if on is not None:
            params, momentum = shard_train_state(on, params, momentum)
        held = sum(t.numel() for t in (*params.values(), *momentum.values())) * 4 / 2**20
        step = make_train_step(on, lr=1e-2)
        losses, seconds = [], []
        for _ in range(BLOCK_TRAIN_STEPS):
            t0 = time.perf_counter()
            _, _, loss = step(params, momentum, x, target)
            sync()
            seconds.append(time.perf_counter() - t0)
            losses.append(loss.item())
        return params, losses, seconds, held

    shards, losses, seconds, held = steps(mesh)
    fraction = {k: shards[k].numel() / whole[k].numel() for k in shards}
    block = {"step_ms": 1e3 * seconds[-1], "first_step_ms": 1e3 * seconds[0],
             "mib_held": held, "losses": losses, "shard_fraction": fraction}
    for k, want in BLOCK_TRAIN_FRACTION.items():
        if fraction[k] != want:
            failures.append(f"parallel block train: {k} holds {fraction[k]} of the whole, "
                            f"want {want}")
    gathered = gather_train_state(mesh, shards)
    if rank == 0:
        params, want_losses, single_s, single_held = steps(None)
        loss_err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(losses, want_losses))
        leaf_err = max((gathered[k].double() - params[k].double()).abs().max().item()
                       / max(1.0, params[k].abs().max().item()) for k in params)
        if not (loss_err <= BLOCK_TRAIN_RTOL and leaf_err <= BLOCK_TRAIN_RTOL):
            failures.append(f"parallel block train: losses {loss_err}, worst leaf {leaf_err} "
                            f"from one device > {BLOCK_TRAIN_RTOL}")
        block.update(single_losses=want_losses, single_step_ms=1e3 * single_s[-1],
                     single_mib_held=single_held, loss_rel_err=loss_err, worst_leaf_err=leaf_err)
    return block, failures


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()

    import torch.nn.functional as F

    from winograd_tpu_torch.baseline import cudnn as baseline
    from winograd_tpu_torch.config import (
        BF16W_RTOL_BACKBONE, BF16W_TRAIN_GRAD_RTOL, CASES, INT8_RTOL_BACKBONE, ResNet34Config,
        ResNet50Config,
    )
    from winograd_tpu_torch.bench.cli import run_case, train_step, train_step_scalar
    from winograd_tpu_torch.engine import (
        CAPTURE_PASSES, ResNet50Engine, ResNetBasicEngine, engine_from_torch,
    )
    from winograd_tpu_torch.kernels import _build, transforms
    from winograd_tpu_torch.kernels import basic_stage as bs
    from winograd_tpu_torch.kernels import quantized as q8
    from winograd_tpu_torch.kernels.direct import (
        conv3x3_bn_direct, conv3x3_bn_direct_plain, direct_filter, direct_plan, im2col3x3,
    )
    from winograd_tpu_torch.kernels.pointwise import conv1x1_bn, conv1x1_bn_plain, split_plan
    from winograd_tpu_torch.kernels.stage import (
        resnet_stage_fused, resnet_stage_fused_plain, stack_stage_params,
    )
    from winograd_tpu_torch.kernels.stem import (
        stem_fused, stem_fused_plain, stem_fused_pre, stem_fused_pre_plain, stem_prepare_input,
    )
    from winograd_tpu_torch.kernels.transition import (
        fuse_transition_weights, strided_im2col, transition_block_fused,
        transition_block_fused_plain, transition_plan,
    )
    from winograd_tpu_torch.kernels.winograd import (
        conv3x3_bn_winograd, conv3x3_bn_winograd_plain, winograd2_mid_plain, winograd_plan,
    )
    from winograd_tpu_torch.models.basic import (
        basicnet_arrays, basicnet_forward, basicnet_forward_int8, basicnet_forward_train,
        basicnet_params, cast_basicnet_bf16w, init_basicnet_arrays, quantize_basicnet,
    )
    from winograd_tpu_torch.models.checkpoint import (
        load_checkpoint_dir, save_checkpoint_dir, save_model,
    )
    from winograd_tpu_torch.models.import_torch import build_torch_reference_resnet
    from winograd_tpu_torch.models.train import (
        make_resnet50_train_step, trainable_basicnet_params, trainable_resnet50_params,
    )
    from winograd_tpu_torch.models.convert import (
        cast_bf16w, params_from_jax, params_to, stem_filter_s2d,
    )
    from winograd_tpu_torch.utils.checker import ParityError
    from winograd_tpu_torch.models.resnet50 import (
        init_resnet50_arrays, init_resnet50_params, quantize_resnet50, resnet50_forward,
        resnet50_forward_int8, resnet50_forward_train,
    )
    from winograd_tpu_torch.utils import checker as host_checker
    from winograd_tpu_torch.utils import io as host_io
    from winograd_tpu_torch.utils import native
    from winograd_tpu_torch.utils.timing import bench_graph
    from winograd_tpu_torch.utils.tree import tree_leaves, tree_map

    dev = torch.device("cuda", 0)
    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)
            print(f"FAIL: {what}", file=sys.stderr)

    build_s = _build.build_all()
    print(json.dumps({"phase": "build", "seconds": build_s}), flush=True)

    # -- the native host library (utils/native.py) ---------------------------
    build_dir = pathlib.Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    native.CALLS.clear()
    blob = _rand(np.random.default_rng(5), 14, 14, 128)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        path = os.path.join(tmp, "blob.bin")
        host_io.save_parameter(path, blob)
        back = host_io.get_parameters({path: blob.size})[path]
    res = host_checker.output_checker(np.pad(blob, ((1, 1), (1, 1), (0, 0))), blob, 14, 128,
                                      shift=1)
    served_native = dict(native.CALLS)
    check(native.available() and served_native == {
        "wt_write_f32": 1, "wt_read_many_f32": 1, "wt_output_checker": 1},
        f"native host library: loaded {native.available()}, served {served_native}")
    check(np.array_equal(back, blob.ravel()) and res.error_count == 0 and res.max_error == 0.0,
          f"native host library: read back or checked wrong ({res})")
    print(json.dumps({"phase": "native", "library": str(native.library_path()),
                      "available": native.available(), "served": served_native}), flush=True)

    def t(a):
        return torch.as_tensor(a, device=dev)

    def bn(rng, c):
        gamma, beta, mean = _rand(rng, c), _rand(rng, c), _rand(rng, c)
        var = (rng.random(c) * 3 + 5).astype(np.float32)
        s, b = transforms.fold_batchnorm(gamma, beta, mean, var)
        return t(s), t(b)

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def wrapper_ms(fn, reps=20, warmup=2):
        """One eager call between two events: device time plus whatever host
        time the device waits for."""
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(reps):
            a, b = events()
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)

    def device_ms(fn):
        """Device time per call: 20 calls captured in one CUDA graph, the
        median of 20 replays between two events, over 20 (bench_graph)."""
        return bench_graph(fn) / 1e3

    def bound(work, nbytes):
        """work: operations by peak rate ({rate: count}). Returns the
        operations' time and the bytes' time, in ms; the bound is the
        larger."""
        ops_ms = 1e3 * sum(n / rate for rate, n in work.items())
        bytes_ms = 1e3 * nbytes / HBM_BYTES_S
        return ops_ms, bytes_ms

    def nchw(x):
        return x.permute(0, 3, 1, 2)

    # -- f32 cases: (kernel fn, plain fn, library fn, work, bytes) ----------
    def pointwise_work(p, k, n):
        """The GEMV's FFMA products at the FP32 rate; the MMA tiles' as three
        TF32 passes (3xTF32); the epilogue at the FP32 rate."""
        if split_plan(p, k, n, _build.sm_count(dev)).gemv:
            return {FP32_FLOPS: 2 * p * k * n + 4 * p * n}
        return {TF32_FLOPS: 3 * 2 * p * k * n, FP32_FLOPS: 4 * p * n}

    def pointwise_case(rng, p, k, n, relu):
        x, w = t(_rand(rng, p, k)), t(_rand(rng, k, n))
        s, b = bn(rng, n)
        return (lambda: conv1x1_bn(x, w, s, b, relu),
                lambda: conv1x1_bn_plain(x, w, s, b, relu),
                lambda: torch.matmul(x, w),
                pointwise_work(p, k, n), 4 * (p * k + k * n + p * n + 2 * n))

    def bf16w(layer):
        """A layer's weights in bfloat16 (the bf16w tier's storage)."""
        return {k: v.to(torch.bfloat16) if k.startswith(("w", "u2")) else v
                for k, v in layer.items()}

    def pointwise_bf16w_case(rng, p, k, n, relu):
        """Products as two BF16 passes (a_hi, a_lo), GEMV too; weights at 2
        bytes; library: the f32 row's torch.matmul on the f32 weights."""
        x, w = t(_rand(rng, p, k)), t(_rand(rng, k, n))
        w16 = w.to(torch.bfloat16)
        s, b = bn(rng, n)
        return (lambda: conv1x1_bn(x, w16, s, b, relu),
                lambda: conv1x1_bn_plain(x, w16, s, b, relu),
                lambda: torch.matmul(x, w),
                {BF16_FLOPS: 2 * 2 * p * k * n, FP32_FLOPS: 4 * p * n},
                4 * (p * k + p * n + 2 * n) + 2 * k * n)

    def conv3x3_inputs(rng, n, h, w, cin, cout):
        x, wt = t(_rand(rng, n, h, w, cin)), _rand(rng, cout, cin, 3, 3)
        s, b = bn(rng, cout)
        w_cl = t(wt).contiguous(memory_format=torch.channels_last)
        return x, wt, s, b, lambda: F.conv2d(nchw(x), w_cl, padding=1)

    def winograd_case(rng, n, h, w, cin, cout, m, relu, filt="f32"):
        """filt "bf16": the bf16-filter F(2,3) (its products as two BF16
        passes, the JAX kernel's hi/lo split; library F.conv2d in bf16);
        "bf16w": the bf16w instantiation (products as two BF16 passes, u at
        2 bytes; library the f32 row's call)."""
        x, wt, s, b, lib = conv3x3_inputs(rng, n, h, w, cin, cout)
        u = t(transforms.transform_filter(wt, m=m))
        a2, nt = (m + 2) ** 2, n * (-(-h // m)) * (-(-w // m))
        fwd, inv = _winograd_transform_flops(m)
        products, transforms_flops = 2 * a2 * nt * cin * cout, nt * (fwd * cin + inv * cout)
        if filt == "bf16":
            u = u.to(torch.bfloat16)
            x16 = nchw(x).to(torch.bfloat16)
            w16 = t(wt).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
            return (lambda: conv3x3_bn_winograd(x, u, s, b, relu, "bf16"),
                    lambda: winograd2_mid_plain(x, u, s, b, relu),
                    lambda: F.conv2d(x16, w16, padding=1),
                    {BF16_FLOPS: 2 * products, FP32_FLOPS: transforms_flops},
                    4 * n * h * w * (cin + cout) + 2 * a2 * cin * cout + 8 * cout)
        if filt == "bf16w":
            u = u.to(torch.bfloat16)
            return (lambda: conv3x3_bn_winograd(x, u, s, b, relu, "bf16w"),
                    lambda: conv3x3_bn_winograd_plain(x, u, s, b, relu), lib,
                    {BF16_FLOPS: 2 * products,
                     FP32_FLOPS: transforms_flops + 4 * n * h * w * cout},
                    4 * n * h * w * (cin + cout) + 2 * a2 * cin * cout + 8 * cout)
        return (lambda: conv3x3_bn_winograd(x, u, s, b, relu),
                lambda: conv3x3_bn_winograd_plain(x, u, s, b, relu),
                lib, {TF32_FLOPS: 3 * products,
                      FP32_FLOPS: transforms_flops + 4 * n * h * w * cout},
                4 * (n * h * w * (cin + cout) + a2 * cin * cout + 2 * cout))

    def direct_case(rng, n, h, w, cin, cout, relu, bf16=False):
        """bf16: the bf16w instantiation (w9 at 2 bytes, products as two BF16
        passes; library the f32 row's call)."""
        x, wt, s, b, lib = conv3x3_inputs(rng, n, h, w, cin, cout)
        w9 = t(direct_filter(wt))
        p = n * h * w
        rate, passes, wbytes = (BF16_FLOPS, 2, 2) if bf16 else (TF32_FLOPS, 3, 4)
        if bf16:
            w9 = w9.to(torch.bfloat16)
        return (lambda: conv3x3_bn_direct(x, w9, s, b, relu),
                lambda: conv3x3_bn_direct_plain(x, w9, s, b, relu),
                lib, {rate: passes * 2 * p * 9 * cin * cout, FP32_FLOPS: 4 * p * cout},
                4 * (n * h * w * (cin + cout) + 2 * cout) + wbytes * 9 * cin * cout)

    def stem_case(rng, n, h, w, cin, c, precision):
        """At "bf16w" w192 is bf16 (2 bytes), the products two BF16 passes
        (the JAX kernel's hi/lo split of the image), the library the f32
        row's cuDNN call."""
        x, w7 = t(_rand(rng, n, h, w, cin)), _rand(rng, c, cin, 7, 7)
        s, b = bn(rng, c)
        w192 = t(stem_filter_s2d(w7))
        dt = torch.bfloat16 if precision == "bf16" else torch.float32
        x_lib = nchw(x).to(dt)
        w7_cl = t(w7).to(dt).contiguous(memory_format=torch.channels_last)
        ho, wo, po, qo = -(-h // 2), -(-w // 2), -(-h // 4), -(-w // 4)
        products = 2 * n * ho * wo * 49 * cin * c
        work, wbytes = {FP32_FLOPS: products}, 4
        if precision == "bf16":
            work = {BF16_FLOPS: products}
        elif precision == "bf16w":
            work, wbytes, w192 = {BF16_FLOPS: 2 * products}, 2, w192.to(torch.bfloat16)
        return (lambda: stem_fused(x, w192, s, b, precision),
                lambda: stem_fused_plain(x, w192, s, b, precision),
                lambda: F.max_pool2d(F.conv2d(x_lib, w7_cl, stride=2, padding=3), 3, 2, 1),
                work, 4 * (n * h * w * cin + n * po * qo * c + 2 * c) + wbytes * 64 * cin * c)

    def stem_pre_case(rng, n, h, w, cin, c, precision):
        """The stem's prepared-input entry on the operand stem_prepare_input
        builds on the host before the timed region (read once: (h + 6) x
        (w + 6) x C4 floats an image); work as stem_case's; library: cuDNN's
        conv, the folded BN, ReLU and the maxpool in f32."""
        x_np, w7 = _rand(rng, n, h, w, cin), _rand(rng, c, cin, 7, 7)
        s, b = bn(rng, c)
        xb = stem_prepare_input(x_np, precision).to(dev)
        w192 = t(stem_filter_s2d(w7))
        x_lib = nchw(t(x_np))
        w7_cl = t(w7).contiguous(memory_format=torch.channels_last)
        s4, b4 = s.view(1, -1, 1, 1), b.view(1, -1, 1, 1)
        po, qo = -(-h // 4), -(-w // 4)
        products = 2 * n * -(-h // 2) * -(-w // 2) * 49 * cin * c
        work, wbytes = {FP32_FLOPS: products}, 4
        if precision == "bf16w":
            work, wbytes, w192 = {BF16_FLOPS: 2 * products}, 2, w192.to(torch.bfloat16)

        def lib():
            y = F.conv2d(x_lib, w7_cl, stride=2, padding=3)
            return F.max_pool2d(torch.relu(y * s4 + b4), 3, 2, 1)

        return (lambda: stem_fused_pre(xb, w192, s, b, h, w, precision),
                lambda: stem_fused_pre_plain(xb, w192, s, b, h, w, precision), lib,
                work, 4 * (xb.numel() + n * po * qo * c + 2 * c) + wbytes * 64 * cin * c)

    def conv3x3_filter(rng, cin, cout):
        w = _rand(rng, cout, cin, 3, 3)
        return w, t(w).contiguous(memory_format=torch.channels_last)

    def stage_blocks(rng, cio, cmid, nb):
        blocks = []
        for _ in range(nb):
            wm = _rand(rng, cmid, cmid, 3, 3)
            (s1, b1), (s2, b2), (s3, b3) = bn(rng, cmid), bn(rng, cmid), bn(rng, cio)
            blocks.append(dict(
                w_reduce=t(_rand(rng, cio, cmid)), s_reduce=s1, b_reduce=b1,
                u2_mid=t(transforms.transform_filter(wm, m=2)), w9_mid=t(direct_filter(wm)),
                s_mid=s2, b_mid=b2, w_expand=t(_rand(rng, cmid, cio)), s_expand=s3,
                b_expand=b3, w_mid=wm))
        return blocks

    def stage_case(rng, n, h, w, cio, cmid, nb, mid, bf16=False):
        """bf16: the bf16w instantiation (bf16 weights at 2 bytes, products
        as two BF16 passes; library the f32 row's calls)."""
        blocks = stage_blocks(rng, cio, cmid, nb)
        lib_w = [(b["w_reduce"], t(b.pop("w_mid")).contiguous(memory_format=torch.channels_last),
                  b["w_expand"]) for b in blocks]
        stacked = stack_stage_params(blocks)
        if bf16:
            stacked = bf16w(stacked)
        x = t(_rand(rng, n, h, w, cio))

        def lib():
            y = x
            for wr, wm_cl, we in lib_w:
                y = torch.matmul(y, wr)
                y = F.conv2d(nchw(y), wm_cl, padding=1).permute(0, 2, 3, 1)
                y = torch.matmul(y, we)
            return y

        p = n * h * w
        epilogues = 4 * p * 2 * cmid + 5 * p * cio
        if mid == "winograd2":
            nt = n * (-(-h // 2)) * (-(-w // 2))
            fwd, inv = _winograd_transform_flops(2)
            mid_products, mid_elems = 2 * 16 * nt * cmid * cmid, 16 * cmid * cmid
            epilogues += nt * (fwd + inv) * cmid
        else:
            mid_products, mid_elems = 2 * p * 9 * cmid * cmid, 9 * cmid * cmid
        rate, passes, wbytes = (BF16_FLOPS, 2, 2) if bf16 else (TF32_FLOPS, 3, 4)
        work = {rate: nb * passes * (4 * p * cio * cmid + mid_products),
                FP32_FLOPS: nb * epilogues}
        nbytes = (4 * (2 * p * cio + nb * (4 * cmid + 2 * cio))
                  + wbytes * nb * (2 * cio * cmid + mid_elems))
        return (lambda: resnet_stage_fused(x, stacked, mid),
                lambda: resnet_stage_fused_plain(x, stacked, mid), lib, work, nbytes)

    def transition_params(rng, cin, cmid, cout):
        wm = _rand(rng, cmid, cmid, 3, 3)
        (s1, b1), (s2, b2), (s3, b3), (sp, bp) = (bn(rng, c) for c in (cmid, cmid, cout, cout))
        return wm, dict(w_reduce=t(_rand(rng, cin, cmid)), s_reduce=s1, b_reduce=b1,
                        w9_mid=t(direct_filter(wm)), s_mid=s2, b_mid=b2,
                        w_expand=t(_rand(rng, cmid, cout)), s_expand=s3, b_expand=b3,
                        w_proj=t(_rand(rng, cin, cout)), s_proj=sp, b_proj=bp)

    def transition_case(rng, n, h, w, cin, cmid, cout, bf16=False):
        """bf16: the bf16w instantiation (bf16 weights at 2 bytes, products
        as two BF16 passes; library the f32 row's calls)."""
        wm, params = transition_params(rng, cin, cmid, cout)
        wm_cl = t(wm).contiguous(memory_format=torch.channels_last)
        params["wep"], params["bep"] = fuse_transition_weights(params)
        lib_params = params
        if bf16:
            params = bf16w(params)
        x = t(_rand(rng, n, h, w, cin))

        def lib():
            y = torch.matmul(x, lib_params["w_reduce"])
            y = F.conv2d(nchw(y), wm_cl, stride=2, padding=1).permute(0, 2, 3, 1)
            return (torch.matmul(y, lib_params["w_expand"])
                    + torch.matmul(x[:, ::2, ::2, :], lib_params["w_proj"]))

        ho, wo = -(-h // 2), -(-w // 2)
        p1, p2 = n * h * w, n * ho * wo
        flops = 2 * (p1 * cin * cmid + p2 * (9 * cmid * cmid + (cmid + cin) * cout))
        rate, passes, wbytes = (BF16_FLOPS, 2, 2) if bf16 else (TF32_FLOPS, 3, 4)
        nbytes = (4 * (p1 * cin + p2 * cout + 4 * cmid + cout)
                  + wbytes * (cin * cmid + 9 * cmid * cmid + (cmid + cin) * cout))
        return (lambda: transition_block_fused(x, params),
                lambda: transition_block_fused_plain(x, params), lib,
                {rate: passes * flops, FP32_FLOPS: 4 * (p1 + p2) * cmid + 2 * p2 * cout},
                nbytes)

    def basic_blocks(rng, c, nb):
        blocks = []
        for _ in range(nb):
            blk = {}
            for leg in ("a", "b"):
                w = _rand(rng, c, c, 3, 3)
                blk[f"w_{leg}"], blk[f"w9_{leg}"] = w, direct_filter(w)
                blk[f"s_{leg}"], blk[f"b_{leg}"] = (v.cpu().numpy() for v in bn(rng, c))
            blocks.append(blk)
        return blocks

    def basic_stage_case(rng, n, h, w, c, nb, bf16=False):
        """bf16: the bf16w instantiation (w9_a, w9_b at 2 bytes, products as
        two BF16 passes; library the f32 row's calls)."""
        blocks = basic_blocks(rng, c, nb)
        stacked = {k: v.to(dev) for k, v in bs.stack_basic_stage_params(blocks).items()}
        if bf16:
            stacked = bf16w(stacked)
        lib_w = [t(blk[f"w_{leg}"]).contiguous(memory_format=torch.channels_last)
                 for blk in blocks for leg in ("a", "b")]
        x = t(_rand(rng, n, h, w, c))

        def lib():
            y = nchw(x)
            for wc in lib_w:
                y = F.conv2d(y, wc, padding=1)
            return y

        p = n * h * w
        rate, passes, wbytes = (BF16_FLOPS, 2, 2) if bf16 else (TF32_FLOPS, 3, 4)
        return (lambda: bs.basic_stage_fused(x, stacked),
                lambda: bs.basic_stage_fused_plain(x, stacked), lib,
                {rate: nb * passes * 2 * 2 * p * 9 * c * c, FP32_FLOPS: nb * (4 + 5) * p * c},
                4 * (2 * p * c + nb * 4 * c) + wbytes * nb * 2 * 9 * c * c)

    # -- int8 cases ---------------------------------------------------------
    def qrows(a):
        """Activations quantized per row as int8 (rows of a 2-D view), with
        at least 32 rows (torch._int_mm refuses 16 or fewer)."""
        q = q8.quantize_rows(a.reshape(-1, a.shape[-1]))[0].to(torch.int8)
        return F.pad(q, (0, 0, 0, 32 - q.shape[0])) if q.shape[0] <= 16 else q.contiguous()

    def int_mm(*pairs):
        """The GEMMs through torch._int_mm, int8 x int8 -> int32. A B that
        cuBLASLt refuses row-major (some int8 shapes have no kernel in that
        layout) is handed over column-major, its layout chosen offline,
        before the timed region."""
        def layout(a, b):
            try:
                torch._int_mm(a, b)
                return a, b
            except RuntimeError:
                return a, b.t().contiguous().t()

        pairs = [layout(a, b) for a, b in pairs]

        def run():
            return [torch._int_mm(a, b) for a, b in pairs]
        return run

    def qweights(w):
        w_q, s_w = q8.quantize_weights(w)
        return t(w_q), t(s_w)

    def pointwise_int8_case(rng, p, k, n, relu):
        x = t(_rand(rng, p, k))
        w_q, s_w = qweights(_rand(rng, k, n))
        s, b = bn(rng, n)
        return (lambda: q8.conv1x1_bn_int8(x, w_q, s_w, s, b, relu),
                lambda: q8.conv1x1_bn_int8_plain(x, w_q, s_w, s, b, relu),
                int_mm((qrows(x), w_q)),
                {INT8_OPS: 2 * p * k * n, FP32_FLOPS: 4 * p * n + 2 * p * k},
                4 * p * k + k * n + 4 * p * n + 12 * n)

    def direct_int8_case(rng, n, h, w, cin, cout, relu):
        x = t(_rand(rng, n, h, w, cin))
        w9_q, s_w9 = qweights(direct_filter(_rand(rng, cout, cin, 3, 3)))
        s, b = bn(rng, cout)
        p = n * h * w
        return (lambda: q8.conv3x3_bn_int8(x, w9_q, s_w9, s, b, relu),
                lambda: q8.conv3x3_bn_int8_plain(x, w9_q, s_w9, s, b, relu),
                int_mm((qrows(im2col3x3(x)), w9_q)),
                {INT8_OPS: 2 * p * 9 * cin * cout, FP32_FLOPS: 4 * p * cout + 2 * p * 9 * cin},
                4 * p * cin + 9 * cin * cout + 4 * p * cout + 12 * cout)

    def stage_int8_case(rng, n, h, w, cio, cmid, nb, mid):
        blocks = stage_blocks(rng, cio, cmid, nb)
        for b in blocks:
            del b["w_mid"]
        qs = {k: v.to(dev) for k, v in q8.quantize_stage_params(blocks).items()}
        x = t(_rand(rng, n, h, w, cio))
        p = n * h * w
        hq = qrows(t(_rand(rng, p, cmid)))
        pairs = []
        for b in range(nb):
            pairs += [(qrows(x), qs["w_reduce_q"][b]), (hq, qs["w_expand_q"][b])]
            if mid == "direct":
                pairs.append((qrows(im2col3x3(t(_rand(rng, n, h, w, cmid)))), qs["w9_mid_q"][b]))
        mm = int_mm(*pairs)
        work = {INT8_OPS: nb * 4 * p * cio * cmid,
                FP32_FLOPS: nb * (4 * p * (2 * cmid + cio) + 2 * p * (cio + cmid))}
        if mid == "winograd2":
            nt = n * (-(-h // 2)) * (-(-w // 2))
            fwd, inv = _winograd_transform_flops(2)
            work[BF16_FLOPS] = nb * 2 * (2 * 16 * nt * cmid * cmid)
            work[FP32_FLOPS] += nb * nt * (fwd + inv) * cmid
            v = t(_rand(rng, 16, nt, cmid)).to(torch.bfloat16)
            u = qs["u2_mid_bf16"]

            def lib():
                return mm(), [torch.bmm(v, u[b]) for b in range(nb)]
            mid_bytes = 2 * 16 * cmid * cmid
        else:
            work[INT8_OPS] += nb * 2 * p * 9 * cmid * cmid
            work[FP32_FLOPS] += nb * 2 * p * 9 * cmid
            lib = mm
            mid_bytes = 9 * cmid * cmid
        nbytes = 8 * p * cio + nb * (2 * cio * cmid + mid_bytes + 4 * (6 * cmid + 3 * cio))
        return (lambda: q8.resnet_stage_int8(x, qs, mid),
                lambda: q8.resnet_stage_int8_plain(x, qs, mid), lib, work, nbytes)

    def basic_stage_int8_case(rng, n, h, w, c, nb):
        qs = {k: v.to(dev) for k, v in bs.quantize_basic_stage_params(basic_blocks(rng, c, nb)).items()}
        x = t(_rand(rng, n, h, w, c))
        cols = qrows(im2col3x3(x))
        p = n * h * w
        lib = int_mm(*[(cols, qs[f"w9_{leg}_q"][b]) for b in range(nb) for leg in ("a", "b")])
        work = {INT8_OPS: nb * 2 * 2 * p * 9 * c * c,
                FP32_FLOPS: nb * 2 * (4 * p * c + 2 * p * 9 * c)}
        return (lambda: bs.basic_stage_int8(x, qs), lambda: bs.basic_stage_int8_plain(x, qs),
                lib, work, 8 * p * c + nb * (2 * 9 * c * c + 4 * 6 * c))

    def winograd_int8_case(rng, n, h, w, cin, cout, relu):
        x = t(_rand(rng, n, h, w, cin))
        u_q, s_u = (t(a) for a in q8.quantize_winograd_filter(
            transforms.transform_filter(_rand(rng, cout, cin, 3, 3), m=2)))
        s, b = bn(rng, cout)
        nt = n * (-(-h // 2)) * (-(-w // 2))
        v = t(_rand(rng, 16, nt, cin))
        lib = int_mm(*[(qrows(v[p]), u_q[p]) for p in range(16)])
        fwd, inv = _winograd_transform_flops(2)
        work = {INT8_OPS: 2 * 16 * nt * cin * cout,
                FP32_FLOPS: nt * (fwd * cin + inv * cout) + 2 * 16 * nt * (cin + cout)
                + 4 * n * h * w * cout}
        return (lambda: q8.conv3x3_bn_winograd_int8(x, u_q, s_u, s, b, relu),
                lambda: q8.conv3x3_bn_winograd_int8_plain(x, u_q, s_u, s, b, relu),
                lib, work, 4 * n * h * w * (cin + cout) + 16 * cin * cout + 4 * 18 * cout)

    def transition_int8_case(rng, n, h, w, cin, cmid, cout):
        _, params = transition_params(rng, cin, cmid, cout)
        qp = {k: v.to(dev) for k, v in q8.quantize_transition_params(params).items()}
        x = t(_rand(rng, n, h, w, cin))
        ho, wo = -(-h // 2), -(-w // 2)
        p1, p2 = n * h * w, n * ho * wo
        h1 = t(_rand(rng, n, h, w, cmid))
        lib = int_mm((qrows(x), qp["w_reduce_q"]), (qrows(strided_im2col(h1)), qp["w9_mid_q"]),
                     (qrows(t(_rand(rng, p2, cmid))), qp["w_expand_q"]),
                     (qrows(x[:, ::2, ::2, :]), qp["w_proj_q"]))
        macs = p1 * cin * cmid + p2 * (9 * cmid * cmid + cmid * cout + cin * cout)
        work = {INT8_OPS: 2 * macs,
                FP32_FLOPS: 4 * (p1 * cmid + p2 * cmid + 2 * p2 * cout)
                + 2 * (p1 * cin + p2 * (9 * cmid + cmid + cin))}
        nbytes = (4 * (p1 * cin + p2 * cout) + cin * cmid + 9 * cmid * cmid
                  + (cmid + cin) * cout + 4 * (6 * cmid + 6 * cout))
        return (lambda: q8.transition_block_int8(x, qp),
                lambda: q8.transition_block_int8_plain(x, qp), lib, work, nbytes)

    # -- serving at full width ---------------------------------------------
    cfg = ResNet50Config()
    params = init_resnet50_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(1)
    images = _rand(rng, 8, cfg.img, cfg.img, 3)
    n_single, n_batch = 10, 3
    requests = 1 + n_single + n_batch

    def sync():
        torch.cuda.synchronize()

    def phase_start():
        torch.cuda.reset_peak_memory_stats()

    def peak_mib():
        return torch.cuda.max_memory_allocated() / 2**20

    def counted(engine, first, single_fn, batch_fn):
        """A counted run (phase 3's rule): counters zeroed; the first N=1
        request (its wrapper launches: the warm-up and capture passes, by
        shape, kept); n_single N=1 requests, which must add nothing; n_batch
        N=8 requests, the first of which captures N=8. Every request must be
        served by a graph replay (the engine's count). Returns (N=1 logits
        by image, N=8 logits, N=1 seconds, N=8 seconds, counts after the
        first request, the N=1 requests, the first N=8 request and all, the
        first request's shapes, the replays of the run)."""
        replays0 = engine.replays
        _build.reset_counts()
        single = {0: first()}
        sync()
        counts = [dict(_build.LAUNCHES)]
        shapes = {name: collections.Counter(c) for name, c in _build.LAUNCH_SHAPES.items()}
        lat = []
        for i in range(n_single):
            t0 = time.perf_counter()
            logits = single_fn(i % 8)
            sync()
            lat.append(time.perf_counter() - t0)
            single.setdefault(i % 8, logits)
        counts.append(dict(_build.LAUNCHES))
        batch_s = []
        for j in range(n_batch):
            t0 = time.perf_counter()
            logits8 = batch_fn()
            sync()
            batch_s.append(time.perf_counter() - t0)
            if j == 0:
                counts.append(dict(_build.LAUNCHES))
        counts.append(dict(_build.LAUNCHES))
        replays = engine.replays - replays0
        check(replays == requests, f"{requests} requests served by {replays} graph replays")
        return single, logits8, lat, batch_s, counts, shapes, replays

    def serve(engine):
        return counted(engine, lambda: engine(images[0]), lambda i: engine(images[i]),
                       lambda: engine(images))

    def check_launches(expected, counts, shapes, tier):
        """Each kernel launches its count in one forward CAPTURE_PASSES times
        at the first N=1 request and again at the first N=8 request, and at
        no other request: a replay runs no wrapper."""
        first, after_single, after_batch1, final = counts
        for name, per in expected.items():
            want = per * CAPTURE_PASSES
            got = (first.get(name, 0), after_single.get(name, 0), after_batch1.get(name, 0),
                   final.get(name, 0))
            check(got == (want, want, 2 * want, 2 * want),
                  f"{tier} {name}: launches after the first N=1, the N=1 replays, the first "
                  f"N=8 and all requests {got}, want {(want, want, 2 * want, 2 * want)}")
            check(sum(shapes.get(name, {}).values()) == want,
                  f"{tier} {name}: first request launched {dict(shapes.get(name, {}))}, want "
                  f"{per} a forward x {CAPTURE_PASSES}")
        extra = set(final) - set(expected)
        check(not extra, f"{tier}: kernels off the path launched: {sorted(extra)}")
        return final

    def eager_forward(forward, tier_params, **kw):
        """The tier's model forward (models/resnet50.py, models/basic.py) on
        its own device copy of the tier's parameters, called with no graph:
        the forward the engine captures."""
        p = params_to(tier_params, dev, torch.float32)
        return lambda x: forward(x, p, dev, **kw)

    def eager_ms(eager, n, reps):
        """The tier's forward called eagerly (no graph) on the numpy images,
        as a request arrives, host clock to a synchronize, median of `reps`
        after one warm call."""
        with torch.inference_mode():
            eager(images[:n])
            sync()
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                eager(images[:n])
                sync()
                times.append(time.perf_counter() - t0)
        return 1e3 * statistics.median(times)

    def timing(lat, batch_s, eager):
        """The served (replayed) figures beside the same tier's eager ones;
        N=8 images/s from the requests after the capturing one."""
        n1_eager = eager_ms(eager, 1, n_single)
        n8_eager = eager_ms(eager, 8, n_batch)
        return {"n1_latency_ms_median": 1e3 * statistics.median(lat),
                "n1_latency_ms": [1e3 * v for v in lat],
                "n8_images_per_s": 8 / statistics.median(batch_s[1:]),
                "n1_eager_latency_ms": n1_eager, "n8_eager_images_per_s": 8e3 / n8_eager}

    def served_record(phase, single, logits8, counts, shapes):
        return {"phase": phase, "single": single, "logits8": logits8, "launches": counts[-1],
                "shapes": shapes}

    def serve_f32(phase, engine, eager, expected, golden):
        """The f32 tier's counted run and checks."""
        phase_start()
        single, logits8, lat, batch_s, counts, shapes, replays = serve(engine)
        launches = check_launches(expected, counts, shapes, phase)
        got = single[0].double().cpu().numpy()
        tol = ATOL * max(1.0, float(np.abs(golden).max()))
        err = float(np.abs(got - golden).max())
        check(got.shape == golden.shape and np.isfinite(got).all() and err <= tol,
              f"{phase}: N=1 logits vs float64 CPU golden: max abs err {err} > {tol}")
        ref8 = torch.stack([single[i] for i in range(8)])
        err8 = float((logits8.double() - ref8.double()).abs().max())
        check(tuple(logits8.shape) == (8,) + golden.shape and bool(torch.isfinite(logits8).all())
              and err8 <= tol, f"{phase}: N=8 logits vs each image's N=1 logits: {err8}")
        print(json.dumps({
            "phase": phase, **timing(lat, batch_s, eager),
            "golden_max_abs_err": err, "golden_tol": tol,
            "golden_max_abs": float(np.abs(golden).max()),
            "n8_vs_n1_max_abs_err": err8, "launches": launches, "requests": requests,
            "replays": replays, "peak_mib": peak_mib(),
        }), flush=True)
        return served_record(phase, single, logits8, counts, shapes)

    def serve_bf16w(phase, engine, eager, expected, golden, ref_cpu, cfg):
        """The bf16w tier's counted run and checks."""
        phase_start()
        single, logits8, lat, batch_s, counts, shapes, replays = serve(engine)
        launches = check_launches(expected, counts, shapes, phase)
        check(set(shapes.get("stem_bf16w", {})) == {(1, cfg.img, cfg.img, 3, cfg.stem_c, "bf16w")},
              f"{phase} stem shapes {dict(shapes.get('stem_bf16w', {}))}, want bf16w")
        check(all(shape[5] == 2 for shape in shapes.get("winograd_bf16w", {})),
              f"{phase} Winograd shapes {dict(shapes.get('winograd_bf16w', {}))}, want F(2,3)")
        got = single[0].cpu()
        gold_tol = BF16W_RTOL_BACKBONE * max(1.0, float(np.abs(golden).max()))
        gold_err = float(np.abs(got.double().numpy() - golden).max())
        cpu_tol = ATOL * max(1.0, ref_cpu.abs().max().item())
        cpu_err = (got - ref_cpu).abs().max().item()
        check(got.shape == golden.shape and bool(torch.isfinite(got).all())
              and gold_err <= gold_tol, f"{phase}: N=1 logits vs golden: {gold_err} > {gold_tol}")
        check(cpu_err <= cpu_tol,
              f"{phase}: N=1 logits vs the CPU plain bf16w forward: {cpu_err} > {cpu_tol}")
        ref8 = torch.stack([single[i] for i in range(8)])
        row_err = (logits8 - ref8).abs().amax(dim=-1)
        row_tol = ATOL * ref8.abs().amax(dim=-1).clamp(min=1.0)
        check(tuple(logits8.shape) == (8,) + golden.shape and bool(torch.isfinite(logits8).all())
              and bool((row_err <= row_tol).all()),
              f"{phase}: N=8 rows vs each image's N=1 logits: {row_err.tolist()} > {row_tol.tolist()}")
        print(json.dumps({
            "phase": phase, **timing(lat, batch_s, eager),
            "golden_max_abs_err": gold_err, "golden_tol": gold_tol,
            "cpu_bf16w_max_abs_err": cpu_err, "cpu_bf16w_tol": cpu_tol,
            "n8_vs_n1_max_abs_err": float(row_err.max()),
            "same_class_as_f32": int(got.argmax()) == int(np.argmax(golden)),
            "launches": launches, "requests": requests, "replays": replays,
            "peak_mib": peak_mib(),
        }), flush=True)
        return served_record(phase, single, logits8, counts, shapes)

    def serve_int8(phase, engine, eager, expected, golden, ref_int8, cfg):
        """The int8 tier's counted run and checks; serve_pre must refuse."""
        phase_start()
        single8, logits88, lat8, batch8_s, counts, shapes8, replays = serve(engine)
        launches8 = check_launches(expected, counts, shapes8, phase)
        check(set(shapes8.get("stem", {})) == {(1, cfg.img, cfg.img, 3, cfg.stem_c, "bf16")},
              f"{phase} stem shapes {dict(shapes8.get('stem', {}))}, want bf16")
        check(all(shape[-1] == "bf16" for shape in shapes8.get("winograd", {})),
              f"{phase} Winograd shapes {dict(shapes8.get('winograd', {}))}, want bf16 filters")
        got8 = single8[0].cpu()
        gold_tol = INT8_RTOL_BACKBONE * max(1.0, float(np.abs(golden).max()))
        gold_err = float(np.abs(got8.double().numpy() - golden).max())
        cpu_tol = INT8_CHAINED_RTOL * max(1.0, ref_int8.abs().max().item())
        cpu_err = (got8 - ref_int8).abs().max().item()
        check(got8.shape == golden.shape and bool(torch.isfinite(got8).all())
              and gold_err < gold_tol, f"{phase}: N=1 logits vs f32 golden: {gold_err} >= {gold_tol}")
        check(cpu_err <= cpu_tol,
              f"{phase}: N=1 logits vs the CPU plain int8 forward: {cpu_err} > {cpu_tol}")
        ref88 = torch.stack([single8[i] for i in range(8)])
        err88 = float((logits88 - ref88).abs().max())
        tol88 = INT8_CHAINED_RTOL * max(1.0, ref88.abs().max().item())
        check(tuple(logits88.shape) == (8,) + golden.shape and bool(torch.isfinite(logits88).all())
              and err88 <= tol88, f"{phase}: N=8 logits vs each image's N=1 logits: {err88} > {tol88}")
        try:
            engine.serve_pre(engine.prepare_input(images[0]))
            check(False, f"{phase}: serve_pre served the int8 tier")
        except ValueError:
            pass
        print(json.dumps({
            "phase": phase, **timing(lat8, batch8_s, eager),
            "golden_max_abs_err": gold_err, "golden_tol": gold_tol,
            "cpu_int8_max_abs_err": cpu_err, "cpu_int8_tol": cpu_tol,
            "n8_vs_n1_max_abs_err": err88, "n8_vs_n1_tol": tol88,
            "same_class_as_f32": int(got8.argmax()) == int(np.argmax(golden)),
            "serve_pre_refused": True, "launches": launches8, "requests": requests,
            "replays": replays,
            "peak_mib": peak_mib(),
        }), flush=True)
        return served_record(phase, single8, logits88, counts, shapes8)

    def serve_pre_phase(phase, engine, expected, record):
        """The prepared-input contract at the engine's tier: prepare_input on
        the host, then a counted run of serve_pre as phase 3's (the stem's
        launches counted as its prepared-input entry); the logits equal the
        raw-image route's of the same engine to the bit, N=1 and N=8."""
        phase_start()
        pre_expected = {{"stem": "stem_pre", "stem_bf16w": "stem_pre_bf16w"}.get(k, k): v
                        for k, v in expected.items()}
        t0 = time.perf_counter()
        xb = [engine.prepare_input(images[i]) for i in range(8)]
        prepare_ms = 1e3 * (time.perf_counter() - t0) / 8
        xb8 = engine.prepare_input(images)
        single, logits8, lat, batch_s, counts, shapes, replays = counted(
            engine, lambda: engine.serve_pre(xb[0]), lambda i: engine.serve_pre(xb[i]),
            lambda: engine.serve_pre(xb8))
        launches = check_launches(pre_expected, counts, shapes, phase)
        diffs = [float((single[i][0] - record["single"][i]).abs().max()) for i in range(8)]
        diff8 = float((logits8 - record["logits8"]).abs().max())
        check(all(torch.equal(single[i][0], record["single"][i]) for i in range(8))
              and torch.equal(logits8, record["logits8"]),
              f"{phase}: serve_pre logits differ from engine(x): N=1 {diffs}, N=8 {diff8}")
        print(json.dumps({
            "phase": phase, "n1_latency_ms_median": 1e3 * statistics.median(lat),
            "n1_latency_ms": [1e3 * v for v in lat],
            "n8_images_per_s": 8 / statistics.median(batch_s[1:]),
            "prepare_input_ms_per_image": prepare_ms,
            "n1_max_abs_diff_vs_raw": max(diffs), "n8_max_abs_diff_vs_raw": diff8,
            "launches": launches, "requests": requests, "replays": replays,
            "peak_mib": peak_mib(),
        }), flush=True)
        return served_record(phase, single, logits8, counts, shapes)

    def throughput_line(model, engine):
        stats = engine.throughput(8)
        print(json.dumps({"phase": "throughput", "model": model, "tier": engine.tier,
                          **stats}), flush=True)

    from torch.profiler import ProfilerActivity, profile

    def by_kernel(prof, reps=1):
        """A profile's device ms by kernel name, per rep, and its number of
        device kernels."""
        out, kernels = collections.defaultdict(float), 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0:
                out[_kernel_name(e.key)] += e.device_time_total / reps / 1e3
                kernels += e.count
        return out, kernels

    def profile_phase(engine, eager, phase):
        """torch.profiler over served requests (graph replays). Where the
        trace holds no kernel of a replay, the names and busy time come from
        eager forwards of the same tier, said so in the line."""
        for n, reps in ((1, 5), (8, 3)):
            engine(images[:n])
            sync()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    engine(images[:n])
                    sync()
                window_ms = 1e3 * (time.perf_counter() - t0) / reps
            source = "replays"

            by_name, _ = by_kernel(prof, reps)
            if not any(not k.startswith(("Memcpy", "Memset")) for k in by_name):
                source = "eager forwards (no kernel of a replay in the trace)"
                x = torch.as_tensor(images[:n], device=dev)
                with torch.inference_mode(), profile(
                        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(reps):
                        eager(x)
                        sync()
                by_name, _ = by_kernel(prof, reps)
            busy = sum(by_name.values())
            check(0 < busy <= window_ms, f"{phase} N={n}: device busy {busy} ms of {window_ms} ms")
            print(json.dumps({
                "phase": phase, "n": n, "device_busy_ms": busy, "request_ms": window_ms,
                "idle_share": 1 - busy / window_ms, "kernels_from": source,
                "device_ms_by_kernel": dict(sorted(by_name.items(), key=lambda kv: -kv[1])),
            }), flush=True)

    images32 = _rand(np.random.default_rng(2), 32, cfg.img, cfg.img, 3)

    def batch32_phase(model, engine, expected):
        """A counted run of N=32 requests from numpy images (phase batch32):
        counters zeroed; the first request must launch one forward's
        kernels CAPTURE_PASSES times, the three replays after it nothing;
        every row within the N=8 bar of that image's N=1 logits (1e-4; int8
        1e-3, each times max(1, max|N=1 row|)). The line gives the replayed
        N=32 latency, throughput(32) and the phase's peak device memory."""
        phase_start()
        replays0 = engine.replays
        _build.reset_counts()
        logits32 = engine(images32)
        sync()
        first = dict(_build.LAUNCHES)
        shapes = {name: collections.Counter(c) for name, c in _build.LAUNCH_SHAPES.items()}
        lat = []
        for _ in range(3):
            t0 = time.perf_counter()
            engine(images32)
            sync()
            lat.append(time.perf_counter() - t0)
        final = dict(_build.LAUNCHES)
        replays = engine.replays - replays0
        what = f"batch32 {model} {engine.tier}"
        want = {name: per * CAPTURE_PASSES for name, per in expected.items()}
        check(first == want and final == want,
              f"{what}: launches at the first N=32 request {first}, after its replays {final}, "
              f"want {want} then nothing")
        check(replays == 4, f"{what}: 4 requests served by {replays} graph replays")
        rows = torch.stack([engine(images32[i]) for i in range(32)])
        tol = INT8_CHAINED_RTOL if engine.tier == "int8" else ATOL
        row_err = ((logits32 - rows).abs().amax(dim=1)
                   / rows.abs().amax(dim=1).clamp(min=1.0)).max().item()
        finite = bool(torch.isfinite(logits32).all())
        check(finite and logits32.shape == rows.shape and row_err <= tol,
              f"{what}: N=32 rows vs each image's N=1 logits: {row_err} > {tol} (finite={finite})")
        stats = engine.throughput(32)
        print(json.dumps({
            "phase": "batch32", "model": model, "tier": engine.tier,
            "n32_latency_ms_median": 1e3 * statistics.median(lat),
            "n32_latency_ms": [1e3 * v for v in lat],
            "throughput_32_images_per_s": stats["images_per_sec"], "row_err": row_err,
            "row_tol": tol, "launches": final, "replays": replays, "peak_mib": peak_mib(),
        }), flush=True)
        return {"phase": "batch32", "launches": final, "shapes": shapes}

    def depth_phase(model, sd, tier, tol, ref, expected):
        """A deep classifier (phase depth) through engine_from_torch at one
        tier, counted: counters zeroed; the first N=1 request must launch
        ResNet-50's kernels of the tier (expected) CAPTURE_PASSES times, the
        n_single replays after it nothing; then two images' logits within
        tol of the module's own forward (ref). The line gives the replayed
        N=1 latency, throughput(8), the device busy time of an N=1 replay
        (torch.profiler over 5) and the phase's peak device memory."""
        phase_start()
        engine = engine_from_torch(sd, tier=tier, device=dev)
        replays0 = engine.replays
        _build.reset_counts()
        engine(images[0])
        sync()
        first = dict(_build.LAUNCHES)
        shapes = {name: collections.Counter(c) for name, c in _build.LAUNCH_SHAPES.items()}
        lat = []
        for i in range(n_single):
            t0 = time.perf_counter()
            engine(images[i % 8])
            sync()
            lat.append(time.perf_counter() - t0)
        final = dict(_build.LAUNCHES)
        replays = engine.replays - replays0
        what = f"depth {model} {tier}"
        want = {name: per * CAPTURE_PASSES for name, per in expected.items()}
        check(first == want and final == want,
              f"{what}: launches at the first N=1 request {first}, after its replays {final}, "
              f"want {want} then nothing")
        check(replays == 1 + n_single, f"{what}: {1 + n_single} requests served by {replays} "
              "graph replays")
        out = engine(images[:2]).double()
        err = (out - ref).abs().max().item()
        check(bool(torch.isfinite(out).all()) and err <= tol,
              f"{what}: {err} > {tol} against the module's own forward")
        stats = engine.throughput(8)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                engine(images[0])
                sync()
        by_name, _ = by_kernel(prof, 5)
        busy = sum(by_name.values())
        check(busy > 0, f"{what}: no kernel of an N=1 replay in the profiler's trace")
        print(json.dumps({
            "phase": "depth", "model": model, "tier": tier, "engine": type(engine).__name__,
            "launches_per_forward": {k: v // CAPTURE_PASSES for k, v in final.items()},
            "stage_blocks": sorted({shape[5] for name, c in shapes.items()
                                    if name.startswith("stage") for shape in c}),
            "max_abs_err": err, "tol": tol, "n1_latency_ms_median": 1e3 * statistics.median(lat),
            "throughput_8_images_per_s": stats["images_per_sec"], "n1_device_busy_ms": busy,
            "replays": replays, "peak_mib": peak_mib(),
        }), flush=True)
        return {"phase": "depth", "launches": final, "shapes": shapes}

    served = []  # each counted run's record (launches, first request's shapes, logits)
    golden = resnet50_forward(
        images[0], params_from_jax(init_resnet50_arrays(cfg, seed=0), "cpu", torch.float64),
        device="cpu",
    ).numpy()
    engine = ResNet50Engine(params, device=dev)
    eager = eager_forward(resnet50_forward, params)
    r50 = serve_f32("serving", engine, eager, EXPECTED_PER_FORWARD, golden)
    served.append(r50)
    served.append(serve_pre_phase("serving_pre", engine, EXPECTED_PER_FORWARD, r50))
    throughput_line("resnet50", engine)
    profile_phase(engine, eager, "profile")
    served.append(batch32_phase("resnet50", engine, EXPECTED_PER_FORWARD))
    del engine, eager

    # -- the bf16w tier -----------------------------------------------------
    engine16 = ResNet50Engine(params, tier="bf16w", device=dev)
    cpu_params = params_from_jax(init_resnet50_arrays(cfg, seed=0), "cpu", torch.float32)
    ref_bf16w = resnet50_forward(images[0], cast_bf16w(cpu_params), device="cpu",
                                 precision="bf16w")
    eager = eager_forward(resnet50_forward, cast_bf16w(params), precision="bf16w")
    rec = serve_bf16w("serving_bf16w", engine16, eager, EXPECTED_PER_FORWARD_BF16W, golden,
                      ref_bf16w, cfg)
    served.append(rec)
    served.append(serve_pre_phase("serving_pre_bf16w", engine16, EXPECTED_PER_FORWARD_BF16W, rec))
    throughput_line("resnet50", engine16)
    profile_phase(engine16, eager, "profile_bf16w")
    served.append(batch32_phase("resnet50", engine16, EXPECTED_PER_FORWARD_BF16W))
    del engine16, eager

    # -- the int8 tier ------------------------------------------------------
    engine8 = ResNet50Engine(params, tier="int8", device=dev)
    ref_int8 = resnet50_forward_int8(images[0], quantize_resnet50(cpu_params), device="cpu")
    eager = eager_forward(resnet50_forward_int8, quantize_resnet50(params))
    served.append(serve_int8("serving_int8", engine8, eager, EXPECTED_PER_FORWARD_INT8, golden,
                             ref_int8, cfg))
    throughput_line("resnet50", engine8)
    profile_phase(engine8, eager, "profile_int8")
    served.append(batch32_phase("resnet50", engine8, EXPECTED_PER_FORWARD_INT8))
    del engine8, eager, params, cpu_params

    # -- the basic family: ResNet-34 at every tier --------------------------
    cfg34 = ResNet34Config("resnet34")
    case34 = init_basicnet_arrays(cfg34, seed=0)
    golden34 = basicnet_forward(images[0], basicnet_params(case34, cfg34, "cpu", torch.float64),
                                device="cpu").numpy()
    params34 = basicnet_params(case34, cfg34, dev)
    engine, eager = ResNetBasicEngine(params34, device=dev), eager_forward(basicnet_forward, params34)
    r34 = serve_f32("serving_basic", engine, eager, EXPECTED_PER_FORWARD_BASIC, golden34)
    served.append(r34)
    served.append(serve_pre_phase("serving_pre_basic", engine, EXPECTED_PER_FORWARD_BASIC, r34))
    throughput_line("resnet34", engine)
    profile_phase(engine, eager, "profile_basic")
    served.append(batch32_phase("resnet34", engine, EXPECTED_PER_FORWARD_BASIC))
    del engine, eager, params34
    cpu34 = basicnet_params(case34, cfg34, "cpu")
    ref34_bf16w = basicnet_forward(images[0], cast_basicnet_bf16w(cpu34), device="cpu",
                                   precision="bf16w")
    engine16 = ResNetBasicEngine(cpu34, tier="bf16w", device=dev)
    eager = eager_forward(basicnet_forward, cast_basicnet_bf16w(cpu34), precision="bf16w")
    rec = serve_bf16w("serving_basic_bf16w", engine16, eager, EXPECTED_PER_FORWARD_BASIC_BF16W,
                      golden34, ref34_bf16w, cfg34)
    served.append(rec)
    served.append(serve_pre_phase("serving_pre_basic_bf16w", engine16,
                                  EXPECTED_PER_FORWARD_BASIC_BF16W, rec))
    throughput_line("resnet34", engine16)
    profile_phase(engine16, eager, "profile_basic_bf16w")
    served.append(batch32_phase("resnet34", engine16, EXPECTED_PER_FORWARD_BASIC_BF16W))
    del engine16, eager
    ref34_int8 = basicnet_forward_int8(images[0], quantize_basicnet(cpu34), device="cpu")
    engine8 = ResNetBasicEngine(cpu34, tier="int8", device=dev)
    eager = eager_forward(basicnet_forward_int8, quantize_basicnet(cpu34))
    served.append(serve_int8("serving_basic_int8", engine8, eager, EXPECTED_PER_FORWARD_BASIC_INT8,
                             golden34, ref34_int8, cfg34))
    throughput_line("resnet34", engine8)
    profile_phase(engine8, eager, "profile_basic_int8")
    served.append(batch32_phase("resnet34", engine8, EXPECTED_PER_FORWARD_BASIC_INT8))
    del engine8, eager, cpu34

    # -- torchvision-format weights: both families at every tier ------------
    phase_start()
    x2 = torch.as_tensor(images[:2], device=dev)
    for model_name, kw in (("resnet50", {}), ("resnet34", {"block": "basic"})):
        module = build_torch_reference_resnet(layers=(3, 4, 6, 3), stem_c=64,
                                              planes=(64, 128, 256, 512), classes=1000, seed=0,
                                              **kw)
        sd = module.state_dict()
        with torch.no_grad():
            ref = module.to(dev)(x2.permute(0, 3, 1, 2).contiguous()).double()
        del module
        scale = max(1.0, ref.abs().max().item())
        for tier, rtol in (("f32", ATOL), ("bf16w", BF16W_RTOL_BACKBONE),
                           ("int8", INT8_RTOL_BACKBONE)):
            imported = engine_from_torch(sd, tier=tier, device=dev)
            err = (imported(images[:2]).double() - ref).abs().max().item()
            check(err <= rtol * scale,
                  f"import_torch {model_name} {tier}: {err} > {rtol * scale} against the module")
            print(json.dumps({"phase": "import_torch", "model": model_name, "tier": tier,
                              "engine": type(imported).__name__, "max_abs_err": err,
                              "tol": rtol * scale, "ref_max_abs": scale,
                              "peak_mib": peak_mib()}), flush=True)
            del imported

    # -- depth: ResNet-101 and ResNet-152 from torchvision-format weights ---
    for model_name, layers in (("resnet101", (3, 4, 23, 3)), ("resnet152", (3, 8, 36, 3))):
        module = build_torch_reference_resnet(layers=layers, stem_c=64,
                                              planes=(64, 128, 256, 512), classes=1000, seed=0)
        sd = module.state_dict()
        with torch.no_grad():
            ref = module.to(dev)(x2.permute(0, 3, 1, 2).contiguous()).double()
        del module
        scale = max(1.0, ref.abs().max().item())
        for tier, rtol, expected in (("f32", ATOL, EXPECTED_PER_FORWARD),
                                     ("bf16w", BF16W_RTOL_BACKBONE, EXPECTED_PER_FORWARD_BF16W),
                                     ("int8", INT8_RTOL_BACKBONE, EXPECTED_PER_FORWARD_INT8)):
            served.append(depth_phase(model_name, sd, tier, rtol * scale, ref, expected))

    # -- a checkpoint of the trainable set, served --------------------------
    phase_start()
    trained = {
        "resnet50": (ResNet50Engine,
                     trainable_resnet50_params(init_resnet50_arrays(cfg, seed=0)), r50),
        "resnet34": (ResNetBasicEngine,
                     trainable_basicnet_params(basicnet_arrays(case34, cfg34)), r34),
    }
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        for model_name, (engine_cls, tree, record) in trained.items():
            path = str(pathlib.Path(tmp) / f"{model_name}.npz")
            t0 = time.perf_counter()
            save_model(path, tree, extra={"step": np.asarray(0)})
            loaded = engine_cls.from_checkpoint(path, device=dev)
            build_s = time.perf_counter() - t0
            want = record["single"][0]
            err = (loaded(images[0]) - want).abs().max().item()
            tol = ATOL * max(1.0, want.abs().max().item())
            check(err <= tol, f"checkpoint {model_name}: {err} > {tol} against the engine on the "
                  "full parameters")
            print(json.dumps({"phase": "checkpoint", "model": model_name, "max_abs_err": err,
                              "tol": tol, "save_and_load_s": build_s,
                              "file_mib": os.path.getsize(path) / 2**20,
                              "peak_mib": peak_mib()}), flush=True)
            del loaded
            # The checkpoint directory, written in the background from the
            # card's tensors, loaded back onto the card like the tree, served.
            directory = pathlib.Path(tmp) / f"{model_name}_dir"
            on_card = tree_map(lambda a: torch.as_tensor(a, device=dev), tree)
            t0 = time.perf_counter()
            handle = save_checkpoint_dir(directory, on_card, wait=False)
            handle.wait_until_finished()
            save_s = time.perf_counter() - t0
            back = load_checkpoint_dir(directory, like=on_card, device=dev)
            same = all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(on_card)))
            check(same, f"checkpoint_dir {model_name}: the tree read back differs")
            loaded = engine_cls.from_checkpoint(str(directory), device=dev)
            err_dir = (loaded(images[0]) - want).abs().max().item()
            check(err_dir <= tol, f"checkpoint_dir {model_name}: {err_dir} > {tol} against the "
                  "engine on the full parameters")
            print(json.dumps({"phase": "checkpoint_dir", "model": model_name,
                              "max_abs_err": err_dir, "tol": tol, "bit_equal": same,
                              "save_s": save_s, "files": len(os.listdir(directory)),
                              "peak_mib": peak_mib()}), flush=True)
            del loaded, back, on_card

    # -- training: one N=1 step of full-width ResNet-50 and ResNet-18 -------
    # Bench mode 19's and 25's configurations, seeded; the trainable sets
    # (raw filters, folded BN).
    cfg19, cfg25 = CASES[19], CASES[25]
    trainees = {
        "resnet50": (resnet50_forward_train, baseline.resnet50_forward_cudnn,
                     trainable_resnet50_params(init_resnet50_arrays(cfg19, seed=0))),
        "resnet18": (basicnet_forward_train, baseline.basicnet_forward_cudnn,
                     trainable_basicnet_params(basicnet_arrays(init_basicnet_arrays(cfg25, seed=0),
                                                               cfg25))),
    }

    def cpu_step(model):
        """The f32 step through the plain versions on the CPU in float64: the
        scalar and the gradient leaves."""
        forward, _, tree = trainees[model]
        t0 = time.perf_counter()
        scalar, grads = train_step(lambda x_, p: forward(x_, p, None, "cpu"),
                                   baseline.tensors(tree, "cpu", torch.float64))(
            torch.as_tensor(images[:1], dtype=torch.float64))
        return scalar.item(), grads, time.perf_counter() - t0

    def training_phase(model, precision, golden):
        """One N=1 train step on the card, counted (counters zeroed just
        before, the launches pinned to EXPECTED_TRAIN_STEP), held to the
        float64 CPU step; then its device time replayed from a CUDA graph
        and eager, the cuDNN autograd step's (at f32) and, for ResNet-50, the
        SGD step's (make_resnet50_train_step: forward, backward, update)."""
        phase = "training" if precision is None else "training_bf16w"
        forward, cudnn_forward, tree = trainees[model]
        phase_start()
        params = baseline.tensors(tree, dev)
        fwd = lambda x_, p: forward(x_, p, precision, dev)  # noqa: E731
        x1 = torch.as_tensor(images[:1], device=dev)
        _build.reset_counts()
        scalar, grads = train_step(fwd, params)(x1)
        sync()
        launches = dict(_build.LAUNCHES)
        shapes = {name: collections.Counter(c) for name, c in _build.LAUNCH_SHAPES.items()}
        expected = EXPECTED_TRAIN_STEP[(model, precision)]
        check(launches == expected, f"{phase} {model}: launches {launches}, want {expected}")
        g_scalar, g_grads, golden_s = golden
        scalar = scalar.item()
        rel = abs(scalar - g_scalar) / max(abs(g_scalar), 1.0)
        bar = TRAIN_RTOL if precision is None else BF16W_TRAIN_GRAD_RTOL
        check(bool(np.isfinite(scalar)) and rel < bar,
              f"{phase} {model}: step scalar {scalar} vs float64 {g_scalar}: {rel} >= {bar}")
        leaf_err = [(g.cpu().double() - r).abs().max().item() / max(1.0, r.abs().max().item())
                    for g, r in zip(grads, g_grads)]
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        check(len(grads) == len(g_grads) and finite, f"{phase} {model}: gradient leaves")
        if precision is None:
            check(max(leaf_err) <= TRAIN_RTOL,
                  f"{phase} {model}: worst gradient leaf {max(leaf_err)} > {TRAIN_RTOL}")
        step = train_step_scalar(fwd, params)
        line = {"phase": phase, "model": model, "step_scalar": scalar,
                "golden_step_scalar": g_scalar, "scalar_rel_err": rel, "scalar_bar": bar,
                "worst_leaf_err": max(leaf_err), "leaves": len(grads),
                "leaf_bar": TRAIN_RTOL if precision is None else None,
                "golden_cpu_s": golden_s, "launches": launches,
                "step_replayed_ms": device_ms(lambda: step(x1)),
                "step_eager_ms": wrapper_ms(lambda: step(x1), reps=10)}
        if precision is None:
            cudnn_step = train_step_scalar(cudnn_forward, params)
            line["cudnn_step_replayed_ms"] = device_ms(lambda: cudnn_step(x1))
            line["cudnn_step_eager_ms"] = wrapper_ms(lambda: cudnn_step(x1), reps=10)
        if model == "resnet50":
            sgd = make_resnet50_train_step(lr=1e-2, precision=precision)
            trained_p = baseline.tensors(tree, dev)
            mom = tree_map(torch.zeros_like, trained_p)
            labels = torch.zeros(1, dtype=torch.long, device=dev)
            _, _, loss = sgd(trained_p, mom, x1, labels)
            with torch.no_grad():
                ref_logits = cudnn_forward(x1, params)
                want = torch.nn.functional.cross_entropy(ref_logits, labels)
            # A cross-entropy moves at most twice as far as the logits do.
            loss_err = abs(loss.item() - want.item())
            loss_tol = (2 * (ATOL if precision is None else BF16W_RTOL_BACKBONE)
                        * max(1.0, ref_logits.abs().max().item()))
            check(loss_err <= loss_tol, f"{phase} {model}: SGD step loss {loss.item()} vs the "
                  f"cuDNN forward's cross-entropy {want.item()}")
            line.update(sgd_loss=loss.item(), sgd_loss_err=loss_err, sgd_loss_tol=loss_tol,
                        sgd_step_replayed_ms=device_ms(lambda: sgd(trained_p, mom, x1, labels)[2]),
                        sgd_step_eager_ms=wrapper_ms(lambda: sgd(trained_p, mom, x1, labels),
                                                     reps=10))
        line["peak_mib"] = peak_mib()
        # Where an eager step's device time goes, by kernel name.
        step(x1)
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(x1)
            sync()
        by_name, kernels = by_kernel(prof)
        line.update(eager_device_busy_ms=sum(by_name.values()), eager_device_kernels=kernels,
                    device_ms_by_kernel=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12]))
        print(json.dumps(line), flush=True)
        return {"phase": phase, "launches": launches, "shapes": shapes, "per_step": True}

    for model in trainees:
        golden = cpu_step(model)
        for precision in (None, "bf16w"):
            served.append(training_phase(model, precision, golden))
        del golden

    # -- kernels against their plain versions ------------------------------
    make_case = {"pointwise": pointwise_case, "winograd": winograd_case,
                 "direct": direct_case, "stem": stem_case, "stage": stage_case,
                 "transition": transition_case, "pointwise_int8": pointwise_int8_case,
                 "direct_int8": direct_int8_case, "stage_int8": stage_int8_case,
                 "transition_int8": transition_int8_case, "winograd_int8": winograd_int8_case,
                 "basic_stage": basic_stage_case, "basic_stage_int8": basic_stage_int8_case,
                 "pointwise_bf16w": pointwise_bf16w_case, "stem_bf16w": stem_case,
                 "stage_bf16w": lambda rng, *shape: stage_case(rng, *shape, bf16=True),
                 "transition_bf16w": lambda rng, *shape: transition_case(rng, *shape, bf16=True),
                 "winograd_bf16w": lambda rng, *shape: winograd_case(rng, *shape, filt="bf16w"),
                 "direct_bf16w": lambda rng, *shape: direct_case(rng, *shape, bf16=True),
                 "basic_stage_bf16w": lambda rng, *shape: basic_stage_case(rng, *shape, bf16=True),
                 "stem_pre": stem_pre_case, "stem_pre_bf16w": stem_pre_case}
    # Off the served N=1 lists: F(4,3) accuracy at the mode-0 shape; the
    # block at modes 6 and 9; the batched layouts' cases (rows 7, 9, 18 and
    # 20 of the TPU kernel table) at N=8; the conv5_x stage geometry, which
    # the f32 route runs per layer; the int8 block (row 16) at mode 6; the
    # f32 and int8 direct 3x3s at N=8; the stem at N=8 in every precision;
    # the bf16w pointwise head, conv4_x and conv5_x stages and 14->7
    # transition at N=8, the bf16w block at modes 6 and 9; the bf16w
    # Winograd, direct 3x3 and basic stage of ResNet-34 at N=8.
    extra = {
        "winograd": [(1, 14, 14, 128, 128, 4, True)],
        "stage": [(1, 14, 14, 1024, 256, 1, "direct"), (1, 28, 28, 512, 128, 1, "winograd2"),
                  (8, 14, 14, 1024, 256, 5, "direct"), (1, 7, 7, 2048, 512, 2, "direct")],
        "transition": [(8, 14, 14, 1024, 512, 2048)],
        "stage_int8": [(8, 14, 14, 1024, 256, 5, "direct"), (1, 14, 14, 1024, 256, 1, "direct")],
        "transition_int8": [(8, 14, 14, 1024, 512, 2048)],
        "stem": [(8, 224, 224, 3, 64, "f32"), (8, 224, 224, 3, 64, "bf16")],
        "basic_stage": [(8, 7, 7, 512, 2), (1, 7, 7, 512, 1)],
        "basic_stage_int8": [(8, 7, 7, 512, 2), (1, 7, 7, 512, 1)],
        "winograd_int8": [(8, 14, 14, 256, 256, True), (8, 28, 28, 128, 128, True),
                          *WIDE_WINOGRAD_INT8],
        "pointwise": [(8, 2048, 1000, False), (392, 2048, 512, True)],
        "pointwise_int8": [(8, 2048, 1000, False)],
        "direct_int8": [(8, 7, 7, 512, 512, False)],
        "direct": [(8, 7, 7, 512, 512, True)],
        "pointwise_bf16w": [(8, 2048, 1000, False)],
        "stem_bf16w": [(8, 224, 224, 3, 64, "bf16w")],
        "stage_bf16w": [(8, 14, 14, 1024, 256, 5, "direct"), (8, 7, 7, 2048, 512, 2, "direct"),
                        (1, 14, 14, 1024, 256, 1, "direct"), (1, 28, 28, 512, 128, 1, "winograd2")],
        "transition_bf16w": [(8, 14, 14, 1024, 512, 2048)],
        "winograd_bf16w": [(8, 56, 56, 64, 64, 2, True)],
        "direct_bf16w": [(8, 7, 7, 512, 512, False)],
        "basic_stage_bf16w": [(8, 7, 7, 512, 2)],
        "stem_pre": [(8, 224, 224, 3, 64, "f32")],
        "stem_pre_bf16w": [(8, 224, 224, 3, 64, "bf16w")],
    }
    sms = _build.sm_count(dev)

    def winograd_cut(n, h, w, cin, cout, m, relu, filt="f32"):
        """The f32 route's Cin splits."""
        if filt == "bf16":
            return None
        return winograd_plan(n, h, w, cin, cout, m, sms).splits

    splits_of = {
        "pointwise": lambda p, k, n, relu: split_plan(p, k, n, sms).splits,
        "direct": lambda n, h, w, cin, cout, relu: direct_plan(n, h, w, cin, cout, sms).splits,
        "direct_int8": lambda n, h, w, cin, cout, relu: q8.direct_int8_plan(
            n, h, w, cin, cout, sms).splits,
        "winograd": winograd_cut,
        "pointwise_int8": lambda p, k, n, relu: q8.pointwise_int8_plan(p, k, n, sms).splits,
        "transition": lambda *shape: [s.splits for s in transition_plan(*shape, sms)[1:]],
        "basic_stage_int8": lambda n, h, w, c, nb: bs.basic_stage_int8_plan(
            n, h, w, c, sms).splits,
        "basic_stage": lambda n, h, w, c, nb: bs.basic_stage_plan(n, h, w, c, sms).conv.splits,
    }
    for name in ("pointwise", "transition", "winograd", "direct", "basic_stage"):
        splits_of[f"{name}_bf16w"] = splits_of[name]

    def winograd_int8_cut(n, h, w, cin, cout, relu):
        plan = q8.winograd_int8_plan(n, h, w, cin, cout, sms)
        return {"tile_blocks": plan.tile_blocks, "col_blocks": plan.col_blocks,
                "blocks": plan.blocks, "chunk": plan.chunk}

    plans_of = {
        "pointwise_int8": lambda p, k, n, relu: {
            "route": q8.pointwise_int8_plan(p, k, n, sms).path},
        "winograd_int8": winograd_int8_cut,
    }
    # Launches: the wrappers' (the warm-up and capture passes of each shape)
    # in every counted run. A prepared-input run adds its stem's shapes to
    # the per-image sums, its other kernels being the raw route's.
    all_launches = collections.Counter()
    per_image = collections.defaultdict(collections.Counter)
    for rec in served:
        all_launches.update(rec["launches"])
        pre = rec["phase"].startswith("serving_pre")
        passes = 1 if rec.get("per_step") else CAPTURE_PASSES
        for name, counter in rec["shapes"].items():
            if pre and not name.startswith("stem_pre"):
                continue
            per_image[name].update({shape: c // passes for shape, c in counter.items()})
    totals = {}
    rng = np.random.default_rng(0)
    for name in make_case:
        counter = per_image.get(name, collections.Counter())
        tot = collections.defaultdict(float)
        tot["max_abs_err"] = 0.0
        lib_ok = True
        for shape in dict.fromkeys(list(counter) + extra.get(name, [])):
            n_img = counter.get(shape, 0)
            kern, plain, lib, work, nbytes = make_case[name](rng, *shape)
            exact = name in EXACT or name in ("stem", "winograd") and shape[-1] == "bf16"
            rtol = 0.0 if exact else ATOL
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            finite = bool(torch.isfinite(got).all())
            tol = rtol * max(1.0, ref.abs().max().item())
            check(finite and err <= tol, f"{name}{shape}: max abs err {err} > {tol} (finite={finite})")
            try:
                lib()
                torch.cuda.synchronize()
                lib_ms = device_ms(lib)
            except RuntimeError as e:   # a library call that refuses these operands
                print(json.dumps({"kernel": name, "shape": shape, "library_error": str(e)[:300]}))
                lib_ms, lib_ok = None, False
            ms, plain_ms = device_ms(kern), device_ms(plain)
            host_ms = wrapper_ms(kern)
            ops_ms, bytes_ms = bound(work, nbytes)
            splits = {"splits": splits_of[name](*shape)} if name in splits_of else {}
            if name in plans_of:
                splits.update(plans_of[name](*shape))
            print(json.dumps({
                "kernel": name, "shape": shape, "per_image": n_img, **splits,
                "max_abs_err": err, "tol": tol, "ms": ms, "wrapper_ms": host_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "gops_s": sum(work.values()) / ms / 1e6,
            }), flush=True)
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            for key, v in (("ms", ms), ("wrapper_ms", host_ms), ("plain_ms", plain_ms),
                           ("library_ms", lib_ms or 0.0), ("ops_ms", ops_ms),
                           ("bytes_ms", bytes_ms), ("bound_ms", max(ops_ms, bytes_ms))):
                tot[key] += n_img * v
        tot["library_ok"] = lib_ok
        totals[name] = tot

    # -- the benchmark CLI's modes on the card -------------------------------
    for mode in BENCH_MODES:
        _build.reset_counts()
        try:
            row = run_case(mode)
        except (ParityError, RuntimeError) as e:
            check(False, f"bench mode {mode}: {type(e).__name__}: {e}")
            continue
        launches = dict(_build.LAUNCHES)
        has = {"cuda": True, "cudnn": True, "int8": mode not in TRAIN_MODES, "bf16w": True,
               "direct": row["max_error_direct"] is not None,
               "winograd_f43": row["max_error_winograd_f43"] is not None,
               "pre": mode in PRE_MODES}
        untimed = [p for p, on in has.items() if on and row[f"{p}_device_us"] is None]
        check(row["parity_ok"] and not row["tf32"] and not untimed,
              f"bench mode {mode}: parity_ok {row['parity_ok']}, tf32 {row['tf32']}, "
              f"paths with no device time {untimed}")
        print(json.dumps({"phase": "bench", **{
            k: v for k, v in row.items()
            if k in ("mode", "name", "parity_ok", "tf32") or k.endswith(
                ("_device_us", "_mean_us", "_chained_us", "_rel_error"))
            or k.startswith("max_error_")}, "launches": launches}), flush=True)

    # -- parallel: every partition in one world of four ranks on the card ---
    from torch.multiprocessing import ProcessRaisedException

    from winograd_tpu_torch.parallel import spawn_world

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        ranks = spawn_world(_parallel_rank, PARALLEL_RANKS, (images[:4],),
                            timeout=PARALLEL_TIMEOUT_S)
    except ProcessRaisedException as e:
        check(False, f"parallel: a rank failed: {e}")
        ranks = []
    for r in ranks:
        for what in r["failures"]:
            check(False, what)
    per_rank_keys = ("eager_ms", "launches", "peak_device_mib", "weights_mib")
    for lines in zip(*(r["lines"] for r in ranks)):
        for line in lines:
            all_launches.update(line["launches"])
        print(json.dumps({
            "phase": "parallel", "ranks": len(lines), "backend": "gloo",
            "mesh": PARALLEL_MESHES[lines[0]["partition"]],
            **{k: v for k, v in lines[0].items() if k not in per_rank_keys},
            **{f"{k}_by_rank": [line[k] for line in lines] for k in per_rank_keys}}), flush=True)
    for line in ranks[0]["nccl"] if ranks else []:
        print(json.dumps({"phase": "parallel", "ranks": 1, "backend": "nccl", "mesh": [1],
                          **line}), flush=True)
    if ranks:
        for r in ranks:
            all_launches.update(r["train"]["launches"])
        print(json.dumps({"phase": "parallel_train", "model": "resnet50", "ranks": len(ranks),
                          "mesh": PARALLEL_MESHES["data"], "n": 4, **ranks[0]["train"],
                          "step_ms_by_rank": [r["train"]["step_ms"] for r in ranks],
                          "first_step_ms_by_rank": [r["train"]["first_step_ms"] for r in ranks],
                          "peak_device_mib_by_rank": [r["train"]["peak_device_mib"]
                                                      for r in ranks]}), flush=True)
    if ranks:
        print(json.dumps({"phase": "parallel_block_train", "ranks": len(ranks),
                          "mesh": PARALLEL_MESHES["model"], "n": 4, "hw": 14,
                          "c_io": BLOCK_TRAIN_CIO, "c_mid": BLOCK_TRAIN_CMID,
                          **ranks[0]["block_train"],
                          "step_ms_by_rank": [r["block_train"]["step_ms"] for r in ranks],
                          "mib_held_by_rank": [r["block_train"]["mib_held"] for r in ranks]}),
              flush=True)
    print(json.dumps({"phase": "parallel_world", "seconds": time.perf_counter() - t0}),
          flush=True)

    kernels = []
    for name, tot in totals.items():
        replaces, covers = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "winograd_tpu_torch/csrc/"
                      f"{SOURCE_FILES.get(name, name).removesuffix('_bf16w')}.cu",
            "replaces": replaces, "covers": covers, "launches": all_launches.get(name, 0),
            "max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
            "wrapper_ms": tot["wrapper_ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes",
            "library_ms": tot["library_ms"] if tot["library_ok"] else None,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
