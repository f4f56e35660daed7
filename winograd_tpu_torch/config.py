"""Static configuration registry: the benchmark cases, their FLOP counts,
the benchmark protocol and the accuracy bars.

A copy of winograd_tpu/config.py, kept here so that the port imports nothing
from the JAX package. Mode numbers are the JAX package's (and, for modes
0-5, the reference CLI's):
    0: 3x3 Winograd 128->128 + BN + ReLU
    1: 3x3 Winograd 256->256 + BN + ReLU
    2: 1x1 512->128  + BN + ReLU   (bottleneck "in")
    3: 1x1 128->512  + BN          (bottleneck "out", no ReLU)
    4: 1x1 1024->256 + BN + ReLU
    5: 1x1 256->1024 + BN          (no ReLU)
    6: full residual bottleneck block 1024->256->256->1024 + skip (N=1)
    7: the same block at N=8
    8: ResNet-50 conv4_x stage (6 blocks)
    9/10: conv3_x / conv5_x block geometries (28x28 and 7x7)
    11/12: stride-2 stage transitions
    13: the 13-block conv3_x->conv4_x->conv5_x backbone
    14: the same backbone at N=8
    15: the complete 16-block ResNet-50 residual trunk (conv2_x..conv5_x)
    16: the complete ResNet-50 classifier (224x224x3 image -> 1000 logits)
    17: one training step through the 13-block backbone
    18: the complete classifier at N=8
    19: one training step through the complete classifier
    20/21: ResNet-101 / ResNet-152
    22: the classifier stem alone (7x7/2 conv + BN + ReLU + 3x3/2 maxpool)
    23/24: ResNet-18 / ResNet-34, the basic-block family
    25: one ResNet-18 training step
    26: ResNet-18 at N=8
    27/28: ResNet-50 / ResNet-18 at N=32
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class LayerConfig:
    """One fused conv+BN(+ReLU) layer case."""

    name: str
    kind: str  # "winograd3x3" | "pointwise"
    cin: int
    cout: int
    hw: int = 14  # square feature map side
    relu: bool = True
    # Winograd tile algebra F(m x m, r x r); fixed at F(4,3) like the reference.
    tile_m: int = 4
    tile_r: int = 3

    @property
    def tiles_per_side(self) -> int:
        return -(-self.hw // self.tile_m)  # cdiv

    @property
    def num_tiles(self) -> int:
        return self.tiles_per_side ** 2

    @property
    def alpha(self) -> int:
        """Winograd input-tile side (m + r - 1 = 6 for F(4,3))."""
        return self.tile_m + self.tile_r - 1


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """ResNet bottleneck block(s): 1x1 reduce -> 3x3 -> 1x1 expand + skip.
    blocks > 1 chains that many bottlenecks (6 is ResNet-50's conv4_x)."""

    name: str
    c_io: int = 1024
    c_mid: int = 256
    hw: int = 14
    batch: int = 1
    blocks: int = 1


@dataclasses.dataclass(frozen=True)
class TransitionConfig:
    """Stride-2 downsample (stage-transition) bottleneck block: 1x1 reduce
    -> stride-2 3x3 -> 1x1 expand, with a stride-2 1x1 projection shortcut
    (ResNet v1.5). hw is the input side; the output is ceil(hw/2)."""

    name: str
    c_in: int
    c_mid: int
    c_out: int
    hw: int
    batch: int = 1


CASES: Dict[int, object] = {
    0: LayerConfig("winograd3x3_128", "winograd3x3", 128, 128, relu=True),
    1: LayerConfig("winograd3x3_256", "winograd3x3", 256, 256, relu=True),
    2: LayerConfig("pointwise_512_128", "pointwise", 512, 128, relu=True),
    3: LayerConfig("pointwise_128_512", "pointwise", 128, 512, relu=False),
    4: LayerConfig("pointwise_1024_256", "pointwise", 1024, 256, relu=True),
    5: LayerConfig("pointwise_256_1024", "pointwise", 256, 1024, relu=False),
    6: BlockConfig("bottleneck_block", batch=1),
    7: BlockConfig("bottleneck_block_batched", batch=8),
    8: BlockConfig("resnet50_conv4x_stage", batch=1, blocks=6),
    9: BlockConfig("resnet50_conv3x_block", c_io=512, c_mid=128, hw=28),
    10: BlockConfig("resnet50_conv5x_block", c_io=2048, c_mid=512, hw=7),
    11: TransitionConfig("transition_conv3_to_4", 512, 256, 1024, hw=28),
    12: TransitionConfig("transition_conv4_to_5", 1024, 512, 2048, hw=14),
}


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """ResNet-50 conv3_x -> conv4_x -> conv5_x backbone: 13 bottleneck
    blocks across three resolutions (28 -> 14 -> 7) with two stride-2
    transitions. Stage tuples are (c_io, c_mid, hw, identity_blocks)."""

    name: str
    stages = (
        (512, 128, 28, 4),
        (1024, 256, 14, 5),
        (2048, 512, 7, 2),
    )
    batch: int = 1


CASES[13] = BackboneConfig("resnet50_backbone_13")
CASES[14] = BackboneConfig("resnet50_backbone_13_b8", batch=8)


@dataclasses.dataclass(frozen=True)
class FullTrunkConfig(BackboneConfig):
    """The complete ResNet-50 residual trunk: conv2_x at 56x56 through
    conv5_x at 7x7, 16 bottleneck blocks with three stride-2 transitions."""

    stages = (
        (256, 64, 56, 3),
        (512, 128, 28, 3),
        (1024, 256, 14, 5),
        (2048, 512, 7, 2),
    )


CASES[15] = FullTrunkConfig("resnet50_trunk_16")


@dataclasses.dataclass(frozen=True)
class ResNet50Config(BackboneConfig):
    """The complete ResNet-50 image classifier: the stem (7x7/2 conv + BN +
    ReLU + 3x3/2 maxpool, 224x224x3 -> 56x56x64), conv2_x's stride-1
    projection entry block, the 16-block residual trunk, and the head
    (global avgpool + FC to num_classes logits).

    Stage tuples are (c_io, c_mid, hw, identity blocks after the stage's
    entry block); stage 0 enters through the projection block, later stages
    through a stride-2 transition. The name defaults to mode 16's."""

    name: str = "resnet50_full"
    stages = (
        (256, 64, 56, 2),
        (512, 128, 28, 3),
        (1024, 256, 14, 5),
        (2048, 512, 7, 2),
    )
    img: int = 224
    stem_c: int = 64
    num_classes: int = 1000


CASES[16] = ResNet50Config("resnet50_full")


@dataclasses.dataclass(frozen=True)
class TrainConfig(BackboneConfig):
    """One fwd+bwd training step over the 13-block backbone."""


CASES[17] = TrainConfig("resnet50_backbone_13_trainstep")
CASES[18] = ResNet50Config("resnet50_full_b8", batch=8)


@dataclasses.dataclass(frozen=True)
class FullTrainConfig(ResNet50Config):
    """One fwd+bwd training step over the complete classifier."""


CASES[19] = FullTrainConfig("resnet50_full_trainstep")


@dataclasses.dataclass(frozen=True)
class ResNet101Config(ResNet50Config):
    """The complete ResNet-101 classifier: ResNet-50's stage geometries at
    conv3_x 4 blocks, conv4_x 23. Its case is made in memory, not written
    to disk (on_disk)."""

    stages = (
        (256, 64, 56, 2),
        (512, 128, 28, 3),
        (1024, 256, 14, 22),
        (2048, 512, 7, 2),
    )
    on_disk = False


@dataclasses.dataclass(frozen=True)
class ResNet152Config(ResNet101Config):
    """The complete ResNet-152 classifier (conv3_x 8 blocks, conv4_x 36)."""

    stages = (
        (256, 64, 56, 2),
        (512, 128, 28, 7),
        (1024, 256, 14, 35),
        (2048, 512, 7, 2),
    )


CASES[20] = ResNet101Config("resnet101_full")
CASES[21] = ResNet152Config("resnet152_full")


@dataclasses.dataclass(frozen=True)
class StemConfig:
    """The classifier stem alone: 7x7/2 conv + BN + ReLU + 3x3/2 maxpool.
    Its case is made in memory (on_disk=False)."""

    name: str
    img: int = 224
    cin: int = 3
    cout: int = 64
    batch: int = 1
    on_disk: bool = False


CASES[22] = StemConfig("resnet50_stem")


@dataclasses.dataclass(frozen=True)
class BasicNetConfig:
    """The complete ResNet-18 classifier, the basic-block family (two 3x3
    convs per block; torchvision BasicBlock semantics). Stage tuples are
    (channels, hw, blocks); stage 0's blocks are all identity (the stem
    already outputs its width), later stages enter with a stride-2
    downsample block (stride-2 3x3 + 3x3, stride-2 1x1 projection skip)
    counted in `blocks`. Its case is made in memory (on_disk)."""

    name: str
    stages = (
        (64, 56, 2),
        (128, 28, 2),
        (256, 14, 2),
        (512, 7, 2),
    )
    img: int = 224
    stem_c: int = 64
    num_classes: int = 1000
    batch: int = 1
    on_disk = False


@dataclasses.dataclass(frozen=True)
class ResNet34Config(BasicNetConfig):
    """The complete ResNet-34 classifier: the deeper basic-block depths
    (3/4/6/3), same stage geometries and kernels as ResNet-18."""

    stages = (
        (64, 56, 3),
        (128, 28, 4),
        (256, 14, 6),
        (512, 7, 3),
    )


@dataclasses.dataclass(frozen=True)
class BasicTrainConfig(BasicNetConfig):
    """One fwd+bwd ResNet-18 training step."""


@dataclasses.dataclass(frozen=True)
class BasicNetB8Config(BasicNetConfig):
    """The complete ResNet-18 classifier at N=8."""

    batch: int = 8


@dataclasses.dataclass(frozen=True)
class ResNet50B32Config(ResNet50Config):
    """The complete ResNet-50 classifier at N=32 (made in memory)."""

    batch: int = 32
    on_disk = False


@dataclasses.dataclass(frozen=True)
class BasicNetB32Config(BasicNetConfig):
    """The complete ResNet-18 classifier at N=32."""

    batch: int = 32


CASES[23] = BasicNetConfig("resnet18_full")
CASES[24] = ResNet34Config("resnet34_full")
CASES[25] = BasicTrainConfig("resnet18_trainstep")
CASES[26] = BasicNetB8Config("resnet18_full_b8")
CASES[27] = ResNet50B32Config("resnet50_full_b32")
CASES[28] = BasicNetB32Config("resnet18_full_b32")


def stem_entry_flops(img: int, stem_c: int, c_mid0: int, c_io0: int) -> int:
    """Nominal FLOPs of the stem 7x7/2 conv + conv2_x's stride-1 projection
    entry block (reduce, 3x3, expand, projection shortcut) at batch 1."""
    hs = img // 2
    hw0 = img // 4
    return 2 * hs * hs * 49 * 3 * stem_c + 2 * hw0 * hw0 * (
        stem_c * c_mid0 + 9 * c_mid0 * c_mid0
        + c_mid0 * c_io0 + stem_c * c_io0
    )


def case_flops(cfg) -> int:
    """Nominal conv FLOPs of a case (2 * the MACs of the mathematical
    convolution, whatever algorithm computes it)."""
    if isinstance(cfg, BackboneConfig):
        total = 0
        prev = None
        for c_io, c_mid, hw, blocks in cfg.stages:
            if prev is not None:
                total += case_flops(
                    TransitionConfig("t", prev, c_mid, c_io, hw=2 * hw, batch=cfg.batch)
                )
            total += case_flops(
                BlockConfig("b", c_io=c_io, c_mid=c_mid, hw=hw,
                            batch=cfg.batch, blocks=blocks)
            )
            prev = c_io
        if isinstance(cfg, ResNet50Config):
            c_io0, c_mid0, hw0, _ = cfg.stages[0]
            total += cfg.batch * stem_entry_flops(
                cfg.img, cfg.stem_c, c_mid0, c_io0
            )
            total += 2 * cfg.batch * cfg.stages[-1][0] * cfg.num_classes
        if isinstance(cfg, (TrainConfig, FullTrainConfig)):
            total *= 3  # fwd + bwd ~ 3x forward FLOPs (standard estimate)
        return total
    if isinstance(cfg, BasicNetConfig):
        hs = cfg.img // 2
        total = 2 * hs * hs * 49 * 3 * cfg.stem_c  # stem 7x7/2 conv
        prev = cfg.stem_c
        for c, hw, blocks in cfg.stages:
            if prev != c:  # stride-2 entry block (3x3/2 + 3x3 + 1x1 proj)
                total += 2 * hw * hw * (9 * prev * c + 9 * c * c + prev * c)
                blocks -= 1
            total += blocks * 2 * hw * hw * 2 * 9 * c * c
            prev = c
        total += 2 * cfg.stages[-1][0] * cfg.num_classes  # head FC
        if isinstance(cfg, BasicTrainConfig):
            total *= 3  # fwd + bwd ~ 3x forward FLOPs (standard estimate)
        return cfg.batch * total
    if isinstance(cfg, StemConfig):
        hs = -(-cfg.img // 2)
        return 2 * cfg.batch * hs * hs * 49 * cfg.cin * cfg.cout
    if isinstance(cfg, TransitionConfig):
        ho = -(-cfg.hw // 2)
        return 2 * cfg.batch * (
            cfg.hw * cfg.hw * cfg.c_in * cfg.c_mid
            + ho * ho * (9 * cfg.c_mid * cfg.c_mid
                         + cfg.c_mid * cfg.c_out + cfg.c_in * cfg.c_out)
        )
    if isinstance(cfg, BlockConfig):
        return (
            2 * cfg.batch * cfg.blocks * cfg.hw * cfg.hw
            * (cfg.c_io * cfg.c_mid + 9 * cfg.c_mid * cfg.c_mid
               + cfg.c_mid * cfg.c_io)
        )
    k = 9 if cfg.kind == "winograd3x3" else 1
    return 2 * cfg.hw * cfg.hw * k * cfg.cin * cfg.cout


# NVIDIA H100 SXM dense BF16 tensor-core peak (data sheet, at 700 W): the
# denominator of the benchmark's model FLOPs utilization.
H100_PEAK_FLOPS = 989e12


def case_config(mode: int):
    if mode not in CASES:
        raise ValueError(f"unknown mode {mode}; valid modes: {sorted(CASES)}")
    return CASES[mode]


# Benchmark protocol (the reference's: 100 iterations, the first 2
# discarded as warmup, the mean of the rest).
BENCH_ITERATIONS = 100
BENCH_WARMUP = 2

# The serving tiers: f32, bf16 weight storage (bf16w), int8 weights.
TIERS = ("f32", "bf16w", "int8")

# f32 correctness bar: max abs error <= 1e-4 against the float64 golden,
# with no allowance for a fraction of elements.
PARITY_ATOL = 1e-4
BN_EPS = 1e-5

# Reduced-precision serving-tier bars: max abs error <= rtol * max(1,
# max|golden|) against the f32 model's float64 golden. The bf16w tier
# (bf16 weight storage, the f32 activation split hi/lo) is set by the
# offline bf16 rounding of the weights (~2^-9 relative), the int8 tier by
# 8-bit quantization; the *_BACKBONE bars hold for whole backbones and
# classifiers, whose layers compound the error.
BF16W_RTOL = 5e-3
BF16W_RTOL_BACKBONE = 5e-3
INT8_RTOL = 5e-2
INT8_RTOL_BACKBONE = 5e-2

# The bf16w training tier (f32 master weights, the bf16w kernels as the
# forward, an f32 backward): the bound on its train-step scalar (loss +
# every grad leaf's squared norm) against the f32 step's, relative. The
# forward's bf16 weight rounding (~2^-9) reaches the loss and every
# gradient, so the bound keeps a margin over the f32 step's 1e-3, scaled by
# the forward tier's error (the JAX package's constant).
BF16W_TRAIN_GRAD_RTOL = 2e-2
