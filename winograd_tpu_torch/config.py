"""Static configuration of the port's served model and its accuracy bar.

A copy of the parts of winograd_tpu/config.py that the served paths need
(ResNet50Config, BasicNetConfig, ResNet34Config, PARITY_ATOL,
BF16W_RTOL, BF16W_RTOL_BACKBONE, INT8_RTOL_BACKBONE, BN_EPS), kept here so the port imports nothing from the
JAX package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ResNet50Config:
    """The complete ResNet-50 image classifier: the stem (7x7/2 conv + BN +
    ReLU + 3x3/2 maxpool, 224x224x3 -> 56x56x64), conv2_x's stride-1
    projection entry block, the 16-block residual trunk, and the head
    (global avgpool + FC to num_classes logits).

    Stage tuples are (c_io, c_mid, hw, identity blocks after the stage's
    entry block); stage 0 enters through the projection block, later stages
    through a stride-2 transition."""

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
    batch: int = 1


@dataclasses.dataclass(frozen=True)
class BasicNetConfig:
    """The complete ResNet-18 classifier, the basic-block family (two 3x3
    convs per block; torchvision BasicBlock semantics). Stage tuples are
    (channels, hw, blocks); stage 0's blocks are all identity (the stem
    already outputs its width), later stages enter with a stride-2
    downsample block (stride-2 3x3 + 3x3, stride-2 1x1 projection skip)
    counted in `blocks`."""

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


# f32 correctness bar: max abs error <= 1e-4 against the float64 golden.
PARITY_ATOL = 1e-4
# bf16w serving tier bars (bf16 weight storage, the f32 activation split
# hi/lo): max abs error <= 5e-3 * max(1, max|golden|) against the f32
# model's float64 golden, for one layer (BF16W_RTOL) and for whole
# backbones and the classifier (BF16W_RTOL_BACKBONE); the offline bf16
# rounding of the weights (~2^-9 relative) sets the error.
BF16W_RTOL = 5e-3
BF16W_RTOL_BACKBONE = 5e-3
# int8 serving tier bar for whole backbones and the classifier: max abs
# error <= 5e-2 * max(1, max|golden|) against the f32 model's float64
# golden (8-bit quantization, compounded over the layers).
INT8_RTOL_BACKBONE = 5e-2
BN_EPS = 1e-5
