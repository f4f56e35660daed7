"""Static configuration of the port's served model and its accuracy bar.

A copy of the parts of winograd_tpu/config.py that the served paths need
(ResNet50Config, PARITY_ATOL, INT8_RTOL_BACKBONE, BN_EPS), kept here so the
port imports nothing from the JAX package.
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


# f32 correctness bar: max abs error <= 1e-4 against the float64 golden.
PARITY_ATOL = 1e-4
# int8 serving tier bar for whole backbones and the classifier: max abs
# error <= 5e-2 * max(1, max|golden|) against the f32 model's float64
# golden (8-bit quantization, compounded over the layers).
INT8_RTOL_BACKBONE = 5e-2
BN_EPS = 1e-5
