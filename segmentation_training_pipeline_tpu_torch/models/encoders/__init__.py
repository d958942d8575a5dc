"""Encoder (backbone) table of the port.

Counterpart of ``segmentation_training_pipeline_tpu/models/encoders/
__init__.py``: each encoder's ``forward(x, train)`` returns the feature
maps [C1 … C5] at strides 2/4/8/16/32 and its ``out_channels`` lists their
widths, the contract the decoders rely on.  Every name of the JAX table
(``_SPECS``: 34 backbones and the ``mobilenetv1`` alias), with its
classes' names and constructor arguments; each class here also takes
``in_channels`` first.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Type

from .densenet import DenseNetEncoder
from .efficientnet import EfficientNetEncoder
from .inception import InceptionResNetV2Encoder, InceptionV3Encoder
from .mobilenet import MobileNetV1Encoder
from .mobilenetv2 import MobileNetV2Encoder
from .resnet import ResNetEncoder, SENet154Encoder, SEResNetEncoder
from .vgg import VGGEncoder
from .xception import XceptionEncoder
from .xception_aligned import AlignedXceptionEncoder

# name → (module class, constructor kwargs); the stage sizes of resnet18,
# of resnet34 and resnet50, of resnet101 and of resnet152
_18, _34, _101, _152 = (2, 2, 2, 2), (3, 4, 6, 3), (3, 4, 23, 3), (3, 8, 36, 3)
ENCODERS: Dict[str, Tuple[Type, Dict[str, Any]]] = {
    "resnet18": (ResNetEncoder, dict(stage_sizes=_18, bottleneck=False)),
    "resnet34": (ResNetEncoder, dict(stage_sizes=_34, bottleneck=False)),
    "resnet50": (ResNetEncoder, dict(stage_sizes=_34, bottleneck=True)),
    "resnet101": (ResNetEncoder, dict(stage_sizes=_101, bottleneck=True)),
    "resnet152": (ResNetEncoder, dict(stage_sizes=_152, bottleneck=True)),
    "seresnet18": (SEResNetEncoder, dict(stage_sizes=_18, bottleneck=False)),
    "seresnet34": (SEResNetEncoder, dict(stage_sizes=_34, bottleneck=False)),
    # the Caffe/Cadene se_resnet bottleneck strides its first 1×1
    "seresnet50": (SEResNetEncoder, dict(stage_sizes=_34, bottleneck=True,
                                         stride_on_conv1=True)),
    "seresnet101": (SEResNetEncoder, dict(stage_sizes=_101, bottleneck=True,
                                          stride_on_conv1=True)),
    "seresnet152": (SEResNetEncoder, dict(stage_sizes=_152, bottleneck=True,
                                          stride_on_conv1=True)),
    # ResNeXt 32x4d: cardinality-32 grouped 3×3, 2× inner width
    "resnext50": (ResNetEncoder, dict(stage_sizes=_34, bottleneck=True,
                                      groups=32, width_factor=2)),
    "resnext101": (ResNetEncoder, dict(stage_sizes=_101, bottleneck=True,
                                       groups=32, width_factor=2)),
    "seresnext50": (SEResNetEncoder, dict(stage_sizes=_34, bottleneck=True,
                                          groups=32, width_factor=2)),
    "seresnext101": (SEResNetEncoder, dict(stage_sizes=_101, bottleneck=True,
                                           groups=32, width_factor=2)),
    # Cadene senet154: its own block (2p/4p widths, cardinality 64, deep
    # stem, kernel-3 downsamples)
    "senet154": (SENet154Encoder, {}),
    "vgg16": (VGGEncoder, dict(stage_convs=(2, 2, 3, 3, 3))),
    "vgg19": (VGGEncoder, dict(stage_convs=(2, 2, 4, 4, 4))),
    "mobilenet": (MobileNetV1Encoder, {}),
    "mobilenetv1": (MobileNetV1Encoder, {}),
    "mobilenetv2": (MobileNetV2Encoder, {}),
    "densenet121": (DenseNetEncoder, dict(block_sizes=(6, 12, 24, 16))),
    "densenet169": (DenseNetEncoder, dict(block_sizes=(6, 12, 32, 32))),
    "densenet201": (DenseNetEncoder, dict(block_sizes=(6, 12, 48, 32))),
    "xception": (XceptionEncoder, {}),
    # the DeepLabV3+ graph; the factory sets output_stride=16 with DeepLab
    "xception_aligned": (AlignedXceptionEncoder, {}),
    "inceptionv3": (InceptionV3Encoder, {}),
    "inceptionresnetv2": (InceptionResNetV2Encoder, {}),
}
# EfficientNet B0-B7: (width_mult, depth_mult)
for _i, (_w, _d) in enumerate([
        (1.0, 1.0), (1.0, 1.1), (1.1, 1.2), (1.2, 1.4),
        (1.4, 1.8), (1.6, 2.2), (1.8, 2.6), (2.0, 3.1)]):
    ENCODERS[f"efficientnetb{_i}"] = (
        EfficientNetEncoder, dict(width_mult=_w, depth_mult=_d))


def build_encoder(name: str, in_channels: int = 3, **overrides):
    cls, kw = ENCODERS[name.lower()]
    return cls(in_channels, **{**kw, **overrides})
