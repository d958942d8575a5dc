"""Encoder (backbone) table of the port.

Counterpart of ``segmentation_training_pipeline_tpu/models/encoders/
__init__.py``: each encoder's ``forward(x, train)`` returns the feature
maps [C1 … C5] at strides 2/4/8/16/32 and its ``out_channels`` lists their
widths, the contract the decoders rely on.  Ported so far: resnet18,
resnet34 and efficientnetb0–b7.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Type

from .efficientnet import EfficientNetEncoder
from .resnet import ResNetEncoder

# name → (module class, constructor kwargs)
ENCODERS: Dict[str, Tuple[Type, Dict[str, Any]]] = {
    "resnet18": (ResNetEncoder, dict(stage_sizes=(2, 2, 2, 2))),
    "resnet34": (ResNetEncoder, dict(stage_sizes=(3, 4, 6, 3))),
}
# EfficientNet B0-B7: (width_mult, depth_mult)
for _i, (_w, _d) in enumerate([
        (1.0, 1.0), (1.0, 1.1), (1.1, 1.2), (1.2, 1.4),
        (1.4, 1.8), (1.6, 2.2), (1.8, 2.6), (2.0, 3.1)]):
    ENCODERS[f"efficientnetb{_i}"] = (
        EfficientNetEncoder, dict(width_mult=_w, depth_mult=_d))


def build_encoder(name: str, in_channels: int = 3):
    cls, kw = ENCODERS[name.lower()]
    return cls(in_channels, **kw)
