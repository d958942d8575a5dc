"""MobileNet (v1) encoder (Howard et al. 2017), alpha 1.0.

Counterpart of ``segmentation_training_pipeline_tpu/models/encoders/
mobilenet.py``: a 3×3/2 ``conv1`` then 13 depthwise-separable blocks
(depthwise 3×3 ``conv_dw_{i}`` and pointwise 1×1 ``conv_pw_{i}``, each
followed by Keras BatchNorm (momentum 0.99, eps 1e-3) and ReLU6), strides
at blocks 2/4/6/12.  Taps ``conv_pw_{1,3,5,11,13}_relu``: 64/128/256/512/
1024 channels at strides 2/4/8/16/32.  Names as the Keras layers.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import BatchNorm, Conv

Tensor = torch.Tensor

# pointwise output channels per block (alpha = 1.0)
_PW_CHANNELS = (64, 128, 128, 256, 256, 512, 512, 512, 512, 512, 512,
                1024, 1024)
_STRIDE_BLOCKS = frozenset({2, 4, 6, 12})
_TAP_BLOCKS = frozenset({1, 3, 5, 11, 13})


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels, 0.99, 1e-3)


class MobileNetV1Encoder(nn.Module):
    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.conv1 = Conv(in_channels, 32, 3, 2)
        self.conv1_bn = _bn(32)
        c = 32
        for i, pw in enumerate(_PW_CHANNELS, start=1):
            s = 2 if i in _STRIDE_BLOCKS else 1
            self.add_module(f"conv_dw_{i}", Conv(c, c, 3, s, groups=c))
            self.add_module(f"conv_dw_{i}_bn", _bn(c))
            self.add_module(f"conv_pw_{i}", Conv(c, pw, 1))
            self.add_module(f"conv_pw_{i}_bn", _bn(pw))
            c = pw
        self.out_channels = [_PW_CHANNELS[i - 1] for i in sorted(_TAP_BLOCKS)]

    def forward(self, x: Tensor, train: bool = False) -> List[Tensor]:
        m = self._modules
        y = F.relu6(self.conv1_bn(self.conv1(x), train))
        feats = []
        for i in range(1, len(_PW_CHANNELS) + 1):
            y = F.relu6(m[f"conv_dw_{i}_bn"](m[f"conv_dw_{i}"](y), train))
            y = F.relu6(m[f"conv_pw_{i}_bn"](m[f"conv_pw_{i}"](y), train))
            if i in _TAP_BLOCKS:
                feats.append(y)
        return feats
