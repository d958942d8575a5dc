"""MobileNetV2 encoder (Sandler et al. 2018).

Counterpart of ``segmentation_training_pipeline_tpu/models/encoders/
mobilenetv2.py``: inverted residuals (1×1 ``expand`` when t ≠ 1, depthwise
3×3, linear 1×1 ``project``, an identity add at stride 1 with equal
widths), ReLU6, BatchNorm with momentum 0.999 and eps 1e-3.  Taps: the
map before each stride-2 block (16/24/32/96 channels at strides 2..16)
and the 1280-channel 1×1 head (stride 32).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import BatchNorm, Conv

Tensor = torch.Tensor

# (expansion t, out channels c, repeats n, stride s) — Table 2 of the paper
_MBV2_CFG = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels, 0.999, 1e-3)


class InvertedResidual(nn.Module):
    def __init__(self, in_channels: int, expansion: int, features: int,
                 stride: int):
        super().__init__()
        hidden = in_channels * expansion
        self.stride = stride
        if expansion != 1:
            self.expand = Conv(in_channels, hidden, 1)
            self.expand_bn = _bn(hidden)
        self.depthwise = Conv(hidden, hidden, 3, stride, groups=hidden)
        self.dw_bn = _bn(hidden)
        self.project = Conv(hidden, features, 1)
        self.project_bn = _bn(features)
        self.residual = stride == 1 and in_channels == features

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        y = x
        if hasattr(self, "expand"):
            y = F.relu6(self.expand_bn(self.expand(y), train))
        y = F.relu6(self.dw_bn(self.depthwise(y), train))
        y = self.project_bn(self.project(y), train)
        return y + x if self.residual else y


class MobileNetV2Encoder(nn.Module):
    def __init__(self, in_channels: int = 3, alpha: float = 1.0):
        super().__init__()

        def c(ch):
            return max(8, int(ch * alpha + 4) // 8 * 8)

        self.stem_conv = Conv(in_channels, c(32), 3, 2)
        self.stem_bn = _bn(c(32))
        self.blocks: List[str] = []
        self.out_channels: List[int] = []
        cin = c(32)
        for t, ch, n, s in _MBV2_CFG:
            for i in range(n):
                stride = s if i == 0 else 1
                if stride == 2:
                    self.out_channels.append(cin)
                name = f"block{len(self.blocks)}"
                self.add_module(name, InvertedResidual(cin, t, c(ch), stride))
                self.blocks.append(name)
                cin = c(ch)
        head = c(1280) if alpha > 1.0 else 1280
        self.head_conv = Conv(cin, head, 1)
        self.head_bn = _bn(head)
        self.out_channels.append(head)

    def forward(self, x: Tensor, train: bool = False) -> List[Tensor]:
        y = F.relu6(self.stem_bn(self.stem_conv(x), train))
        feats = []
        for name in self.blocks:
            block = self._modules[name]
            if block.stride == 2:
                feats.append(y)       # the last map at the previous stride
            y = block(y, train)
        feats.append(F.relu6(self.head_bn(self.head_conv(y), train)))
        return feats
