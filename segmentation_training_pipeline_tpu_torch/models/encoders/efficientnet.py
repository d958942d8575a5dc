"""EfficientNet B0–B7 encoders (Tan & Le 2019).

Counterpart of ``segmentation_training_pipeline_tpu/models/encoders/
efficientnet.py`` (``MBConv``, ``EfficientNetEncoder``): MBConv blocks
(1×1 expand → depthwise k×k → squeeze-excitation → 1×1 project) with
swish activations and stochastic depth on the identity blocks, widths and
depths scaled per variant.  BatchNorm here uses momentum 0.99 and eps 1e-3.
The stride-2 depthwise convs pad as XLA's SAME does, (1, 2) for a 5×5 at
an even size.  Feature taps: the input of each stride-2 block and the head
(strides 2/4/8/16/32).  Submodule names follow the flax tree
(``stage1_block0/depthwise``, ``se/reduce`` …) so ``models.bridge`` maps
weights by name.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import (BatchNorm, Conv, DropPath, SEBlock, round_filters,
                      round_repeats)

Tensor = torch.Tensor

# (expansion, channels, repeats, stride, kernel) of B0
_EFF_CFG = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels, momentum=0.99, eps=1e-3)


class MBConv(nn.Module):
    def __init__(self, in_channels: int, expansion: int, features: int,
                 stride: int, kernel: int, drop_rate: float):
        super().__init__()
        hidden = in_channels * expansion
        self.has_expand = expansion != 1
        if self.has_expand:
            self.expand = Conv(in_channels, hidden, 1)
            self.expand_bn = _bn(hidden)
        self.depthwise = Conv(hidden, hidden, kernel, stride, groups=hidden)
        self.dw_bn = _bn(hidden)
        self.se = SEBlock(hidden, max(1, in_channels // 4))
        self.project = Conv(hidden, features, 1)
        self.project_bn = _bn(features)
        self.residual = stride == 1 and in_channels == features
        if self.residual:
            self.drop_path = DropPath(drop_rate)

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        y = x
        if self.has_expand:
            y = F.silu(self.expand_bn(self.expand(y), train))
        y = F.silu(self.dw_bn(self.depthwise(y), train))
        y = self.project_bn(self.project(self.se(y)), train)
        if self.residual:
            y = self.drop_path(y, train) + x
        return y


class EfficientNetEncoder(nn.Module):
    def __init__(self, in_channels: int = 3, width_mult: float = 1.0,
                 depth_mult: float = 1.0, drop_connect: float = 0.2):
        super().__init__()
        stem = round_filters(32, width_mult)
        self.stem_conv = Conv(in_channels, stem, 3, 2)
        self.stem_bn = _bn(stem)
        total = sum(round_repeats(r, depth_mult) for _, _, r, _, _ in _EFF_CFG)
        self.blocks: List[str] = []
        self.out_channels: List[int] = []
        cin, idx = stem, 0
        for si, (t, ch, n, s, k) in enumerate(_EFF_CFG):
            out = round_filters(ch, width_mult)
            for i in range(round_repeats(n, depth_mult)):
                stride = s if i == 0 else 1
                if stride == 2:
                    self.out_channels.append(cin)
                name = f"stage{si}_block{i}"
                self.add_module(name, MBConv(cin, t, out, stride, k,
                                             drop_connect * idx / total))
                self.blocks.append(name)
                cin, idx = out, idx + 1
        head = round_filters(1280, width_mult)
        self.head_conv = Conv(cin, head, 1)
        self.head_bn = _bn(head)
        self.out_channels.append(head)

    def forward(self, x: Tensor, train: bool = False) -> List[Tensor]:
        y = F.silu(self.stem_bn(self.stem_conv(x), train))
        feats = []
        for name in self.blocks:
            block = getattr(self, name)
            if block.depthwise.stride == 2:
                feats.append(y)
            y = block(y, train)
        feats.append(F.silu(self.head_bn(self.head_conv(y), train)))
        return feats
