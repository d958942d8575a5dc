"""Xception encoder (Chollet 2017), the classic graph.

Counterpart of ``segmentation_training_pipeline_tpu/models/encoders/
xception.py``: separable convs (depthwise 3×3 → pointwise 1×1, no BN
between, no bias) each followed by one BN; entry and exit blocks of 2
separable convs and a 3×3/2 SAME max-pool with a strided 1×1 conv
shortcut; ``middle_blocks`` identity blocks of 3 at stride 16; a ReLU
before each separable conv (none before the very first) and none after
the residual add; every conv and pool SAME.  Taps: C1 64 (post-stem),
C2 128, C3 256, C4 728, C5 2048.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import BatchNorm, Conv, max_pool_same

Tensor = torch.Tensor


class SeparableConv(nn.Module):
    """Depthwise 3×3 then pointwise 1×1, both bias-free."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.depthwise = Conv(in_channels, in_channels, 3,
                              groups=in_channels)
        self.pointwise = Conv(in_channels, features, 1)

    def forward(self, x: Tensor) -> Tensor:
        return self.pointwise(self.depthwise(x))


class XceptionBlock(nn.Module):
    """``reps`` × (ReLU → SeparableConv → BN), an optional trailing
    stride-2 max-pool, and a conv shortcut when the shape changes.
    ``grow_first=False`` (the exit block) grows the width on the LAST
    separable conv."""

    def __init__(self, in_channels: int, features: int, reps: int = 2,
                 stride: int = 1, start_with_relu: bool = True,
                 grow_first: bool = True):
        super().__init__()
        self.reps = reps
        self.stride = stride
        self.start_with_relu = start_with_relu
        if stride != 1 or in_channels != features:
            self.shortcut = Conv(in_channels, features, 1, stride)
            self.shortcut_bn = BatchNorm(features)
        c = in_channels
        for i in range(reps):
            grow = (i == 0) if grow_first else (i == reps - 1)
            feats = features if grow or (grow_first and i > 0) \
                else in_channels
            self.add_module(f"sep{i + 1}", SeparableConv(c, feats))
            self.add_module(f"bn{i + 1}", BatchNorm(feats))
            c = feats

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        m = self._modules
        skip = x
        if hasattr(self, "shortcut"):
            skip = self.shortcut_bn(self.shortcut(x), train)
        y = x
        for i in range(1, self.reps + 1):
            if i > 1 or self.start_with_relu:
                y = F.relu(y)
            y = m[f"bn{i}"](m[f"sep{i}"](y), train)
        if self.stride != 1:
            y = max_pool_same(y, 3, self.stride)
        return y + skip


class XceptionEncoder(nn.Module):
    def __init__(self, in_channels: int = 3, middle_blocks: int = 8):
        super().__init__()
        self.middle_blocks = middle_blocks
        self.stem_conv1 = Conv(in_channels, 32, 3, 2)
        self.stem_bn1 = BatchNorm(32)
        self.stem_conv2 = Conv(32, 64, 3)
        self.stem_bn2 = BatchNorm(64)
        self.block1 = XceptionBlock(64, 128, stride=2, start_with_relu=False)
        self.block2 = XceptionBlock(128, 256, stride=2)
        self.block3 = XceptionBlock(256, 728, stride=2)
        for i in range(middle_blocks):
            self.add_module(f"block{4 + i}", XceptionBlock(728, 728, reps=3))
        self.add_module(f"block{4 + middle_blocks}",
                        XceptionBlock(728, 1024, stride=2, grow_first=False))
        self.exit_sep1 = SeparableConv(1024, 1536)
        self.exit_bn1 = BatchNorm(1536)
        self.exit_sep2 = SeparableConv(1536, 2048)
        self.exit_bn2 = BatchNorm(2048)
        self.out_channels = [64, 128, 256, 728, 2048]

    def forward(self, x: Tensor, train: bool = False) -> List[Tensor]:
        m = self._modules
        y = F.relu(self.stem_bn1(self.stem_conv1(x), train))
        y = F.relu(self.stem_bn2(self.stem_conv2(y), train))
        feats = [y]                                   # C1, stride 2
        y = self.block1(y, train)
        feats.append(y)                               # C2, stride 4
        y = self.block2(y, train)
        feats.append(y)                               # C3, stride 8
        y = self.block3(y, train)
        for i in range(self.middle_blocks):           # middle flow
            y = m[f"block{4 + i}"](y, train)
        feats.append(y)                               # C4, stride 16
        y = m[f"block{4 + self.middle_blocks}"](y, train)
        y = F.relu(self.exit_bn1(self.exit_sep1(y), train))
        y = F.relu(self.exit_bn2(self.exit_sep2(y), train))
        feats.append(y)                               # C5, stride 32
        return feats
