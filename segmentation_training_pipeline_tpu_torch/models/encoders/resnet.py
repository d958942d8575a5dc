"""ResNet encoders (He et al. 2016) — the post-activation BasicBlock graph.

Counterpart of ``segmentation_training_pipeline_tpu/models/encoders/
resnet.py`` (``BasicBlock``, ``ResNetEncoder``) for resnet18 and resnet34.  Feature
taps: C1 = post-stem ReLU (stride 2), C2..C5 = the four residual stages
(strides 4/8/16/32).  Submodule names follow the flax tree
(``stem_conv``, ``stage2_block1/conv1`` …) so ``models.bridge`` maps
weights by name.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import BatchNorm, Conv, max_pool_same

Tensor = torch.Tensor


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int):
        super().__init__()
        self.conv1 = Conv(in_channels, features, 3, stride)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv(features, features, 3)
        self.bn2 = BatchNorm(features)
        self.has_downsample = stride != 1 or in_channels != features
        if self.has_downsample:
            self.downsample = Conv(in_channels, features, 1, stride)
            self.bn_down = BatchNorm(features)

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        residual = x
        if self.has_downsample:
            residual = self.bn_down(self.downsample(x), train)
        return F.relu(y + residual)


class ResNetEncoder(nn.Module):
    def __init__(self, in_channels: int = 3,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64):
        super().__init__()
        self.stem_conv = Conv(in_channels, width, 7, 2)
        self.stem_bn = BatchNorm(width)
        self.block_names: List[List[str]] = []
        cin = width
        for stage, n_blocks in enumerate(stage_sizes):
            features = width * (2 ** stage)
            names = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                name = f"stage{stage + 1}_block{b + 1}"
                self.add_module(name, BasicBlock(cin, features, stride))
                names.append(name)
                cin = features
            self.block_names.append(names)
        self.out_channels = [width] + [width * 2 ** s
                                       for s in range(len(stage_sizes))]

    def forward(self, x: Tensor, train: bool = False) -> List[Tensor]:
        y = F.relu(self.stem_bn(self.stem_conv(x), train))
        feats = [y]                                   # C1, stride 2
        y = max_pool_same(y, 3, 2)
        for names in self.block_names:
            for name in names:
                y = getattr(self, name)(y, train)
            feats.append(y)                           # C2..C5
        return feats
