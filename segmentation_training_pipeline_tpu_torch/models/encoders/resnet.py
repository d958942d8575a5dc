"""ResNet, ResNeXt and SE-ResNet encoders (He et al. 2016; Xie et al.
2017; Hu et al. 2018) — the post-activation graphs.

Counterpart of ``segmentation_training_pipeline_tpu/models/encoders/
resnet.py`` (``BasicBlock``, ``Bottleneck``, ``ResNetEncoder``,
``SEResNetEncoder``).  Feature taps: C1 = post-stem ReLU (stride 2),
C2..C5 = the four residual stages (strides 4/8/16/32).  Submodule names
follow the flax tree (``stem_conv``, ``stage2_block1/conv1``, ``…/se/
reduce`` …) so ``models.bridge`` maps weights by name.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import BatchNorm, Conv, SEBlock, max_pool_same

Tensor = torch.Tensor


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, features: int, stride: int,
                 use_se: bool = False):
        super().__init__()
        self.conv1 = Conv(in_channels, features, 3, stride)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv(features, features, 3)
        self.bn2 = BatchNorm(features)
        if use_se:
            # canonical SENet: reduction 16, ReLU hidden activation
            self.se = SEBlock(features, max(features // 16, 1), act="relu")
        self.has_downsample = stride != 1 or in_channels != features
        if self.has_downsample:
            self.downsample = Conv(in_channels, features, 1, stride)
            self.bn_down = BatchNorm(features)

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        if hasattr(self, "se"):
            y = self.se(y)
        residual = x
        if self.has_downsample:
            residual = self.bn_down(self.downsample(x), train)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """1×1 → 3×3 (``groups``, inner width ``features·width_factor``) → 1×1
    to 4·features.  The stride sits on the 3×3 (torchvision "v1.5") or,
    with ``stride_on_conv1``, on the first 1×1 (the Caffe/Cadene
    se_resnet graph): the weight shapes are the same either way."""

    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int,
                 use_se: bool = False, groups: int = 1, width_factor: int = 1,
                 stride_on_conv1: bool = False):
        super().__init__()
        inner = features * width_factor
        out = features * 4
        s1, s2 = (stride, 1) if stride_on_conv1 else (1, stride)
        self.conv1 = Conv(in_channels, inner, 1, s1)
        self.bn1 = BatchNorm(inner)
        self.conv2 = Conv(inner, inner, 3, s2, groups=groups)
        self.bn2 = BatchNorm(inner)
        self.conv3 = Conv(inner, out, 1)
        self.bn3 = BatchNorm(out)
        if use_se:
            self.se = SEBlock(out, max(out // 16, 1), act="relu")
        self.has_downsample = stride != 1 or in_channels != out
        if self.has_downsample:
            self.downsample = Conv(in_channels, out, 1, stride)
            self.bn_down = BatchNorm(out)

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        if hasattr(self, "se"):
            y = self.se(y)
        residual = x
        if self.has_downsample:
            residual = self.bn_down(self.downsample(x), train)
        return F.relu(y + residual)


class ResNetEncoder(nn.Module):
    use_se = False

    def __init__(self, in_channels: int = 3,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 bottleneck: bool = False, width: int = 64,
                 groups: int = 1, width_factor: int = 1,
                 stride_on_conv1: bool = False):
        super().__init__()
        block = Bottleneck if bottleneck else BasicBlock
        kw = dict(groups=groups, width_factor=width_factor,
                  stride_on_conv1=stride_on_conv1) if bottleneck else {}
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
                self.add_module(name, block(cin, features, stride,
                                            use_se=self.use_se, **kw))
                names.append(name)
                cin = features * block.expansion
            self.block_names.append(names)
        self.out_channels = [width] + [width * 2 ** s * block.expansion
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


class SEResNetEncoder(ResNetEncoder):
    use_se = True
