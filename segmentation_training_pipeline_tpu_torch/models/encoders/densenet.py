"""DenseNet-121/169/201 encoders (Huang et al. 2017).

Counterpart of ``segmentation_training_pipeline_tpu/models/encoders/
densenet.py``: dense layers (BN → ReLU → 1×1 to 4·growth → BN → ReLU →
3×3 to growth, concatenated onto the input), growth 32, transitions of
BN → ReLU → 1×1 to half the channels → 2×2/2 average pool (VALID; under
the space axis on the slab, or whole where the pooled level runs whole).
Taps: C1 post-stem ReLU (stride 2), C2..C4 each dense block before its
transition, C5 the final BN + ReLU.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...parallel import spatial
from ..layers import BatchNorm, Conv, max_pool_same

Tensor = torch.Tensor


class DenseLayer(nn.Module):
    def __init__(self, in_channels: int, growth: int):
        super().__init__()
        self.bn1 = BatchNorm(in_channels)
        self.conv1 = Conv(in_channels, 4 * growth, 1)
        self.bn2 = BatchNorm(4 * growth)
        self.conv2 = Conv(4 * growth, growth, 3)

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        y = self.conv1(F.relu(self.bn1(x, train)))
        y = self.conv2(F.relu(self.bn2(y, train)))
        return torch.cat([x, y], dim=1)


class DenseNetEncoder(nn.Module):
    def __init__(self, in_channels: int = 3,
                 block_sizes: Sequence[int] = (6, 12, 24, 16),
                 growth: int = 32):
        super().__init__()
        self.block_sizes = tuple(block_sizes)
        self.stem_conv = Conv(in_channels, 64, 7, 2)
        self.stem_bn = BatchNorm(64)
        self.out_channels = [64]
        c = 64
        for bi, n in enumerate(block_sizes):
            for li in range(n):
                self.add_module(f"block{bi + 1}_layer{li + 1}",
                                DenseLayer(c, growth))
                c += growth
            self.out_channels.append(c)
            if bi < len(block_sizes) - 1:
                self.add_module(f"trans{bi + 1}_bn", BatchNorm(c))
                self.add_module(f"trans{bi + 1}_conv", Conv(c, c // 2, 1))
                c //= 2
        self.final_bn = BatchNorm(c)

    def forward(self, x: Tensor, train: bool = False) -> List[Tensor]:
        m = self._modules
        y = F.relu(self.stem_bn(self.stem_conv(x), train))
        feats = [y]                                   # C1, stride 2
        y = max_pool_same(y, 3, 2)
        last = len(self.block_sizes) - 1
        for bi, n in enumerate(self.block_sizes):
            for li in range(1, n + 1):
                y = m[f"block{bi + 1}_layer{li}"](y, train)
            if bi < last:
                feats.append(y)                       # C2..C4
                y = F.relu(m[f"trans{bi + 1}_bn"](y, train))
                y = spatial.valid_pool(m[f"trans{bi + 1}_conv"](y), 2,
                                       F.avg_pool2d)
        feats.append(F.relu(self.final_bn(y, train)))  # C5, stride 32
        return feats
