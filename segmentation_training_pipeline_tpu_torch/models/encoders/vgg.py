"""VGG16/19 encoders (Simonyan & Zisserman 2015), with BatchNorm.

Counterpart of ``segmentation_training_pipeline_tpu/models/encoders/
vgg.py``: per stage, 3×3 conv → BN → ReLU ``stage_convs[s]`` times, then a
2×2/2 max-pool (VALID: an odd size floors); taps after each pool (strides
2..32; under the space axis on the slab, or whole where the pooled level
runs whole).  Names ``stage{s}_conv{c}`` / ``stage{s}_bn{c}`` as the flax
tree; without BN (``use_bn=False``) the convs carry a bias.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...parallel import spatial
from ..layers import BatchNorm, Conv

Tensor = torch.Tensor


class VGGEncoder(nn.Module):
    def __init__(self, in_channels: int = 3,
                 stage_convs: Sequence[int] = (2, 2, 3, 3, 3),
                 widths: Sequence[int] = (64, 128, 256, 512, 512),
                 use_bn: bool = True):
        super().__init__()
        self.stage_convs = tuple(stage_convs)
        self.use_bn = use_bn
        cin = in_channels
        for stage, (n, w) in enumerate(zip(stage_convs, widths)):
            for c in range(n):
                self.add_module(f"stage{stage + 1}_conv{c + 1}",
                                Conv(cin, w, 3, bias=not use_bn))
                if use_bn:
                    self.add_module(f"stage{stage + 1}_bn{c + 1}",
                                    BatchNorm(w))
                cin = w
        self.out_channels = list(widths)

    def forward(self, x: Tensor, train: bool = False) -> List[Tensor]:
        m = self._modules
        feats, y = [], x
        for stage, n in enumerate(self.stage_convs):
            for c in range(1, n + 1):
                y = m[f"stage{stage + 1}_conv{c}"](y)
                if self.use_bn:
                    y = m[f"stage{stage + 1}_bn{c}"](y, train)
                y = F.relu(y)
            y = spatial.valid_pool(y, 2, F.max_pool2d)
            feats.append(y)                       # C1..C5
        return feats
