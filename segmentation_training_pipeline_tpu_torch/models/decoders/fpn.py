"""FPN decoder (Lin et al. 2017, as ``segmentation_models.FPN`` adapts it).

Counterpart of ``segmentation_training_pipeline_tpu/models/decoders/
fpn.py``: lateral 1×1 convs (with bias, flax's default) onto P5..P2 (256
channels), top-down nearest 2× upsampling with addition, two 3×3
conv-BN-ReLU heads per level (128 channels), nearest resize of each level
to P2 (×8/×4/×2/×1), sum, then ``merge_conv``.  The output stays at stride
4; the model resizes the logits ×4 (``models.factory``).  Names follow the
flax tree (``lat5``, ``seg5_conv1/conv`` …).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn

from ..layers import Conv, ConvBN, resize_to, upsample2x

Tensor = torch.Tensor


class FPNDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int],
                 pyramid_channels: int = 256,
                 segmentation_channels: int = 128):
        super().__init__()
        for level in (5, 4, 3, 2):
            self.add_module(f"lat{level}", Conv(
                encoder_channels[level - 1], pyramid_channels, 1, bias=True))
            self.add_module(f"seg{level}_conv1", ConvBN(
                pyramid_channels, segmentation_channels))
            self.add_module(f"seg{level}_conv2", ConvBN(
                segmentation_channels, segmentation_channels))
        self.merge_conv = ConvBN(segmentation_channels, segmentation_channels)
        self.out_channels = segmentation_channels

    def forward(self, feats: List[Tensor], train: bool = False) -> Tensor:
        p5 = self.lat5(feats[4])
        p4 = self.lat4(feats[3]) + upsample2x(p5)
        p3 = self.lat3(feats[2]) + upsample2x(p4)
        p2 = self.lat2(feats[1]) + upsample2x(p3)
        y = None
        for level, p in zip((5, 4, 3, 2), (p5, p4, p3, p2)):
            s = getattr(self, f"seg{level}_conv1")(p, train)
            s = getattr(self, f"seg{level}_conv2")(s, train)
            s = resize_to(s, p2.shape[2], p2.shape[3])
            y = s if y is None else y + s
        return self.merge_conv(y, train)
