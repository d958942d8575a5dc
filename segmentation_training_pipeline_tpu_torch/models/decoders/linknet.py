"""Linknet decoder (Chaurasia & Culurciello 2017).

Counterpart of ``segmentation_training_pipeline_tpu/models/decoders/
linknet.py``: each block is a 1×1 conv-BN-ReLU to C/4 (at least 16)
(``squeeze``), a nearest 2× upsample and a 3×3 conv-BN-ReLU (``conv``),
then a 1×1 conv-BN-ReLU to the skip's width (``expand``); the encoder
skip is ADDED.  ``dec1``..``dec4`` take C4..C1, ``dec5`` and
``final_conv`` (32 channels) run at full resolution.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn

from ..layers import ConvBN, upsample2x

Tensor = torch.Tensor


class LinknetDecoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_features: int):
        super().__init__()
        c = max(in_channels // 4, 16)
        self.squeeze = ConvBN(in_channels, c, 1)
        self.conv = ConvBN(c, c)
        self.expand = ConvBN(c, out_features, 1)

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        y = upsample2x(self.squeeze(x, train))
        return self.expand(self.conv(y, train), train)


class LinknetDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int],
                 final_width: int = 32):
        super().__init__()
        skips = list(encoder_channels[:-1])[::-1]        # C4, C3, C2, C1
        cin = encoder_channels[-1]
        for i, c in enumerate(skips):
            self.add_module(f"dec{i + 1}", LinknetDecoderBlock(cin, c))
            cin = c
        self.n_skips = len(skips)
        self.add_module(f"dec{len(skips) + 1}",
                        LinknetDecoderBlock(cin, final_width))
        self.final_conv = ConvBN(final_width, final_width)
        self.out_channels = final_width

    def forward(self, feats: List[Tensor], train: bool = False) -> Tensor:
        skips = list(feats[:-1])[::-1]
        y = feats[-1]
        for i, skip in enumerate(skips):
            y = getattr(self, f"dec{i + 1}")(y, train) + skip.to(y.dtype)
        y = getattr(self, f"dec{self.n_skips + 1}")(y, train)
        return self.final_conv(y, train)
