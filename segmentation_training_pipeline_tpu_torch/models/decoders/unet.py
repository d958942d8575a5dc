"""U-Net decoder (Ronneberger et al. 2015).

Counterpart of ``segmentation_training_pipeline_tpu/models/decoders/
unet.py``: for each of 5 steps, nearest 2× upsample → concat the encoder
skip → two 3×3 conv-BN-ReLU blocks; widths 256/128/64/32/16.  Stage and
block names follow the flax tree (``up1/conv1/conv`` …).  ``remat``
checkpoints each stage on its own (``layers.run_part``), as the JAX
decoder's per-stage ``nn.remat``: the backward pass then recomputes one
stage's activations at a time.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from ..layers import ConvBN, run_part, upsample2x

Tensor = torch.Tensor


class UnetStage(nn.Module):
    """One decode step: upsample 2× → concat skip → ConvBN ×2."""

    def __init__(self, in_channels: int, skip_channels: int, width: int):
        super().__init__()
        self.conv1 = ConvBN(in_channels + skip_channels, width)
        self.conv2 = ConvBN(width, width)

    def forward(self, y: Tensor, skip: Optional[Tensor],
                train: bool = False) -> Tensor:
        y = upsample2x(y)
        if skip is not None:
            if skip.shape[2] != y.shape[2]:  # odd-size guard
                y = y[:, :, :skip.shape[2], :skip.shape[3]]
            y = torch.cat([y, skip.to(y.dtype)], dim=1)
        return self.conv2(self.conv1(y, train), train)


class UnetDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int],
                 widths: Sequence[int] = (256, 128, 64, 32, 16),
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        # feats: [C1..C5] at strides 2..32; decode from C5 up with skips
        # C4, C3, C2, C1 and no skip at full resolution
        skips = list(encoder_channels[:-1])[::-1]
        cin = encoder_channels[-1]
        self.n_stages = len(widths)
        for i, w in enumerate(widths):
            skip = skips[i] if i < len(skips) else 0
            self.add_module(f"up{i + 1}", UnetStage(cin, skip, w))
            cin = w
        self.out_channels = cin

    def forward(self, feats: List[Tensor], train: bool = False) -> Tensor:
        skips = list(feats[:-1])[::-1]
        y = feats[-1]
        for i in range(self.n_stages):
            skip = skips[i] if i < len(skips) else None
            y = run_part(self._modules[f"up{i + 1}"], "", None, self.remat,
                         y, skip, train=train)
        return y  # full input resolution
