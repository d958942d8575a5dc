"""DeepLabV3+ decoders (Chen et al. 2018).

Counterpart of ``segmentation_training_pipeline_tpu/models/decoders/
deeplab.py``:

* ``DeepLabV3PlusDecoder``, the generic head for any encoder: ``ASPP``
  (1×1, three dilated 3×3 and image pooling) on C4 (stride 16), a
  bilinear resize to C2 (stride 4), a concat with C2 projected to 48
  channels, two 3×3 refinements;
* ``AlignedDeepLabDecoder``, bonlime's pascal_voc graph for the
  ``xception_aligned`` encoder at output stride 16: ASPP on C5 with
  separable dilated branches, branch order [pool, 1×1, rate 6, 12, 18],
  dropout 0.1, the 256-channel C2 skip projected to 48, two separable
  refinements; its BatchNorms use momentum 0.99 and eps 1e-5.  Flat
  names, as the Keras layers.

Both return the stride-4 map (a bilinear resize keeps the compute dtype,
which CUDA autocast would widen to f32); the model head resizes the f32 logits to
the input size (``models.factory``).  The image-pooling branch resizes a
1×1 map, which both of JAX's methods copy to every pixel.  Under the
space axis the image pooling is a mean over the group
(``parallel/spatial.py:mean_hw``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..encoders.xception_aligned import add_sep_conv_bn, sep_conv_bn
from ...parallel import spatial
from ..layers import BatchNorm, Conv, ConvBN, Dropout, resize_to

Tensor = torch.Tensor


class ASPP(nn.Module):
    def __init__(self, in_channels: int, channels: int = 256,
                 rates: Sequence[int] = (6, 12, 18)):
        super().__init__()
        self.rates = tuple(rates)
        self.b0_conv = ConvBN(in_channels, channels, 1)
        for r in self.rates:
            self.add_module(f"rate{r}_conv", Conv(in_channels, channels, 3,
                                                  dilation=r))
            self.add_module(f"rate{r}_bn", BatchNorm(channels, 0.99, 1e-3))
        self.pool_conv = ConvBN(in_channels, channels, 1)
        self.project = ConvBN(channels * (len(self.rates) + 2), channels, 1)

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        m = self._modules
        branches = [self.b0_conv(x, train)]
        for r in self.rates:
            branches.append(F.relu(m[f"rate{r}_bn"](m[f"rate{r}_conv"](x),
                                                   train)))
        g = self.pool_conv(spatial.mean_hw(x), train)
        branches.append(resize_to(g, x.shape[2], x.shape[3]))
        return self.project(torch.cat(branches, dim=1), train)


class DeepLabV3PlusDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int], channels: int = 256,
                 low_level_channels: int = 48):
        super().__init__()
        self.aspp = ASPP(encoder_channels[3], channels)
        self.low_project = ConvBN(encoder_channels[1], low_level_channels, 1)
        self.refine1 = ConvBN(channels + low_level_channels, channels)
        self.refine2 = ConvBN(channels, channels)
        self.out_channels = channels

    def forward(self, feats: List[Tensor], train: bool = False) -> Tensor:
        c2, c4 = feats[1], feats[3]                   # strides 4, 16
        y = self.aspp(c4, train)
        # CUDA autocast resizes in f32; the map keeps its compute dtype
        y = resize_to(y, c2.shape[2], c2.shape[3], "bilinear").to(y.dtype)
        low = self.low_project(c2, train)
        y = torch.cat([y, low.to(y.dtype)], dim=1)
        return self.refine2(self.refine1(y, train), train)


class AlignedDeepLabDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int], channels: int = 256,
                 rates: Sequence[int] = (6, 12, 18)):
        super().__init__()
        cin = encoder_channels[4]
        self.rates = tuple(rates)
        self.image_pooling = Conv(cin, channels, 1)
        self.image_pooling_BN = _bn(channels)
        self.aspp0 = Conv(cin, channels, 1)
        self.aspp0_BN = _bn(channels)
        for i, r in enumerate(self.rates):
            add_sep_conv_bn(self, cin, channels, f"aspp{i + 1}", rate=r,
                            eps=1e-5)
        self.concat_projection = Conv(channels * (len(self.rates) + 2),
                                      channels, 1)
        self.concat_projection_BN = _bn(channels)
        self.dropout = Dropout(0.1)
        self.feature_projection0 = Conv(encoder_channels[1], 48, 1)
        self.feature_projection0_BN = _bn(48)
        add_sep_conv_bn(self, channels + 48, channels, "decoder_conv0",
                        eps=1e-5)
        add_sep_conv_bn(self, channels, channels, "decoder_conv1", eps=1e-5)
        self.out_channels = channels

    def forward(self, feats: List[Tensor], train: bool = False) -> Tensor:
        x, skip = feats[4], feats[1]
        b4 = spatial.mean_hw(x)
        b4 = F.relu(self.image_pooling_BN(self.image_pooling(b4), train))
        branches = [resize_to(b4, x.shape[2], x.shape[3], "bilinear"),
                    F.relu(self.aspp0_BN(self.aspp0(x), train))]
        for i in range(len(self.rates)):
            branches.append(sep_conv_bn(self, x, f"aspp{i + 1}", train,
                                        depth_activation=True))
        y = self.concat_projection(torch.cat(branches, dim=1))
        y = self.dropout(F.relu(self.concat_projection_BN(y, train)), train)
        y = resize_to(y, skip.shape[2], skip.shape[3], "bilinear").to(y.dtype)
        low = F.relu(self.feature_projection0_BN(
            self.feature_projection0(skip), train))
        y = torch.cat([y, low.to(y.dtype)], dim=1)
        y = sep_conv_bn(self, y, "decoder_conv0", train,
                        depth_activation=True)
        return sep_conv_bn(self, y, "decoder_conv1", train,
                           depth_activation=True)


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels, 0.99, 1e-5)
