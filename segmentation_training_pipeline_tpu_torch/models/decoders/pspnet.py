"""PSPNet decoder (Zhao et al. 2017).

Counterpart of ``segmentation_training_pipeline_tpu/models/decoders/
pspnet.py``: pyramid pooling over C3 (stride 8) to 1/2/3/6 bins by exact
adaptive average pooling, a 1×1 conv-BN-ReLU per bin (``bin{b}_conv``),
a bilinear resize back, a concat with C3 and ``fuse_conv`` (3×3 to 512).
The output stays at stride 8; the model resizes the f32 logits to the
input size (``models.factory``).  Under the space axis the bins are whole
on every rank and each resize back is cut to the rank's slab.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn as nn

from ...parallel import spatial
from ..layers import ConvBN, resize_to

Tensor = torch.Tensor


def _adaptive_pool_matrix(n: int, bins: int) -> np.ndarray:
    """(bins, n) row-stochastic matrix of exact adaptive average pooling:
    bin i averages [floor(i·n/b), ceil((i+1)·n/b))."""
    m = np.zeros((bins, n), np.float32)
    for i in range(bins):
        s = (i * n) // bins
        e = -(-((i + 1) * n) // bins)
        m[i, s:e] = 1.0 / (e - s)
    return m


def adaptive_avg_pool(y: Tensor, b: int) -> Tensor:
    """NCHW → (N, C, b, b) by two matmuls with the pooling matrices in
    ``y``'s dtype, as the reference builds them (1/48 rounds to bf16 under
    bf16 compute).  A slab of a split level multiplies its columns of the
    whole image's H matrix and sums the products over the space group:
    the bins are whole on every rank."""
    split = spatial.is_split(y)
    h = spatial.current().global_h(y) if split else y.shape[2]
    mh, mw = (torch.from_numpy(_adaptive_pool_matrix(n, b)).to(y.device,
                                                               y.dtype)
              for n in (h, y.shape[3]))
    if split:
        n = y.shape[2]
        mh = mh[:, spatial.current().index * n:][:, :n]
    p = torch.einsum("ih,nchw->nciw", mh, y)
    if split:
        p = spatial.space_sum(p)
    return torch.einsum("jw,nciw->ncij", mw, p)


class PSPDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int],
                 bins: Sequence[int] = (1, 2, 3, 6),
                 conv_channels: int = 512):
        super().__init__()
        self.bins = tuple(bins)
        cin = encoder_channels[2]
        width = conv_channels // len(self.bins)
        for b in self.bins:
            self.add_module(f"bin{b}_conv", ConvBN(cin, width, 1))
        self.fuse_conv = ConvBN(cin + width * len(self.bins), conv_channels)
        self.out_channels = conv_channels

    def forward(self, feats: List[Tensor], train: bool = False) -> Tensor:
        y = feats[2]                                      # C3, stride 8
        h, w = y.shape[2:]
        pooled = [y]
        for b in self.bins:
            p = getattr(self, f"bin{b}_conv")(adaptive_avg_pool(y, b), train)
            # CUDA autocast resizes in f32; the concat takes y's dtype
            pooled.append(resize_to(p, h, w, "bilinear").to(y.dtype))
        return self.fuse_conv(torch.cat(pooled, dim=1), train)
