"""The modified *aligned* Xception (Xception-65), the DeepLabV3+ backbone
of bonlime/keras-deeplab-v3-plus.

Counterpart of ``segmentation_training_pipeline_tpu/models/encoders/
xception_aligned.py``.  Against the classic graph (``xception.py``): a
separable conv is depthwise 3×3 → BN → pointwise 1×1 → BN
(``sep_conv_bn``), with one ReLU before it or, with ``depth_activation``,
a ReLU after each BN; every downsampling is a strided separable conv (no
max-pool); blocks are 3 separable convs with the stride on the last and a
1×1-conv, identity-sum or no shortcut; ``middle_units`` (16) middle
units; Keras BatchNorm (momentum 0.99, eps 1e-3).  Names are flat, as the
Keras layers (``entry_flow_block1_separable_conv1_depthwise_BN`` …).

``output_stride=16`` (the DeepLab layout) keeps exit block 1 at stride 1
and dilates exit block 2 at rate 2; the weights have the same shapes as
at 32.  XLA pads a dilated conv for its effective size (k − 1)·r + 1.
Taps: C1 64 (stride 2), C2 256 (stride 4: entry block 2 after its second
separable conv, bonlime's decoder skip), C3 256 (stride 8), C4 728
(stride 16), C5 2048 (stride 32, or 16 dilated).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import BatchNorm, Conv

Tensor = torch.Tensor


def add_sep_conv_bn(owner: nn.Module, in_channels: int, features: int,
                    prefix: str, stride: int = 1, rate: int = 1,
                    eps: float = 1e-3) -> None:
    """Register bonlime's ``SepConv_BN`` layers on ``owner``:
    ``{prefix}_depthwise[_BN]`` and ``{prefix}_pointwise[_BN]``."""
    owner.add_module(f"{prefix}_depthwise", Conv(
        in_channels, in_channels, 3, stride, groups=in_channels,
        dilation=rate))
    owner.add_module(f"{prefix}_depthwise_BN",
                     BatchNorm(in_channels, 0.99, eps))
    owner.add_module(f"{prefix}_pointwise", Conv(in_channels, features, 1))
    owner.add_module(f"{prefix}_pointwise_BN", BatchNorm(features, 0.99, eps))


def sep_conv_bn(owner: nn.Module, y: Tensor, prefix: str, train: bool,
                depth_activation: bool = False) -> Tensor:
    """depthwise → BN → pointwise → BN, with one ReLU before
    (``depth_activation=False``) or one after each BN (``True``)."""
    m = owner._modules
    if not depth_activation:
        y = F.relu(y)
    y = m[f"{prefix}_depthwise_BN"](m[f"{prefix}_depthwise"](y), train)
    if depth_activation:
        y = F.relu(y)
    y = m[f"{prefix}_pointwise_BN"](m[f"{prefix}_pointwise"](y), train)
    return F.relu(y) if depth_activation else y


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels, 0.99, 1e-3)


class AlignedXceptionEncoder(nn.Module):
    def __init__(self, in_channels: int = 3, output_stride: int = 32,
                 middle_units: int = 16):
        super().__init__()
        os16 = output_stride == 16
        self.entry_flow_conv1_1 = Conv(in_channels, 32, 3, 2)
        self.entry_flow_conv1_1_BN = _bn(32)
        self.entry_flow_conv1_2 = Conv(32, 64, 3)
        self.entry_flow_conv1_2_BN = _bn(64)
        # (prefix, depths, shortcut, stride, rate, depth_activation)
        self.blocks = [
            ("entry_flow_block1", [128] * 3, "conv", 2, 1, False),
            ("entry_flow_block2", [256] * 3, "conv", 2, 1, False),
            ("entry_flow_block3", [728] * 3, "conv", 2, 1, False),
            *[(f"middle_flow_unit_{i + 1}", [728] * 3, "sum", 1, 1, False)
              for i in range(middle_units)],
            ("exit_flow_block1", [728, 1024, 1024], "conv",
             1 if os16 else 2, 1, False),
            ("exit_flow_block2", [1536, 1536, 2048], "none", 1,
             2 if os16 else 1, True)]
        c = 64
        for prefix, depths, skip, stride, rate, _ in self.blocks:
            for i in range(3):
                add_sep_conv_bn(self, c if i == 0 else depths[i - 1],
                                depths[i], f"{prefix}_separable_conv{i + 1}",
                                stride if i == 2 else 1, rate)
            if skip == "conv":
                self.add_module(f"{prefix}_shortcut",
                                Conv(c, depths[-1], 1, stride))
                self.add_module(f"{prefix}_shortcut_BN", _bn(depths[-1]))
            c = depths[-1]
        self.out_channels = [64, 256, 256, 728, 2048]

    def _block(self, y: Tensor, prefix: str, depths: Sequence[int],
               skip: str, depth_activation: bool, train: bool):
        """bonlime ``_xception_block`` → (output, the tap after the second
        separable conv)."""
        residual, tap = y, None
        for i in range(3):
            residual = sep_conv_bn(self, residual,
                                   f"{prefix}_separable_conv{i + 1}", train,
                                   depth_activation)
            if i == 1:
                tap = residual
        m = self._modules
        if skip == "conv":
            residual = residual + m[f"{prefix}_shortcut_BN"](
                m[f"{prefix}_shortcut"](y), train)
        elif skip == "sum":
            residual = residual + y
        return residual, tap

    def forward(self, x: Tensor, train: bool = False) -> List[Tensor]:
        y = F.relu(self.entry_flow_conv1_1_BN(self.entry_flow_conv1_1(x),
                                              train))
        y = F.relu(self.entry_flow_conv1_2_BN(self.entry_flow_conv1_2(y),
                                              train))
        feats = [y]                                   # C1, stride 2
        for prefix, depths, skip, _, _, act in self.blocks:
            if prefix == "exit_flow_block1":
                feats.append(y)                       # C4, stride 16
            y, tap = self._block(y, prefix, depths, skip, act, train)
            if prefix == "entry_flow_block2":
                feats += [tap, y]                     # C2, C3
        feats.append(y)                               # C5
        return feats
