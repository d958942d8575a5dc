"""Shared building blocks of the model zoo (PyTorch).

Counterpart of ``segmentation_training_pipeline_tpu/models/layers.py``.
Modules work on NCHW tensors (PyTorch's convolution layout; the model
takes and returns NHWC at its boundary and keeps channels-last strides
inside).  Three conventions of the flax reference are kept exactly:

  * SAME padding as XLA computes it: total = max((ceil(n/s) − 1)·s + k − n,
    0), split low = total // 2, high = the rest.  At even sizes a strided
    conv pads asymmetrically (the 7×7/2 stem pads (2, 3), a 3×3/2 conv
    (0, 1)), which a symmetric ``padding=k//2`` gets wrong.
  * BatchNorm with flax's running-statistics rule: running = m·running +
    (1 − m)·batch with m = 0.9 (PyTorch's momentum 0.1), and the BIASED
    batch variance (PyTorch folds in the unbiased one).  In training mode
    the layer leaves its updated statistics in ``updated``; the caller
    collects them (``models.factory.apply_model``).
  * Initialisation as flax's defaults: conv kernels from
    variance_scaling(1, fan_in, truncated normal), biases 0, BN scale 1 and
    bias 0.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

Tensor = torch.Tensor


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding (low, high) of one spatial axis."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def pad_same(x: Tensor, k: int, s: int, value: float = 0.0) -> Tensor:
    """Pad an NCHW tensor for a VALID k×k / s window to act as SAME."""
    (t, b), (l, r) = (same_pads(x.shape[2], k, s),
                      same_pads(x.shape[3], k, s))
    if t == b == l == r == 0:
        return x
    return F.pad(x, (l, r, t, b), value=value)


# truncated_normal(stddev=1) over [-2, 2] has std 0.8796…; flax divides it
# out so variance_scaling keeps the requested variance
_TRUNC_STD = 0.87962566103423978


class Conv(nn.Module):
    """k×k convolution with XLA SAME padding (flax ``nn.Conv``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1, bias: bool = False):
        super().__init__()
        self.kernel = kernel
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        fan_in = self.weight.shape[1] * self.kernel * self.kernel
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std,
                                  2.0 * std, generator=gen)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: Tensor) -> Tensor:
        k, s = self.kernel, self.stride
        if s == 1 and k % 2 == 1:
            return F.conv2d(x, self.weight, self.bias, 1, k // 2)
        return F.conv2d(pad_same(x, k, s), self.weight, self.bias, s)


class BatchNorm(nn.Module):
    """BatchNorm over NCHW channels with flax's statistics rule."""

    def __init__(self, channels: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum       # flax convention (decay of running)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.updated: Optional[Tuple[Tensor, Tensor]] = None

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        mean = self.running_mean.clone()
        var = self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True,
                         1.0 - self.momentum, self.eps)
        # PyTorch blended in the unbiased batch variance n/(n−1)·v; flax
        # blends the biased v: rescale the blended-in part by (n−1)/n
        n = x.numel() // x.shape[1]
        kept = self.momentum * self.running_var
        self.updated = (mean, kept + (var - kept) * ((n - 1) / n))
        return y


class ConvBN(nn.Module):
    """Conv → BatchNorm → ReLU (optional)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, act: bool = True):
        super().__init__()
        self.conv = Conv(in_channels, features, kernel, stride)
        self.bn = BatchNorm(features)
        self.act = act

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        x = self.bn(self.conv(x), train)
        return F.relu(x) if self.act else x


def max_pool_same(x: Tensor, k: int = 3, s: int = 2) -> Tensor:
    """k×k / s max-pool with SAME padding by −inf (flax ``nn.max_pool``)."""
    return F.max_pool2d(pad_same(x, k, s, value=float("-inf")), k, s)


def upsample2x(x: Tensor) -> Tensor:
    """Nearest 2× upsample (``jax.image.resize`` nearest: dst i ← src i//2)
    in the input's dtype: CUDA autocast would run it in f32, which is no
    more exact for a copy and doubles its bytes and the concat's after."""
    with torch.autocast(x.device.type, enabled=False):
        return F.interpolate(x, scale_factor=2, mode="nearest")
