"""Plain float32 references of the benchmark's two models.

Unet with a ResNet-34 encoder (He et al. 2016; Ronneberger et al. 2015;
segmentation_models' defaults: decoder widths 256-128-64-32-16, nearest 2x
upsampling, skips C4..C1) and DeepLabV3+ on the aligned Xception-65 at
output stride 16 (Chen et al. 2018; bonlime/keras-deeplab-v3-plus's
``pascal_voc`` graph: 16 middle units, separable ASPP at rates 6, 12, 18
with image pooling, a 48-channel skip projection and two separable
refinements).  Written from those descriptions in plain PyTorch: NCHW,
float32, convolutions padded as XLA's SAME (low = total // 2), BatchNorm by
flax's rule (biased batch variance, running = m·running + (1 − m)·batch),
initialisation left to the caller.  Parameter and buffer names follow the
flax tree (``encoder.stage1_block1.conv1.weight``, ``logits_conv.bias`` …)
so that one set of named tensors feeds this module and the program alike.

``quant`` (a callable on tensors, or None) rounds every convolution's input
and weight before the product: the benchmark's lower-precision control.
``checkpoint=True`` recomputes each block's activations in the backward
pass, so that the reference fits beside nothing else at the timed batch.
A model takes NHWC input and returns NHWC float32 logits; in training mode
``forward`` also fills ``self.new_stats`` with the updated running
statistics by name.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _checkpoint

Tensor = torch.Tensor


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding (low, high) of one axis for a window of ``k``
    taps (a dilated kernel's effective size) at stride ``s``."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Ctx:
    """What one forward shares with its layers: train mode, the quantiser
    and where the new running statistics go."""

    def __init__(self, train: bool, quant: Optional[Callable] = None):
        self.train = train
        self.quant = quant
        self.stats: Dict[str, Tensor] = {}


class RConv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 groups: int = 1, dilation: int = 1, bias: bool = False):
        super().__init__()
        self.k, self.stride, self.groups, self.dilation = k, stride, groups, \
            dilation
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: Tensor, ctx: Ctx) -> Tensor:
        span = (self.k - 1) * self.dilation + 1
        t, b = same_pads(x.shape[2], span, self.stride)
        l, r = same_pads(x.shape[3], span, self.stride)
        x = F.pad(x, (l, r, t, b))
        w = self.weight
        if ctx.quant is not None:
            x, w = ctx.quant(x), ctx.quant(w)
        return F.conv2d(x, w, self.bias, self.stride, 0, self.dilation,
                        self.groups)


class RBN(nn.Module):
    """flax's BatchNorm: ``momentum`` is the decay of the running values."""

    def __init__(self, c: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.key = ""

    def forward(self, x: Tensor, ctx: Ctx) -> Tensor:
        if ctx.train:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            m = self.momentum
            ctx.stats[self.key + "running_mean"] = (
                m * self.running_mean + (1.0 - m) * mean).detach()
            ctx.stats[self.key + "running_var"] = (
                m * self.running_var + (1.0 - m) * var).detach()
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * scale[:, None, None] \
            + self.bias[:, None, None]


def _run(fn, ctx: Ctx, *xs):
    """``fn(*xs)``, recomputed in the backward pass when the model
    checkpoints and autograd records."""
    if getattr(ctx, "remat", False) and torch.is_grad_enabled():
        return _checkpoint(fn, *xs, use_reentrant=False)
    return fn(*xs)


# ---------------------------------------------------------------------------
# Unet-resnet34
# ---------------------------------------------------------------------------

class BasicBlock(nn.Module):
    def __init__(self, cin: int, c: int, stride: int):
        super().__init__()
        self.conv1 = RConv(cin, c, 3, stride)
        self.bn1 = RBN(c)
        self.conv2 = RConv(c, c, 3)
        self.bn2 = RBN(c)
        self.down = stride != 1 or cin != c
        if self.down:
            self.downsample = RConv(cin, c, 1, stride)
            self.bn_down = RBN(c)

    def forward(self, x: Tensor, ctx: Ctx) -> Tensor:
        y = F.relu(self.bn1(self.conv1(x, ctx), ctx))
        y = self.bn2(self.conv2(y, ctx), ctx)
        r = self.bn_down(self.downsample(x, ctx), ctx) if self.down else x
        return F.relu(y + r)


class ResNet34Encoder(nn.Module):
    stages = (3, 4, 6, 3)

    def __init__(self):
        super().__init__()
        self.stem_conv = RConv(3, 64, 7, 2)
        self.stem_bn = RBN(64)
        cin = 64
        self.names: List[List[str]] = []
        for s, n in enumerate(self.stages):
            c = 64 * 2 ** s
            names = []
            for b in range(n):
                name = f"stage{s + 1}_block{b + 1}"
                self.add_module(name, BasicBlock(cin, c,
                                                 2 if b == 0 and s else 1))
                names.append(name)
                cin = c
            self.names.append(names)
        self.out_channels = [64, 64, 128, 256, 512]

    def forward(self, x: Tensor, ctx: Ctx) -> List[Tensor]:
        y = _run(lambda z: F.relu(self.stem_bn(self.stem_conv(z, ctx), ctx)),
                 ctx, x)
        feats = [y]
        t, b = same_pads(y.shape[2], 3, 2)
        l, r = same_pads(y.shape[3], 3, 2)
        y = F.max_pool2d(F.pad(y, (l, r, t, b), value=float("-inf")), 3, 2)
        for names in self.names:
            for name in names:
                y = _run(lambda z, m=getattr(self, name): m(z, ctx), ctx, y)
            feats.append(y)
        return feats


class ConvBN(nn.Module):
    """flax tree ``{name}/conv`` and ``{name}/bn``; ReLU after."""

    def __init__(self, cin: int, c: int, k: int = 3):
        super().__init__()
        self.conv = RConv(cin, c, k)
        self.bn = RBN(c)

    def forward(self, x: Tensor, ctx: Ctx) -> Tensor:
        return F.relu(self.bn(self.conv(x, ctx), ctx))


class UnetStage(nn.Module):
    def __init__(self, cin: int, skip: int, c: int):
        super().__init__()
        self.conv1 = ConvBN(cin + skip, c)
        self.conv2 = ConvBN(c, c)

    def forward(self, y: Tensor, skip: Optional[Tensor], ctx: Ctx) -> Tensor:
        y = F.interpolate(y, scale_factor=2, mode="nearest")
        if skip is not None:
            y = torch.cat([y, skip], 1)
        return self.conv2(self.conv1(y, ctx), ctx)


class UnetDecoder(nn.Module):
    widths = (256, 128, 64, 32, 16)

    def __init__(self, enc: Sequence[int]):
        super().__init__()
        skips = list(enc[:-1])[::-1]
        cin = enc[-1]
        for i, w in enumerate(self.widths):
            self.add_module(f"up{i + 1}", UnetStage(
                cin, skips[i] if i < len(skips) else 0, w))
            cin = w
        self.out_channels = cin

    def forward(self, feats: List[Tensor], ctx: Ctx) -> Tensor:
        skips = list(feats[:-1])[::-1]
        y = feats[-1]
        for i in range(len(self.widths)):
            stage = getattr(self, f"up{i + 1}")
            if i < len(skips):
                y = _run(lambda a, s, m=stage: m(a, s, ctx), ctx, y, skips[i])
            else:
                y = _run(lambda a, m=stage: m(a, None, ctx), ctx, y)
        return y


# ---------------------------------------------------------------------------
# DeepLabV3+ on the aligned Xception-65, output stride 16
# ---------------------------------------------------------------------------

def add_sep(owner: nn.Module, cin: int, c: int, prefix: str, stride: int = 1,
            rate: int = 1, eps: float = 1e-3) -> None:
    """bonlime's ``SepConv_BN``: depthwise 3x3 → BN → pointwise 1x1 → BN."""
    owner.add_module(f"{prefix}_depthwise",
                     RConv(cin, cin, 3, stride, groups=cin, dilation=rate))
    owner.add_module(f"{prefix}_depthwise_BN", RBN(cin, 0.99, eps))
    owner.add_module(f"{prefix}_pointwise", RConv(cin, c, 1))
    owner.add_module(f"{prefix}_pointwise_BN", RBN(c, 0.99, eps))


def sep(owner: nn.Module, y: Tensor, prefix: str, ctx: Ctx,
        depth_activation: bool) -> Tensor:
    m = owner._modules
    if not depth_activation:
        y = F.relu(y)
    y = m[f"{prefix}_depthwise_BN"](m[f"{prefix}_depthwise"](y, ctx), ctx)
    if depth_activation:
        y = F.relu(y)
    y = m[f"{prefix}_pointwise_BN"](m[f"{prefix}_pointwise"](y, ctx), ctx)
    return F.relu(y) if depth_activation else y


class AlignedXception65(nn.Module):
    def __init__(self, middle_units: int = 16):
        super().__init__()
        self.entry_flow_conv1_1 = RConv(3, 32, 3, 2)
        self.entry_flow_conv1_1_BN = RBN(32, 0.99, 1e-3)
        self.entry_flow_conv1_2 = RConv(32, 64, 3)
        self.entry_flow_conv1_2_BN = RBN(64, 0.99, 1e-3)
        # (prefix, depths, shortcut, stride, rate, depth_activation)
        self.blocks = [
            ("entry_flow_block1", [128] * 3, "conv", 2, 1, False),
            ("entry_flow_block2", [256] * 3, "conv", 2, 1, False),
            ("entry_flow_block3", [728] * 3, "conv", 2, 1, False),
            *[(f"middle_flow_unit_{i + 1}", [728] * 3, "sum", 1, 1, False)
              for i in range(middle_units)],
            ("exit_flow_block1", [728, 1024, 1024], "conv", 1, 1, False),
            ("exit_flow_block2", [1536, 1536, 2048], "none", 1, 2, True)]
        c = 64
        for prefix, depths, skip, stride, rate, _ in self.blocks:
            for i in range(3):
                add_sep(self, c if i == 0 else depths[i - 1], depths[i],
                        f"{prefix}_separable_conv{i + 1}",
                        stride if i == 2 else 1, rate)
            if skip == "conv":
                self.add_module(f"{prefix}_shortcut",
                                RConv(c, depths[-1], 1, stride))
                self.add_module(f"{prefix}_shortcut_BN",
                                RBN(depths[-1], 0.99, 1e-3))
            c = depths[-1]
        self.out_channels = [64, 256, 256, 728, 2048]

    def _block(self, y: Tensor, prefix: str, skip: str, act: bool,
               ctx: Ctx) -> Tuple[Tensor, Tensor]:
        r, tap = y, y
        for i in range(3):
            r = sep(self, r, f"{prefix}_separable_conv{i + 1}", ctx, act)
            if i == 1:
                tap = r
        m = self._modules
        if skip == "conv":
            r = r + m[f"{prefix}_shortcut_BN"](m[f"{prefix}_shortcut"](y, ctx),
                                               ctx)
        elif skip == "sum":
            r = r + y
        return r, tap

    def forward(self, x: Tensor, ctx: Ctx) -> List[Tensor]:
        def stem(z):
            z = F.relu(self.entry_flow_conv1_1_BN(
                self.entry_flow_conv1_1(z, ctx), ctx))
            return F.relu(self.entry_flow_conv1_2_BN(
                self.entry_flow_conv1_2(z, ctx), ctx))

        y = _run(stem, ctx, x)
        feats = [y]
        for prefix, _, skip, _, _, act in self.blocks:
            if prefix == "exit_flow_block1":
                feats.append(y)
            y, tap = _run(lambda z, p=prefix, s=skip, a=act:
                          self._block(z, p, s, a, ctx), ctx, y)
            if prefix == "entry_flow_block2":
                feats += [tap, y]
        feats.append(y)
        return feats


class AlignedDeepLabDecoder(nn.Module):
    rates = (6, 12, 18)

    def __init__(self, enc: Sequence[int], c: int = 256):
        super().__init__()
        cin = enc[4]
        self.image_pooling = RConv(cin, c, 1)
        self.image_pooling_BN = RBN(c, 0.99, 1e-5)
        self.aspp0 = RConv(cin, c, 1)
        self.aspp0_BN = RBN(c, 0.99, 1e-5)
        for i, r in enumerate(self.rates):
            add_sep(self, cin, c, f"aspp{i + 1}", rate=r, eps=1e-5)
        self.concat_projection = RConv(c * (len(self.rates) + 2), c, 1)
        self.concat_projection_BN = RBN(c, 0.99, 1e-5)
        self.feature_projection0 = RConv(enc[1], 48, 1)
        self.feature_projection0_BN = RBN(48, 0.99, 1e-5)
        add_sep(self, c + 48, c, "decoder_conv0", eps=1e-5)
        add_sep(self, c, c, "decoder_conv1", eps=1e-5)
        self.out_channels = c
        self.keep_mask: Optional[Tensor] = None   # dropout 0.1's, bound

    def forward(self, feats: List[Tensor], ctx: Ctx) -> Tensor:
        x, skip = feats[4], feats[1]

        def aspp(x):
            b4 = x.mean(dim=(2, 3), keepdim=True)
            b4 = F.relu(self.image_pooling_BN(self.image_pooling(b4, ctx),
                                              ctx))
            branches = [b4.expand(-1, -1, x.shape[2], x.shape[3]),
                        F.relu(self.aspp0_BN(self.aspp0(x, ctx), ctx))]
            for i in range(len(self.rates)):
                branches.append(sep(self, x, f"aspp{i + 1}", ctx, True))
            y = self.concat_projection(torch.cat(branches, 1), ctx)
            return F.relu(self.concat_projection_BN(y, ctx))

        y = _run(aspp, ctx, x)
        if ctx.train and self.keep_mask is not None:
            y = torch.where(self.keep_mask, y / 0.9, torch.zeros_like(y))

        def tail(y, skip):
            y = F.interpolate(y, size=skip.shape[2:], mode="bilinear",
                              align_corners=False)
            low = F.relu(self.feature_projection0_BN(
                self.feature_projection0(skip, ctx), ctx))
            y = sep(self, torch.cat([y, low], 1), "decoder_conv0", ctx, True)
            return sep(self, y, "decoder_conv1", ctx, True)

        return _run(tail, ctx, y, skip)


# ---------------------------------------------------------------------------

class Segmenter(nn.Module):
    """encoder → decoder → 1x1 logits head in float32; a sub-resolution
    decoder's logits resized bilinearly to the input size."""

    def __init__(self, arch: str, classes: int = 1):
        super().__init__()
        if arch == "unet-resnet34":
            self.encoder = ResNet34Encoder()
            self.decoder = UnetDecoder(self.encoder.out_channels)
        elif arch == "deeplabv3-xception_aligned":
            self.encoder = AlignedXception65()
            self.decoder = AlignedDeepLabDecoder(self.encoder.out_channels)
        else:
            raise KeyError(f"no reference for {arch!r}")
        self.logits_conv = RConv(self.decoder.out_channels, classes, 1,
                                 bias=True)
        for name, m in self.named_modules():
            if isinstance(m, RBN):
                m.key = name + "."
        self.remat = False
        self.new_stats: Dict[str, Tensor] = {}

    def forward(self, x: Tensor, train: bool = False,
                quant: Optional[Callable] = None) -> Tensor:
        ctx = Ctx(train, quant)
        ctx.remat = self.remat
        h, w = x.shape[1], x.shape[2]
        feats = self.encoder(x.permute(0, 3, 1, 2).contiguous(), ctx)
        y = self.decoder(feats, ctx)
        logits = self.logits_conv(y, ctx)
        if logits.shape[2:] != (h, w):
            logits = F.interpolate(logits, size=(h, w), mode="bilinear",
                                   align_corners=False)
        self.new_stats = ctx.stats
        return logits.permute(0, 2, 3, 1)


def conv_fan_in(shape: Sequence[int]) -> int:
    return int(math.prod(shape[1:]))
