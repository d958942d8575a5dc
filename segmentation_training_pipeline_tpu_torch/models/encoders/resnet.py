"""ResNet, ResNeXt, SE-ResNet and SENet-154 encoders (He et al. 2016;
Xie et al. 2017; Hu et al. 2018), post-activation, and the
pre-activation Keras graph.

Counterpart of ``segmentation_training_pipeline_tpu/models/encoders/
resnet.py`` (``BasicBlock``, ``Bottleneck``, ``ResNetEncoder``,
``SEResNetEncoder``, ``PreactResNetEncoder``, ``SENet154Bottleneck``,
``SENet154Encoder``).  Feature taps: C1 = post-stem ReLU (stride 2),
C2..C5 = the four residual stages (strides 4/8/16/32); the preact graph
taps the next stage's pre-activation instead.  Submodule names follow the
flax tree (``stem_conv``, ``stage2_block1/conv1``, ``…/se/reduce``,
``stage2_unit1_bn1`` …) so ``models.bridge`` maps weights by name.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import BatchNorm, Conv, SEBlock, max_pool_same

Tensor = torch.Tensor


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, features: int, stride: int,
                 use_se: bool = False):
        super().__init__()
        self.conv1 = Conv(in_channels, features, 3, stride)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv(features, features, 3)
        self.bn2 = BatchNorm(features)
        if use_se:
            # canonical SENet: reduction 16, ReLU hidden activation
            self.se = SEBlock(features, max(features // 16, 1), act="relu")
        self.has_downsample = stride != 1 or in_channels != features
        if self.has_downsample:
            self.downsample = Conv(in_channels, features, 1, stride)
            self.bn_down = BatchNorm(features)

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        if hasattr(self, "se"):
            y = self.se(y)
        residual = x
        if self.has_downsample:
            residual = self.bn_down(self.downsample(x), train)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """1×1 → 3×3 (``groups``, inner width ``features·width_factor``) → 1×1
    to 4·features.  The stride sits on the 3×3 (torchvision "v1.5") or,
    with ``stride_on_conv1``, on the first 1×1 (the Caffe/Cadene
    se_resnet graph): the weight shapes are the same either way."""

    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int,
                 use_se: bool = False, groups: int = 1, width_factor: int = 1,
                 stride_on_conv1: bool = False):
        super().__init__()
        inner = features * width_factor
        out = features * 4
        s1, s2 = (stride, 1) if stride_on_conv1 else (1, stride)
        self.conv1 = Conv(in_channels, inner, 1, s1)
        self.bn1 = BatchNorm(inner)
        self.conv2 = Conv(inner, inner, 3, s2, groups=groups)
        self.bn2 = BatchNorm(inner)
        self.conv3 = Conv(inner, out, 1)
        self.bn3 = BatchNorm(out)
        if use_se:
            self.se = SEBlock(out, max(out // 16, 1), act="relu")
        self.has_downsample = stride != 1 or in_channels != out
        if self.has_downsample:
            self.downsample = Conv(in_channels, out, 1, stride)
            self.bn_down = BatchNorm(out)

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        if hasattr(self, "se"):
            y = self.se(y)
        residual = x
        if self.has_downsample:
            residual = self.bn_down(self.downsample(x), train)
        return F.relu(y + residual)


class ResNetEncoder(nn.Module):
    use_se = False

    def __init__(self, in_channels: int = 3,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 bottleneck: bool = False, width: int = 64,
                 groups: int = 1, width_factor: int = 1,
                 stride_on_conv1: bool = False):
        super().__init__()
        block = Bottleneck if bottleneck else BasicBlock
        kw = dict(groups=groups, width_factor=width_factor,
                  stride_on_conv1=stride_on_conv1) if bottleneck else {}
        self.stem_conv = Conv(in_channels, width, 7, 2)
        self.stem_bn = BatchNorm(width)
        self.block_names: List[List[str]] = []
        cin = width
        for stage, n_blocks in enumerate(stage_sizes):
            features = width * (2 ** stage)
            names = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                name = f"stage{stage + 1}_block{b + 1}"
                self.add_module(name, block(cin, features, stride,
                                            use_se=self.use_se, **kw))
                names.append(name)
                cin = features * block.expansion
            self.block_names.append(names)
        self.out_channels = [width] + [width * 2 ** s * block.expansion
                                       for s in range(len(stage_sizes))]

    def forward(self, x: Tensor, train: bool = False) -> List[Tensor]:
        y = F.relu(self.stem_bn(self.stem_conv(x), train))
        feats = [y]                                   # C1, stride 2
        y = max_pool_same(y, 3, 2)
        for names in self.block_names:
            for name in names:
                y = getattr(self, name)(y, train)
            feats.append(y)                           # C2..C5
        return feats


class SEResNetEncoder(ResNetEncoder):
    use_se = True


def _keras_bn(channels: int, scale: bool = True) -> BatchNorm:
    """Keras BatchNormalization's defaults: momentum 0.99, eps 1e-3."""
    return BatchNorm(channels, 0.99, 1e-3, scale)


class PreactResNetEncoder(nn.Module):
    """The classification_models (Keras) pre-activation ResNet graph:
    ``bn_data`` (no scale) on the input, a 7×7/2 ``conv0`` + ``bn0``, then
    units of BN → ReLU before each conv, the shortcut conv of each stage's
    first unit reading the PRE-ACTIVATED tensor, and a final ``bn1`` +
    ReLU.  ``bottleneck`` builds its 1×1 → 3×3 (stride) → 1×1·4 units,
    ``se`` adds ChannelSE (``…_se``) to each unit's branch.  Taps: C1 =
    ``relu0``, C2..C4 = ``stage{2,3,4}_unit1_relu1``, C5 = the final ReLU;
    the widths equal the post-activation encoder's.  Flat names, as the
    Keras layers."""

    def __init__(self, in_channels: int = 3,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 bottleneck: bool = False, se: bool = False):
        super().__init__()
        self.bottleneck = bottleneck
        self.bn_data = _keras_bn(in_channels, scale=False)
        self.conv0 = Conv(in_channels, width, 7, 2)
        self.bn0 = _keras_bn(width)
        self.units: List[List[str]] = []
        cin = width
        for stage, n_units in enumerate(stage_sizes):
            features = width * (2 ** stage)
            out = features * 4 if bottleneck else features
            names = []
            for b in range(n_units):
                u = f"stage{stage + 1}_unit{b + 1}"
                s = 2 if (b == 0 and stage > 0) else 1
                self.add_module(f"{u}_bn1", _keras_bn(cin))
                if b == 0:
                    self.add_module(f"{u}_sc", Conv(cin, out, 1, s))
                if bottleneck:
                    self.add_module(f"{u}_conv1", Conv(cin, features, 1))
                    self.add_module(f"{u}_bn2", _keras_bn(features))
                    self.add_module(f"{u}_conv2",
                                    Conv(features, features, 3, s))
                    self.add_module(f"{u}_bn3", _keras_bn(features))
                    self.add_module(f"{u}_conv3", Conv(features, out, 1))
                else:
                    self.add_module(f"{u}_conv1", Conv(cin, features, 3, s))
                    self.add_module(f"{u}_bn2", _keras_bn(features))
                    self.add_module(f"{u}_conv2", Conv(features, features, 3))
                if se:
                    self.add_module(f"{u}_se", SEBlock(out, max(out // 16, 1),
                                                       act="relu"))
                names.append(u)
                cin = out
            self.units.append(names)
        self.bn1 = _keras_bn(cin)
        self.out_channels = [width] + [
            width * 2 ** s * (4 if bottleneck else 1)
            for s in range(len(stage_sizes))]

    def forward(self, x: Tensor, train: bool = False) -> List[Tensor]:
        m = self._modules
        y = self.bn_data(x, train)
        y = F.relu(self.bn0(self.conv0(y), train))
        feats = [y]                                   # C1 = relu0
        y = max_pool_same(y, 3, 2)
        for stage, names in enumerate(self.units):
            for b, u in enumerate(names):
                h = F.relu(m[f"{u}_bn1"](y, train))
                if b == 0 and stage > 0:
                    feats.append(h)                   # stageN_unit1_relu1
                sc = m[f"{u}_sc"](h) if b == 0 else y
                h = m[f"{u}_conv1"](h)
                h = m[f"{u}_conv2"](F.relu(m[f"{u}_bn2"](h, train)))
                if self.bottleneck:
                    h = m[f"{u}_conv3"](F.relu(m[f"{u}_bn3"](h, train)))
                if f"{u}_se" in m:
                    h = m[f"{u}_se"](h)
                y = h + sc
        feats.append(F.relu(self.bn1(y, train)))      # C5
        return feats


class SENet154Bottleneck(nn.Module):
    """Cadene ``SEBottleneck``: 1×1 → 2p, grouped-64 3×3 (stride) → 4p,
    1×1 4p → 4p, SE (r = 16), and a ``down_kernel``×``down_kernel``
    downsample conv where the shape changes."""

    def __init__(self, in_channels: int, features: int, stride: int,
                 groups: int = 64, down_kernel: int = 1):
        super().__init__()
        out = features * 4
        self.conv1 = Conv(in_channels, features * 2, 1)
        self.bn1 = BatchNorm(features * 2)
        self.conv2 = Conv(features * 2, out, 3, stride, groups=groups)
        self.bn2 = BatchNorm(out)
        self.conv3 = Conv(out, out, 1)
        self.bn3 = BatchNorm(out)
        self.se = SEBlock(out, max(out // 16, 1), act="relu")
        self.has_downsample = stride != 1 or in_channels != out
        if self.has_downsample:
            self.downsample = Conv(in_channels, out, down_kernel, stride)
            self.bn_down = BatchNorm(out)

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.se(self.bn3(self.conv3(y), train))
        residual = x
        if self.has_downsample:
            residual = self.bn_down(self.downsample(x), train)
        return F.relu(y + residual)


class SENet154Encoder(nn.Module):
    """Cadene senet154: a deep 3-conv stem (64-64-128) and SEBottleneck
    stages at cardinality 64, kernel-3 downsamples after stage 1.  Taps:
    C1 128 channels (stride 2), C2..C5 256/512/1024/2048."""

    def __init__(self, in_channels: int = 3,
                 stage_sizes: Sequence[int] = (3, 8, 36, 3)):
        super().__init__()
        cin = in_channels
        for i, (width, stride) in enumerate([(64, 2), (64, 1), (128, 1)]):
            self.add_module(f"stem_conv{i + 1}", Conv(cin, width, 3, stride))
            self.add_module(f"stem_bn{i + 1}", BatchNorm(width))
            cin = width
        self.block_names: List[List[str]] = []
        for stage, n_blocks in enumerate(stage_sizes):
            features = 64 * (2 ** stage)
            names = []
            for b in range(n_blocks):
                name = f"stage{stage + 1}_block{b + 1}"
                self.add_module(name, SENet154Bottleneck(
                    cin, features, 2 if (b == 0 and stage > 0) else 1,
                    down_kernel=1 if stage == 0 else 3))
                names.append(name)
                cin = features * 4
            self.block_names.append(names)
        self.out_channels = [128] + [256 * 2 ** s
                                     for s in range(len(stage_sizes))]

    def forward(self, x: Tensor, train: bool = False) -> List[Tensor]:
        m = self._modules
        y = x
        for i in range(1, 4):
            y = F.relu(m[f"stem_bn{i}"](m[f"stem_conv{i}"](y), train))
        feats = [y]                                   # C1, stride 2
        y = max_pool_same(y, 3, 2)
        for names in self.block_names:
            for name in names:
                y = m[name](y, train)
            feats.append(y)                           # C2..C5
        return feats
