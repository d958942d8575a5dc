"""InceptionV3 (Szegedy et al. 2016) and Inception-ResNet-V2 (Szegedy et
al. 2017) encoders.

Counterpart of ``segmentation_training_pipeline_tpu/models/encoders/
inception.py``: every conv and pool SAME-padded (the canonical graphs pad
VALID), so the taps land at strides 2/4/8/16/32; channel counts as the
canonical graphs.  The unit is ``_CBR`` (conv → BN with eps 1e-3 →
ReLU, names ``conv`` and ``bn``), with (1, 7), (7, 1), (1, 3) and
(3, 1) kernels.  InceptionV3's branch pools divide by the full 3×3 window
(``count_include_pad=True``, torchvision), Inception-ResNet-V2's mixed_5b
pool by the real inputs (``False``, timm).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from ..layers import ConvBN, Conv, avg_pool_same, max_pool_same

Tensor = torch.Tensor


def _CBR(in_channels: int, features: int, kernel=(3, 3),
         stride: int = 1) -> ConvBN:
    """conv → BN → ReLU, the Inception unit."""
    return ConvBN(in_channels, features, kernel, stride, eps=1e-3)


def add_branches(owner: nn.Module, in_channels: int, chains):
    """Register parallel chains of ``_CBR`` units on ``owner`` (flat, as
    the flax names) → (the chains' plan, their concatenated width).
    ``chains``: per branch, its (name, features, kernel, stride) units in
    order; a branch that starts with "avg" ("avg_excl") reads the 3×3 SAME
    average pool of the input with (without) the padding counted, and one
    that is "max" alone is the 3×3/2 SAME max-pool."""
    plan, width = [], 0
    for chain in chains:
        pool = chain[0] if isinstance(chain[0], str) else None
        units, c = [], in_channels
        for name, feats, kernel, stride in chain[1 if pool else 0:]:
            owner.add_module(name, _CBR(c, feats, kernel, stride))
            units.append(name)
            c = feats
        plan.append((pool, units))
        width += c
    return plan, width


def run_branches(owner: nn.Module, plan, x: Tensor, train: bool) -> Tensor:
    outs = []
    for pool, units in plan:
        y = x
        if pool == "max":
            y = max_pool_same(x, 3, 2)
        elif pool is not None:
            y = avg_pool_same(x, 3, 1, count_include_pad=pool == "avg")
        for name in units:
            y = owner._modules[name](y, train)
        outs.append(y)
    return torch.cat(outs, dim=1)


class _Branches(nn.Module):
    """A block of parallel ``_CBR`` chains (``add_branches``)."""

    def __init__(self, in_channels: int, chains):
        super().__init__()
        self.plan, self.out_channels = add_branches(self, in_channels,
                                                    chains)

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        return run_branches(self, self.plan, x, train)


def InceptionA(c: int, pool_features: int) -> _Branches:
    return _Branches(c, [
        [("b1x1", 64, 1, 1)],
        [("b5_1", 48, 1, 1), ("b5_2", 64, 5, 1)],
        [("b3_1", 64, 1, 1), ("b3_2", 96, 3, 1), ("b3_3", 96, 3, 1)],
        ["avg", ("bp", pool_features, 1, 1)]])


def ReductionA(c: int) -> _Branches:
    return _Branches(c, [
        [("b3", 384, 3, 2)],
        [("bd_1", 64, 1, 1), ("bd_2", 96, 3, 1), ("bd_3", 96, 3, 2)],
        ["max"]])


def InceptionB(c: int, c7: int) -> _Branches:
    return _Branches(c, [
        [("b1x1", 192, 1, 1)],
        [("b7_1", c7, 1, 1), ("b7_2", c7, (1, 7), 1),
         ("b7_3", 192, (7, 1), 1)],
        [("bd_1", c7, 1, 1), ("bd_2", c7, (7, 1), 1), ("bd_3", c7, (1, 7), 1),
         ("bd_4", c7, (7, 1), 1), ("bd_5", 192, (1, 7), 1)],
        ["avg", ("bp", 192, 1, 1)]])


def ReductionB(c: int) -> _Branches:
    return _Branches(c, [
        [("b3_1", 192, 1, 1), ("b3_2", 320, 3, 2)],
        [("b7_1", 192, 1, 1), ("b7_2", 192, (1, 7), 1),
         ("b7_3", 192, (7, 1), 1), ("b7_4", 192, 3, 2)],
        ["max"]])


class InceptionC(nn.Module):
    """The 8×8-grid block: its 3×3 branches fork into (1, 3) and (3, 1)."""

    def __init__(self, c: int):
        super().__init__()
        for name, cin, feats, kernel in [
                ("b1x1", c, 320, 1), ("b3_1", c, 384, 1),
                ("b3_2a", 384, 384, (1, 3)), ("b3_2b", 384, 384, (3, 1)),
                ("bd_1", c, 448, 1), ("bd_2", 448, 384, 3),
                ("bd_3a", 384, 384, (1, 3)), ("bd_3b", 384, 384, (3, 1)),
                ("bp", c, 192, 1)]:
            self.add_module(name, _CBR(cin, feats, kernel))
        self.out_channels = 320 + 4 * 384 + 192

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        m = self._modules
        b3 = m["b3_1"](x, train)
        bd = m["bd_2"](m["bd_1"](x, train), train)
        return torch.cat([
            m["b1x1"](x, train), m["b3_2a"](b3, train), m["b3_2b"](b3, train),
            m["bd_3a"](bd, train), m["bd_3b"](bd, train),
            m["bp"](avg_pool_same(x, 3, 1), train)], dim=1)


def _stem(owner: nn.Module, in_channels: int) -> None:
    for name, cin, feats, stride, kernel in [
            ("stem1", in_channels, 32, 2, 3), ("stem2", 32, 32, 1, 3),
            ("stem3", 32, 64, 1, 3), ("stem4", 64, 80, 1, 1),
            ("stem5", 80, 192, 1, 3)]:
        owner.add_module(name, _CBR(cin, feats, kernel, stride))


def _run_stem(owner: nn.Module, x: Tensor, train: bool) -> List[Tensor]:
    """stem1-3 → C1 (64, stride 2); max-pool, stem4-5 → C2 (192, stride
    4); → [C1, C2]."""
    y = owner.stem3(owner.stem2(owner.stem1(x, train), train), train)
    c2 = owner.stem5(owner.stem4(max_pool_same(y, 3, 2), train), train)
    return [y, c2]


class InceptionV3Encoder(nn.Module):
    def __init__(self, in_channels: int = 3):
        super().__init__()
        _stem(self, in_channels)
        c = 192
        blocks = [InceptionA(c, 32)]
        for pf in (64, 64):
            blocks.append(InceptionA(blocks[-1].out_channels, pf))
        blocks.append(ReductionA(blocks[-1].out_channels))
        for c7 in (128, 160, 160, 192):
            blocks.append(InceptionB(blocks[-1].out_channels, c7))
        blocks.append(ReductionB(blocks[-1].out_channels))
        blocks.append(InceptionC(blocks[-1].out_channels))
        blocks.append(InceptionC(blocks[-1].out_channels))
        for i, block in enumerate(blocks):
            self.add_module(f"mixed{i}", block)
        self.out_channels = [64, 192, 288, 768, 2048]

    def forward(self, x: Tensor, train: bool = False) -> List[Tensor]:
        feats = _run_stem(self, x, train)
        y = max_pool_same(feats[-1], 3, 2)
        for i in range(11):
            y = self._modules[f"mixed{i}"](y, train)
            if i in (2, 7, 10):
                feats.append(y)                       # C3, C4, C5
        return feats


class _IRBlock(_Branches):
    """Residual Inception block (``kind`` "35", "17" or "8"): its branches
    concatenated, a biased 1×1 ``up`` back to the input width, scaled by
    ``scale`` and added; ReLU unless ``relu=False`` (the final block8)."""

    _SPECS = {
        "35": [[("b0", 32, 1, 1)],
               [("b1_1", 32, 1, 1), ("b1_2", 32, 3, 1)],
               [("b2_1", 32, 1, 1), ("b2_2", 48, 3, 1), ("b2_3", 64, 3, 1)]],
        "17": [[("b0", 192, 1, 1)],
               [("b1_1", 128, 1, 1), ("b1_2", 160, (1, 7), 1),
                ("b1_3", 192, (7, 1), 1)]],
        "8": [[("b0", 192, 1, 1)],
              [("b1_1", 192, 1, 1), ("b1_2", 224, (1, 3), 1),
               ("b1_3", 256, (3, 1), 1)]],
    }

    def __init__(self, c: int, kind: str, scale: float, relu: bool = True):
        super().__init__(c, self._SPECS[kind])
        self.scale = scale
        self.relu = relu
        self.up = Conv(self.out_channels, c, 1, bias=True)

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        y = x + self.scale * self.up(super().forward(x, train))
        return torch.relu(y) if self.relu else y


class InceptionResNetV2Encoder(nn.Module):
    def __init__(self, in_channels: int = 3):
        super().__init__()
        _stem(self, in_channels)
        self.m5b, _ = add_branches(self, 192, [
            [("m5b_b0", 96, 1, 1)],
            [("m5b_b1_1", 48, 1, 1), ("m5b_b1_2", 64, 5, 1)],
            [("m5b_b2_1", 64, 1, 1), ("m5b_b2_2", 96, 3, 1),
             ("m5b_b2_3", 96, 3, 1)],
            ["avg_excl", ("m5b_bp", 64, 1, 1)]])
        self.m6a, _ = add_branches(self, 320, [
            [("m6a_b0", 384, 3, 2)],
            [("m6a_b1_1", 256, 1, 1), ("m6a_b1_2", 256, 3, 1),
             ("m6a_b1_3", 384, 3, 2)],
            ["max"]])
        self.m7a, _ = add_branches(self, 1088, [
            [("m7a_b0_1", 256, 1, 1), ("m7a_b0_2", 384, 3, 2)],
            [("m7a_b1_1", 256, 1, 1), ("m7a_b1_2", 288, 3, 2)],
            [("m7a_b2_1", 256, 1, 1), ("m7a_b2_2", 288, 3, 1),
             ("m7a_b2_3", 320, 3, 2)],
            ["max"]])
        for prefix, n, c, kind, scale in [("block35", 10, 320, "35", 0.17),
                                          ("block17", 20, 1088, "17", 0.10),
                                          ("block8", 10, 2080, "8", 0.20)]:
            for i in range(n):
                last = prefix == "block8" and i == n - 1
                # the canonical final block8: scale 1.0, no activation
                self.add_module(f"{prefix}_{i + 1}", _IRBlock(
                    c, kind, 1.0 if last else scale, relu=not last))
        self.conv7b = _CBR(2080, 1536, 1)
        self.out_channels = [64, 192, 320, 1088, 1536]

    def _repeat(self, y: Tensor, prefix: str, n: int, train: bool):
        for i in range(1, n + 1):
            y = self._modules[f"{prefix}_{i}"](y, train)
        return y

    def forward(self, x: Tensor, train: bool = False) -> List[Tensor]:
        feats = _run_stem(self, x, train)
        y = run_branches(self, self.m5b, max_pool_same(feats[-1], 3, 2),
                         train)
        y = self._repeat(y, "block35", 10, train)
        feats.append(y)                               # C3, stride 8
        y = self._repeat(run_branches(self, self.m6a, y, train), "block17",
                         20, train)
        feats.append(y)                               # C4, stride 16
        y = self._repeat(run_branches(self, self.m7a, y, train), "block8",
                         10, train)
        feats.append(self.conv7b(y, train))           # C5, stride 32
        return feats
