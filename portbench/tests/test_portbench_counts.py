"""``counts.py`` against a hand-counted convolution net, and the counts
frozen in every configuration file against a fresh count."""

import json
from pathlib import Path

import pytest
import torch
import torch.nn as nn

from portbench import counts as CN
from portbench.reference.models import Ctx, RBN, RConv

HERE = Path(__file__).resolve().parents[1]


class Tiny(nn.Module):
    """3 → 8 (3x3 / 2) → BN → depthwise 3x3 → 1x1 to 2 (the head)."""

    def __init__(self):
        super().__init__()
        self.a = RConv(3, 8, 3, 2)
        self.bn = RBN(8)
        self.dw = RConv(8, 8, 3, groups=8)
        self.head = RConv(8, 2, 1, bias=True)

    def forward(self, x, train=False):
        ctx = Ctx(train)
        y = self.bn(self.a(x.permute(0, 3, 1, 2), ctx), ctx)
        return self.head(self.dw(y, ctx), ctx)


def test_hand_counted():
    with torch.device("meta"):
        m = Tiny()
    c = CN.count_model(m, m.head, 16, 16)
    # 8x8 outputs: 2·64·8·(3·9); 2·64·8·(1·9); 2·64·2·8
    assert [r[0] for r in c["conv"]] == [2 * 64 * 8 * 27, 2 * 64 * 8 * 9,
                                         2 * 64 * 2 * 8]
    assert [r[1:4] for r in c["conv"]] == [[768, 512, 216], [512, 512, 72],
                                           [512, 128, 16]]
    assert [r[4] for r in c["conv"]] == [0, 1, 0]         # depthwise
    assert [r[5] for r in c["conv"]] == [0, 1, 1]         # input gradient
    assert [r[6] for r in c["conv"]] == [2, 2, 4]         # head in f32
    assert c["bn"] == [512]
    assert c["train_flops"] == 3 * c["forward_flops"] == 3 * sum(
        r[0] for r in c["conv"])


@pytest.mark.parametrize("name", sorted(p.stem for p in
                                        (HERE / "configs").glob("*.json")))
def test_frozen_counts(name):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    assert cfg["counts"], "a configuration file freezes its counts"
    for key, frozen in cfg["counts"].items():
        h, w = (int(v) for v in key.split("x"))
        assert frozen == CN.count(cfg["reference"], h, w)


def test_unet_resnet34_512_flops():
    c = CN.count("unet-resnet34", 512, 512)
    assert len(c["conv"]) == 47 and len(c["bn"]) == 46
    assert 60e9 < c["forward_flops"] < 65e9
