"""architecture + backbone → SegmentationModel (PyTorch).

Counterpart of ``segmentation_training_pipeline_tpu/models/factory.py`` for
the Unet + resnet34 pairing.  The model takes NHWC input and returns NHWC
float32 **logits**; losses and metrics apply the activation themselves.
Inside, it runs NCHW with channels-last strides, under autocast in the
compute dtype (bfloat16 by default), and the 1×1 logits head runs in f32
on an f32 cast of the decoder output (a matmul, which PyTorch keeps in full
f32 unless TF32 is switched on for matmuls).

Parameter names follow the flax tree: ``encoder.*``, ``decoder.*``,
``logits_conv.*`` (see ``models.bridge``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from .decoders.unet import UnetDecoder
from .encoders.resnet import SPECS, ResNetEncoder
from .layers import BatchNorm, Conv

Tensor = torch.Tensor

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
_AUTOCAST = (torch.bfloat16, torch.float16)   # float32/64 run as they are
ARCHITECTURES = {"unet"}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to the torch "
                               "package")


class SegmentationModel(nn.Module):
    """encoder → decoder → dropout → 1×1 head (f32 logits)."""

    def __init__(self, architecture: str = "Unet", backbone: str = "resnet34",
                 classes: int = 1, dropout: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, in_channels: int = 3):
        super().__init__()
        if architecture.lower() not in ARCHITECTURES:
            raise _not_ported(f"architecture {architecture!r}")
        if backbone.lower() not in SPECS:
            raise _not_ported(f"backbone {backbone!r}")
        self.architecture = architecture
        self.backbone = backbone
        self.classes = classes
        self.dropout = dropout
        self.dtype = dtype
        self.encoder = ResNetEncoder(in_channels, **SPECS[backbone.lower()])
        self.decoder = UnetDecoder(self.encoder.out_channels)
        self.logits_conv = Conv(self.decoder.out_channels, classes, 1,
                                bias=True)

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        """x (B, H, W, C) → logits (B, H, W, classes) float32."""
        x = x.permute(0, 3, 1, 2)          # NCHW view, channels-last strides
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype in _AUTOCAST):
            y = self.decoder(self.encoder(x.to(self.dtype), train), train)
            if self.dropout > 0:
                y = F.dropout(y, self.dropout, training=train)
        y = y.float().permute(0, 2, 3, 1)
        w = self.logits_conv.weight[:, :, 0, 0]
        return F.linear(y, w.float(), self.logits_conv.bias.float())


def create_model(architecture: str, backbone: str, classes: int = 1,
                 dropout: float = 0.0, dtype: str = "bfloat16",
                 remat: bool = False, in_channels: int = 3,
                 encoder_variant: str = "") -> SegmentationModel:
    if remat:
        raise _not_ported("remat")
    if encoder_variant:
        raise _not_ported(f"encoder_variant {encoder_variant!r}")
    return SegmentationModel(architecture, backbone, classes, dropout,
                             _DTYPES[dtype], in_channels)


def init_model(model: SegmentationModel, seed: int = 0,
               device="cuda") -> SegmentationModel:
    """Initialise every parameter from ``seed`` with flax's default
    distributions (drawn on the CPU, so the values do not depend on the
    device) and move the model to ``device``; returns the model."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (Conv, BatchNorm)):
            m.reset_parameters(gen)
    return model.to(device)


def model_variables(model: SegmentationModel
                    ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """(params, batch_stats) as name → tensor dicts (detached copies)."""
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = {n: b.detach().clone() for n, b in model.named_buffers()}
    return params, stats


def apply_model(model: SegmentationModel, params: Dict[str, Tensor],
                batch_stats: Dict[str, Tensor], x: Tensor,
                train: bool = False):
    """Functional forward with explicit variables.  Eval mode → logits;
    train mode → (logits, updated batch_stats) with flax's BN rule."""
    logits = functional_call(model, (params, batch_stats), (x,),
                             {"train": train})
    if not train:
        return logits
    new_stats = dict(batch_stats)
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm) and m.updated is not None:
            new_stats[f"{name}.running_mean"] = m.updated[0]
            new_stats[f"{name}.running_var"] = m.updated[1]
            m.updated = None
    return logits, new_stats


def apply_activation(logits: Tensor, activation: str) -> Tensor:
    if activation == "softmax":
        return torch.softmax(logits, dim=-1)
    if activation == "sigmoid":
        return torch.sigmoid(logits)
    return logits
