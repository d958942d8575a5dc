"""architecture + backbone → SegmentationModel (PyTorch).

Counterpart of ``segmentation_training_pipeline_tpu/models/factory.py``:
every decoder (Unet, FPN, Linknet, PSPNet, DeepLabV3+ and their aliases)
and encoder (``encoders.ENCODERS``), the ``keras-preact`` encoder variant
and ``remat``.  The model takes NHWC input and returns NHWC
float32 **logits**; losses and metrics apply the activation themselves.
Inside, it runs NCHW with channels-last strides, under autocast in the
compute dtype (bfloat16 by default), and the 1×1 logits head runs in f32 on
an f32 cast of the decoder output (a matmul, which PyTorch keeps in full
f32 unless TF32 is switched on for matmuls).  A decoder that stops short
of the input resolution (FPN and DeepLab, stride 4; PSPNet, stride 8) gets
its f32 logits resized bilinearly to the input size, as the reference
does.  ``xception_aligned`` pairs as in JAX: with DeepLab it runs at
output stride 16 under bonlime's aligned decoder, with any other decoder
at stride 32.

Parameter names follow the flax tree: ``encoder.*``, ``decoder.*``,
``logits_conv.*`` (see ``models.bridge``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from .decoders.deeplab import AlignedDeepLabDecoder, DeepLabV3PlusDecoder
from .decoders.fpn import FPNDecoder
from .decoders.linknet import LinknetDecoder
from .decoders.pspnet import PSPDecoder
from .decoders.unet import UnetDecoder
from .encoders import ENCODERS
from .encoders.resnet import PreactResNetEncoder
from .layers import BatchNorm, Conv, DropPath, resize_to, run_part
from .pretrained import resolve_pretrained_path

Tensor = torch.Tensor

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
_AUTOCAST = (torch.bfloat16, torch.float16)   # float32/64 run as they are
# the JAX table's names and aliases
DECODERS = {"unet": UnetDecoder, "fpn": FPNDecoder,
            "linknet": LinknetDecoder, "pspnet": PSPDecoder,
            "psp": PSPDecoder, "deeplabv3": DeepLabV3PlusDecoder,
            "deeplabv3+": DeepLabV3PlusDecoder,
            "deeplabv3plus": DeepLabV3PlusDecoder,
            "deeplab": DeepLabV3PlusDecoder}


class SegmentationModel(nn.Module):
    """encoder → decoder → dropout → 1×1 head (f32 logits).

    ``encoder_variant="keras-preact"`` swaps a backbone of
    ``_PREACT_BACKBONES`` for the pre-activation classification_models
    graph that reference-era Keras checkpoints were trained with.
    ``remat`` recomputes the encoder's and the decoder's activations in
    the backward pass instead of keeping them (Unet: per decoder stage),
    as the JAX package's ``nn.remat``; the numbers do not change."""

    def __init__(self, architecture: str = "Unet", backbone: str = "resnet34",
                 classes: int = 1, dropout: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, in_channels: int = 3,
                 remat: bool = False, encoder_variant: str = ""):
        super().__init__()
        arch, name = architecture.lower(), backbone.lower()
        if arch not in DECODERS:
            raise KeyError(f"unknown architecture {architecture!r}; known: "
                           f"{sorted(DECODERS)}")
        if name not in ENCODERS:
            raise KeyError(f"unknown backbone {backbone!r}; known: "
                           f"{sorted(ENCODERS)}")
        enc_cls, enc_kw = ENCODERS[name]
        enc_kw = dict(enc_kw)
        dec_cls = DECODERS[arch]
        if name == "xception_aligned":
            # the bonlime pairing: stride 16 under the aligned decoder,
            # the generic stride-32 layout (same weights) otherwise
            if dec_cls is DeepLabV3PlusDecoder:
                dec_cls = AlignedDeepLabDecoder
                enc_kw["output_stride"] = 16
            else:
                enc_kw["output_stride"] = 32
        if encoder_variant == "keras-preact":
            if name not in _PREACT_BACKBONES:
                raise KeyError(
                    "encoder_variant='keras-preact' only applies to "
                    f"{sorted(_PREACT_BACKBONES)}, got {backbone!r}")
            enc_cls = PreactResNetEncoder
            enc_kw = dict(stage_sizes=enc_kw["stage_sizes"],
                          bottleneck=enc_kw.get("bottleneck", False),
                          se=name.startswith("seresnet"))
        elif encoder_variant:
            raise KeyError(f"unknown encoder_variant {encoder_variant!r}")
        self.architecture = architecture
        self.backbone = backbone
        self.classes = classes
        self.dropout = dropout
        self.dtype = dtype
        self.remat = remat
        self.encoder_variant = encoder_variant
        self.encoder = enc_cls(in_channels, **enc_kw)
        self.decoder = dec_cls(self.encoder.out_channels,
                               **({"remat": remat} if arch == "unet" else {}))
        self.logits_conv = Conv(self.decoder.out_channels, classes, 1,
                                bias=True)

    def forward(self, x: Tensor, train: bool = False,
                drop_masks: Optional[Dict[str, Tensor]] = None) -> Tensor:
        """x (B, H, W, C) → logits (B, H, W, classes) float32.
        ``drop_masks``: keep masks bound to the stochastic-depth and
        dropout layers of those names for this call."""
        x = x.permute(0, 3, 1, 2)          # NCHW view, channels-last strides
        # Unet checkpoints per stage inside its decoder
        block_remat = self.remat and not isinstance(self.decoder,
                                                    UnetDecoder)
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype in _AUTOCAST):
            feats = run_part(self.encoder, "encoder", drop_masks, self.remat,
                             x.to(self.dtype), train=train)
            y = run_part(self.decoder, "decoder", drop_masks, block_remat,
                         feats, train=train)
            if self.dropout > 0:
                y = F.dropout(y, self.dropout, training=train)
        y = y.float().permute(0, 2, 3, 1)
        w = self.logits_conv.weight[:, :, 0, 0]
        logits = F.linear(y, w.float(), self.logits_conv.bias.float())
        if logits.shape[1:3] != x.shape[2:]:
            # a sub-resolution decoder: resize the f32 LOGITS (it commutes
            # with the 1×1 head and moves classes, not 128, channels)
            logits = resize_to(logits.permute(0, 3, 1, 2), x.shape[2],
                               x.shape[3], "bilinear").permute(0, 2, 3, 1)
        return logits

    def drop_paths(self) -> Dict[str, float]:
        """Module name → drop rate of every stochastic-depth layer that
        drops in training (rate > 0)."""
        return {n: m.rate for n, m in self.named_modules()
                if isinstance(m, DropPath) and m.rate > 0.0}

    def sample_drop_masks(self, gen: torch.Generator,
                          b: int) -> Dict[str, Tensor]:
        """Per-example keep masks ((B,) bool, kept with probability
        1 − rate) of every layer in :meth:`drop_paths`, drawn from ``gen``
        in module order."""
        return {n: torch.rand(b, generator=gen, device=gen.device)
                < 1.0 - rate for n, rate in self.drop_paths().items()}


def create_model(architecture: str, backbone: str, classes: int = 1,
                 dropout: float = 0.0, dtype: str = "bfloat16",
                 remat: bool = False, in_channels: int = 3,
                 encoder_variant: str = "") -> SegmentationModel:
    return SegmentationModel(architecture, backbone, classes, dropout,
                             _DTYPES[dtype], in_channels, remat,
                             encoder_variant)


# classification_models builds these from the PRE-ACTIVATION graph, so
# their reference-era .h5 checkpoints only ingest into that variant
_PREACT_BACKBONES = frozenset({
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "seresnet18", "seresnet34",
})


def _variant_for_config(cfg) -> str:
    """Keras ``.h5`` weights for a classification_models-era resnet imply
    the pre-activation graph, decided when the model is built so that the
    weights load one to one; every other config is ``""``.  A checkpoint's
    sidecar that pins the variant builds it (``variant_from_checkpoint``)."""
    spec = cfg.encoder_weights
    if spec and cfg.backbone.lower() in _PREACT_BACKBONES:
        path = resolve_pretrained_path(cfg.backbone, spec, quiet=True)
        if path and path.endswith((".h5", ".hdf5")):
            return "keras-preact"
    return ""


def model_from_config(cfg, encoder_variant: Optional[str] = None
                      ) -> SegmentationModel:
    """``encoder_variant=None`` derives the variant from the config; a
    string (possibly "") pins it, as the checkpoint sidecar does at load
    time (``variant_from_checkpoint``)."""
    return create_model(
        cfg.architecture, cfg.backbone, cfg.classes, cfg.dropout, cfg.dtype,
        cfg.remat, encoder_variant=(_variant_for_config(cfg)
                                    if encoder_variant is None
                                    else encoder_variant))


def variant_from_checkpoint(cfg, ckpt_paths) -> str:
    """The encoder variant to restore ``cfg`` from checkpoints with: the
    first sidecar (in order) that records ``encoder_variant`` wins, the
    graph the weights were trained with; else the config decides."""
    from ..train.checkpoint import checkpoint_meta

    if isinstance(ckpt_paths, str):
        ckpt_paths = [ckpt_paths]
    for p in ckpt_paths:
        meta = checkpoint_meta(p)
        if meta is not None and "encoder_variant" in meta:
            return str(meta["encoder_variant"])
    return _variant_for_config(cfg)


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
                train: bool = False,
                drop_masks: Optional[Dict[str, Tensor]] = None):
    """Functional forward with explicit variables.  Eval mode → logits;
    train mode → (logits, updated batch_stats) with flax's BN rule.  In
    train mode every layer of ``model.drop_paths()`` takes its keep mask
    from ``drop_masks`` (name → (B,) bool); a ``Dropout`` layer takes one
    from there too if given (x's shape), else draws it."""
    names = list(model.drop_paths()) if train else []
    missing = [n for n in names if n not in (drop_masks or {})]
    if missing:
        raise ValueError(f"train mode needs the drop-path keep masks of "
                         f"{missing}")
    bns = [(n, m) for n, m in model.named_modules()
           if isinstance(m, BatchNorm)]
    for _, m in bns:
        m.updated = None   # a remat recomputation's, from the last backward
    logits = functional_call(model, (params, batch_stats), (x,),
                             {"train": train,
                              "drop_masks": drop_masks if train else None})
    if not train:
        return logits
    new_stats = dict(batch_stats)
    for name, m in bns:
        if m.updated is not None:
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
