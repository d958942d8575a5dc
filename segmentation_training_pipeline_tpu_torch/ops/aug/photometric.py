"""Photometric (pixel-value) augmenters — image only, mask untouched.

Counterpart of ``segmentation_training_pipeline_tpu/ops/aug/photometric.py``
for the augmenters ported so far (``Multiply``).  Parameters are per image,
(B,), or per image and channel, (B, C) (imgaug ``per_channel=True``);
values live on the 0..255 scale and the pipeline clips at its end.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _bcast(param: Tensor) -> Tensor:
    """(B,) → (B, 1, 1, 1) or (B, C) → (B, 1, 1, C)."""
    if param.dim() == 2:
        return param[:, None, None, :]
    return param[:, None, None, None]


def multiply(images: Tensor, factor: Tensor) -> Tensor:
    return images * _bcast(factor)
