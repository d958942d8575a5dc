"""Input preprocessing (uint8 or 0..255 float → network dtype).

Counterpart of ``segmentation_training_pipeline_tpu/ops/preprocess.py``;
Keras-compatible mode names:

  * ``tf``     : x/127.5 − 1          (default)
  * ``scale``  : x/255
  * ``torch``  : x/255 then ImageNet mean/std (grayscale: 0.449/0.226)
  * ``caffe``  : RGB→BGR, subtract ImageNet BGR means (no scaling)
"""

from __future__ import annotations

import torch

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
_CAFFE_BGR_MEAN = (103.939, 116.779, 123.68)


def preprocess(x: torch.Tensor, mode: str = "tf",
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (..., C) → preprocessed (..., C) in ``dtype``."""
    x = x.float()
    if mode in ("tf", None, "default"):
        y = x / 127.5 - 1.0
    elif mode == "scale":
        y = x / 255.0
    elif mode == "torch":
        y = x / 255.0
        if y.shape[-1] == len(_IMAGENET_MEAN):
            mean = torch.tensor(_IMAGENET_MEAN, device=x.device)
            std = torch.tensor(_IMAGENET_STD, device=x.device)
            y = (y - mean) / std
        else:
            y = (y - 0.449) / 0.226  # grayscale fallback
    elif mode == "caffe":
        y = x.flip(-1) if x.shape[-1] == 3 else x
        y = y - torch.tensor(_CAFFE_BGR_MEAN[: y.shape[-1]], device=x.device)
    else:
        raise KeyError(f"unknown preprocessing mode {mode!r}")
    return y.to(dtype)
