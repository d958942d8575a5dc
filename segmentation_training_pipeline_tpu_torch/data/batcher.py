"""Host-side image and mask preparation at the config shape.

Counterpart of ``prepare_image`` and ``prepare_mask`` in
``segmentation_training_pipeline_tpu/data/batcher.py``.  Resizes go
through ``cv2`` (its fixed-point uint8 ``INTER_LINEAR`` is part of the
byte contract), imported only where sizes differ: a resize to the same size
is an exact copy in OpenCV, so skipping it changes no value.  ``make_batches``
and ``Prefetcher`` are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def prepare_image(x: np.ndarray, shape) -> np.ndarray:
    """HWC uint8 at the config shape (resized on the host with cv2)."""
    h, w, c = shape
    if x.ndim == 2:
        x = x[:, :, None]
    if x.shape[-1] == 1 and c == 3:
        x = np.repeat(x, 3, axis=-1)
    elif x.shape[-1] == 3 and c == 1:
        x = x.mean(axis=-1, keepdims=True)
    if x.shape[:2] != (h, w):
        import cv2

        x = cv2.resize(x, (w, h), interpolation=cv2.INTER_LINEAR)
        if x.ndim == 2:
            x = x[:, :, None]
    if x.dtype != np.uint8:
        x = np.clip(x, 0, 255).astype(np.uint8) if x.max() > 1.5 else (
            np.clip(x, 0, 1) * 255
        ).astype(np.uint8)
    return x


def _resize_nearest(y: np.ndarray, h: int, w: int) -> np.ndarray:
    import cv2

    return cv2.resize(y, (w, h), interpolation=cv2.INTER_NEAREST)


def prepare_mask(y: Optional[np.ndarray], shape, classes: int,
                 activation: str) -> np.ndarray:
    """HW[C] mask → (H, W, classes) float32 in {0, 1}.

    Accepts binary {0,1}/{0,255} masks, per-class channel stacks, or
    integer class-index maps (softmax mode).  Nearest-neighbour resize keeps
    labels crisp.
    """
    h, w, _ = shape
    if y is None:
        return np.zeros((h, w, classes), np.float32)
    y = np.asarray(y)
    if y.ndim == 3 and y.shape[-1] == 1:
        y = y[:, :, 0]
    if y.ndim == 2:
        if y.shape != (h, w):
            y = _resize_nearest(y, h, w)
        if activation == "softmax" and classes > 1:
            idx = y.astype(np.int64)
            if idx.max() > classes - 1 and idx.max() > 1:  # {0,255} binary
                idx = (idx > 127).astype(np.int64)
            out = np.zeros((h, w, classes), np.float32)
            np.put_along_axis(out, idx[:, :, None], 1.0, axis=-1)
            return out
        m = (y > 127) if y.max() > 1.5 else (y > 0.5)
        return np.repeat(m[:, :, None].astype(np.float32), classes, axis=-1) \
            if classes > 1 else m[:, :, None].astype(np.float32)
    # channel-stacked per-class masks
    if y.shape[:2] != (h, w):
        y = _resize_nearest(y.astype(np.float32), h, w)
        if y.ndim == 2:
            y = y[:, :, None]
    if y.shape[-1] != classes:
        raise ValueError(f"mask has {y.shape[-1]} channels, config classes={classes}")
    return (y > (127 if y.max() > 1.5 else 0.5)).astype(np.float32)
