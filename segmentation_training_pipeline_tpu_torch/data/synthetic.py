"""Deterministic synthetic segmentation datasets.

Counterpart of ``segmentation_training_pipeline_tpu/data/synthetic.py``:
textured backgrounds, several overlapping foreground shapes with their own
texture, brightness drift, and dark occluder bars that cross shapes without
being part of the mask.  The draws are ``np.random.RandomState``'s, in the
JAX package's order, so the same seed gives the same arrays in both
packages.  The PyTorch package keeps its own copy so that it can make a
dataset where the JAX package is not installed.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .datasets import LambdaDataSet


def _rot_grid(size: int, cy: float, cx: float, theta: float):
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    y, x = yy - cy, xx - cx
    c, s = np.cos(theta), np.sin(theta)
    return c * y + s * x, -s * y + c * x


def _textured_background(r: np.random.RandomState, size: int) -> np.ndarray:
    """Base brightness + low-frequency gradient + fine noise + channel cast."""
    base = r.uniform(40, 110)
    gy, gx = r.uniform(-30, 30, size=2)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = base + gy * yy + gx * xx + r.randn(size, size).astype(np.float32) * 8
    img = np.repeat(img[:, :, None], 3, axis=2)
    img += r.randn(1, 1, 3).astype(np.float32) * 6
    return img


def _maybe_occluder_bar(r: np.random.RandomState, size: int,
                        img: np.ndarray) -> np.ndarray:
    """With p=0.6, darken a bar crossing the frame; returns its bool mask
    (all-False when no bar) so callers can clear it from their labels."""
    if r.rand() < 0.6:
        cy, cx = r.uniform(0, size, size=2)
        theta = r.uniform(0, np.pi)
        ry, _ = _rot_grid(size, cy, cx, theta)
        bar = np.abs(ry) < r.uniform(0.015 * size, 0.05 * size)
        img[bar] *= r.uniform(0.25, 0.5)
        return bar
    return np.zeros((size, size), bool)


def _one_item(r: np.random.RandomState, size: int) -> Tuple[np.ndarray, np.ndarray]:
    img = _textured_background(r, size)
    mask = np.zeros((size, size), bool)
    for _ in range(r.randint(1, 4)):
        cy, cx = r.uniform(0.15 * size, 0.85 * size, size=2)
        a = r.uniform(0.08 * size, 0.28 * size)
        b = r.uniform(0.08 * size, 0.28 * size)
        theta = r.uniform(0, np.pi)
        ry, rx = _rot_grid(size, cy, cx, theta)
        if r.rand() < 0.5:
            inside = (ry / a) ** 2 + (rx / b) ** 2 < 1.0       # ellipse
        else:
            inside = (np.abs(ry) < a) & (np.abs(rx) < b)       # rectangle
        offset = r.uniform(45, 110) * (1 if r.rand() < 0.7 else -1)
        texture = r.randn(size, size).astype(np.float32) * r.uniform(4, 12)
        img[inside] += offset + texture[inside, None]
        mask |= inside

    # dark occluder bar crossing the frame — NOT in the mask
    mask &= ~_maybe_occluder_bar(r, size, img)

    img = np.clip(img, 0, 255).astype(np.uint8)
    return img, mask.astype(np.uint8)


def generate_shapes_dataset(n: int, size: int = 128, seed: int = 7,
                            p_empty: float = 0.0) -> LambdaDataSet:
    """→ in-memory LambdaDataSet of ``n`` (image, mask) pairs.

    ``p_empty``: probability of a background-only item (empty mask), so
    that ``negatives:`` plans differ."""
    r = np.random.RandomState(seed)
    xs, ys = [], []
    for _ in range(n):
        if p_empty > 0.0 and r.rand() < p_empty:
            x, y = _background_only(r, size)
        else:
            x, y = _one_item(r, size)
        xs.append(x)
        ys.append(y * 255)
    return LambdaDataSet(xs, ys, ids=[f"shape{i:04d}" for i in range(n)])


def _background_only(r: np.random.RandomState,
                     size: int) -> Tuple[np.ndarray, np.ndarray]:
    """A negative item: textured background (+ optional occluder bar), no
    foreground shapes, empty mask."""
    img = _textured_background(r, size)
    _maybe_occluder_bar(r, size, img)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img, np.zeros((size, size), np.uint8)


def _one_item_multiclass(r: np.random.RandomState,
                         size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Class-index masks: 0 background, 1 ellipses, 2 rectangles (a later
    shape overwrites an earlier one); the occluder bar is background."""
    img = _textured_background(r, size)
    mask = np.zeros((size, size), np.uint8)
    for _ in range(r.randint(2, 5)):
        cy, cx = r.uniform(0.15 * size, 0.85 * size, size=2)
        a = r.uniform(0.08 * size, 0.25 * size)
        b = r.uniform(0.08 * size, 0.25 * size)
        theta = r.uniform(0, np.pi)
        ry, rx = _rot_grid(size, cy, cx, theta)
        is_ellipse = r.rand() < 0.5
        if is_ellipse:
            inside = (ry / a) ** 2 + (rx / b) ** 2 < 1.0
        else:
            inside = (np.abs(ry) < a) & (np.abs(rx) < b)
        offset = r.uniform(45, 110) * (1 if r.rand() < 0.7 else -1)
        texture = r.randn(size, size).astype(np.float32) * r.uniform(4, 12)
        img[inside] += offset + texture[inside, None]
        mask[inside] = 1 if is_ellipse else 2

    mask[_maybe_occluder_bar(r, size, img)] = 0
    return np.clip(img, 0, 255).astype(np.uint8), mask


def generate_multiclass_shapes_dataset(n: int, size: int = 128,
                                       seed: int = 7) -> LambdaDataSet:
    """→ in-memory LambdaDataSet of ``n`` (image, class-index mask) pairs
    with 3 classes (background, ellipse, rectangle), for the softmax
    path (BASELINE config 3)."""
    r = np.random.RandomState(seed)
    xs, ys = [], []
    for _ in range(n):
        x, y = _one_item_multiclass(r, size)
        xs.append(x)
        ys.append(y)
    return LambdaDataSet(xs, ys, ids=[f"mshape{i:04d}" for i in range(n)])


def write_shapes_dataset(out_dir: str, n: int, size: int = 128,
                         seed: int = 7,
                         p_empty: float = 0.0) -> Tuple[str, str]:
    """Write PNGs to ``out_dir/images`` + ``out_dir/masks``.  Returns the
    two dirs.  ``p_empty`` draws background-only items (empty masks) as
    :func:`generate_shapes_dataset` does; at 0 the files are the JAX
    package's ``write_shapes_dataset``'s."""
    import cv2

    images_dir = os.path.join(out_dir, "images")
    masks_dir = os.path.join(out_dir, "masks")
    os.makedirs(images_dir, exist_ok=True)
    os.makedirs(masks_dir, exist_ok=True)
    ds = generate_shapes_dataset(n, size, seed, p_empty)
    for i in range(n):
        item = ds[i]
        cv2.imwrite(os.path.join(images_dir, f"{item.id}.png"),
                    cv2.cvtColor(item.x, cv2.COLOR_RGB2BGR))
        cv2.imwrite(os.path.join(masks_dir, f"{item.id}.png"), item.y)
    return images_dir, masks_dir
