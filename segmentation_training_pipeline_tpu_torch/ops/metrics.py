"""Evaluation metrics (IoU / dice / accuracy family).

Counterpart of ``segmentation_training_pipeline_tpu/ops/metrics.py``: all 7
metrics of its registry with their aliases.  Metrics take
**probabilities** and ground truth; all but ``soft_iou`` threshold them
(sigmoid: p ≥ 0.5; softmax: argmax one-hot).  Each is a
``*_per_example`` function returning (B,) float32 values, entry b the
reference's scalar on the batch of image b alone, which the train step
weights.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
_EPS = 1e-7


def _flatten_spatial(x: Tensor) -> Tensor:
    """(B, ..., C) → (B, N, C)."""
    return x.reshape(x.shape[0], -1, x.shape[-1])


def _binarize(p: Tensor, activation: str, threshold: float = 0.5) -> Tensor:
    p = p.float()
    if activation == "softmax":
        return F.one_hot(p.argmax(-1), p.shape[-1]).float()
    return (p >= threshold).float()


def _counts(y_true: Tensor, probs: Tensor, activation: str):
    p = _flatten_spatial(_binarize(probs, activation))
    t = _flatten_spatial(torch.round(y_true.float()))
    return (p * t).sum(1), p.sum(1), t.sum(1)


def iou_score_per_example(y_true: Tensor, probs: Tensor,
                          activation: str = "sigmoid") -> Tensor:
    inter, ps, ts = _counts(y_true, probs, activation)
    return ((inter + _EPS) / (ps + ts - inter + _EPS)).mean(-1)


def dice_score_per_example(y_true: Tensor, probs: Tensor,
                           activation: str = "sigmoid") -> Tensor:
    inter, ps, ts = _counts(y_true, probs, activation)
    return ((2.0 * inter + _EPS) / (ps + ts + _EPS)).mean(-1)


def binary_accuracy_per_example(y_true: Tensor, probs: Tensor,
                                activation: str = "sigmoid") -> Tensor:
    pred = _binarize(probs, activation)
    hit = (pred == torch.round(y_true.float())).float()
    return _flatten_spatial(hit).mean(dim=(1, 2))


def accuracy_per_example(y_true: Tensor, probs: Tensor,
                         activation: str = "sigmoid") -> Tensor:
    """Softmax: the share of pixels whose argmax class is the true one;
    otherwise :func:`binary_accuracy_per_example`."""
    if activation == "softmax":
        hit = (probs.argmax(-1) == y_true.argmax(-1)).float()
        return hit.reshape(hit.shape[0], -1).mean(-1)
    return binary_accuracy_per_example(y_true, probs, activation)


def precision_per_example(y_true: Tensor, probs: Tensor,
                          activation: str = "sigmoid") -> Tensor:
    inter, ps, _ = _counts(y_true, probs, activation)
    return ((inter + _EPS) / (ps + _EPS)).mean(-1)


def recall_per_example(y_true: Tensor, probs: Tensor,
                       activation: str = "sigmoid") -> Tensor:
    inter, _, ts = _counts(y_true, probs, activation)
    return ((inter + _EPS) / (ts + _EPS)).mean(-1)


def soft_iou_per_example(y_true: Tensor, probs: Tensor,
                         activation: str = "sigmoid") -> Tensor:
    """Un-thresholded IoU on the probabilities."""
    p = _flatten_spatial(probs.float())
    t = _flatten_spatial(y_true.float())
    inter = (p * t).sum(1)
    return ((inter + _EPS) / (p.sum(1) + t.sum(1) - inter + _EPS)).mean(-1)


# name → per-example function; names and aliases as in the JAX registry
PER_EXAMPLE: Dict[str, Callable] = {}
for _fn, _names in [
        (binary_accuracy_per_example, ("binary_accuracy",)),
        (accuracy_per_example, ("accuracy", "acc", "categorical_accuracy")),
        (iou_score_per_example, ("iou", "iou_score", "jaccard_score")),
        (dice_score_per_example, ("dice", "dice_score", "f1_score",
                                  "f1-score")),
        (precision_per_example, ("precision",)),
        (recall_per_example, ("recall",)),
        (soft_iou_per_example, ("soft_iou",))]:
    for _n in _names:
        PER_EXAMPLE[_n] = _fn
KNOWN = set(PER_EXAMPLE)


def get(name: str) -> Callable:
    """Per-example metric by (case-insensitive, ``val_``-stripped) name."""
    key = name.lower().replace("val_", "")
    if key not in PER_EXAMPLE:
        raise KeyError(f"unknown metric {name!r}; known: {sorted(KNOWN)}")
    return PER_EXAMPLE[key]
