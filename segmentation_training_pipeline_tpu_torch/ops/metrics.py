"""Evaluation metrics — the dice and IoU scores of the ported slice.

Counterpart of ``segmentation_training_pipeline_tpu/ops/metrics.py``
(``dice_score``, ``iou_score``).  Metrics take **probabilities** and ground
truth, threshold (sigmoid: p ≥ 0.5; softmax: argmax one-hot) and return a
scalar float32 mean over batch and classes; ``*_per_example`` give the
(B,) values the train step weights.
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


def iou_score(y_true: Tensor, probs: Tensor,
              activation: str = "sigmoid") -> Tensor:
    """Thresholded intersection-over-union, averaged over batch and
    classes."""
    return iou_score_per_example(y_true, probs, activation).mean()


def dice_score(y_true: Tensor, probs: Tensor,
               activation: str = "sigmoid") -> Tensor:
    return dice_score_per_example(y_true, probs, activation).mean()


# name → per-example function; aliases as in the JAX registry
PER_EXAMPLE: Dict[str, Callable] = {
    "iou": iou_score_per_example, "iou_score": iou_score_per_example,
    "jaccard_score": iou_score_per_example,
    "dice": dice_score_per_example, "dice_score": dice_score_per_example,
    "f1_score": dice_score_per_example, "f1-score": dice_score_per_example,
}
KNOWN = {"binary_accuracy", "accuracy", "acc", "categorical_accuracy",
         "precision", "recall", "soft_iou"} | set(PER_EXAMPLE)


def get(name: str) -> Callable:
    """Per-example metric by (case-insensitive, ``val_``-stripped) name."""
    key = name.lower().replace("val_", "")
    if key in PER_EXAMPLE:
        return PER_EXAMPLE[key]
    if key in KNOWN:
        raise NotImplementedError(f"metric {name!r} is not yet ported to the "
                                  "torch package")
    raise KeyError(f"unknown metric {name!r}; known: {sorted(KNOWN)}")
