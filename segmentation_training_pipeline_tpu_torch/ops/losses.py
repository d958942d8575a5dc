"""Segmentation losses + the composite-expression parser.

Counterpart of ``segmentation_training_pipeline_tpu/ops/losses.py``: all 14
losses of its registry with their aliases, and the composite YAML syntax
``"binary_crossentropy + 0.25*dice_loss"``.  Losses take **logits** and
apply the activation themselves.  Each is a ``*_per_example`` function
returning (B,) float32 values whatever the compute dtype: entry b is the
reference's scalar loss on the batch of image b alone (what its train step
takes with ``jax.vmap`` over ``loss_fn(y[None], logits[None])``), which
the train step weights per example; every bundled loss is a mean of such
per-image values, so the batch loss is their mean.
"""

from __future__ import annotations

import difflib
import functools
import inspect
import re
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
_SMOOTH = 1.0


def _probs(logits: Tensor, activation: str) -> Tensor:
    logits = logits.float()
    if activation == "softmax":
        return torch.softmax(logits, dim=-1)
    if activation == "sigmoid":
        return torch.sigmoid(logits)
    return logits


def _flatten_spatial(x: Tensor) -> Tensor:
    return x.reshape(x.shape[0], -1, x.shape[-1])


def _class_weights(class_weights, like: Tensor) -> Tensor:
    return torch.as_tensor(class_weights, dtype=torch.float32,
                           device=like.device)


def _weighted_mean_over_classes(per: Tensor, class_weights) -> Tensor:
    """(B, N, C) element losses → (B,): the mean over pixels of the
    class-weighted mean (Σ w·l / Σ w), or the plain mean."""
    if class_weights is not None:
        w = _class_weights(class_weights, per)
        return ((per * w).sum(-1) / w.sum()).mean(-1)
    return per.mean(dim=(1, 2))


def _summed_over_classes(per: Tensor, class_weights) -> Tensor:
    """(B, N, C) element losses → (B,): the mean over pixels of the sum
    over classes; with weights Σ w·l rescaled by C / Σ w (a uniform
    weighting leaves the loss as it was)."""
    if class_weights is not None:
        w = _class_weights(class_weights, per)
        return (per * w).sum(-1).mean(-1) * (w.shape[0] / w.sum())
    return per.sum(-1).mean(-1)


def _region_score(score: Tensor, class_weights) -> Tensor:
    """(B, C) per-class scores → (B,) losses 1 − (weighted) mean."""
    if class_weights is not None:
        w = _class_weights(class_weights, score)
        return 1.0 - (score * w).sum(-1) / w.sum()
    return 1.0 - score.mean(-1)


# ---------------------------------------------------------------------------
# cross-entropies
# ---------------------------------------------------------------------------

def binary_crossentropy_per_example(y_true: Tensor, logits: Tensor,
                                    activation: str = "sigmoid",
                                    class_weights=None) -> Tensor:
    y = y_true.float()
    x = logits.float()
    # stable BCE-with-logits: max(x, 0) − x·y + log1p(exp(−|x|))
    per = torch.clamp(x, min=0.0) - x * y + torch.log1p(torch.exp(-x.abs()))
    return _weighted_mean_over_classes(_flatten_spatial(per), class_weights)


def categorical_crossentropy_per_example(y_true: Tensor, logits: Tensor,
                                         activation: str = "softmax",
                                         class_weights=None) -> Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    per = -_flatten_spatial(y_true.float() * logp)
    return _summed_over_classes(per, class_weights)


def crossentropy_per_example(y_true: Tensor, logits: Tensor,
                             activation: str = "sigmoid",
                             class_weights=None) -> Tensor:
    if activation == "softmax":
        return categorical_crossentropy_per_example(
            y_true, logits, activation, class_weights)
    return binary_crossentropy_per_example(y_true, logits, activation,
                                           class_weights)


# ---------------------------------------------------------------------------
# region losses
# ---------------------------------------------------------------------------

def _region_sums(y_true: Tensor, logits: Tensor, activation: str):
    """(B, C) sums: Σ p·t, Σ p, Σ t over the pixels."""
    p = _flatten_spatial(_probs(logits, activation))
    t = _flatten_spatial(y_true.float())
    return (p * t).sum(1), p.sum(1), t.sum(1)


def dice_loss_per_example(y_true: Tensor, logits: Tensor,
                          activation: str = "sigmoid",
                          class_weights=None) -> Tensor:
    inter, ps, ts = _region_sums(y_true, logits, activation)
    dice = (2.0 * inter + _SMOOTH) / (ps + ts + _SMOOTH)
    return _region_score(dice, class_weights)


def jaccard_loss_per_example(y_true: Tensor, logits: Tensor,
                             activation: str = "sigmoid",
                             class_weights=None) -> Tensor:
    inter, ps, ts = _region_sums(y_true, logits, activation)
    iou = (inter + _SMOOTH) / (ps + ts - inter + _SMOOTH)
    return _region_score(iou, class_weights)


def tversky_loss_per_example(y_true: Tensor, logits: Tensor,
                             activation: str = "sigmoid", alpha: float = 0.5,
                             beta: float = 0.5,
                             class_weights=None) -> Tensor:
    p = _flatten_spatial(_probs(logits, activation))
    t = _flatten_spatial(y_true.float())
    tp = (p * t).sum(1)
    fp = (p * (1 - t)).sum(1)
    fn = ((1 - p) * t).sum(1)
    tv = (tp + _SMOOTH) / (tp + alpha * fp + beta * fn + _SMOOTH)
    return _region_score(tv, class_weights)


# ---------------------------------------------------------------------------
# focal losses (Lin et al. 2017)
# ---------------------------------------------------------------------------

def binary_focal_loss_per_example(y_true: Tensor, logits: Tensor,
                                  activation: str = "sigmoid",
                                  gamma: float = 2.0, alpha: float = 0.25,
                                  class_weights=None) -> Tensor:
    y = y_true.float()
    x = logits.float()
    p = torch.sigmoid(x)
    pos = -alpha * torch.pow(1.0 - p, gamma) * F.logsigmoid(x)
    neg = -(1.0 - alpha) * torch.pow(p, gamma) * F.logsigmoid(-x)
    per = y * pos + (1.0 - y) * neg
    return _weighted_mean_over_classes(_flatten_spatial(per), class_weights)


def categorical_focal_loss_per_example(y_true: Tensor, logits: Tensor,
                                       activation: str = "softmax",
                                       gamma: float = 2.0,
                                       alpha: float = 0.25,
                                       class_weights=None) -> Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    p = torch.exp(logp)
    per = -alpha * y_true.float() * torch.pow(1.0 - p, gamma) * logp
    return _summed_over_classes(_flatten_spatial(per), class_weights)


def focal_loss_per_example(y_true: Tensor, logits: Tensor,
                           activation: str = "sigmoid",
                           class_weights=None) -> Tensor:
    if activation == "softmax":
        return categorical_focal_loss_per_example(
            y_true, logits, activation, class_weights=class_weights)
    return binary_focal_loss_per_example(y_true, logits, activation,
                                         class_weights=class_weights)


# ---------------------------------------------------------------------------
# Lovász losses (Berman et al. 2018): errors sorted in descending order
# (the reference's ``jax.lax.top_k`` over N); the value does not depend on
# how tied errors are ordered
# ---------------------------------------------------------------------------

def _lovasz_grad(gt_sorted: Tensor) -> Tensor:
    """Gradient of the Lovász extension at the sorted errors, per row of
    (R, N) sorted ground truth."""
    gts = gt_sorted.sum(-1, keepdim=True)
    intersection = gts - torch.cumsum(gt_sorted, -1)
    union = gts + torch.cumsum(1.0 - gt_sorted, -1)
    jaccard = 1.0 - intersection / torch.clamp(union, min=1.0)
    return torch.cat([jaccard[:, :1], jaccard[:, 1:] - jaccard[:, :-1]], -1)


def _lovasz_rows(errors: Tensor, gt: Tensor, hinge: bool) -> Tensor:
    """(R, N) errors and {0, 1} ground truth → (R,) Lovász values."""
    errors_sorted, perm = torch.sort(errors, dim=-1, descending=True)
    grad = _lovasz_grad(torch.gather(gt, -1, perm))
    if hinge:
        errors_sorted = torch.relu(errors_sorted)
    return (errors_sorted * grad).sum(-1)


def _per_class_rows(x: Tensor) -> Tensor:
    """(B, …, C) → (B, C, N)."""
    return _flatten_spatial(x).transpose(1, 2)


def lovasz_hinge_per_example(y_true: Tensor, logits: Tensor,
                             activation: str = "sigmoid") -> Tensor:
    """Lovász hinge per image and channel, averaged over the channels."""
    y = _per_class_rows(y_true.float())
    x = _per_class_rows(logits.float())
    b, c, n = x.shape
    errors = 1.0 - x * (2.0 * y - 1.0)
    return _lovasz_rows(errors.reshape(b * c, n), y.reshape(b * c, n),
                        True).view(b, c).mean(-1)


def lovasz_softmax_per_example(y_true: Tensor, logits: Tensor,
                               activation: str = "softmax") -> Tensor:
    p = _per_class_rows(torch.softmax(logits.float(), dim=-1))
    t = _per_class_rows(y_true.float())
    b, c, n = p.shape
    return _lovasz_rows((t - p).abs().reshape(b * c, n),
                        t.reshape(b * c, n), False).view(b, c).mean(-1)


def lovasz_loss_per_example(y_true: Tensor, logits: Tensor,
                            activation: str = "sigmoid") -> Tensor:
    if activation == "softmax":
        return lovasz_softmax_per_example(y_true, logits, activation)
    return lovasz_hinge_per_example(y_true, logits, activation)


# ---------------------------------------------------------------------------
# regression-style
# ---------------------------------------------------------------------------

def mean_squared_error_per_example(y_true: Tensor, logits: Tensor,
                                   activation: str = "sigmoid") -> Tensor:
    d = _probs(logits, activation) - y_true.float()
    return _flatten_spatial(d * d).mean(dim=(1, 2))


def mean_absolute_error_per_example(y_true: Tensor, logits: Tensor,
                                    activation: str = "sigmoid") -> Tensor:
    d = _probs(logits, activation) - y_true.float()
    return _flatten_spatial(d.abs()).mean(dim=(1, 2))


# name → per-example function, the JAX registry's names and aliases
PER_EXAMPLE: Dict[str, Callable] = {}
for _fn, _names in [
        (binary_crossentropy_per_example, ("binary_crossentropy", "bce")),
        (categorical_crossentropy_per_example,
         ("categorical_crossentropy", "cce")),
        (crossentropy_per_example, ("crossentropy",)),
        (dice_loss_per_example, ("dice_loss", "dice")),
        (jaccard_loss_per_example, ("jaccard_loss", "jaccard", "iou_loss")),
        (tversky_loss_per_example, ("tversky_loss",)),
        (focal_loss_per_example, ("focal_loss", "focal")),
        (binary_focal_loss_per_example, ("binary_focal_loss",)),
        (categorical_focal_loss_per_example, ("categorical_focal_loss",)),
        (lovasz_loss_per_example, ("lovasz_loss", "lovasz")),
        (lovasz_hinge_per_example, ("lovasz_hinge",)),
        (lovasz_softmax_per_example, ("lovasz_softmax",)),
        (mean_squared_error_per_example, ("mean_squared_error", "mse")),
        (mean_absolute_error_per_example, ("mean_absolute_error", "mae"))]:
    for _n in _names:
        PER_EXAMPLE[_n] = _fn
KNOWN = set(PER_EXAMPLE)


_TERM_RE = re.compile(
    r"^\s*(?:(?P<w>\d+(?:\.\d*)?|\.\d+)\s*\*\s*)?"
    r"(?P<name>[A-Za-z_][A-Za-z0-9_]*)\s*$")


class LossExprError(ValueError):
    pass


def parse_loss_expr(expr: str) -> List[Tuple[float, str, Callable]]:
    """``"binary_crossentropy + 0.25*dice_loss"`` →
    [(1.0, name, per-example fn), (0.25, …)].

    Grammar: ``expr := term (('+'|'-') term)*``, ``term := [float '*']
    name``."""
    if not isinstance(expr, str) or not expr.strip():
        raise LossExprError(f"empty loss expression: {expr!r}")
    parts: List[Tuple[float, str]] = []
    expect_term = True
    sign = 1.0
    for tok in re.split(r"([+-])", expr):
        if tok in ("+", "-"):
            if expect_term:
                if not parts and sign == 1.0:  # unary sign at the start
                    sign = 1.0 if tok == "+" else -1.0
                    continue
                raise LossExprError(
                    f"misplaced {tok!r} in loss expression {expr!r}")
            sign = 1.0 if tok == "+" else -1.0
            expect_term = True
        elif tok.strip():
            if not expect_term:
                raise LossExprError(
                    f"missing operator before {tok.strip()!r} in {expr!r}")
            parts.append((sign, tok))
            expect_term = False
    if expect_term or not parts:
        raise LossExprError(f"cannot parse loss expression: {expr!r}")

    out = []
    for sgn, term in parts:
        m = _TERM_RE.match(term)
        if not m:
            raise LossExprError(f"bad loss term {term.strip()!r} in {expr!r}")
        w = float(m.group("w")) if m.group("w") else 1.0
        name = m.group("name")
        key = name.lower()
        if key not in PER_EXAMPLE:
            hint = difflib.get_close_matches(key, sorted(KNOWN), n=1)
            extra = f" Did you mean {hint[0]!r}?" if hint else ""
            raise LossExprError(f"unknown loss {name!r} in {expr!r}.{extra}")
        out.append((sgn * w, name, PER_EXAMPLE[key]))
    return out


class CompositeLoss:
    """A parsed loss expression: ``loss(y_true, logits)`` is the batch mean
    (scalar), ``loss.per_example(y_true, logits)`` the (B,) values."""

    def __init__(self, expr: str, activation: str, class_weights=None):
        self.terms = []
        for w, name, fn in parse_loss_expr(expr):
            # class_weights reach every term whose function takes them, as
            # the reference's build_loss binds them
            if (class_weights is not None and "class_weights"
                    in inspect.signature(fn).parameters):
                fn = functools.partial(fn, class_weights=class_weights)
            self.terms.append((w, name, fn))
        self.activation = activation

    def per_example(self, y_true: Tensor, logits: Tensor) -> Tensor:
        total = 0.0
        for w, _name, fn in self.terms:
            total = total + w * fn(y_true, logits, self.activation)
        return total

    def __call__(self, y_true: Tensor, logits: Tensor) -> Tensor:
        return self.per_example(y_true, logits).mean()


def build_loss(expr: str, activation: str,
               class_weights=None) -> CompositeLoss:
    return CompositeLoss(expr, activation, class_weights)
