"""Segmentation losses + the composite-expression parser.

Counterpart of ``segmentation_training_pipeline_tpu/ops/losses.py`` for the
losses ported so far (``binary_crossentropy``, ``dice_loss``) and the
composite YAML syntax ``"binary_crossentropy + 0.25*dice_loss"``.  Losses
take **logits** and apply the activation themselves, and return a float32
scalar (mean over the batch) whatever the compute dtype.  Each also has a
``*_per_example`` form returning (B,) values (every bundled loss is a mean
of per-image means), which the train step weights per example.
"""

from __future__ import annotations

import difflib
import re
from typing import Callable, Dict, List, Tuple

import torch

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


def binary_crossentropy_per_example(y_true: Tensor, logits: Tensor,
                                    activation: str = "sigmoid",
                                    class_weights=None) -> Tensor:
    y = y_true.float()
    x = logits.float()
    # stable BCE-with-logits: max(x, 0) − x·y + log1p(exp(−|x|))
    per = torch.clamp(x, min=0.0) - x * y + torch.log1p(torch.exp(-x.abs()))
    per = _flatten_spatial(per)                                   # (B, N, C)
    if class_weights is not None:
        w = _class_weights(class_weights, per)
        return ((per * w).sum(-1) / w.sum()).mean(-1)
    return per.mean(dim=(1, 2))


def dice_loss_per_example(y_true: Tensor, logits: Tensor,
                          activation: str = "sigmoid",
                          class_weights=None) -> Tensor:
    p = _flatten_spatial(_probs(logits, activation))
    t = _flatten_spatial(y_true.float())
    inter = (p * t).sum(1)                                        # (B, C)
    dice = (2.0 * inter + _SMOOTH) / (p.sum(1) + t.sum(1) + _SMOOTH)
    if class_weights is not None:
        w = _class_weights(class_weights, dice)
        return 1.0 - (dice * w).sum(-1) / w.sum()
    return 1.0 - dice.mean(-1)


def binary_crossentropy(y_true, logits, activation="sigmoid",
                        class_weights=None) -> Tensor:
    return binary_crossentropy_per_example(y_true, logits, activation,
                                           class_weights).mean()


def dice_loss(y_true, logits, activation="sigmoid",
              class_weights=None) -> Tensor:
    return dice_loss_per_example(y_true, logits, activation,
                                 class_weights).mean()


# ported: name → per-example function (names and aliases as in the JAX
# registry); KNOWN holds the reference's other names, not yet ported
_PER_EXAMPLE: Dict[str, Callable] = {
    "binary_crossentropy": binary_crossentropy_per_example,
    "bce": binary_crossentropy_per_example,
    "dice_loss": dice_loss_per_example,
    "dice": dice_loss_per_example,
}
KNOWN = set(_PER_EXAMPLE) | {
    "categorical_crossentropy", "cce", "crossentropy", "jaccard_loss",
    "jaccard", "iou_loss", "tversky_loss", "focal_loss", "focal",
    "binary_focal_loss", "categorical_focal_loss", "lovasz_loss", "lovasz",
    "lovasz_hinge", "lovasz_softmax", "mean_squared_error", "mse",
    "mean_absolute_error", "mae"}

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
        if key not in _PER_EXAMPLE:
            if key in KNOWN:
                raise NotImplementedError(
                    f"loss {name!r} is not yet ported to the torch package")
            hint = difflib.get_close_matches(key, sorted(KNOWN), n=1)
            extra = f" Did you mean {hint[0]!r}?" if hint else ""
            raise LossExprError(f"unknown loss {name!r} in {expr!r}.{extra}")
        out.append((sgn * w, name, _PER_EXAMPLE[key]))
    return out


class CompositeLoss:
    """A parsed loss expression: ``loss(y_true, logits)`` is the batch mean
    (scalar), ``loss.per_example(y_true, logits)`` the (B,) values."""

    def __init__(self, expr: str, activation: str, class_weights=None):
        self.terms = parse_loss_expr(expr)
        self.activation = activation
        self.class_weights = class_weights

    def per_example(self, y_true: Tensor, logits: Tensor) -> Tensor:
        total = 0.0
        for w, _name, fn in self.terms:
            total = total + w * fn(y_true, logits, self.activation,
                                   self.class_weights)
        return total

    def __call__(self, y_true: Tensor, logits: Tensor) -> Tensor:
        return self.per_example(y_true, logits).mean()


def build_loss(expr: str, activation: str,
               class_weights=None) -> CompositeLoss:
    return CompositeLoss(expr, activation, class_weights)
