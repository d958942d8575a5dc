"""Keras optimizer names → unit-learning-rate update rules (PyTorch).

Counterpart of ``segmentation_training_pipeline_tpu/train/optimizers.py``
for Adam.  As in the reference, the optimizer produces **unit-lr** updates
(optax ``scale_by_adam`` without the final ``scale(-lr)``) and the train
step multiplies them by ``-lr``, a per-step runtime scalar, so a schedule
changes the rate without touching optimizer state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

KNOWN = {"adam", "adamw", "sgd", "rmsprop", "nadam", "adamax", "adagrad",
         "adadelta", "lion", "lamb"}


@dataclass
class AdamState:
    mu: Dict[str, Tensor]
    nu: Dict[str, Tensor]
    count: int


class ScaleByAdam:
    """optax.scale_by_adam: mu ← (1−b1)·g + b1·mu, nu ← (1−b2)·g² + b2·nu,
    update = mû / (sqrt(nû) + eps) with the bias corrections 1 − b^count
    taken in float32 as optax takes them."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Dict[str, Tensor]) -> AdamState:
        return AdamState({k: torch.zeros_like(p) for k, p in params.items()},
                         {k: torch.zeros_like(p) for k, p in params.items()},
                         0)

    def update(self, grads: Sequence[Tensor], state: AdamState
               ) -> Tuple[list, AdamState]:
        names = list(state.mu)
        mu = torch._foreach_mul(list(grads), 1.0 - self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(list(state.mu.values()),
                                                   self.b1))
        nu = torch._foreach_mul(torch._foreach_mul(list(grads), list(grads)),
                                1.0 - self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(list(state.nu.values()),
                                                   self.b2))
        count = state.count + 1
        one = np.float32(1.0)
        bc1 = float(one - np.float32(self.b1) ** np.float32(count))
        bc2 = float(one - np.float32(self.b2) ** np.float32(count))
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        return updates, AdamState(dict(zip(names, mu)), dict(zip(names, nu)),
                                  count)


def build_optimizer(name: str = "Adam", clipnorm=None, clipvalue=None,
                    weight_decay=None) -> ScaleByAdam:
    """Unit-lr update rule for a Keras optimizer name (Adam so far)."""
    key = name.lower()
    if key not in KNOWN:
        raise KeyError(f"unknown optimizer {name!r}")
    if key != "adam":
        raise NotImplementedError(f"optimizer {name!r} is not yet ported to "
                                  "the torch package")
    for opt, val in (("clipnorm", clipnorm), ("clipvalue", clipvalue),
                     ("weight_decay", weight_decay)):
        if val:
            raise NotImplementedError(f"{opt} is not yet ported to the torch "
                                      "package")
    return ScaleByAdam()
