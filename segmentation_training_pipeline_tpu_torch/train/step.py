"""The train step: augmentation + preprocessing + forward + loss +
backward + Adam update + BatchNorm running statistics.

Counterpart of ``segmentation_training_pipeline_tpu/train/step.py``
(``TrainState``, ``build_train_step``).  The state is functional, as in
the reference: a step returns a new ``TrainState`` and leaves its input
untouched.  The loss is per example and weighted by ``batch["weight"]``
(wrap-padded duplicates weigh 0); logs carry the weighted loss and
metrics and ``_wsum``, the real-example count.  The step's random draws
(the augmentation's and the stochastic-depth keep masks) arrive as
arguments (``draws``, ``drop_masks``), or are sampled from ``gen``.
Eager PyTorch has no counterpart of ``jax.jit``; nothing is compiled.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from ..models.factory import apply_activation, apply_model, model_variables
from ..ops.preprocess import preprocess

Tensor = torch.Tensor


@dataclass
class TrainState:
    params: Dict[str, Tensor]
    batch_stats: Dict[str, Tensor]
    opt_state: Any
    step: int


def create_train_state(model, tx, device="cuda") -> TrainState:
    """State from the model's current variables, moved with the model to
    ``device`` (4-D conv kernels in channels-last layout on CUDA)."""
    model.to(device)
    params, stats = model_variables(model)

    def put(t):
        if t.dim() == 4 and t.device.type == "cuda":
            t = t.contiguous(memory_format=torch.channels_last)
        return t

    params = {k: put(v) for k, v in params.items()}
    stats = {k: put(v) for k, v in stats.items()}
    return TrainState(params, stats, tx.init(params), 0)


def build_train_step(model, tx, loss_fn, metric_fns: Dict[str, Callable],
                     activation: str, preprocessing: Optional[str],
                     aug=None):
    """→ ``train_step(state, batch, lr, gen=None, draws=None,
    drop_masks=None) -> (state, logs)``.

    ``batch``: {"image": (B, H, W, C) uint8 or 0..255 float, "mask":
    (B, H, W, M), optional "weight": (B,)}.  ``loss_fn`` is a
    ``losses.CompositeLoss``; ``metric_fns`` map names to per-example
    metric functions of (y_true, probs, activation).  ``aug`` is a
    ``lowering.Augmentation``; its draws are ``draws`` if given, else
    sampled from ``gen``.  The keep masks of the model's stochastic-depth
    layers (``model.drop_paths()``) are ``drop_masks`` if given, else
    sampled from ``gen`` after the augmentation's draws."""

    def train_step(state: TrainState, batch, lr: float,
                   gen: Optional[torch.Generator] = None, draws=None,
                   drop_masks=None):
        images, masks = batch["image"], batch["mask"]
        b = images.shape[0]
        w = batch.get("weight")
        if w is None:
            w = torch.ones(b, device=images.device)
        wsum = torch.clamp(w.sum(), min=1.0)
        if aug is not None:
            if draws is None:
                if gen is None:
                    raise ValueError("augmentation needs draws or a "
                                     "generator")
                draws = aug.sample(gen, b, images.shape[1], images.shape[2],
                                   images.shape[3])
            images, masks = aug.apply(draws, images, masks)
        if drop_masks is None and model.drop_paths():
            if gen is None:
                raise ValueError("stochastic depth needs keep masks or a "
                                 "generator")
            drop_masks = model.sample_drop_masks(gen, b)
        x = preprocess(images, preprocessing or "tf", model.dtype)
        masks = masks.float()

        params = {k: p.detach().requires_grad_(True)
                  for k, p in state.params.items()}
        logits, new_stats = apply_model(model, params, state.batch_stats, x,
                                        train=True, drop_masks=drop_masks)
        loss = (loss_fn.per_example(masks, logits) * w).sum() / wsum
        grads = torch.autograd.grad(loss, list(params.values()))
        updates, new_opt = tx.update(grads, state.opt_state)
        new_params = dict(zip(params, torch._foreach_add(
            [p.detach() for p in params.values()],
            torch._foreach_mul(updates, -lr))))

        logs = {"loss": loss.detach()}
        if metric_fns:
            probs = apply_activation(logits.detach(), activation)
            for name, fn in metric_fns.items():
                logs[name] = (fn(masks, probs, activation) * w).sum() / wsum
        logs["_wsum"] = w.sum()
        return TrainState(new_params, new_stats, new_opt,
                          state.step + 1), logs

    return train_step
