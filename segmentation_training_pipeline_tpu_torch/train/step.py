"""The train and eval steps.

Counterpart of ``segmentation_training_pipeline_tpu/train/step.py``
(``TrainState``, ``build_train_step``, ``build_eval_step``) and of the
stage runner's on-device weighted reduction (``train/stage.py``).  The
train step runs augmentation + preprocessing + forward + loss + backward +
the optimizer's unit-lr update times ``-lr`` + the BatchNorm running
statistics.  The state is functional, as in the reference: a step returns
a new ``TrainState`` and leaves its input untouched.  The loss is per
example and weighted by ``batch["weight"]`` (wrap-padded duplicates weigh
0); logs carry the weighted loss and metrics and ``_wsum``, the
real-example count, all as tensors on the batch's device (no host sync).

Only the parameters the optimizer trains (``Optimizer.trainable``) are
differentiated and updated: with a frozen encoder the backward pass stops
at the decoder and the encoder's parameters stay the very same tensors,
while its BatchNorm statistics still move (the forward runs in train mode
on the whole model, as the JAX step's ``mutable=["batch_stats"]``).

The step's random draws (the augmentation's and the stochastic-depth keep
masks) arrive as arguments (``draws``, ``drop_masks``), or are sampled from
``gen``.  Eager PyTorch has no counterpart of ``jax.jit``; nothing is
compiled.

Data parallelism (``mesh``, a ``parallel.mesh.Mesh`` in a process group):
each rank holds its rows of the global batch's images and masks and the
whole ``weight`` vector.  Every rank draws the global batch's augmentation,
transform and keep masks from the same generator and takes its rows
(``Augmentation.take``).  The loss is the rank's share of the global one,
``Σ_rows(per_example·w) / max(Σ w, 1)`` (the global weight sum from the
whole vector, no collective); BatchNorm's statistics are the global
batch's (``models/layers.py``); the trainable gradients are summed over the
group in one flat bucket by one ``all_reduce`` before the optimizer, so
clipping sees the global gradient.  The logs are the rank's shares
(``_wsum`` its real rows), which sum over the group to the one-process
logs; the stage runner sums them once an epoch.  Without ``mesh`` nothing
of this runs.

The ``space`` axis (``mesh.space`` S above 1): every rank of a space group
holds its data rows whole and augments them whole, then keeps its H slab
(``Mesh.slab``) of the images; the model runs on the slabs under
``parallel/spatial.py:partitioned``.  Its logits are gathered over the
group (``spatial.gather``, the float32 B·H·W·C values) and the loss and
metrics run on whole images and whole masks, so dice, jaccard, tversky
and the Lovász sorts see every pixel.  Each rank of the group then
computes the same whole loss: its share is the loss / S (the gather's
backward sums the group's gradients), and its logs count once, on the
group's slab-0 rank, zeros on the others.

``debug`` (YAML ``debug:``), the counterpart of the JAX package's
``jax_debug_nans`` and ``checkify``: ``True`` fails the step with
``FloatingPointError`` (the exception ``jax_debug_nans`` raises) on a
non-finite loss, before the backward pass, and on a non-finite gradient
or updated parameter, at the price of two host syncs a step;
``"checks"`` also runs the forward and backward under
``torch.autograd.set_detect_anomaly(True, check_nan=True)``, whose error
names the backward op that made a NaN and is raised as
``FloatingPointError`` from it.  The anomaly mode is the context
manager's, restored when the step leaves it.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Union

import torch

from ..models.factory import apply_activation, apply_model, model_variables
from ..ops.preprocess import preprocess
from ..parallel import distributed as dist
from ..parallel import spatial

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


def _check_finite(what: str, tensors: Dict[str, Tensor]) -> None:
    """Raise ``FloatingPointError`` naming the tensors with a NaN or an
    infinity (one host sync when all are finite)."""
    if not tensors:
        return
    ok = torch.stack([torch.isfinite(t).all() for t in tensors.values()])
    if not bool(ok.all()):
        bad = [k for k, good in zip(tensors, ok.tolist()) if not good]
        raise FloatingPointError(f"debug: non-finite {what}: {bad[:8]}"
                                 + (f" and {len(bad) - 8} more"
                                    if len(bad) > 8 else ""))


@contextlib.contextmanager
def _anomaly_checks():
    """Autograd's anomaly mode with NaN checks for a block; its NaN error
    raised as ``FloatingPointError``."""
    with torch.autograd.set_detect_anomaly(True, check_nan=True):
        try:
            yield
        except RuntimeError as e:
            if "nan" not in str(e).lower():
                raise
            raise FloatingPointError(str(e)) from e


def build_train_step(model, tx, loss_fn, metric_fns: Dict[str, Callable],
                     activation: str, preprocessing: Optional[str],
                     aug=None, transform: Optional[Callable] = None,
                     debug: Union[bool, str] = False, mesh=None):
    """→ ``train_step(state, batch, lr, gen=None, draws=None,
    drop_masks=None) -> (state, logs)``.

    ``batch``: {"image": (B, H, W, C) uint8 or 0..255 float, "mask":
    (B, H, W, M), optional "weight": (B,)}.  ``tx`` is an
    ``optimizers.Optimizer``; ``loss_fn`` a ``losses.CompositeLoss``;
    ``metric_fns`` map names to per-example metric functions of (y_true,
    probs, activation).  ``transform`` (the deterministic ``transforms:``,
    ``lowering.build_transform_fn``) runs first; ``aug`` is a
    ``lowering.Augmentation`` whose draws are ``draws`` if given, else
    sampled from ``gen``.  The keep masks of the model's stochastic-depth
    layers (``model.drop_paths()``) are ``drop_masks`` if given, else
    sampled from ``gen`` after the augmentation's draws.  ``debug``: see
    the module's notes.  ``mesh``: data parallelism (the module's notes);
    ``draws`` and ``drop_masks`` are then the global batch's."""
    space = mesh is not None and mesh.space > 1

    def train_step(state: TrainState, batch, lr: float,
                   gen: Optional[torch.Generator] = None, draws=None,
                   drop_masks=None):
        images, masks = batch["image"], batch["mask"]
        b = images.shape[0]
        w = batch.get("weight")
        if w is None:
            w = torch.ones(b * (mesh.data if mesh is not None else 1),
                           device=images.device)
        wsum = torch.clamp(w.sum(), min=1.0)
        rows = _rows(mesh, w, b)
        w_rows = w if rows is None else w[rows]
        bg = w.shape[0]   # the global batch
        if transform is not None:
            images, masks = (transform(images, masks) if rows is None else
                             transform(images, masks, rows, bg))
        if aug is not None:
            if draws is None:
                if gen is None:
                    raise ValueError("augmentation needs draws or a "
                                     "generator")
                draws = aug.sample(gen, bg, images.shape[1],
                                   images.shape[2], images.shape[3])
            if rows is not None:
                draws = aug.take(draws, rows)
            images, masks = aug.apply(draws, images, masks)
        if drop_masks is None and model.drop_paths():
            if gen is None:
                raise ValueError("stochastic depth needs keep masks or a "
                                 "generator")
            drop_masks = model.sample_drop_masks(gen, bg)
        if drop_masks is not None and rows is not None:
            drop_masks = {k: v[rows] for k, v in drop_masks.items()}
        hg, wg = images.shape[1], images.shape[2]
        if space:
            images = images[:, mesh.slab(hg)]
        x = preprocess(images, preprocessing or "tf", model.dtype)
        masks = masks.float()      # whole: the loss runs on whole images

        names = tx.trainable(state.params)
        train = {k: state.params[k].detach().requires_grad_(True)
                 for k in names}
        params = {**state.params, **train}
        with (_anomaly_checks() if debug == "checks"
              else contextlib.nullcontext()), spatial.partitioned(
                  mesh, hg, wg):
            logits, new_stats = apply_model(model, params, state.batch_stats,
                                            x, train=True,
                                            drop_masks=drop_masks)
            if space:
                logits = spatial.gather(logits, 1)
            full = (loss_fn.per_example(masks, logits) * w_rows).sum() / wsum
            # every rank of a space group computes this whole loss
            loss = full / mesh.space if space else full
            if debug:
                _check_finite("loss", {"loss": loss})
            # a parameter the loss does not reach (PSPNet reads C3 only, so
            # the encoder's last two stages) gets a zero gradient, as in JAX
            grads = dict(zip(names, torch.autograd.grad(
                loss, list(train.values()), allow_unused=True,
                materialize_grads=True)))
        if mesh is not None:
            dist.all_reduce_flat(list(grads.values()))

        old = {k: state.params[k] for k in names}
        updates, new_opt = tx.update(grads, state.opt_state, old)
        new_params = dict(state.params)
        new_params.update(zip(names, torch._foreach_add(
            list(old.values()), torch._foreach_mul(list(updates.values()),
                                                   -lr))))
        if debug:
            _check_finite("gradients or updated parameters", {
                **{f"grad {k}": g for k, g in grads.items()},
                **{k: new_params[k] for k in names}})

        logs = {"loss": full.detach()}
        if metric_fns:
            probs = apply_activation(logits.detach(), activation)
            for name, fn in metric_fns.items():
                logs[name] = ((fn(masks, probs, activation) * w_rows).sum()
                              / wsum)
        logs["_wsum"] = w_rows.sum()
        if space and mesh.s:
            # the group's logs count once, on its slab-0 rank
            logs = {k: torch.zeros_like(v) for k, v in logs.items()}
        return TrainState(new_params, new_stats, new_opt,
                          state.step + 1), logs

    return train_step


def build_eval_step(model, loss_fn, metric_fns: Dict[str, Callable],
                    activation: str, preprocessing: Optional[str],
                    transform: Optional[Callable] = None, mesh=None):
    """→ ``eval_step(state, batch) -> {"loss": (B,), metric: (B,) …,
    "weight": (B,)}``: per-example values with BatchNorm in eval mode,
    under ``torch.inference_mode()``.  ``transform`` is the deterministic
    ``transforms:`` preprocessing: validation sees what training saw.
    With ``mesh`` the values are the rank's rows' (and their weights);
    under the space axis the model runs on the slabs, the values on the
    gathered logits, and the weights are zeros but on the group's slab-0
    rank, so the group's rows count once."""
    space = mesh is not None and mesh.space > 1

    def eval_step(state: TrainState, batch):
        with torch.inference_mode():
            images, masks = batch["image"], batch["mask"]
            w = batch["weight"]
            rows = _rows(mesh, w, images.shape[0])
            if rows is not None:
                w = w[rows]
            if transform is not None:
                images, masks = (transform(images, masks) if rows is None
                                 else transform(images, masks, rows,
                                                batch["weight"].shape[0]))
            hg, wg = images.shape[1], images.shape[2]
            if space:
                images = images[:, mesh.slab(hg)]
                if mesh.s:
                    w = torch.zeros_like(w)
            x = preprocess(images, preprocessing or "tf", model.dtype)
            masks = masks.float()
            with spatial.partitioned(mesh, hg, wg):
                logits = apply_model(model, state.params, state.batch_stats,
                                     x)
                if space:
                    logits = spatial.gather(logits, 1)
            logs = {"loss": loss_fn.per_example(masks, logits),
                    "weight": w}
            probs = apply_activation(logits, activation)
            for name, fn in metric_fns.items():
                logs[name] = fn(masks, probs, activation)
        return logs

    return eval_step


def _rows(mesh, w: Tensor, b: int) -> Optional[slice]:
    """The rank's rows of the global batch ``w`` weighs (None without a
    mesh); ``b`` images must be there."""
    if mesh is None:
        return None
    rows = mesh.rows(w.shape[0])
    if rows.stop - rows.start != b:
        raise ValueError(f"rank {mesh.rank} holds {b} rows of a global "
                         f"batch of {w.shape[0]}; its share is "
                         f"{rows.stop - rows.start}")
    return rows


def reduce_per_example(logs: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Per-example eval logs {k: (B,), "weight": (B,)} → scalar weighted
    sums ``sum(v·w)`` and the weight sum, on the logs' device."""
    with torch.inference_mode():
        w = logs["weight"]
        out = {k: (v * w).sum() for k, v in logs.items() if k != "weight"}
        out["weight"] = w.sum()
    return out
