"""K-fold × multi-stage training loop (PyTorch).

Counterpart of ``segmentation_training_pipeline_tpu/train/stage.py``
(``fit_pipeline``): per fold, a model initialised at ``random_state +
fold``, its encoder then loaded from ``encoder_weights`` when the config
names them (``models/pretrained.py``; a named spec with no local file
warns and trains from scratch); per stage, the encoder frozen or unfrozen, optional initial
weights, the stage's batch, loss, lr, negatives plan and callbacks, a
fresh optimizer state, then epochs of train steps and a validation pass.
The best epoch (``primary_metric``) is checkpointed to
``weights/best-{fold}.{stage}.weights`` with the JAX package's sidecar
keys, every epoch is a row of ``metrics/metrics-{fold}.{stage}.csv``, and
the best weights carry into the next stage.  ``fit`` is idempotent per
(fold, stage): a stage whose sidecar says ``done`` is skipped and its best
weights loaded; a stage that crashed appends to its CSV.

On the device side: batches arrive through ``Prefetcher`` (pinned,
``non_blocking`` copies); each step's logs stay on the card and the epoch
brings them back in one copy, as the JAX loop's one ``device_get`` per
epoch, so no step waits for the host.  The augmentation draws come from one
``torch.Generator`` per (fold, stage) on the device, seeded with
``random_state·1000 + fold·10 + stage``; they are not threefry's, so the
same seed does not give the JAX package's draws.

``debug: true`` fails the fit on the first train step with a non-finite
loss, gradient or parameter (``FloatingPointError``, as the JAX package's
``jax_debug_nans``); ``debug: checks`` also runs each step under
autograd's anomaly mode (``train/step.py``).  Nothing is caught.

Not ported yet (raises ``NotImplementedError``): a ``mesh:`` of more than
one device.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.batcher import Prefetcher, make_batches
from ..data.datasets import (CropAndSplitDataSet, KFoldedDataSet,
                             expand_tile_indices)
from ..models.factory import (init_model, model_from_config,
                              variant_from_checkpoint)
from ..models.pretrained import load_into_model
from ..ops import metrics as _metrics
from ..ops.aug.lowering import build_transform_fn
from ..ops.losses import build_loss
from . import callbacks as cb
from .checkpoint import checkpoint_meta, load_checkpoint, save_checkpoint
from .optimizers import build_optimizer
from .step import (build_eval_step, build_train_step, create_train_state,
                   reduce_per_example)

Tensor = torch.Tensor


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to the torch "
                               "package")


def _host(logs: List[Dict[str, Tensor]], keys: List[str]) -> np.ndarray:
    """Per-step scalar logs → a (steps, keys) float64 array, in one copy
    from the device."""
    rows = torch.stack([torch.stack([d[k].float() for k in keys])
                        for d in logs])
    return rows.cpu().numpy().astype(np.float64)


def _train_means(logs: List[Dict[str, Tensor]]) -> Dict[str, float]:
    """Per-batch train logs → epoch means weighted by each batch's real
    example count (``_wsum``), so a wrap-padded last batch counts as its
    real rows.  Keys sorted, as the JAX package's logs come out of jit."""
    if not logs:
        return {}
    keys = sorted(logs[0])
    a = _host(logs, keys)
    ws = a[:, keys.index("_wsum")]
    return {k: float(np.sum(a[:, j] * ws) / ws.sum())
            for j, k in enumerate(keys) if k != "_wsum"}


def _val_means(sums: List[Dict[str, Tensor]]) -> Dict[str, float]:
    """Per-batch weighted eval sums (``reduce_per_example``) → padding-
    corrected epoch means."""
    if not sums:
        return {}
    keys = sorted(sums[0])
    a = _host(sums, keys).sum(axis=0)
    wsum = max(a[keys.index("weight")], 1.0)
    return {k: float(a[j] / wsum) for j, k in enumerate(keys)
            if k != "weight"}


class _BestTracker:
    def __init__(self, monitor: str, mode: str):
        self.monitor = monitor
        self.mode = mode
        self.best = math.inf if mode == "min" else -math.inf

    def update(self, logs: Dict[str, float]) -> bool:
        cur = logs.get(self.monitor)
        if cur is None or not math.isfinite(cur):
            return False
        better = cur < self.best if self.mode == "min" else cur > self.best
        if better:
            self.best = cur
        return better


def _variables(state) -> Dict[str, Tensor]:
    """A train state's parameters and BN statistics as one state dict."""
    return {**state.params, **state.batch_stats}


def fit_pipeline(cfg, dataset, foldsToExecute: Optional[Sequence[int]] = None,
                 start_from_stage: int = 0, verbose: Optional[int] = None,
                 device="cuda", timings: Optional[list] = None
                 ) -> Dict[str, Dict]:
    """Train all requested folds through all stages on ``device``.  Returns
    per-(fold, stage) summary dicts (best metric, epochs run, checkpoint
    path), keyed ``fold{f}.stage{s}``.

    ``timings``: a list that gets one dict per epoch with the wall seconds
    of its train loop (ended by the copy of its logs to the host), of the
    wait for its first batch within it, of validation and of the
    checkpoint, and its train steps and images."""
    if cfg.mesh and math.prod(int(v) for v in cfg.mesh.values()) > 1:
        raise _not_ported(f"`mesh: {cfg.mesh}` (more than one device)")
    verbose = cfg.verbose if verbose is None else verbose
    device = torch.device(device)
    # resume rebuilds the graph the checkpoints were trained with
    existing = [cfg.weights_path(f, s) for f in range(cfg.folds_count)
                for s in range(len(cfg.stages))]
    model = model_from_config(cfg, variant_from_checkpoint(cfg, existing))
    metric_fns = {m: _metrics.get(m) for m in cfg.metrics}
    aug, transform = build_transform_fn(cfg.transforms, cfg.augmentation)
    kfold = (dataset if isinstance(dataset, KFoldedDataSet)
             else cfg.kfold(dataset))
    # crops: N — train on N×N tiles; folds and negatives stay parent-level
    train_ds = kfold.dataset
    if cfg.crops:
        train_ds = CropAndSplitDataSet(kfold.dataset, cfg.crops)
    # cache: true — decoded items shared across folds, stages and epochs
    item_cache = {} if cfg.cache else None

    folds = list(foldsToExecute) if foldsToExecute is not None \
        else list(range(cfg.folds_count))
    monitor = cfg.primary_metric
    mode = cfg.primary_mode()

    def batches(ds, plan, batch):
        return Prefetcher(lambda: make_batches(
            ds, plan, cfg.shape, cfg.classes, cfg.activation, batch,
            cache=item_cache), device=device, depth=cfg.prefetch)

    results: Dict[str, Dict] = {}
    for fold in folds:
        variables = None  # lazy: skipped stages never initialise a model

        def ensure_variables(v, fold=fold):
            if v is None:
                # drawn on the CPU, so the values do not depend on the
                # device; then the encoder's pretrained weights, if any
                init_model(model.cpu(), cfg.random_state + fold, "cpu")
                if cfg.encoder_weights:
                    load_into_model(model, cfg.backbone, cfg.encoder_weights)
                model.to(device)
                v = model.state_dict()
            return v

        frozen = cfg.freeze_encoder
        for si, stage in enumerate(cfg.stages):
            key = f"fold{fold}.stage{si}"
            ckpt_path = cfg.weights_path(fold, si)
            meta = checkpoint_meta(ckpt_path)
            if si < start_from_stage or (meta and meta.get("done")):
                # skip a completed stage; pick up its best weights
                if os.path.exists(ckpt_path):
                    variables = load_checkpoint(ckpt_path, model)
                    results[key] = {"skipped": True, "checkpoint": ckpt_path,
                                    **({k: meta[k] for k in ("best",)
                                        if meta and k in meta})}
                continue
            variables = ensure_variables(variables)

            # --- stage setup ---------------------------------------------
            if stage.unfreeze_encoder:
                frozen = False
            if stage.freeze_encoder is not None:
                frozen = stage.freeze_encoder
            if stage.initial_weights:
                p = stage.initial_weights
                if not os.path.isabs(p):
                    p = os.path.join(cfg.directory, p)
                variables = load_checkpoint(p, model)
            model.load_state_dict(variables)

            batch = stage.batch or cfg.batch
            loss_expr = stage.loss or cfg.loss
            loss_fn = build_loss(loss_expr, cfg.activation, cfg.class_weights)
            tx = build_optimizer(cfg, freeze_encoder=frozen)
            train_step = build_train_step(
                model, tx, loss_fn, metric_fns, cfg.activation,
                cfg.preprocessing, aug=aug, transform=transform,
                debug=cfg.debug)
            eval_step = build_eval_step(
                model, loss_fn, metric_fns, cfg.activation, cfg.preprocessing,
                transform=transform)
            state = create_train_state(model, tx, device)

            base_lr = stage.lr if stage.lr is not None else cfg.lr
            control = cb.TrainingControl(base_lr=base_lr)
            cbs = [c for c in
                   (cb.instantiate(s, cfg.directory)
                    for s in (cfg.callbacks + stage.callbacks))
                   if c is not None]
            # a checkpoint without a done-marker means this stage crashed
            # mid-run: append to its metrics history instead of truncating
            resuming = meta is not None and not meta.get("done")
            cbs.append(cb.CSVLogger(cfg.metrics_path(fold, si),
                                    append=resuming))
            for c in cbs:
                c.on_train_begin(control)
            tracker = _BestTracker(monitor, mode)
            negatives = stage.negatives if stage.negatives is not None \
                else cfg.negatives
            val_negatives = (stage.validation_negatives
                             if stage.validation_negatives is not None
                             else cfg.validation_negatives)
            val_idx = kfold.val_indices(fold, val_negatives)
            if cfg.crops:
                val_idx = expand_tile_indices(val_idx, cfg.crops)
            gen = torch.Generator(device=device).manual_seed(
                cfg.random_state * 1000 + fold * 10 + si)

            if verbose:
                print(f"[fold {fold} stage {si}] epochs={stage.epochs} "
                      f"lr={base_lr} loss={loss_expr} frozen={frozen} "
                      f"batch={batch} device={device}")

            # profile: a torch.profiler trace of epoch 1 (epoch 0 holds the
            # first-call setup) unless the stage has only one epoch
            profile_dir = None
            if cfg.profile:
                profile_dir = (cfg.profile if isinstance(cfg.profile, str)
                               else os.path.join(cfg.directory, "profile"))
                profile_dir = os.path.join(profile_dir, f"fold{fold}.stage{si}")

            epochs_run = 0
            for epoch in range(stage.epochs):
                t0 = time.time()
                tracing = profile_dir is not None and (
                    epoch == 1 or (stage.epochs == 1 and epoch == 0))
                prof = None
                if tracing:
                    acts = [torch.profiler.ProfilerActivity.CPU]
                    if device.type == "cuda":
                        acts.append(torch.profiler.ProfilerActivity.CUDA)
                    prof = torch.profiler.profile(activities=acts)
                    prof.__enter__()
                plan = kfold.epoch_indices(fold, epoch, negatives)
                if cfg.crops:
                    plan = expand_tile_indices(
                        plan, cfg.crops,
                        shuffle_seed=cfg.random_state * 31 + fold * 7 + epoch)
                if stage.steps_per_epoch:
                    plan = plan[: stage.steps_per_epoch * batch]
                train_logs = []
                t_first = None
                for b in batches(train_ds, plan, batch):
                    t_first = t_first or time.time()
                    for c in cbs:
                        c.on_batch_begin(control)
                    state, logs = train_step(state, b, control.effective_lr,
                                             gen=gen)
                    train_logs.append(logs)
                    control.global_step += 1
                # the epoch's one copy of its train logs waits for its steps
                epoch_logs = _train_means(train_logs)
                t_train = time.time()
                val_sums = [reduce_per_example(eval_step(state, b))
                            for b in batches(train_ds, val_idx, batch)]
                for k, v in _val_means(val_sums).items():
                    epoch_logs[f"val_{k}"] = v
                t_val = time.time()
                if prof is not None:
                    prof.__exit__(None, None, None)
                    os.makedirs(profile_dir, exist_ok=True)
                    prof.export_chrome_trace(os.path.join(profile_dir,
                                                          "trace.json"))
                    if verbose:
                        print(f"  profiler trace written to {profile_dir}")
                epoch_logs["time"] = time.time() - t0
                epochs_run = epoch + 1

                if tracker.update(epoch_logs):
                    save_checkpoint(ckpt_path, _variables(state),
                                    meta={"fold": fold, "stage": si,
                                          "monitor": monitor,
                                          "best": tracker.best,
                                          "epoch": epoch,
                                          "architecture": cfg.architecture,
                                          "backbone": cfg.backbone,
                                          "encoder_variant":
                                              model.encoder_variant,
                                          "done": False})
                if timings is not None:
                    timings.append(dict(
                        fold=fold, stage=si, epoch=epoch,
                        train_s=t_train - t0,
                        first_batch_s=(t_first or t_train) - t0,
                        val_s=t_val - t_train,
                        checkpoint_s=time.time() - t_val,
                        steps=len(train_logs), images=len(plan)))
                for c in cbs:
                    c.on_epoch_end(epoch, epoch_logs, control)
                if verbose:
                    msg = " ".join(f"{k}={v:.4f}" for k, v in epoch_logs.items())
                    print(f"  epoch {epoch}: {msg} ({time.time()-t0:.1f}s)")
                if control.stop_training:
                    break

            for c in cbs:
                c.on_train_end(control)

            # the best weights carry into the next stage
            if os.path.exists(ckpt_path):
                variables = load_checkpoint(ckpt_path, model)
                m = checkpoint_meta(ckpt_path) or {}
                m["done"] = True
                m["epochs_run"] = epochs_run
                save_checkpoint(ckpt_path, variables, meta=m)
            else:
                # no improvement ever recorded: persist the final weights
                variables = _variables(state)
                save_checkpoint(ckpt_path, variables,
                                meta={"fold": fold, "stage": si,
                                      "monitor": monitor, "best": None,
                                      "architecture": cfg.architecture,
                                      "backbone": cfg.backbone,
                                      "encoder_variant":
                                          model.encoder_variant,
                                      "done": True,
                                      "epochs_run": epochs_run})
            results[key] = {"best": tracker.best, "epochs": epochs_run,
                            "checkpoint": ckpt_path}
    return results
