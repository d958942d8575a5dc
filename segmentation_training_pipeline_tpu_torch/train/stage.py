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

Data parallelism, one process per card (``parallel/``): in a process
group the mesh covers the group (``mesh:`` from YAML, else every rank on
the ``data`` axis; the global batch and each stage's batch must divide by
it, with the JAX package's errors).  Each rank decodes and augments its
rows of every global batch, BatchNorm and the gradients are reduced over
the group (``train/step.py``), and the epoch's train and validation sums
are reduced in one all-reduce before the best-epoch choice and the
callbacks, so every rank takes the same decisions.  Only the primary
writes the checkpoint, the CSV and the event file; two barriers (after
the best save, after the done marker) keep a resume's skips the same on
every rank.  A process without a group runs the one-process path.  With
``mesh: {data: D, space: S}`` the D·S ranks form D space groups: every
rank of a group decodes and augments its data block's rows whole, the
model runs on H slabs (``parallel/spatial.py``), and the group's logs and
validation weights count once (``train/step.py``), so the one all-reduce
of the epoch's sums stays as it is.
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
from ..parallel import distributed as dist
from ..parallel.mesh import MeshSpec, build_mesh
from . import callbacks as cb
from .checkpoint import checkpoint_meta, load_checkpoint, save_checkpoint
from .optimizers import build_optimizer
from .step import (build_eval_step, build_train_step, create_train_state,
                   reduce_per_example)

Tensor = torch.Tensor


def _gcd_mesh(cfg):
    """The data-parallel layout: ``mesh:`` from YAML, else every rank of
    the group on the data axis (the global batch must divide by it), else
    one process on one card."""
    if cfg.mesh:
        return build_mesh(MeshSpec.from_config(cfg.mesh))
    n = dist.process_count()
    if n > 1 and cfg.batch % n:
        raise ValueError(
            f"multi-host run: global batch {cfg.batch} must be divisible "
            f"by the global device count {n} (or set mesh: in YAML)")
    return build_mesh(MeshSpec(data=n, space=1))


def _stack(logs: List[Dict[str, Tensor]], keys: List[str]) -> Tensor:
    """Per-step scalar logs → a (steps, keys) float64 tensor on their
    device (one copy brings it to the host)."""
    return torch.stack([torch.stack([d[k].float() for k in keys])
                        for d in logs]).double()


def _train_means_of(keys: List[str], a: np.ndarray) -> Dict[str, float]:
    """(steps, keys) per-batch train logs → epoch means weighted by each
    batch's real example count (``_wsum``), so a wrap-padded last batch
    counts as its real rows.  Keys sorted, as the JAX package's logs come
    out of jit."""
    ws = a[:, keys.index("_wsum")]
    return {k: float(np.sum(a[:, j] * ws) / ws.sum())
            for j, k in enumerate(keys) if k != "_wsum"}


def _val_means_of(keys: List[str], a: np.ndarray) -> Dict[str, float]:
    """(keys,) weighted eval sums of an epoch → padding-corrected means."""
    wsum = max(a[keys.index("weight")], 1.0)
    return {k: float(a[j] / wsum) for j, k in enumerate(keys)
            if k != "weight"}


def _train_means(logs: List[Dict[str, Tensor]]) -> Dict[str, float]:
    if not logs:
        return {}
    keys = sorted(logs[0])
    return _train_means_of(keys, _stack(logs, keys).cpu().numpy())


def _val_means(sums: List[Dict[str, Tensor]]) -> Dict[str, float]:
    """Per-batch weighted eval sums (``reduce_per_example``) → padding-
    corrected epoch means."""
    if not sums:
        return {}
    keys = sorted(sums[0])
    return _val_means_of(keys, _stack(sums, keys).cpu().numpy().sum(axis=0))


def _group_means(train_logs: List[Dict[str, Tensor]],
                 val_sums: List[Dict[str, Tensor]]) -> Dict[str, float]:
    """The epoch's logs over the group: the ranks' per-step train shares
    and validation sums summed by one all-reduce, then one copy to the
    host.  Every rank gets the same numbers."""
    tk = sorted(train_logs[0]) if train_logs else []
    vk = sorted(val_sums[0]) if val_sums else []
    parts = []
    if tk:
        parts.append(_stack(train_logs, tk).reshape(-1))
    if vk:
        parts.append(_stack(val_sums, vk).sum(0))
    if not parts:
        return {}
    flat = dist.all_reduce_(torch.cat(parts)).cpu().numpy()
    out = {}
    if tk:
        out.update(_train_means_of(tk, flat[:len(train_logs) * len(tk)]
                                   .reshape(len(train_logs), len(tk))))
    if vk:
        vals = _val_means_of(vk, flat[len(flat) - len(vk):])
        out.update({f"val_{k}": v for k, v in vals.items()})
    return out


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
                 device="cuda", timings: Optional[list] = None,
                 aug_seed: Optional[int] = None) -> Dict[str, Dict]:
    """Train all requested folds through all stages on ``device``.  Returns
    per-(fold, stage) summary dicts (best metric, epochs run, checkpoint
    path), keyed ``fold{f}.stage{s}``.

    ``timings``: a list that gets one dict per epoch with the wall seconds
    of its train loop (ended by the copy of its logs to the host), of the
    wait for its first batch within it, of validation and of the
    checkpoint, and its train steps and images.

    ``aug_seed``: replaces ``random_state`` in the seed of the augmentation
    generators (``aug_seed·1000 + fold·10 + stage``), so two fits of one
    config can draw different augmentations; weights and folds keep
    ``random_state``.

    In a process group (``parallel.distributed.maybe_initialize``) the fit
    is data-parallel over the group: see the module's notes."""
    mesh = _gcd_mesh(cfg)
    # the collectives run in any process with a group, whatever its size
    dp = mesh if dist.active() else None
    primary = dist.is_primary()
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
        rows = dp.rows(batch) if dp is not None else None
        return Prefetcher(lambda: make_batches(
            ds, plan, cfg.shape, cfg.classes, cfg.activation, batch,
            cache=item_cache, rows=rows), device=device, depth=cfg.prefetch)

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
            # a stage's batch must stay shardable on the data axis
            if dp is not None and batch % mesh.data:
                if cfg.mesh:
                    raise ValueError(
                        f"stage {si} batch {batch} is not divisible by the "
                        f"configured mesh data axis ({mesh.data})")
                raise ValueError(
                    f"multi-host run: stage {si} batch {batch} must be "
                    f"divisible by the global device count {mesh.world} "
                    f"(or set mesh: in YAML)")
            loss_expr = stage.loss or cfg.loss
            loss_fn = build_loss(loss_expr, cfg.activation, cfg.class_weights)
            tx = build_optimizer(cfg, freeze_encoder=frozen)
            train_step = build_train_step(
                model, tx, loss_fn, metric_fns, cfg.activation,
                cfg.preprocessing, aug=aug, transform=transform,
                debug=cfg.debug, mesh=dp)
            eval_step = build_eval_step(
                model, loss_fn, metric_fns, cfg.activation, cfg.preprocessing,
                transform=transform, mesh=dp)
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
            if primary:  # one writer per shared filesystem
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
            seed0 = cfg.random_state if aug_seed is None else aug_seed
            gen = torch.Generator(device=device).manual_seed(
                seed0 * 1000 + fold * 10 + si)

            if verbose:
                print(f"[fold {fold} stage {si}] epochs={stage.epochs} "
                      f"lr={base_lr} loss={loss_expr} frozen={frozen} "
                      f"batch={batch} device={device}"
                      + (f" rank={mesh.rank}/{mesh.world}" if dp else "")
                      + (f" slab={mesh.s}/{mesh.space}" if mesh.space > 1
                         else ""))

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
                if dp is None:
                    # the epoch's one copy of its train logs waits for its
                    # steps
                    epoch_logs = _train_means(train_logs)
                t_train = time.time()
                val_sums = [reduce_per_example(eval_step(state, b))
                            for b in batches(train_ds, val_idx, batch)]
                if dp is None:
                    for k, v in _val_means(val_sums).items():
                        epoch_logs[f"val_{k}"] = v
                else:
                    # one all-reduce of the epoch's sums: every rank's
                    # best-epoch choice and callbacks see the same numbers
                    epoch_logs = _group_means(train_logs, val_sums)
                t_val = time.time()
                if prof is not None:
                    prof.__exit__(None, None, None)
                    os.makedirs(profile_dir, exist_ok=True)
                    # in a group each rank traces its own card
                    prof.export_chrome_trace(os.path.join(
                        profile_dir, "trace.json" if primary
                        else f"trace-rank{mesh.rank}.json"))
                    if verbose:
                        print(f"  profiler trace written to {profile_dir}")
                epoch_logs["time"] = time.time() - t0
                epochs_run = epoch + 1

                if tracker.update(epoch_logs) and primary:
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

            # the best weights carry into the next stage; the primary's
            # writes land before any rank reads them
            dist.barrier(f"stage-save-{key}")
            if os.path.exists(ckpt_path):
                variables = load_checkpoint(ckpt_path, model)
                m = checkpoint_meta(ckpt_path) or {}
                m["done"] = True
                m["epochs_run"] = epochs_run
                if primary:
                    save_checkpoint(ckpt_path, variables, meta=m)
            elif primary:
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
            else:
                variables = _variables(state)
            # the done marker is visible before any rank moves on, so a
            # resume skips the same stages on every rank
            dist.barrier(f"stage-done-{key}")
            results[key] = {"best": tracker.best, "epochs": epochs_run,
                            "checkpoint": ckpt_path}
    return results
