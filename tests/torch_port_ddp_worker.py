"""One rank of a two-process gloo group for ``test_torch_port_ddp.py``.

Not a pytest module: ``python torch_port_ddp_worker.py MODE RANK WORLD
STORE DIR`` joins the group through the file store ``STORE`` (a file in
the test's temporary directory, so side-by-side test workers never share
a port) and runs, on the CPU:

  * ``step``: from ``DIR/init.pt`` and ``DIR/batch.pt``, one f32 SGD step
    of Unet-resnet18 on its rows of the global batch without an
    augmentation block, then one from the same weights with the
    ``transforms:`` and ``augmentation:`` blocks of ``DIR/blocks.json``
    (the test's config-2 block), its draws sampled from a generator
    seeded as the test's; then rank 0 leaves the group and runs both
    steps again on the whole batch as the one rank of a group of one;
    each result (new parameters, BN statistics, logs) goes to
    ``DIR/step-{RANK}.pt``;
  * ``fit``: the two-stage ``fit_pipeline`` of ``fit_config`` on
    ``fit_dataset``, then the same fit again; on rank 1 the checkpoint,
    CSV and event-file writers raise if called (primary-only IO by
    construction).  ``DIR/summary-{RANK}.json`` holds both results.
"""

import json
import os
import sys

import numpy as np
import torch

FIT_STAGES = [{"epochs": 2}, {"epochs": 2, "lr": 5e-3}]


def fit_config(workdir: str) -> dict:
    """The two-stage config both the ranks and the one-process fit run."""
    return dict(
        architecture="Unet", backbone="resnet18", shape=[32, 32, 3],
        classes=1, activation="sigmoid", loss="binary_crossentropy",
        optimizer="SGD", lr=1e-2, batch=8, folds_count=2, dtype="float32",
        metrics=["iou"], primary_metric="val_iou", stages=FIT_STAGES,
        callbacks={"TensorBoard": {"log_dir": os.path.join(workdir,
                                                           "logs")}})


def fit_dataset():
    """16 32×32 circle-mask items from a fixed numpy seed."""
    from segmentation_training_pipeline_tpu_torch.data.datasets import (
        LambdaDataSet)

    r = np.random.RandomState(7)
    xs, ys = [], []
    yy, xx = np.mgrid[0:32, 0:32]
    for _ in range(16):
        xs.append(r.randint(0, 255, size=(32, 32, 3), dtype=np.uint8))
        cy, cx = r.randint(8, 24, size=2)
        ys.append(((yy - cy) ** 2 + (xx - cx) ** 2 < 36).astype(np.uint8))
    return LambdaDataSet(xs, ys)


STEP_CONFIG = dict(architecture="Unet", backbone="resnet18",
                   shape=[32, 32, 3], classes=1, activation="sigmoid",
                   loss="binary_crossentropy", optimizer="SGD", lr=1e-3,
                   dtype="float32")
AUG_SEED = 5


def build_step(blocks=None, mesh=None):
    """(model, optimizer, step) of ``STEP_CONFIG``; ``blocks``: None or
    {"transforms": …, "augmentation": …}."""
    from segmentation_training_pipeline_tpu_torch import config as TC
    from segmentation_training_pipeline_tpu_torch.models import factory as TF
    from segmentation_training_pipeline_tpu_torch.ops import losses as TLo
    from segmentation_training_pipeline_tpu_torch.ops.aug import (
        lowering as TL)
    from segmentation_training_pipeline_tpu_torch.train import (
        optimizers as TO)
    from segmentation_training_pipeline_tpu_torch.train import step as TS

    cfg = TC.parse_dict(STEP_CONFIG)
    model = TF.create_model("Unet", "resnet18", 1, dtype="float32")
    tx = TO.build_optimizer(cfg)
    aug, transform = (TL.build_transform_fn(blocks["transforms"],
                                            blocks["augmentation"])
                      if blocks else (None, None))
    step = TS.build_train_step(model, tx, TLo.build_loss(cfg.loss, "sigmoid"),
                               {}, "sigmoid", None, aug=aug,
                               transform=transform, mesh=mesh)
    return model, tx, step


def run_step(init: dict, batch: dict, blocks=None, mesh=None):
    """One step from ``init`` on ``batch`` → (params, stats, logs)."""
    from segmentation_training_pipeline_tpu_torch.train import step as TS

    model, tx, step = build_step(blocks, mesh)
    model.load_state_dict(init)
    state = TS.create_train_state(model, tx, device="cpu")
    gen = torch.Generator().manual_seed(AUG_SEED)
    new, logs = step(state, batch, 1e-3, gen=gen)
    return new.params, new.batch_stats, {k: v.detach() for k, v in
                                         logs.items()}


def _forbid_writes():
    from segmentation_training_pipeline_tpu_torch.train import stage
    from segmentation_training_pipeline_tpu_torch.utils import tfevents

    def forbidden_save(*a, **k):
        raise AssertionError("rank 1 wrote a checkpoint")

    class ForbiddenCSV:
        def __init__(self, *a, **k):
            raise AssertionError("rank 1 opened the metrics CSV")

    class ForbiddenWriter:
        def __init__(self, *a, **k):
            raise AssertionError("rank 1 opened an event writer")

    stage.save_checkpoint = forbidden_save
    stage.cb.CSVLogger = ForbiddenCSV
    tfevents.EventFileWriter = ForbiddenWriter


def main():
    mode, rank, world, store, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from segmentation_training_pipeline_tpu_torch.parallel import (
        distributed as D)
    from segmentation_training_pipeline_tpu_torch.parallel.mesh import (
        build_mesh, shard_batch)

    D.maybe_initialize(force=True, backend="gloo",
                       init_method=f"file://{store}", world_size=world,
                       rank=rank, timeout_s=60)
    mesh = build_mesh()
    if (mesh.rank, mesh.world, mesh.data) != (rank, world, world):
        raise RuntimeError(f"rank {rank}: mesh {mesh}")
    if mode == "step":
        init = torch.load(os.path.join(out, "init.pt"))
        batch = shard_batch(torch.load(os.path.join(out, "batch.pt")), mesh)
        with open(os.path.join(out, "blocks.json")) as f:
            blocks = json.load(f)
        result = {}
        for name, b in (("plain", None), ("block", blocks)):
            D.reset_counts()
            params, stats, logs = run_step(init, batch, b, mesh)
            result[name] = dict(
                params=params, stats=stats, logs=logs, counts=D.counts())
        if rank == 0:
            # then rank 0 alone, in a group of one, on the whole batch
            D.shutdown()
            D.maybe_initialize(force=True, backend="gloo",
                               init_method=f"file://{store}-solo",
                               world_size=1, rank=0, timeout_s=60)
            solo = build_mesh()
            whole = shard_batch(torch.load(os.path.join(out, "batch.pt")),
                                solo)
            result["solo"] = {}
            for name, b in (("plain", None), ("block", blocks)):
                params, stats, _ = run_step(init, whole, b, solo)
                result["solo"][name] = dict(params=params, stats=stats)
        torch.save(result, os.path.join(out, f"step-{rank}.pt"))
    else:
        import segmentation_training_pipeline_tpu_torch as stp

        if rank != 0:
            _forbid_writes()
        cfg = stp.parse_dict(fit_config(out), directory=out)
        first = cfg.fit(fit_dataset(), foldsToExecute=[0], verbose=0,
                        device="cpu")
        again = cfg.fit(fit_dataset(), foldsToExecute=[0], verbose=0,
                        device="cpu")
        with open(os.path.join(out, f"summary-{rank}.json"), "w") as f:
            json.dump({"first": first, "again": again}, f)
    D.shutdown()
    print(f"rank {rank}: ok", flush=True)


if __name__ == "__main__":
    main()
