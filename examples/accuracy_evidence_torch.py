"""Accuracy evidence for the ±0.2 pt val-IoU bar (BASELINE.md), on the port.

Trains BASELINE acceptance configs 1-4 (scaled epochs) with the PyTorch
port on the deterministic synthetic shapes datasets, with the same dicts,
datasets, seeds, folds, stages and callbacks as
``examples/accuracy_evidence.py``, then scores each with the full
inference pipeline (``cfg.evaluate``).  On the card (the default):

    python examples/accuracy_evidence_torch.py --config all --out OUT

``OUT/accuracy.json`` holds the evaluate dicts under the JAX script's keys;
``OUT/run.json`` the device, its power limit, ``--seed`` and each config's
fit and evaluate wall seconds.  ``--seed`` seeds the augmentation draws
(``cfg.fit(aug_seed=...)``); weights and folds come from ``random_state``
as in the JAX script.  ``--device cpu`` runs on the CPU; ``--device cuda``
on a host without a card raises.

One initial weight file for both packages (the JAX side is
``examples/accuracy_reference_jax.py``):

    python examples/accuracy_evidence_torch.py --config all --write-init INIT
    python examples/accuracy_evidence_torch.py --config all --init INIT

``--write-init INIT`` writes, for each config, a fold-0 init as a
flax-format checkpoint ``INIT/config{N}.weights`` and its sha256 beside it
(``.sha256``), then stops; ``--init-seed N`` draws it from
``numpy.random.default_rng(N)`` instead, for other inits of the same
configs.  The init has the laws of the port's
``init_model`` (each conv kernel a truncated normal of flax's
``lecun_normal`` scale, biases 0, BatchNorm 1/0/0/1), drawn from
``numpy.random.default_rng(random_state + 0)`` in module order: torch's
own generator gives other bytes across torch versions, numpy's stream the
same bytes on every host (the sha256 says so).  ``--init INIT`` sets stage 0's
``initial_weights`` of every config to that file, so every fold starts from
it; the file's sha256 is printed and kept in ``run.json``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

KEYS = {
    "1": "config1_unet_resnet34_128",
    "2": "config2_fpn_efficientnetb0_256",
    "3": "config3_pspnet_resnet34_multiclass_128",
    "4": "config4_unet_resnet34_5fold_stages_negatives",
}

_PLATEAU = {"ReduceLROnPlateau": {
    "monitor": "val_iou", "factor": 0.5, "patience": 4}}
_BINARY = dict(classes=1, activation="sigmoid",
               loss="binary_crossentropy + 0.25*dice_loss",
               optimizer="Adam", lr=1e-3, batch=16,
               metrics=["iou", "dice"], primary_metric="val_iou",
               folds_count=5, random_state=33)


def config_dicts(epochs: int) -> dict:
    """The four experiment dicts of ``examples/accuracy_evidence.py``."""
    e1 = max(2, epochs // 4)
    e2 = max(4, epochs - e1)
    return {
        # Unet-resnet34 128², BCE(+dice), single fold
        "1": dict(architecture="Unet", backbone="resnet34",
                  shape=[128, 128, 3], **_BINARY,
                  stages=[{"epochs": epochs}], callbacks=_PLATEAU),
        # FPN-efficientnetb0 256² with the Fliplr / Affine / elastic block
        "2": dict(architecture="FPN", backbone="efficientnetb0",
                  shape=[256, 256, 3], **_BINARY,
                  augmentation={
                      "Fliplr": 0.5,
                      "Affine": {"rotate": [-15, 15], "scale": [0.9, 1.1]},
                      "ElasticTransformation": {"alpha": [0, 25],
                                                "sigma": 5},
                  },
                  stages=[{"epochs": epochs}], callbacks=_PLATEAU),
        # PSPNet multiclass (softmax, 3 classes), CE + focal, class weights
        "3": dict(architecture="PSPNet", backbone="resnet34",
                  shape=[128, 128, 3], classes=3, activation="softmax",
                  loss="categorical_crossentropy + 0.5*categorical_focal_loss",
                  class_weights=[0.3, 1.0, 1.0],
                  optimizer="Adam", lr=1e-3, batch=16,
                  metrics=["iou", "dice"], primary_metric="val_iou",
                  folds_count=5, random_state=33,
                  stages=[{"epochs": epochs}], callbacks=_PLATEAU),
        # 5-fold plan, freeze -> unfreeze with an LR drop, negatives=real
        "4": dict(architecture="Unet", backbone="resnet34",
                  shape=[128, 128, 3], **_BINARY,
                  negatives="real", validation_negatives="real",
                  stages=[{"epochs": e1, "freeze_encoder": True},
                          {"epochs": e2, "unfreeze_encoder": True,
                           "lr": 3e-4}]),
    }


def dataset(config: str, n: int):
    """The JAX script's dataset for ``config`` (same generator, seed)."""
    from segmentation_training_pipeline_tpu_torch.data.synthetic import (
        generate_multiclass_shapes_dataset, generate_shapes_dataset)

    if config == "1":
        return generate_shapes_dataset(n, size=128, seed=7)
    if config == "2":
        return generate_shapes_dataset(n, size=256, seed=11)
    if config == "3":
        return generate_multiclass_shapes_dataset(n, size=128, seed=13)
    return generate_shapes_dataset(n, size=128, seed=17, p_empty=0.25)


def init_path(init_dir: str, config: str) -> str:
    return os.path.join(os.path.abspath(init_dir), f"config{config}.weights")


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def numpy_init(model, seed: int):
    """``init_model``'s laws on ``model`` (on the CPU), drawn from
    ``numpy.random.default_rng(seed)``: each conv kernel, in module order,
    std·z with z standard normal redrawn until inside [−2, 2] (float64,
    then cast to float32), std = sqrt(1/fan_in) / _TRUNC_STD; biases and
    BatchNorm reset as ``init_model`` resets them."""
    import math

    import numpy as np
    import torch
    from segmentation_training_pipeline_tpu_torch.models.layers import (
        _TRUNC_STD, BatchNorm, Conv)

    rng = np.random.default_rng(seed)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.reset_parameters(None)       # constants: no generator drawn
        elif isinstance(m, Conv):
            w = m.weight
            std = math.sqrt(1.0 / w[0].numel()) / _TRUNC_STD
            z = rng.standard_normal(w.numel())
            out = np.abs(z) > 2.0
            while out.any():
                z[out] = rng.standard_normal(int(out.sum()))
                out = np.abs(z) > 2.0
            with torch.no_grad():
                w.copy_(torch.from_numpy(
                    (std * z).astype(np.float32).reshape(w.shape)))
                if m.bias is not None:
                    m.bias.zero_()
    return model


def write_init(init_dir: str, config: str, epochs: int,
               seed: int = None) -> str:
    """Write ``config``'s fold-0 init (``numpy_init`` from ``seed``, by
    default ``random_state + 0``); return its sha256 (also written beside
    the file)."""
    import segmentation_training_pipeline_tpu_torch as stp
    from segmentation_training_pipeline_tpu_torch.models.factory import (
        model_from_config)
    from segmentation_training_pipeline_tpu_torch.train.checkpoint import (
        save_checkpoint)

    cfg = stp.parse_dict(config_dicts(epochs)[config], directory=init_dir)
    model = numpy_init(model_from_config(cfg).cpu(),
                       cfg.random_state + 0 if seed is None else seed)
    path = init_path(init_dir, config)
    save_checkpoint(path, model.state_dict())
    digest = sha256(path)
    with open(path + ".sha256", "w") as f:
        f.write(f"{digest}  {os.path.basename(path)}\n")
    return digest


def card_info(device: str) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu"}
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device on this host")
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    try:
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        out["nvidia_smi"] = None
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="stp_accuracy_torch")
    p.add_argument("--n", type=int, default=400)
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--config", choices=["1", "2", "3", "4", "both", "all"],
                   default="both")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=None,
                   help="seed of the augmentation draws "
                        "(default: random_state)")
    p.add_argument("--write-init", metavar="DIR", default=None,
                   help="write each config's fold-0 init (init_model's "
                        "laws drawn from numpy.random.default_rng("
                        "random_state)) to DIR/config{N}.weights with its "
                        "sha256, and stop")
    p.add_argument("--init", metavar="DIR", default=None,
                   help="start stage 0 of every fold of every config from "
                        "DIR/config{N}.weights (as --write-init wrote it; "
                        "examples/accuracy_reference_jax.py --init takes "
                        "the same files)")
    p.add_argument("--init-seed", type=int, default=None,
                   help="--write-init draws from numpy.random.default_rng("
                        "INIT_SEED) instead of random_state (folds, plans "
                        "and augmentation draws keep random_state): other "
                        "inits of the same configs")
    args = p.parse_args(argv)
    wanted = {"all": "1234", "both": "12"}.get(args.config, args.config)

    if args.write_init:
        inits = {c: write_init(args.write_init, c, args.epochs,
                               args.init_seed) for c in wanted}
        for c, digest in inits.items():
            print(f"init config{c}: {init_path(args.write_init, c)} "
                  f"sha256 {digest}", flush=True)
        return inits

    import segmentation_training_pipeline_tpu_torch as stp

    card = card_info(args.device)
    print("device:", json.dumps(card), flush=True)
    dicts = config_dicts(args.epochs)
    inits = {}
    if args.init:
        for c in wanted:
            path = init_path(args.init, c)
            dicts[c]["stages"][0]["initial_weights"] = path
            inits[KEYS[c]] = sha256(path)
            print(f"init config{c}: {path} sha256 {inits[KEYS[c]]}",
                  flush=True)
    results, seconds = {}, {}
    for c in wanted:
        d = os.path.join(args.out, f"config{c}")
        os.makedirs(d, exist_ok=True)
        ds = dataset(c, args.n)
        cfg = stp.parse_dict(dicts[c], directory=d)
        folds = [0, 1] if c == "4" else [0]
        t0 = time.time()
        cfg.fit(ds, foldsToExecute=folds, verbose=1, device=args.device,
                aug_seed=args.seed)
        t1 = time.time()
        # full-pipeline eval (TTA off, original sizes)
        ev = cfg.evaluate(ds, folds=folds if c == "4" else None,
                          device=args.device)
        seconds[KEYS[c]] = {"fit": t1 - t0, "evaluate": time.time() - t1}
        results[KEYS[c]] = ev
        print(f"config{c} evaluate:", ev, seconds[KEYS[c]], flush=True)

    os.makedirs(args.out, exist_ok=True)
    out_json = os.path.join(args.out, "accuracy.json")
    with open(out_json, "w") as f:
        json.dump(results, f, indent=2)
    with open(os.path.join(args.out, "run.json"), "w") as f:
        json.dump({"device": card, "seed": args.seed, "n": args.n,
                   "epochs": args.epochs, "seconds": seconds,
                   "init_sha256": inits}, f, indent=2)
    print(json.dumps(results))
    print(f"written to {out_json}")
    return results


if __name__ == "__main__":
    # run as a file from a checkout: the package sits beside examples/
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
