"""The JAX package's accuracy on BASELINE configs 1-4, on the CPU, from a
given initial weight file: the reference the port is held to.

The same four experiment dicts and datasets as
``examples/accuracy_evidence.py``; ``--init INIT`` sets stage 0's
``initial_weights`` of every config to ``INIT/config{N}.weights``, the
flax-format file that ``examples/accuracy_evidence_torch.py --write-init
INIT`` writes, so every fold of both packages starts from one set of
weights:

    python examples/accuracy_evidence_torch.py --config all --write-init INIT
    python examples/accuracy_reference_jax.py --config 1 --init INIT --out OUT

The CPU is forced (``jax.config.update("jax_platforms", "cpu")`` before
any op).  ``OUT/accuracy.json`` holds the evaluate dicts under the JAX
script's keys, ``OUT/config{N}_f{fold}s{stage}_metrics.csv`` each stage's
per-epoch metrics, and ``OUT/run.json`` the commit, the CPU, the thread
count, the init files' sha256 and each config's fit and evaluate seconds.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import platform
import shutil
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
    from segmentation_training_pipeline_tpu.data.synthetic import (
        generate_multiclass_shapes_dataset, generate_shapes_dataset)

    if config == "1":
        return generate_shapes_dataset(n, size=128, seed=7)
    if config == "2":
        return generate_shapes_dataset(n, size=256, seed=11)
    if config == "3":
        return generate_multiclass_shapes_dataset(n, size=128, seed=13)
    return generate_shapes_dataset(n, size=128, seed=17, p_empty=0.25)


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _commit() -> str | None:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=30, cwd=os.path.dirname(os.path.abspath(__file__))
        ).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def _cpu_name() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="stp_accuracy_jax")
    p.add_argument("--n", type=int, default=400)
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--config", choices=["1", "2", "3", "4", "both", "all"],
                   default="both")
    p.add_argument("--init", metavar="DIR", default=None,
                   help="start stage 0 of every fold of every config from "
                        "DIR/config{N}.weights (written by "
                        "examples/accuracy_evidence_torch.py --write-init)")
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")  # before any op
    import segmentation_training_pipeline_tpu as stp

    wanted = {"all": "1234", "both": "12"}.get(args.config, args.config)
    dicts = config_dicts(args.epochs)
    inits = {}
    if args.init:
        for c in wanted:
            path = os.path.join(os.path.abspath(args.init),
                                f"config{c}.weights")
            dicts[c]["stages"][0]["initial_weights"] = path
            inits[KEYS[c]] = sha256(path)
            print(f"init config{c}: {path} sha256 {inits[KEYS[c]]}",
                  flush=True)
    os.makedirs(args.out, exist_ok=True)
    results, seconds = {}, {}
    for c in wanted:
        d = os.path.join(args.out, f"config{c}")
        os.makedirs(d, exist_ok=True)
        ds = dataset(c, args.n)
        cfg = stp.parse_dict(dicts[c], directory=d)
        folds = [0, 1] if c == "4" else [0]
        t0 = time.time()
        cfg.fit(ds, foldsToExecute=folds, verbose=1)
        t1 = time.time()
        # full-pipeline eval (TTA off, original sizes)
        ev = cfg.evaluate(ds, folds=folds if c == "4" else None)
        seconds[KEYS[c]] = {"fit": t1 - t0, "evaluate": time.time() - t1}
        results[KEYS[c]] = ev
        for f in folds:
            for s in range(len(dicts[c]["stages"])):
                src = os.path.join(d, "metrics", f"metrics-{f}.{s}.csv")
                if os.path.exists(src):
                    shutil.copy(src, os.path.join(
                        args.out, f"config{c}_f{f}s{s}_metrics.csv"))
        print(f"config{c} evaluate:", ev, seconds[KEYS[c]], flush=True)

    out_json = os.path.join(args.out, "accuracy.json")
    with open(out_json, "w") as f:
        json.dump(results, f, indent=2)
    with open(os.path.join(args.out, "run.json"), "w") as f:
        json.dump({
            "commit": _commit(), "jax": jax.__version__,
            "platform": jax.devices()[0].platform, "cpu": _cpu_name(),
            "cpu_count": os.cpu_count(),
            "threads": len(os.sched_getaffinity(0)),
            "xla_flags": os.environ.get("XLA_FLAGS", ""),
            "n": args.n, "epochs": args.epochs, "init_sha256": inits,
            "seconds": seconds}, f, indent=2)
    print(json.dumps(results))
    print(f"written to {out_json}")
    return results


if __name__ == "__main__":
    # run as a file from a checkout: the package sits beside examples/
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
