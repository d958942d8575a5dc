"""Split an accuracy gap of ``examples/accuracy_evidence_torch.py``.

Trains one BASELINE config as that script does (its dict, dataset and
folds), optionally at another ``dtype``, then scores the best checkpoint
with ``cfg.evaluate`` on fold 0's train and validation images apart, beside
the best ``val_iou`` of the fit's CSV.  On the card:

    python examples/accuracy_gap_torch.py --config 3 [--dtype float32]

Prints one JSON line: ``evaluate`` on all images (the accuracy script's
number), on the train and the validation images, the CSV's best
``val_iou`` and its epoch, the last epoch's train ``iou``, the fit's
seconds, and ``evaluate_round2``: the same predictions scored as the JAX
package's evaluate scored them when it wrote
``docs/evidence/accuracy.json`` (see :func:`round2_scores`).  The
evaluate on the validation images should equal the CSV's best
``val_iou``: both score the same weights on the same images.
"""

from __future__ import annotations

import argparse
import csv
import importlib.util
import json
import os
import sys
import tempfile
import time


def _accuracy_script():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "accuracy_evidence_torch.py")
    spec = importlib.util.spec_from_file_location("accuracy_evidence_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def round2_scores(cfg, dataset, folds, device) -> dict:
    """IoU and dice per image, averaged, as the JAX package's host-side
    evaluate computed them in the commit that added
    ``docs/evidence/accuracy.json`` (f52a37b, ``infer.py:_np_metric``;
    replaced the same day by the registry's per-class metrics): one hard
    mask per image (softmax: every class whose probability ties the
    maximum; sigmoid: p ≥ 0.5) and the intersection and union pooled over
    all classes, background included.  Under sigmoid this equals
    ``cfg.evaluate``'s; under softmax it counts a pixel's class agreement
    once over all classes, where ``cfg.evaluate`` averages per class."""
    import numpy as np

    from segmentation_training_pipeline_tpu_torch.data.batcher import (
        prepare_mask)
    from segmentation_training_pipeline_tpu_torch.infer import (
        predict_on_dataset)

    eps, sums, n = 1e-7, {"iou": 0.0, "dice": 0.0}, 0
    for item in predict_on_dataset(cfg, dataset, folds=folds, device=device):
        p = np.asarray(item.prediction, np.float32)
        y = prepare_mask(item.y, (*p.shape[:2], 3), cfg.classes,
                         cfg.activation)
        if cfg.activation == "softmax" and p.shape[-1] > 1:
            hard = (p == p.max(axis=-1, keepdims=True)).astype(np.float32)
        else:
            hard = (p >= 0.5).astype(np.float32)
        t = np.round(y).astype(np.float32)
        inter, total = float((hard * t).sum()), float(hard.sum() + t.sum())
        sums["iou"] += (inter + eps) / (total - inter + eps)
        sums["dice"] += (2 * inter + eps) / (total + eps)
        n += 1
    return {k: v / n for k, v in sums.items()}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--config", choices=["1", "2", "3", "4"], default="3")
    p.add_argument("--n", type=int, default=400)
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--dtype", default=None,
                   help="override the config's dtype (default: its own)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import segmentation_training_pipeline_tpu_torch as stp
    from segmentation_training_pipeline_tpu_torch.data.datasets import (
        SubDataSet)

    acc = _accuracy_script()
    card = acc.card_info(args.device)
    d = dict(acc.config_dicts(args.epochs)[args.config])
    if args.dtype:
        d["dtype"] = args.dtype
    ds = acc.dataset(args.config, args.n)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = stp.parse_dict(d, directory=args.out or tmp)
        t0 = time.time()
        cfg.fit(ds, foldsToExecute=[0], verbose=0, device=args.device,
                aug_seed=args.seed)
        fit_s = time.time() - t0
        kfold = cfg.kfold(ds)
        split = {"train": kfold.folds[0].train,
                 "val": kfold.val_indices(0, cfg.validation_negatives)}
        out = {"config": args.config, "dtype": cfg.dtype, "seed": args.seed,
               "device": card, "fit_s": fit_s,
               "evaluate": cfg.evaluate(ds, folds=[0], device=args.device)}
        out["evaluate_round2"] = round2_scores(cfg, ds, [0], args.device)
        for name, idx in split.items():
            out[f"evaluate_{name}"] = cfg.evaluate(
                SubDataSet(ds, idx), folds=[0], device=args.device)
            out[f"n_{name}"] = len(idx)
        rows = list(csv.DictReader(open(cfg.metrics_path(0, 0))))
    val = [float(r["val_iou"]) for r in rows]
    best = max(range(len(val)), key=val.__getitem__)
    out.update(csv_best_val_iou=val[best], csv_best_epoch=best,
               csv_last_train_iou=float(rows[-1]["iou"]))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
