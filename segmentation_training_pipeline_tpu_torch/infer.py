"""Inference: flip-TTA, per-fold ensembling, directory batch prediction.

Counterpart of ``segmentation_training_pipeline_tpu/infer.py``: per fold,
load ``weights/best-{fold}.{stage}.weights`` → batch images → predict →
optional TTA average → mean over folds → threshold → resize back → PNG per
input id.  One ``SegmentationModel`` lives on the card with one
``(params, batch_stats)`` pair per fold beside it; a batch is uploaded
once, preprocessed once, run through every fold (every TTA view, un-flipped
after the activation) under ``torch.inference_mode()``, summed on the card
in fold order and brought back once.  Data-sharded serving, as the JAX
package's mesh: a process without a process group that sees more than one
card (or is given ``devices``) keeps a model and every fold's variables on
each, zero-pads a batch to a multiple of the card count, predicts each
slice on its card and brings the slices back in order; in a process group
each rank predicts on its own card alone.  No hand-written kernel is on
this path (the TTA views are flips and rotations, the model is cuDNN).
The config's deterministic
``transforms:`` run on the uploaded batch before preprocessing, as in
training (``lowering.build_transform_fn``).
"""

from __future__ import annotations

import copy
import csv
import os
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from .config import PipelineConfig
from .data.batcher import prepare_image, prepare_mask
from .data.datasets import DataSet, DirectoryDataSet, PredictionItem
from .models.factory import (apply_activation, apply_model, model_from_config,
                             model_variables, variant_from_checkpoint)
from .ops import metrics as _metrics
from .ops.aug.lowering import build_transform_fn
from .ops.preprocess import preprocess
from .parallel import distributed as dist
from .train.checkpoint import load_checkpoint
from .utils.rle import rle_encode

Tensor = torch.Tensor


class InferenceBundle:
    """A model on ``device``, one variables pair per requested fold, and
    the config's TTA mode; with ``devices`` (by default every card a
    process without a group sees, when ``device`` names no index) a copy
    of both on each device, the batch split across them."""

    def __init__(self, cfg: PipelineConfig, folds: Sequence[int], stage: int,
                 tta=None, device="cuda", devices=None):
        self.cfg = cfg
        self.tta = tta if tta is not None else (
            "flip" if cfg.flipPred else cfg.testTimeAugmentation)
        if self.tta in ("d4", "full") and cfg.shape[0] != cfg.shape[1]:
            raise ValueError(
                "testTimeAugmentation: d4 needs a square shape (rot90 "
                f"members change H/W), got {cfg.shape[:2]} — use 'flips'")
        _, self.transform = build_transform_fn(cfg.transforms, [])
        self.stage = stage if stage >= 0 else len(cfg.stages) - 1
        self.folds = list(folds)
        paths = [cfg.weights_path(f, self.stage) for f in self.folds]
        # cheap existence check BEFORE the model is built
        for f, path in zip(self.folds, paths):
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"no checkpoint for fold {f} stage {self.stage}: {path}")
        self.device = torch.device(device)
        # the sidecar records the graph the weights were trained with
        self.model = model_from_config(
            cfg, variant_from_checkpoint(cfg, paths)).to(self.device).eval()
        self.fold_vars = []
        for path in paths:
            load_checkpoint(path, self.model)
            self.fold_vars.append(model_variables(self.model))
        if devices is None and self.device.type == "cuda" and \
                self.device.index is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        if dist.active() or not devices or len(devices) < 2:
            devices = [self.device]
        # (device, model, fold variables) per device, the first this one
        self.replicas = [(self.device, self.model, self.fold_vars)]
        for d in devices[1:]:
            d = torch.device(d)
            self.replicas.append((d, copy.deepcopy(self.model).to(d), [
                tuple({k: v.to(d) for k, v in t.items()} for t in pair)
                for pair in self.fold_vars]))

    def _views(self, model, params, stats, x: Tensor) -> Tensor:
        """Probabilities of one fold, averaged over the TTA views in the
        JAX package's order (each view un-flipped after the activation)."""
        def fwd(z):
            return apply_activation(apply_model(model, params, stats, z),
                                    self.cfg.activation)

        p, tta = fwd(x), self.tta
        if tta in ("flip", "hflip", True):
            return (p + fwd(x.flip(2)).flip(2)) / 2.0
        if tta in ("flips", "d4_subset", "hvflip", "d4", "full"):
            acc = p
            acc = acc + fwd(x.flip(2)).flip(2)
            acc = acc + fwd(x.flip(1)).flip(1)
            acc = acc + fwd(x.flip(1, 2)).flip(1, 2)
            if tta in ("flips", "d4_subset", "hvflip"):
                return acc / 4.0
            # all 8 dihedral symmetries: + R90, R270, transpose and
            # anti-transpose (an involution); square frames only
            def anti(z):
                return z.transpose(1, 2).flip(1, 2)

            for k in (1, 3):
                acc = acc + torch.rot90(fwd(torch.rot90(x, k, (1, 2))), -k,
                                        (1, 2))
            acc = acc + fwd(x.transpose(1, 2)).transpose(1, 2)
            acc = acc + anti(fwd(anti(x)))
            return acc / 8.0
        return p

    def predict_probs(self, images_u8: np.ndarray) -> np.ndarray:
        """(B, H, W, C) uint8 at config shape → fold-ensembled probs (f32).
        Over several devices the batch is zero-padded to a multiple of
        their count (the padded rows cut off the result)."""
        if len(self.replicas) == 1:
            return self._predict(self.replicas[0], images_u8).cpu().numpy()
        n, nd = int(images_u8.shape[0]), len(self.replicas)
        images_u8 = np.asarray(images_u8)
        if n % nd:
            images_u8 = np.concatenate([images_u8, np.zeros(
                (nd - n % nd, *images_u8.shape[1:]), images_u8.dtype)])
        # every slice is queued on its device before any comes back; the
        # transforms draw for the whole padded batch and take its rows
        per = images_u8.shape[0] // nd
        outs = [self._predict(r, images_u8[i * per:(i + 1) * per],
                              slice(i * per, (i + 1) * per), nd * per)
                for i, r in enumerate(self.replicas)]
        return np.concatenate([o.cpu().numpy() for o in outs])[:n]

    def _predict(self, replica, images_u8: np.ndarray,
                 rows: Optional[slice] = None,
                 batch: Optional[int] = None) -> Tensor:
        device, model, fold_vars = replica
        with torch.inference_mode():
            images = torch.from_numpy(np.ascontiguousarray(images_u8)).to(
                device)
            if self.transform is not None:
                # masks do not exist here: a dummy rides the joint transform
                dummy = torch.zeros((*images.shape[:3], 1), device=device)
                images, _ = (self.transform(images, dummy) if rows is None
                             else self.transform(images, dummy, rows, batch))
            x = preprocess(images, self.cfg.preprocessing or "tf",
                           model.dtype)
            acc = None
            for params, stats in fold_vars:
                p = self._views(model, params, stats, x)
                acc = p if acc is None else acc + p
            return acc / len(fold_vars)


def _resolve_folds(cfg: PipelineConfig, folds, stage: int) -> List[int]:
    if folds is not None:
        return list(folds) if not isinstance(folds, int) else [folds]
    st = stage if stage >= 0 else len(cfg.stages) - 1
    found = [f for f in range(cfg.folds_count)
             if os.path.exists(cfg.weights_path(f, st))]
    if not found:
        raise FileNotFoundError(
            f"no trained fold checkpoints for stage {st} under {cfg.weights_dir}")
    return found


def load_model(cfg: PipelineConfig, fold: Union[int, Sequence[int]] = 0,
               stage: int = -1, device="cuda") -> InferenceBundle:
    folds = [fold] if isinstance(fold, int) else list(fold)
    return InferenceBundle(cfg, folds, stage, device=device)


# ---------------------------------------------------------------------------
# crops: N×N tile split + stitch
# ---------------------------------------------------------------------------

def _predict_full_image(bundle: InferenceBundle, batch_items: List[np.ndarray],
                        batch_size: int) -> List[np.ndarray]:
    """Predict a list of HWC uint8 images (any sizes) → per-image prob maps
    at ORIGINAL sizes, honoring cfg.crops tiling.  A tile whose size is the
    config's is not resized (cv2's same-size resize is a copy)."""
    cfg = bundle.cfg
    crops = cfg.crops or 1

    # build the (image_idx, tile_box) work list
    work = []
    for i, img in enumerate(batch_items):
        H, W = img.shape[:2]
        if crops == 1:
            work.append((i, (0, 0, H, W)))
        else:
            hs = np.linspace(0, H, crops + 1).astype(int)
            ws = np.linspace(0, W, crops + 1).astype(int)
            for r in range(crops):
                for c in range(crops):
                    work.append((i, (hs[r], ws[c], hs[r + 1], ws[c + 1])))

    outs = [np.zeros((*img.shape[:2], cfg.classes), np.float32)
            for img in batch_items]
    for start in range(0, len(work), batch_size):
        chunk = work[start : start + batch_size]
        arr = np.stack([prepare_image(batch_items[i][y0:y1, x0:x1], cfg.shape)
                        for i, (y0, x0, y1, x1) in chunk])
        if len(chunk) < batch_size:  # one batch shape, as the JAX package
            arr = np.concatenate(
                [arr, np.zeros((batch_size - len(chunk), *arr.shape[1:]),
                               arr.dtype)])
        probs = bundle.predict_probs(arr)
        for k, (i, (y0, x0, y1, x1)) in enumerate(chunk):
            tile_p = probs[k]
            if tile_p.shape[:2] != (y1 - y0, x1 - x0):
                import cv2

                tile_p = cv2.resize(tile_p, (x1 - x0, y1 - y0),
                                    interpolation=cv2.INTER_LINEAR)
                if tile_p.ndim == 2:
                    tile_p = tile_p[:, :, None]
            outs[i][y0:y1, x0:x1] = tile_p
    return outs


# ---------------------------------------------------------------------------
# public prediction surface
# ---------------------------------------------------------------------------

def predict_on_dataset(cfg: PipelineConfig, dataset: DataSet, folds=None,
                       stage: int = -1, batch_size: Optional[int] = None,
                       ttflips=None, device="cuda"
                       ) -> Iterator[PredictionItem]:
    """Yield PredictionItems with ``.prediction`` filled (probs at original
    image size, fold-ensembled, TTA per config)."""
    folds = _resolve_folds(cfg, folds, stage)
    bundle = InferenceBundle(cfg, folds, stage, tta=ttflips, device=device)
    bs = batch_size or cfg.batch
    buf_items: List[PredictionItem] = []

    def flush():
        probs = _predict_full_image(bundle, [it.x for it in buf_items], bs)
        for it, p in zip(buf_items, probs):
            it.prediction = p
            yield it
        buf_items.clear()

    for i in range(len(dataset)):
        buf_items.append(dataset[i])
        if len(buf_items) >= bs:
            yield from flush()
    if buf_items:
        yield from flush()


def _mask(cfg: PipelineConfig, p: np.ndarray, thr: float) -> np.ndarray:
    """uint8 mask: softmax → the argmax class; otherwise 255 where class
    channel 0 is at or above ``thr``, else 0."""
    if cfg.activation == "softmax" and cfg.classes > 1:
        return np.argmax(p, axis=-1).astype(np.uint8)
    return ((p[:, :, 0] >= thr) * 255).astype(np.uint8)


def predict_all_to_dir(cfg: PipelineConfig, src, dst: str, folds=None,
                       stage: int = -1, threshold: Optional[float] = None,
                       batch_size: Optional[int] = None, ttflips=None,
                       device="cuda") -> int:
    """Directory (or DataSet) → PNG masks in ``dst``.  Returns file count.

    Binary/sigmoid: 0/255 mask PNG of class channel 0.  Softmax: argmax
    class-index PNG.
    """
    import cv2

    ds = DirectoryDataSet(src) if isinstance(src, str) else src
    os.makedirs(dst, exist_ok=True)
    thr = cfg.threshold if threshold is None else threshold
    n = 0
    for item in predict_on_dataset(cfg, ds, folds=folds, stage=stage,
                                   batch_size=batch_size, ttflips=ttflips,
                                   device=device):
        cv2.imwrite(os.path.join(dst, f"{item.id}.png"),
                    _mask(cfg, item.prediction, thr))
        n += 1
    return n


def predict_to_csv(cfg: PipelineConfig, src, csv_path: str, folds=None,
                   stage: int = -1, threshold: Optional[float] = None,
                   batch_size: Optional[int] = None,
                   id_column: str = "id", rle_column: str = "rle_mask",
                   device="cuda") -> int:
    """Kaggle-style RLE submission: one row per input id."""
    ds = DirectoryDataSet(src) if isinstance(src, str) else src
    thr = cfg.threshold if threshold is None else threshold
    n = 0
    os.makedirs(os.path.dirname(os.path.abspath(csv_path)), exist_ok=True)
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([id_column, rle_column])
        for item in predict_on_dataset(cfg, ds, folds=folds, stage=stage,
                                       batch_size=batch_size, device=device):
            # softmax: channel 0 is background, foreground = argmax != 0
            w.writerow([item.id, rle_encode(_mask(cfg, item.prediction,
                                                  thr) > 0)])
            n += 1
    return n


def evaluate(cfg: PipelineConfig, dataset: DataSet, folds=None,
             stage: int = -1, batch_size: Optional[int] = None,
             threshold: Optional[float] = None,
             device="cuda") -> Dict[str, float]:
    """Dataset-level metrics with the full inference pipeline (TTA +
    ensembling) at original image sizes.

    The per-example values are the registry's (``ops/metrics.py``), as in
    validation.  Items are bucketed by (mask, prediction) shape and each
    bucket's stack is scored at once when it reaches ``batch_size`` (no
    padding: eager PyTorch has no static batch shape to keep).  A
    non-default ``threshold`` pre-binarizes sigmoid probabilities (the
    registry metrics themselves binarize at 0.5); softmax metrics use
    argmax regardless of threshold."""
    names = list(cfg.metrics) or ["iou", "dice"]
    fns = {nm: _metrics.get(nm) for nm in names}
    thr = cfg.threshold if threshold is None else threshold
    bs = batch_size or cfg.batch
    sums = {nm: 0.0 for nm in names}
    count = 0
    buckets: Dict[tuple, list] = {}

    def flush(key):
        ys, ps = zip(*buckets.pop(key))
        y = torch.from_numpy(np.stack(ys)).to(device)
        p = torch.from_numpy(np.stack(ps)).to(device)
        for nm, fn in fns.items():
            sums[nm] += float(fn(y, p, cfg.activation).sum())

    for item in predict_on_dataset(cfg, dataset, folds=folds, stage=stage,
                                   batch_size=batch_size, device=device):
        if item.y is None:
            continue
        y = prepare_mask(item.y, (*item.prediction.shape[:2], 3),
                         cfg.classes, cfg.activation).astype(np.float32)
        p = np.asarray(item.prediction, np.float32)
        if thr != 0.5 and cfg.activation != "softmax":
            p = (p >= thr).astype(np.float32)
        key = (y.shape, p.shape)
        buckets.setdefault(key, []).append((y, p))
        count += 1
        if len(buckets[key]) >= bs:
            flush(key)
    for key in list(buckets):
        flush(key)
    if count == 0:
        return {}
    return {nm: s / count for nm, s in sums.items()}
