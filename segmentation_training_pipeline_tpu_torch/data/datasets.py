"""Datasets for serving: the protocol, wrappers and directory readers.

Counterpart of the serving part of
``segmentation_training_pipeline_tpu/data/datasets.py``:
``PredictionItem(id, x, y)``, the ``DataSet`` protocol (``__len__`` +
``__getitem__``), the composite/subset/lambda wrappers, and the readers of
an image directory (``DirectoryDataSet``) and of a Kaggle-style RLE CSV
(``CSVRLEDataSet``).  Host-side only; image files decode with ``cv2``,
imported where a file is read.  K-fold splitting, ``CropAndSplitDataSet``
and the negatives rule are not ported yet.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..utils.rle import rle_decode


@dataclass
class PredictionItem:
    """One example: image ``x`` (H, W, C), optional mask ``y``.

    ``id`` is the stable identifier used for prediction filenames.
    """

    id: Any
    x: np.ndarray
    y: Optional[np.ndarray] = None
    prediction: Optional[np.ndarray] = None


class DataSet:
    """Minimal dataset protocol: ``__len__`` and ``__getitem__`` → PredictionItem."""

    def __len__(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def __getitem__(self, idx: int) -> PredictionItem:  # pragma: no cover - abstract
        raise NotImplementedError

    def item(self, idx: int) -> PredictionItem:
        return self[idx]


class CompositeDataSet(DataSet):
    """Concatenation of several datasets (reference: extra_train_data merging)."""

    def __init__(self, *datasets: DataSet):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        d = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[d][idx - int(self._offsets[d])]


class SubDataSet(DataSet):
    """A view over a subset of indices of a parent dataset."""

    def __init__(self, parent: DataSet, indices: Sequence[int]):
        self.parent = parent
        self.indices = np.asarray(indices, dtype=np.int64)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.parent[int(self.indices[idx])]

    def image_path(self, idx: int):
        return self.parent.image_path(int(self.indices[idx]))  # type: ignore[attr-defined]

    def mask_path(self, idx: int):
        return self.parent.mask_path(int(self.indices[idx]))  # type: ignore[attr-defined]

    def __getattr__(self, name):
        # forward OPTIONAL protocol hooks (item_is_negative) when the
        # parent has them; index-taking hooks must remap through indices
        if name == "item_is_negative" and hasattr(self.parent,
                                                  "item_is_negative"):
            return lambda i: self.parent.item_is_negative(
                int(self.indices[i]))
        raise AttributeError(name)


class LambdaDataSet(DataSet):
    """Build a dataset from arrays or callables (used by tests/examples)."""

    def __init__(self, xs, ys=None, ids=None):
        self.xs = xs
        self.ys = ys
        self.ids = ids

    def __len__(self):
        return len(self.xs)

    def __getitem__(self, idx):
        x = self.xs[idx]
        y = None if self.ys is None else self.ys[idx]
        i = idx if self.ids is None else self.ids[idx]
        return PredictionItem(i, np.asarray(x), None if y is None else np.asarray(y))


_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp")


class DirectoryDataSet(DataSet):
    """images-dir (+ optional masks-dir) → dataset of PredictionItems.

    Masks are matched by stem: ``images/a.jpg`` ↔ ``masks/a.png`` (any image
    extension).  Images decode to RGB uint8, masks to single-channel uint8.
    """

    def __init__(self, images_dir: str, masks_dir: Optional[str] = None):
        self.images_dir = images_dir
        self.masks_dir = masks_dir
        self.files = sorted(
            f for f in os.listdir(images_dir) if f.lower().endswith(_IMG_EXTS)
        )
        if not self.files:
            raise ValueError(f"no images found in {images_dir!r}")
        self._mask_index = {}
        if masks_dir:
            for f in os.listdir(masks_dir):
                if f.lower().endswith(_IMG_EXTS):
                    self._mask_index[os.path.splitext(f)[0]] = f
            stems = {os.path.splitext(f)[0] for f in self.files}
            if self._mask_index and not (stems & set(self._mask_index)):
                # per-item misses are legitimate (negative examples), but
                # ZERO matches means the naming convention is wrong and
                # every image would silently train toward an empty mask
                raise ValueError(
                    f"masks_dir {masks_dir!r} matches no image stem from "
                    f"{images_dir!r} — masks pair by stem "
                    "(images/a.jpg <-> masks/a.png); check the naming")

    def __len__(self):
        return len(self.files)

    def image_path(self, idx: int) -> str:
        return os.path.join(self.images_dir, self.files[idx])

    def mask_path(self, idx: int) -> Optional[str]:
        if not self.masks_dir:
            return None
        stem = os.path.splitext(self.files[idx])[0]
        f = self._mask_index.get(stem)
        return os.path.join(self.masks_dir, f) if f else None

    def __getitem__(self, idx):
        import cv2

        fname = self.files[idx]
        stem = os.path.splitext(fname)[0]
        img = cv2.imread(os.path.join(self.images_dir, fname), cv2.IMREAD_COLOR)
        if img is None:
            raise IOError(f"failed to read {fname!r}")
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        y = None
        if self.masks_dir and stem in self._mask_index:
            m = cv2.imread(
                os.path.join(self.masks_dir, self._mask_index[stem]),
                cv2.IMREAD_GRAYSCALE,
            )
            if m is None:
                raise IOError(f"failed to read mask for {fname!r}")
            y = m
        return PredictionItem(stem, img, y)


class CSVRLEDataSet(DataSet):
    """images-dir + Kaggle-style CSV (image id + RLE-encoded mask) →
    dataset of PredictionItems — the READ side of the competition loop
    whose write side is ``predict_to_csv``.

    * Column names auto-detect: id from ``id``/``ImageId``/``img_id``/
      ``image_id``, rle from ``rle_mask``/``EncodedPixels``/``rle``/
      ``encoded_pixels`` (or pass ``id_column``/``rle_column``).
    * Multiple rows per id (Airbus instance masks) union into one binary
      mask; an empty/NaN rle is a negative (empty mask) — which is what
      ``negatives:`` sampling keys off.
    * RLE is column-major 1-indexed (utils/rle.py); the mask shape is the
      decoded image's (H, W).
    """

    def __init__(self, images_dir: str, csv_path: str,
                 id_column: Optional[str] = None,
                 rle_column: Optional[str] = None):
        self.images_dir = images_dir
        files = sorted(
            f for f in os.listdir(images_dir)
            if f.lower().endswith(_IMG_EXTS))
        if not files:
            raise ValueError(f"no images found in {images_dir!r}")
        by_stem = {os.path.splitext(f)[0]: f for f in files}

        with open(csv_path, newline="") as fh:
            reader = csv.DictReader(fh)
            cols = reader.fieldnames or []
            idc = id_column or next(
                (c for c in cols
                 if c.lower() in ("id", "imageid", "img_id", "image_id")),
                None)
            rlec = rle_column or next(
                (c for c in cols
                 if c.lower() in ("rle_mask", "encodedpixels", "rle",
                                  "encoded_pixels", "mask")), None)
            if idc is None or rlec is None:
                raise ValueError(
                    f"{csv_path}: cannot find id/rle columns in {cols} — "
                    "pass id_column=/rle_column=")
            rles: Dict[str, List[str]] = {}
            stem_src: Dict[str, str] = {}  # stem → raw id that produced it
            for row in reader:
                raw = str(row[idc])
                # strip only a KNOWN image extension: bare ids may contain
                # dots ('scan.v2_001'), and a blind splitext would mangle
                # them (or collide two ids into one stem)
                rid = (os.path.splitext(raw)[0]
                       if raw.lower().endswith(_IMG_EXTS) else raw)
                if stem_src.setdefault(rid, raw) != raw:
                    raise ValueError(
                        f"{csv_path}: ids {stem_src[rid]!r} and {raw!r} "
                        f"both resolve to image stem {rid!r} — their "
                        "instance masks would silently union")
                rles.setdefault(rid, []).append(row[rlec] or "")

        missing = sorted(set(rles) - set(by_stem))
        if missing:
            raise ValueError(
                f"{csv_path} references ids with no image in "
                f"{images_dir!r}: {missing[:5]}{'...' if len(missing) > 5 else ''}")
        # CSV order defines membership: ids absent from the CSV are test
        # images and stay out of this (training) dataset
        self.items = sorted(rles)
        self._files = by_stem
        self._rles = rles

    def __len__(self):
        return len(self.items)

    def image_path(self, idx: int) -> str:
        return os.path.join(self.images_dir, self._files[self.items[idx]])

    def item_is_negative(self, idx: int) -> bool:
        """Mask emptiness straight from the CSV — no image decode."""
        return not any(str(r).strip() and str(r).strip().lower() != "nan"
                       for r in self._rles[self.items[idx]])

    def __getitem__(self, idx):
        import cv2

        stem = self.items[idx]
        img = cv2.imread(self.image_path(idx), cv2.IMREAD_COLOR)
        if img is None:
            raise IOError(f"failed to read image for id {stem!r}")
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        mask = np.zeros(img.shape[:2], np.uint8)
        for rle in self._rles[stem]:
            mask |= rle_decode(rle, img.shape[:2])
        return PredictionItem(stem, img, mask * 255)
