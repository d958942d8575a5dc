"""Datasets: the protocol, wrappers, directory readers, K-fold splitting
and negative sampling.

Counterpart of ``segmentation_training_pipeline_tpu/data/datasets.py``:
``PredictionItem(id, x, y)``, the ``DataSet`` protocol (``__len__`` +
``__getitem__``), the composite/subset/lambda wrappers, the ``crops:`` tile
view, the readers of an image directory (``DirectoryDataSet``) and of a
Kaggle-style RLE CSV (``CSVRLEDataSet``), and ``KFoldedDataSet`` with its
seeded fold splits and per-epoch index plans (``negatives: none|real|N``),
drawn with ``np.random.RandomState`` exactly as the JAX package draws them.
Host-side only; image files decode with ``cv2``, imported where a file is
read.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

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


class CropAndSplitDataSet(DataSet):
    """N×N tile view for ``crops: N`` training.

    Item ``i`` is tile ``(r, c) = divmod(i % N², N)`` of parent item
    ``i // N²``, cut from the ORIGINAL image/mask with the same
    ``np.linspace`` grid the predict-side stitcher uses (infer.py), so a
    model trained on tiles sees exactly the tiles it will be asked to
    predict.  Fold assignment stays at the parent level (expand parent
    index plans with :func:`expand_tile_indices`): tiles of one image in
    both train and val would leak.
    """

    def __init__(self, parent: DataSet, n: int):
        if n < 2:
            raise ValueError("crops must be >= 2")
        self.parent = parent
        self.n = int(n)

    def __len__(self):
        return len(self.parent) * self.n * self.n

    def __getitem__(self, idx):
        n2 = self.n * self.n
        if idx < 0:
            idx += len(self)
        pi, t = divmod(int(idx), n2)
        r, c = divmod(t, self.n)
        item = self.parent[pi]
        H, W = item.x.shape[:2]
        hs = np.linspace(0, H, self.n + 1).astype(int)
        ws = np.linspace(0, W, self.n + 1).astype(int)
        y0, y1 = int(hs[r]), int(hs[r + 1])
        x0, x1 = int(ws[c]), int(ws[c + 1])
        x = item.x[y0:y1, x0:x1]
        y = None if item.y is None else item.y[y0:y1, x0:x1]
        return PredictionItem(f"{item.id}#t{r}_{c}", x, y)


def expand_tile_indices(parent_indices: np.ndarray, n: int,
                        shuffle_seed: Optional[int] = None) -> np.ndarray:
    """Parent-level index plan → tile-level plan into a CropAndSplitDataSet
    (each parent index becomes its N² tile indices; optionally shuffled)."""
    n2 = n * n
    base = np.asarray(parent_indices, dtype=np.int64)
    tiles = (base[:, None] * n2 + np.arange(n2)[None, :]).ravel()
    if shuffle_seed is not None:
        np.random.RandomState(shuffle_seed % (2 ** 31)).shuffle(tiles)
    return tiles


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


# ---------------------------------------------------------------------------
# K-fold index math (sklearn's KFold / StratifiedKFold with shuffling)
# ---------------------------------------------------------------------------

def kfold_indices(n: int, folds: int, random_state: int = 33,
                  shuffle: bool = True) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``sklearn.model_selection.KFold(folds, shuffle, random_state)``:
    shuffle the indices with ``np.random.RandomState(seed)``, then take
    consecutive chunks as test folds; the first ``n % folds`` folds get
    one extra element."""
    if folds < 2:
        raise ValueError("folds_count must be >= 2 for k-fold splitting")
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(random_state).shuffle(idx)
    sizes = np.full(folds, n // folds, dtype=np.int64)
    sizes[: n % folds] += 1
    out = []
    start = 0
    for s in sizes:
        test = idx[start : start + s]
        train = np.concatenate([idx[:start], idx[start + s :]])
        out.append((np.sort(train), np.sort(test)))
        start += s
    return out


def stratified_kfold_indices(labels: np.ndarray, folds: int,
                             random_state: int = 33):
    """Stratified K-fold: per-class shuffled round-robin assignment, so
    every fold keeps the global positive/negative ratio."""
    n = len(labels)
    assign = np.empty(n, dtype=np.int64)
    rng = np.random.RandomState(random_state)
    for cls in np.unique(labels):
        members = np.flatnonzero(labels == cls)
        rng.shuffle(members)
        assign[members] = np.arange(len(members)) % folds
    out = []
    for f in range(folds):
        test = np.flatnonzero(assign == f)
        train = np.flatnonzero(assign != f)
        out.append((train, test))
    return out


def _is_negative(item: PredictionItem) -> bool:
    y = item.y
    return y is None or not np.any(y)


@dataclass
class FoldSplit:
    train: np.ndarray
    val: np.ndarray


class KFoldedDataSet:
    """Seeded K-fold view over a dataset with negative-sampling plans.

    ``negatives``/``validation_negatives`` ∈ {None/'real', 'none', number}:
      * ``real`` / None — keep every empty-mask item (the real distribution);
      * ``none`` — drop empty-mask items entirely;
      * ``N`` — per epoch, sample ``N × n_positives`` negatives (with a
        per-epoch seed).

    ``epoch_indices(fold, epoch, negatives)`` returns the deterministic index
    plan for that epoch: host-side numpy randomness only, the same plans as
    the JAX package's for the same dataset and ``random_state``.
    """

    def __init__(self, dataset: DataSet, folds_count: int = 5,
                 random_state: int = 33, test_split: float = 0.0,
                 stratified: bool = False):
        self.dataset = dataset
        self.folds_count = folds_count
        self.random_state = random_state
        n = len(dataset)
        all_idx = np.arange(n)
        if test_split and test_split > 0:
            rng = np.random.RandomState(random_state)
            perm = rng.permutation(n)
            n_test = int(round(n * test_split))
            self.test_indices = np.sort(perm[:n_test])
            work = np.sort(perm[n_test:])
        else:
            self.test_indices = np.empty(0, dtype=np.int64)
            work = all_idx
        self._work = work
        self._neg_cache: Optional[np.ndarray] = None
        if stratified:
            # stratify on mask emptiness (positive/negative), the label that
            # matters for segmentation fold balance
            labels = self._negativity()[work].astype(np.int64)
            rel_folds = stratified_kfold_indices(
                labels, folds_count, random_state)
        else:
            rel_folds = kfold_indices(len(work), folds_count, random_state)
        self.folds = [FoldSplit(work[tr], work[va]) for tr, va in rel_folds]

    def __len__(self):
        return self.folds_count

    # -- negativity classification (cached; one pass over the dataset) ------
    def _negativity(self) -> np.ndarray:
        if self._neg_cache is None:
            flags = np.zeros(len(self.dataset), dtype=bool)
            # datasets that know emptiness without decoding (CSVRLEDataSet)
            # expose item_is_negative: no image-decode sweep
            cheap = getattr(self.dataset, "item_is_negative", None)
            for i in range(len(self.dataset)):
                flags[i] = (cheap(i) if cheap is not None
                            else _is_negative(self.dataset[i]))
            self._neg_cache = flags
        return self._neg_cache

    def _apply_negatives(self, indices: np.ndarray, negatives,
                         epoch: int) -> np.ndarray:
        if negatives in (None, "real"):
            return indices
        neg_flags = self._negativity()[indices]
        pos = indices[~neg_flags]
        neg = indices[neg_flags]
        if negatives == "none":
            return pos
        try:
            ratio = float(negatives)
        except (TypeError, ValueError):
            raise ValueError(
                f"negatives must be 'none', 'real' or a number, got {negatives!r}"
            )
        want = int(round(ratio * len(pos)))
        if want >= len(neg):
            return indices
        rng = np.random.RandomState((self.random_state * 1_000_003 + epoch) % (2**31))
        chosen = rng.choice(neg, size=want, replace=False)
        return np.concatenate([pos, chosen])

    def epoch_indices(self, fold: int, epoch: int, negatives=None,
                      shuffle: bool = True) -> np.ndarray:
        """Deterministic training index plan for (fold, epoch)."""
        base = self._apply_negatives(self.folds[fold].train, negatives, epoch)
        if shuffle:
            rng = np.random.RandomState(
                (self.random_state * 7_654_321 + fold * 97 + epoch) % (2**31)
            )
            base = rng.permutation(base)
        return base

    def val_indices(self, fold: int, validation_negatives=None) -> np.ndarray:
        return self._apply_negatives(self.folds[fold].val, validation_negatives, 0)

    def train_subset(self, fold: int) -> SubDataSet:
        return SubDataSet(self.dataset, self.folds[fold].train)

    def val_subset(self, fold: int) -> SubDataSet:
        return SubDataSet(self.dataset, self.folds[fold].val)

    def test_subset(self) -> SubDataSet:
        return SubDataSet(self.dataset, self.test_indices)
