"""Host-side batch assembly and the prefetch to the card.

Counterpart of ``segmentation_training_pipeline_tpu/data/batcher.py``.
The host decodes, resizes to the config shape and stacks **uint8** images
and uint8 one-hot masks (a quarter of float32 on the wire); the step casts
to float, augments and normalises on the device.  Resizes go through
``cv2`` (its fixed-point uint8 ``INTER_LINEAR`` is part of the byte
contract), imported only where sizes differ: a resize to the same size is an
exact copy in OpenCV, so skipping it changes no value.

``make_batches`` decodes a file-backed dataset (one that serves
``image_path`` and ``mask_path``) at 1 or 3 channels on the thread pool of
``data/loader.py``, which gives the bytes of the JAX package's native C++
loader, and any other dataset item by item (``dataset[i]``), as the JAX
batcher chooses.  Under data parallelism (``rows``) each rank decodes only
its rows of every global batch and carries the global ``weight`` vector
(the JAX package decodes the whole global batch on every host, but decode
is most of a fit step's host time).  ``Prefetcher`` runs the batch
generator on a worker thread that pins each batch; the consumer copies it
to the card with ``non_blocking=True`` on its current stream, so the
worker never touches a stream and the copy overlaps the previous step.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from .datasets import DataSet
from .loader import default_pool


def prepare_image(x: np.ndarray, shape) -> np.ndarray:
    """HWC uint8 at the config shape (resized on the host with cv2)."""
    h, w, c = shape
    if x.ndim == 2:
        x = x[:, :, None]
    if x.shape[-1] == 1 and c == 3:
        x = np.repeat(x, 3, axis=-1)
    elif x.shape[-1] == 3 and c == 1:
        x = x.mean(axis=-1, keepdims=True)
    if x.shape[:2] != (h, w):
        import cv2

        x = cv2.resize(x, (w, h), interpolation=cv2.INTER_LINEAR)
        if x.ndim == 2:
            x = x[:, :, None]
    if x.dtype != np.uint8:
        x = np.clip(x, 0, 255).astype(np.uint8) if x.max() > 1.5 else (
            np.clip(x, 0, 1) * 255
        ).astype(np.uint8)
    return x


def _resize_nearest(y: np.ndarray, h: int, w: int) -> np.ndarray:
    import cv2

    return cv2.resize(y, (w, h), interpolation=cv2.INTER_NEAREST)


def prepare_mask(y: Optional[np.ndarray], shape, classes: int,
                 activation: str) -> np.ndarray:
    """HW[C] mask → (H, W, classes) float32 in {0, 1}.

    Accepts binary {0,1}/{0,255} masks, per-class channel stacks, or
    integer class-index maps (softmax mode).  Nearest-neighbour resize keeps
    labels crisp.
    """
    h, w, _ = shape
    if y is None:
        return np.zeros((h, w, classes), np.float32)
    y = np.asarray(y)
    if y.ndim == 3 and y.shape[-1] == 1:
        y = y[:, :, 0]
    if y.ndim == 2:
        if y.shape != (h, w):
            y = _resize_nearest(y, h, w)
        if activation == "softmax" and classes > 1:
            idx = y.astype(np.int64)
            if idx.max() > classes - 1 and idx.max() > 1:  # {0,255} binary
                idx = (idx > 127).astype(np.int64)
            out = np.zeros((h, w, classes), np.float32)
            np.put_along_axis(out, idx[:, :, None], 1.0, axis=-1)
            return out
        m = (y > 127) if y.max() > 1.5 else (y > 0.5)
        return np.repeat(m[:, :, None].astype(np.float32), classes, axis=-1) \
            if classes > 1 else m[:, :, None].astype(np.float32)
    # channel-stacked per-class masks
    if y.shape[:2] != (h, w):
        y = _resize_nearest(y.astype(np.float32), h, w)
        if y.ndim == 2:
            y = y[:, :, None]
    if y.shape[-1] != classes:
        raise ValueError(f"mask has {y.shape[-1]} channels, config classes={classes}")
    return (y > (127 if y.max() > 1.5 else 0.5)).astype(np.float32)


def _masks_u8_to_onehot(masks_u8: np.ndarray, classes: int,
                        activation: str) -> np.ndarray:
    """(B, H, W) uint8 decoded masks → (B, H, W, classes) uint8 {0,1},
    with prepare_mask's binary/{0,255}/class-index rules and PER-ITEM
    thresholds (a batch may mix {0,1} and {0,255} masks)."""
    per_max = masks_u8.reshape(masks_u8.shape[0], -1).max(axis=1)
    if activation == "softmax" and classes > 1:
        idx = masks_u8.astype(np.int64)
        is_255 = (per_max > classes - 1) & (per_max > 1)
        idx = np.where(is_255[:, None, None],
                       (masks_u8 > 127).astype(np.int64), idx)
        out = np.zeros((*masks_u8.shape, classes), np.uint8)
        np.put_along_axis(out, idx[..., None], 1, axis=-1)
        return out
    m = np.where((per_max > 1.5)[:, None, None],
                 masks_u8 > 127, masks_u8 > 0)
    m = m[..., None].astype(np.uint8)
    return np.repeat(m, classes, axis=-1) if classes > 1 else m


def _paths_available(dataset, probe_idx: int) -> bool:
    """True iff the dataset really serves file paths (a wrapper such as
    ``SubDataSet`` defines ``image_path`` whatever its parent does, so
    probe it)."""
    if not (hasattr(dataset, "image_path") and hasattr(dataset, "mask_path")):
        return False
    try:
        return dataset.image_path(probe_idx) is not None
    except Exception:
        return False


def make_batches(dataset: DataSet, indices: Sequence[int], shape, classes: int,
                 activation: str, batch_size: int,
                 wrap_pad: bool = True,
                 cache: Optional[dict] = None,
                 stats: Optional[dict] = None,
                 rows: Optional[slice] = None
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Yield batches of stacked uint8 images + uint8 one-hot masks + float32
    weights, in plan order.

    The final partial batch wraps around to the plan's start and its
    padding rows get weight 0, so the steps can discount them.  ``cache``
    (``cache: true`` in YAML): per-index dict of decoded ``(img_u8,
    mask_u8)`` items, so epochs after the first skip the decode.  A
    file-backed dataset at 1 or 3 channels decodes on the shared
    ``loader.default_pool()``; a file that fails raises ``IOError`` with
    the batch's count of failures.  ``stats``: a dict accumulating
    ``decode_s`` (wall seconds spent assembling batches), ``batches``,
    ``native`` (whether the pool served this plan) and ``decode_threads``
    (its threads, 0 without it).  ``rows``: decode only these rows of each
    batch (a rank's, ``parallel.mesh.Mesh.rows``); ``weight`` stays the
    whole batch's.
    """
    idx = np.asarray(indices, dtype=np.int64)
    n = len(idx)
    if n == 0:
        return
    h, w, c = shape
    pool = (default_pool() if c in (1, 3)
            and _paths_available(dataset, int(idx[0])) else None)
    if stats is not None:
        stats["native"] = pool is not None
        stats["decode_threads"] = pool.threads if pool is not None else 0
        stats.setdefault("decode_s", 0.0)
        stats.setdefault("batches", 0)
    for start in range(0, n, batch_size):
        _t0 = time.perf_counter() if stats is not None else 0.0
        sel = idx[start : start + batch_size]
        n_real = len(sel)
        if n_real < batch_size and wrap_pad:
            extra = idx[np.arange(batch_size - n_real) % n]
            sel = np.concatenate([sel, extra])
        weight = (np.arange(len(sel)) < n_real).astype(np.float32)
        if rows is not None:
            sel = sel[rows]
        if cache is not None and all(int(i) in cache for i in sel):
            imgs_arr = np.stack([cache[int(i)][0] for i in sel])
            masks_arr = np.stack([cache[int(i)][1] for i in sel])
        elif pool is not None:
            ipaths = [dataset.image_path(int(i)) for i in sel]
            mpaths = [dataset.mask_path(int(i)) for i in sel]
            imgs_arr, masks_u8, fails = pool.load_batch(ipaths, mpaths, h, w,
                                                        c)
            if fails:
                raise IOError(f"decode pool failed on {fails} of {len(sel)} "
                              f"files (first: {ipaths[0]})")
            masks_arr = _masks_u8_to_onehot(masks_u8, classes, activation)
        else:
            imgs, masks = [], []
            for i in sel:
                item = dataset[int(i)]
                imgs.append(prepare_image(item.x, shape))
                masks.append(prepare_mask(item.y, shape, classes,
                                          activation).astype(np.uint8))
            imgs_arr = np.stack(imgs)
            masks_arr = np.stack(masks)
        if cache is not None:
            for j in range(len(sel)):
                ii = int(sel[j])
                if ii not in cache:
                    cache[ii] = (imgs_arr[j], masks_arr[j])
        if stats is not None:
            stats["decode_s"] += time.perf_counter() - _t0
            stats["batches"] += 1
        yield {
            "image": imgs_arr,
            "mask": masks_arr,
            "weight": weight,
        }


class Prefetcher:
    """Batches from ``gen_fn()`` built ``depth`` ahead on a worker thread
    and yielded as tensors on ``device``.

    The worker turns each numpy batch into tensors and, for a CUDA device,
    pins them; the consumer (the caller's thread) copies them to the card
    with ``non_blocking=True`` on its current stream.  An error in the
    worker is re-raised in the consumer; leaving the loop early stops the
    worker."""

    def __init__(self, gen_fn: Callable[[], Iterator[Dict[str, np.ndarray]]],
                 device="cuda", depth: int = 2):
        self.gen_fn = gen_fn
        self.device = torch.device(device)
        self.depth = max(1, depth)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        done = object()
        err = []
        stop = threading.Event()
        pin = self.device.type == "cuda"

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for batch in self.gen_fn():
                    t = {k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in batch.items()}
                    if pin:
                        t = {k: v.pin_memory() for k, v in t.items()}
                    if not put(t):
                        return
            except BaseException as e:  # surfaced in the consumer
                err.append(e)
            finally:
                put(done)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    if err:
                        raise err[0]
                    return
                yield {k: v.to(self.device, non_blocking=pin)
                       for k, v in item.items()}
        finally:
            stop.set()
            th.join()
