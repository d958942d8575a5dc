"""Parallel decode and resize of image and mask files into batch buffers.

Counterpart of ``segmentation_training_pipeline_tpu/native/loader.py`` and
``native/loader.cc``, on a persistent pool of Python threads that call
``cv2``, which releases the GIL while it decodes and resizes.  The bytes
are ``loader.cc``'s:

  * images: ``IMREAD_COLOR``, ``INTER_LINEAR`` only when the size differs,
    then BGR → RGB; for C = 1 the UNWEIGHTED mean of the three channels
    rounded to uint8 (``loader.cc`` sums them in float32, divides by 3 and
    rounds with ``convertTo``; ``cv2.transform`` with weights 1/3 rounds
    the same float sum, and a sum of three uint8 over 3 is never within
    1/6 of a rounding tie, so both give round(k/3));
  * masks: ``IMREAD_GRAYSCALE``, ``INTER_NEAREST`` when the size differs;
    an item without a mask file gets zeros;

written in item order into preallocated (N, H, W, C) and (N, H, W)
uint8 buffers.  A file that fails to decode is counted, not dropped.

Threads.  The pool has ``os.cpu_count()`` threads unless told otherwise
(``loader.cc`` takes ``hardware_concurrency``).  Each lowers its own
scheduling priority (Linux ``setpriority`` on the thread's id; the rest of
the process keeps its own), so that the thread dispatching the train
step to the card gets a core when it wants one while every decode thread
is busy.  ``cv2``'s global thread count is left as the user set it:
OpenCV's pool runs one parallel region at a time, and a ``resize`` that
finds it busy runs on its caller's thread, so the pool's threads do not
multiply with OpenCV's.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np

# niceness the decode threads add to their own: below the main thread,
# still ahead of any background work
_NICE = 5


def _lower_priority() -> None:
    try:
        tid = threading.get_native_id()
        os.setpriority(os.PRIO_PROCESS, tid,
                       os.getpriority(os.PRIO_PROCESS, tid) + _NICE)
    except (AttributeError, OSError):   # not Linux, or not permitted
        pass


class DecodePool:
    """A persistent pool of ``n_threads`` decode threads (0: one per CPU
    of the host, as ``loader.cc``)."""

    def __init__(self, n_threads: int = 0):
        self.threads = int(n_threads) or os.cpu_count() or 1
        self._pool = ThreadPoolExecutor(self.threads,
                                        thread_name_prefix="stp-decode",
                                        initializer=_lower_priority)

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def load_batch(self, img_paths: Sequence[str],
                   mask_paths: Optional[Sequence[Optional[str]]],
                   h: int, w: int, c: int = 3
                   ) -> Tuple[np.ndarray, Optional[np.ndarray], int]:
        """→ (images (N, H, W, C) uint8, masks (N, H, W) uint8 or None,
        the number of files that failed), as
        ``NativeLoader.load_batch``."""
        import cv2

        if c not in (1, 3):
            raise ValueError(f"the decode pool gives 1 or 3 channels, not "
                             f"{c}")
        n = len(img_paths)
        imgs = np.empty((n, h, w, c), np.uint8)
        masks = np.empty((n, h, w), np.uint8) if mask_paths is not None \
            else None
        mean = np.full((1, 3), 1.0 / 3.0, np.float32)

        def image(i: int) -> int:
            img = cv2.imread(img_paths[i], cv2.IMREAD_COLOR)
            if img is None:
                return 1
            if img.shape[:2] != (h, w):
                img = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
            if c == 1:
                imgs[i, :, :, 0] = cv2.transform(img, mean).reshape(h, w)
            else:
                imgs[i] = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            return 0

        def mask(i: int) -> int:
            if mask_paths[i] is None:
                masks[i] = 0
                return 0
            m = cv2.imread(mask_paths[i], cv2.IMREAD_GRAYSCALE)
            if m is None:
                return 1
            if m.shape != (h, w):
                m = cv2.resize(m, (w, h), interpolation=cv2.INTER_NEAREST)
            masks[i] = m
            return 0

        def item(i: int) -> int:
            return image(i) + (mask(i) if masks is not None else 0)

        return imgs, masks, sum(self._pool.map(item, range(n)))


_DEFAULT: Optional[DecodePool] = None
_LOCK = threading.Lock()


def default_pool() -> DecodePool:
    """The process's shared pool, made at first use."""
    global _DEFAULT
    with _LOCK:
        if _DEFAULT is None:
            _DEFAULT = DecodePool()
        return _DEFAULT
