"""Run-length encoding for Kaggle-style mask submissions.

Counterpart of ``segmentation_training_pipeline_tpu/utils/rle.py``: runs
are column-major and 1-indexed (the Kaggle convention), and a run past the
end of the mask raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def rle_encode(mask: np.ndarray) -> str:
    """Binary mask (H, W) → 'start len start len ...', column-major,
    1-indexed (Kaggle convention)."""
    pixels = np.asarray(mask, dtype=bool).flatten(order="F")
    padded = np.concatenate([[False], pixels, [False]])
    changes = np.flatnonzero(padded[1:] != padded[:-1]) + 1
    starts = changes[::2]
    ends = changes[1::2]
    return " ".join(f"{s} {e - s}" for s, e in zip(starts, ends))


def rle_decode(rle: Optional[str], shape) -> np.ndarray:
    """'start len ...' → binary mask (H, W) uint8, column-major 1-indexed.

    Runs beyond H·W raise: silently clipping them (the easy bug) means an
    RLE encoded at a different resolution trains on corrupted labels with
    no signal."""
    h, w = shape[:2]
    out = np.zeros(h * w, dtype=np.uint8)
    if rle and str(rle).strip() and str(rle).strip().lower() != "nan":
        nums = np.asarray(str(rle).split(), dtype=np.int64)
        starts, lengths = nums[0::2] - 1, nums[1::2]
        if len(starts) and (starts.min() < 0
                            or int((starts + lengths).max()) > h * w):
            raise ValueError(
                f"RLE run extends past the {h}x{w} mask "
                f"(max end {int((starts + lengths).max())} > {h * w}) — "
                "was the RLE encoded at a different resolution?")
        for s, l in zip(starts, lengths):
            out[s : s + l] = 1
    return out.reshape((h, w), order="F")
