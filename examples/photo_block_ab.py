#!/usr/bin/env python3
"""Time augmentation blocks of two or more checkouts of the port side by
side on one card.

    python3 examples/photo_block_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (an older commit's, unpacked
with ``git archive``, or an edit of it).  The checkouts run in turns,
first to last and back (A B … B A), each turn in a process of its own that
imports the port and ``chip_smoke.py`` from its ROOT.  A turn times, at
``chip_smoke.py``'s 512² B16 batch, each name of CASES alone through
``Augmentation.apply`` (CUDA events, median of 10, as its ``photo_paths``)
and runs its ``train_filter`` phase (the block's ms and the img/s of 10
bf16 steps).  One JSON line per turn.  Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CASES = ("jpegcompression", "gaussianblur", "directededgedetect",
         "edgedetect")


def turn(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke as CS

    CS.phase_device()
    CS.phase_build()
    _, imgs, masks, _ = CS.train_shapes()
    specs = dict(CS.PHOTO_CASES)
    block_ms = {}
    for case in CASES:
        aug = CS.LW.build_augmentation(specs[case])
        draws = CS._to(aug.sample(torch.Generator().manual_seed(CS.SEED),
                                  CS.BATCH, CS.SIZE, CS.SIZE), "cuda")
        block_ms[case] = CS.cuda_ms(lambda: aug.apply(draws, imgs, masks),
                                    10)
    filt = CS.phase_train_filter(imgs, masks, CS.SEED, "")
    return dict(block_ms=block_ms, train_filter_block_ms=filt["block_ms"],
                train_filter_img_per_s=filt["img_per_s"])


def main(argv=None) -> int:
    roots = list(argv if argv is not None else sys.argv[1:])
    if not roots:
        raise SystemExit(__doc__)
    for root in roots + roots[::-1]:
        out = subprocess.run(
            [sys.executable, __file__, "--turn", root], capture_output=True,
            text=True, check=True).stdout.strip().splitlines()[-1]
        print(json.dumps({"root": root, **json.loads(out)}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--turn"]:
        print(json.dumps(turn(sys.argv[2])), flush=True)
    else:
        sys.exit(main())
