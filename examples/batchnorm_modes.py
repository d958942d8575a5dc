#!/usr/bin/env python3
"""Time one batch-norm kernel of this checkout in launch variants on one
card: the sweep behind ``_mode``'s choice (``_DIRECT_BYTES``) and the
direct mode's ``_DIRECT_ROWS`` and ``_DIRECT_TILE``.

    python3 examples/batchnorm_modes.py [KERNEL [VARIANT ...]]

KERNEL defaults to ``bn_grad_apply``; a VARIANT is ``R`` (the ring of
bulk copies, where the kernel has one) or ``D<n>`` (direct 16-byte
loads, ``n`` rows, or ``bn_grad_apply``'s vectors of a plane, a thread:
``_DIRECT_ROWS``), then optionally ``t<w>`` (a direct tile of ``w``
channels: ``_DIRECT_TILE``) and ``u`` (a grid that holds every tile at
once instead of walking on past a wave: ``items`` = tiles); the default
is ``D8``.  The mode and ``u`` are forced by wrapping
``models/batchnorm.py``'s ``_mode`` and ``_plan`` for KERNEL alone; rows
and tile hold for every kernel's direct mode while the variant runs
(only KERNEL's times are printed).  The variants run in turns, first to
last and back; each turn runs every case of ``chip_smoke.py``'s
``batchnorm`` phase (``BN_CASES``) as the phase does
(``chip_smoke._bn_case``: the four kernels through their wrappers,
checked against their plain versions, each the median of 50 launches
behind the 20 ms hold).  One JSON line per case: the map's bytes a
tensor, the mode ``_mode`` picks unforced, each variant's ms in both of
its turns, and whether every turn held the checks (sums within 1e-12, 0
ulp, bit for bit).  A map without 16-byte accesses runs one value at a
time in every variant.  Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.getcwd())

import chip_smoke as CS  # noqa: E402
from segmentation_training_pipeline_tpu_torch.models import (  # noqa: E402
    batchnorm as BN)

LETTERS = {BN._RING: "R", BN._DIRECT: "D", BN._PER_VALUE: "V"}


def forced(kernel: str, variant: str):
    """``_mode``, ``_plan``, rows a thread and tile of ``kernel``'s
    launches in ``variant``."""
    mode = BN._RING if variant[0] == "R" else BN._DIRECT
    head, _, tile = variant[1:].rstrip("u").partition("t")
    rows = int(head or BN._DIRECT_ROWS)
    tile = int(tile or BN._DIRECT_TILE)
    plain_mode, plain_plan = BN._mode, BN._plan

    def pick(k, *args):
        m = plain_mode(k, *args)
        return mode if k == kernel and m != BN._PER_VALUE else m

    def plan(k, rows_, outer, c, inner, esize, m, card):
        out = plain_plan(k, rows_, outer, c, inner, esize, m, card)
        if k != kernel or not variant.endswith("u"):
            return out
        span, slices, tw, cluster, _ = out
        return span, slices, tw, cluster, min(
            -(-c // tw) if rows_ else c, 65535)
    return pick, plan, rows, tile


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    kernel = args.pop(0) if args else "bn_grad_apply"
    variants = args or ["D8"]
    CS.phase_device()
    cases = list(enumerate(CS.BN_CASES))
    times = {}
    for variant in variants + variants[::-1]:
        pick, plan, rows, tile = forced(kernel, variant)
        saved = BN._mode, BN._plan, BN._DIRECT_ROWS, BN._DIRECT_TILE
        BN._mode, BN._plan, BN._DIRECT_ROWS, BN._DIRECT_TILE = (
            pick, plan, rows, tile)
        BN._GEOMETRY.clear()
        try:
            for i, (name, shape, dtype, layout) in cases:
                c = CS._bn_case(name, shape, dtype, layout, CS.SEED + i,
                                yardsticks=False, strict=False)
                times.setdefault(i, []).append(
                    (variant, c["kernels"][kernel]["ms"], c["ok"]))
        finally:
            BN._mode, BN._plan, BN._DIRECT_ROWS, BN._DIRECT_TILE = saved
            BN._GEOMETRY.clear()
    for i, (name, shape, dtype, layout) in cases:
        x = CS._bn_inputs(shape, dtype, layout, CS.SEED + i)["x"]
        b, c, h, w = shape
        rows = BN._rows(x)
        outer, inner = (b * h * w, 1) if rows else (b, h * w)
        vec = (c if rows else inner) % (16 // x.element_size()) == 0
        picked = BN._mode(kernel, rows, outer, c, inner, x.element_size(),
                          vec)
        print(json.dumps({
            "kernel": kernel, "case": name, "shape": list(shape),
            "dtype": str(dtype).split(".")[-1], "layout": layout,
            "tensor_bytes": x.numel() * x.element_size(),
            "picked": LETTERS[picked],
            "ms": {v: [t for u, t, _ in times[i] if u == v]
                   for v in variants},
            "ok": all(ok for *_, ok in times[i])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
