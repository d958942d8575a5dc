#!/usr/bin/env python3
"""Time versions of the port's CUDA kernels side by side on one card.

    python3 compare_kernels.py SOURCE.cu [SOURCE.cu ...]

Each SOURCE is a version of a file in
``segmentation_training_pipeline_tpu_torch/csrc/``: an older commit's, or
an edit of it.  It is built with the port's ``nvcc`` flags plus
``-Xptxas -v`` (the register counts are printed), and each kernel entry
point it exports stands in for the port's own while that kernel runs
through its wrapper on the tensors ``chip_smoke.py`` captures at the
train shapes.  Each kernel is timed and held against its plain version
as in ``chip_smoke.py``'s kernel phase; a version that disagrees is
reported, not refused.  The versions run in turns, first to last and back
(A B … B A), one JSON line per version and kernel, so that versions are
compared within one call on one card; the shear's rows also give the time
and the bound of each of its two passes (``pass_ms``, ``pass_bound_ms``).  The first two lines time one
device copy (``copy_``, the same bytes read and written once) of the
planes kernels X and Y take and of the lines the shear's x-pass takes: the
streaming rate the card reaches on them, beside the bound.  Needs one CUDA
card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as CS
from segmentation_training_pipeline_tpu_torch import kernels as K

FIELDS = ("ms", "plain_ms", "bound_ms", "bound_share", "max_abs_err",
          "mask_mismatch")


def build(sources: list[str]) -> list[ctypes.CDLL]:
    """Compile every source in parallel into ``_build/compare/``."""
    out_dir = K.BUILD_DIR / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = K.find_nvcc()
    procs = []
    for i, src in enumerate(sources):
        lib = out_dir / f"{i}-{Path(src).stem}.so"
        procs.append((src, lib, subprocess.Popen(
            [nvcc, *K.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(K.CSRC_DIR),
             "-o", str(lib), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = []
    for src, lib, p in procs:
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        print(json.dumps({"build": src, "ptxas": [
            line.split(":", 1)[1].strip() for line in log.splitlines()
            if "Compiling entry" in line or "registers" in line]}),
            flush=True)
        libs.append(ctypes.CDLL(str(lib)))
    return libs


def entry_points(lib: ctypes.CDLL) -> dict:
    """The port's kernels that ``lib`` exports, with their C signatures."""
    fns = {}
    for k in K.KERNELS.values():
        if hasattr(lib, k.symbol):
            fn = getattr(lib, k.symbol)
            fn.argtypes = k.argtypes
            fn.restype = ctypes.c_int
            fns[k.name] = fn
    return fns


def main(argv=None) -> int:
    sources = sys.argv[1:] if argv is None else argv
    if not sources:
        print(__doc__, file=sys.stderr)
        return 2
    CS.phase_device()
    fns = [entry_points(lib) for lib in build(sources)]
    args_of = CS.phase_capture(*CS.train_shapes())
    # kernel Y's planes and the shear's x-pass lines
    for planes in (args_of["warp_y"][0], args_of["shear"][0][0]):
        copy = torch.empty_like(planes)
        print(json.dumps({"yardstick": "copy_", "shape": list(planes.shape),
                          "bytes": 2 * planes.numel() * planes.element_size(),
                          "ms": CS.cuda_ms(lambda: copy.copy_(planes), 50,
                                           hold=True)}), flush=True)
    turns = list(range(len(sources)))
    for i in turns + turns[::-1]:
        for name, fn in fns[i].items():
            kernel = K.KERNELS[name]
            saved, kernel._fn = kernel._fn, fn
            try:
                m = CS.measure_kernel(name, args_of)
            finally:
                kernel._fn = saved
            row = {"source": sources[i], "kernel": name,
                   **{f: m[f] for f in FIELDS}}
            if "passes" in m:
                row["pass_ms"] = [p["ms"] for p in m["passes"]]
                row["pass_bound_ms"] = [p["bound_ms"] for p in m["passes"]]
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
