#!/usr/bin/env python3
"""Time the host side of a train-mode BatchNorm layer of two or more
checkouts of the port, on the CPU, in one process.

    python3 examples/batchnorm_host.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (an older commit's, unpacked
with ``git archive``, or this one).  Its port package is copied into a
temporary directory under another name, so that every checkout imports
side by side, and every kernel entry point is bound to a C function that
returns 0 at once (compiled with ``cc``): a call runs the wrapper's own
work (checks, the launch plan's cache, scratch, ``ctypes`` marshalling of
each argument, autograd) and no kernel.  The tensors are on the ``meta``
device, which takes the wrappers' CUDA branch without a card.  One layer's
forward and backward on bf16 channels-last maps, a tiny one (2, 64, 8, 8)
and layer 4's (16, 512, 16, 16); blocks of ``CALLS`` calls interleaved
across the checkouts (A B … B A) ``TURNS`` times.  Prints one JSON line:
per checkout and map, the median and least microseconds a call.  Needs
``cc``; no card.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

PACKAGE = "segmentation_training_pipeline_tpu_torch"
SHAPES = {"tiny": (2, 64, 8, 8), "layer4": (16, 512, 16, 16)}
CALLS, TURNS = 200, 20
# each kernel's ``Card`` fields on an H100 80GB HBM3 (bf16 channels-last:
# the reductions' and bn_apply's ring instantiations, bn_grad_apply's)
H100_CARDS = {"bn_stats": (132, 4, 8, (528, 264, 124, 62)),
              "bn_apply": (132, 4, 1, (528,)),
              "bn_grad_stats": (132, 4, 8, (528, 264, 124, 62)),
              "bn_grad_apply": (132, 2, 1, (264,))}


def stubbed_layer(name: str, address: int):
    """The ``BatchNorm`` layer class of package ``name``, its launches
    bound to the C function at ``address``, its device checks and stream
    query off."""
    K = importlib.import_module(name + ".kernels")
    BN = importlib.import_module(name + ".models.batchnorm")
    L = importlib.import_module(name + ".models.layers")
    for k in K.KERNELS.values():
        k._fn = ctypes.CFUNCTYPE(ctypes.c_int, *k.argtypes)(address)
    BN._check = lambda *a, **kw: None
    K.stream_of = lambda x: 0
    if hasattr(BN, "_card"):          # an H100 80GB HBM3's occupancy
        BN._card = lambda device, kernel, *a: BN.Card(*H100_CARDS[kernel])
    return L.BatchNorm


def main(argv=None) -> int:
    roots = list(sys.argv[1:] if argv is None else argv)
    if not roots:
        raise SystemExit(__doc__)
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        noop = Path(tmp) / "noop.c"
        noop.write_text("int stp_noop(void) { return 0; }\n")
        lib_path = Path(tmp) / "libnoop.so"
        subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", str(lib_path),
                        str(noop)], check=True)
        address = ctypes.cast(ctypes.CDLL(str(lib_path)).stp_noop,
                              ctypes.c_void_p).value
        pkgs = Path(tmp) / "pkgs"
        steps = {}
        for i, root in enumerate(roots):
            name = f"stp_checkout{i}"
            shutil.copytree(Path(root) / PACKAGE, pkgs / name,
                            ignore=shutil.ignore_patterns("_build", "*.so"))
        sys.path.insert(0, str(pkgs))
        for i, root in enumerate(roots):
            layer = stubbed_layer(f"stp_checkout{i}", address)
            for s, shape in SHAPES.items():
                x = torch.empty(shape, device="meta", dtype=torch.bfloat16)
                x = x.contiguous(memory_format=torch.channels_last)
                x.requires_grad_(True)
                dy = torch.empty_like(x).detach()
                bn = layer(shape[1]).to("meta")
                args = (x, *bn.parameters())
                steps[root, s] = (lambda bn=bn, x=x, args=args, dy=dy:
                                  torch.autograd.grad(bn(x, train=True),
                                                      args, dy))
                for _ in range(CALLS):
                    steps[root, s]()
        times = {key: [] for key in steps}
        for _ in range(TURNS):
            for root in roots + roots[::-1]:
                for s in SHAPES:
                    f = steps[root, s]
                    t0 = time.perf_counter()
                    for _ in range(CALLS):
                        f()
                    times[root, s].append(
                        (time.perf_counter() - t0) / CALLS * 1e6)
    print(json.dumps({root: {s: dict(median_us=statistics.median(
        times[root, s]), least_us=min(times[root, s])) for s in SHAPES}
        for root in roots}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
