#!/usr/bin/env python3
"""Time the train steps of two or more checkouts of the port side by side
on one card, with their batch norm's device time.

    python3 examples/batchnorm_ab.py OUT ROOT [ROOT ...]

Each ROOT is a checkout of this repository (an older commit's, unpacked
with ``git archive``, or an edit of it).  The checkouts run in turns,
first to last and back (A B … B A), each turn in a process of its own that
imports the port and ``chip_smoke.py`` from its ROOT and runs that
checkout's ``train`` and ``train_deeplab`` phases (Unet-resnet34 and
DeepLabV3-xception_aligned at 512² B16, bf16, the config-2 block, 10
steps), each followed by three profiled steps whose kernel tables go to
``OUT/<turn>_<phase>.txt``.  One JSON line per turn: each phase's steady
step ms (steps 2-10, host clock, synchronised), img/s, and the profile's
device busy ms, idle share, launches and batch-norm ms a step; and
``layer_host_us``: one train-mode ``BatchNorm`` layer of the checkout
(``models/layers.py``), forward and backward, in microseconds a call
(``HOST_CALLS`` calls queued back to back, one synchronise; the median
of ``HOST_BLOCKS`` such blocks), on the host's wall clock and as the
process's CPU time (``time.process_time``: the host work itself, less
moved by other tenants of a shared host than the wall clock), on bf16
channels-last maps: a tiny one (2, 64, 8, 8), whose device work is
shorter than its host work, and layer 4's (16, 512, 16, 16).  Needs one
CUDA card and ``nvcc``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import time

HOST_SHAPES = {"tiny": (2, 64, 8, 8), "layer4": (16, 512, 16, 16)}
HOST_CALLS, HOST_BLOCKS = 200, 7


def layer_host_us(torch, BatchNorm) -> dict:
    """Microseconds a layer's forward and backward take on the host
    clock, per map in ``HOST_SHAPES`` (see the module's notes)."""
    out = {}
    for name, shape in HOST_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = (3 + torch.randn(shape, generator=gen, device="cuda")).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        dy = torch.randn_like(x)
        x.requires_grad_(True)
        bn = BatchNorm(shape[1]).cuda()
        args = (x, *bn.parameters())

        def step():
            torch.autograd.grad(bn(x, train=True), args, dy)

        for _ in range(50):
            step()
        torch.cuda.synchronize()
        wall, cpu = [], []
        for _ in range(HOST_BLOCKS):
            t0, c0 = time.perf_counter(), time.process_time()
            for _ in range(HOST_CALLS):
                step()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
            cpu.append((time.process_time() - c0) / HOST_CALLS * 1e6)
        out[name] = dict(wall=statistics.median(wall),
                         cpu=statistics.median(cpu))
    return out


def turn(root: str, prefix: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke as CS

    CS.phase_device()
    CS.phase_build()
    _, imgs, masks, _ = CS.train_shapes()
    unet = CS.CF.parse_dict({"architecture": "Unet", "backbone": "resnet34",
                             "loss": CS.LOSS, "optimizer": "Adam",
                             "lr": CS.LR, "batch": CS.BATCH,
                             "augmentation": CS.CONFIG2_BLOCK,
                             "metrics": ["dice", "iou"]})
    deeplab = dataclasses.replace(unet, architecture="DeepLabV3",
                                  backbone="xception_aligned")
    x_y_elastic = {"warp_x": 1, "warp_y": 1, "elastic": 1}
    from segmentation_training_pipeline_tpu_torch.models.layers import (
        BatchNorm)

    out = {"layer_host_us": layer_host_us(CS.torch, BatchNorm)}
    for name, cfg in (("train", unet), ("train_deeplab", deeplab)):
        lines = io.StringIO()
        with contextlib.redirect_stdout(lines):
            run = CS.phase_train(name, cfg, imgs, masks, CS.STEPS, CS.SEED,
                                 x_y_elastic, f"{prefix}_{name}.txt")
        prof = next(json.loads(s) for s in lines.getvalue().splitlines()
                    if s.startswith('{"phase": "profile"'))
        out[name] = dict(
            steady_step_ms=statistics.mean(run["step_ms"][1:]),
            img_per_s=run["img_per_s"], device_busy_ms=prof["device_busy_ms"],
            idle_share=prof["idle_share"],
            kernels_per_step=prof["kernels_per_step"],
            batch_norm_ms=prof["by_layer_ms"]["batch norm"])
        CS.torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    if len(args) < 2:
        raise SystemExit(__doc__)
    out_dir, roots = args[0], args[1:]
    os.makedirs(out_dir, exist_ok=True)
    for i, root in enumerate(roots + roots[::-1]):
        prefix = os.path.join(os.path.abspath(out_dir), f"turn{i}")
        res = subprocess.run(
            [sys.executable, __file__, "--turn", root, prefix],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise SystemExit(f"turn {i} ({root}) failed:\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        print(json.dumps({"root": root, "turn": i,
                          **json.loads(res.stdout.strip().splitlines()[-1])}),
              flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--turn"]:
        print(json.dumps(turn(sys.argv[2], sys.argv[3])), flush=True)
    else:
        sys.exit(main())
