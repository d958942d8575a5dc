#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA Hopper card and check it.

    python3 chip_smoke.py [--profile FILE]

Needs a CUDA card (sm_90a), PyTorch built for CUDA and ``nvcc``; imports
nothing of JAX.  Phases, each printing one JSON line; any failure raises
and the script exits non-zero:

  1. device: ``nvidia-smi`` name and power limit, torch, capability;
  2. build: compile the CUDA kernels from ``csrc/`` (parallel ``nvcc``);
  3. reference: on a small input, the augmentation with the kernels on
     the card against the plain versions on the CPU (same draws), and the
     float32 forward on the card against the CPU;
  4. capture: the config-2 augmentation once at the train shapes,
     recording the tensors the path hands each kernel;
  5. kernel: per kernel, on those tensors, the kernel against its plain
     PyTorch version on the card (images within 1e-3, mask pixels
     mismatching in at most 1e-4 of the mask entries) and both timed
     with CUDA events beside the kernel's memory bound;
  6. train: full-width Unet-resnet34 at 512², B16, bf16 autocast (f32
     head), bce + 0.25·dice, Adam at lr 5e-4, with the config-2 block,
     for 10 steps on a fixed synthetic batch; every launch count
     is reset just before and read just after, and each kernel must have
     launched once per step;
  7. the ``kernels`` summary line, then the last line
     ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from segmentation_training_pipeline_tpu_torch import kernels as K
from segmentation_training_pipeline_tpu_torch.models import factory as MF
from segmentation_training_pipeline_tpu_torch.ops import losses as LO
from segmentation_training_pipeline_tpu_torch.ops import metrics as ME
from segmentation_training_pipeline_tpu_torch.ops.aug import elastic as EL
from segmentation_training_pipeline_tpu_torch.ops.aug import fused_warp as FW
from segmentation_training_pipeline_tpu_torch.ops.aug import lowering as LW
from segmentation_training_pipeline_tpu_torch.train import optimizers as OP
from segmentation_training_pipeline_tpu_torch.train import step as ST

CONFIG2_BLOCK = {
    "Fliplr": 0.5,
    "Affine": {"rotate": [-15, 15], "scale": [0.85, 1.15],
               "translate_percent": {"x": [-0.1, 0.1], "y": [-0.1, 0.1]}},
    "ElasticTransformation": {"alpha": [0, 40], "sigma": 6},
    "Multiply": [0.9, 1.1],
}
LOSS = "binary_crossentropy + 0.25*dice_loss"
LR = 5e-4
STEPS, BATCH, SIZE, SEED = 10, 16, 512, 0   # the config-2 batch at 512²
IMG_ATOL = 1e-3
MASK_SHARE = 1e-4
# card vs CPU end to end: sin/cos/exp and the blur's sums round differently
# there, moving a sample coordinate by ~1e-5 px, which moves a noisy image
# value by up to |grad I|·1e-5 and can flip a mask pixel sitting on a tie
REF_IMG_ATOL = 0.05
REF_MASK_SHARE = 1e-3

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s outside the
# tensor cores
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
# f32 operations per output pixel, counted from the kernel sources
OPS_PER_PIXEL = {"warp_x": 25, "warp_y": 27, "elastic": 32}
SOURCES = {"warp_x": "segmentation_training_pipeline_tpu_torch/csrc/warp_xy.cu",
           "warp_y": "segmentation_training_pipeline_tpu_torch/csrc/warp_xy.cu",
           "elastic": "segmentation_training_pipeline_tpu_torch/csrc/elastic.cu"}


def check(ok: bool, what) -> None:
    """A failed check ends the run (asserts would vanish under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke.py check failed: {what}")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median time of one call of ``fn`` on the card (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def synthetic_batch(b: int, h: int, w: int, seed: int):
    """uint8 images whose bright discs are the mask, plus noise."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy = r.uniform(0.3, 0.7, b) * h
    cx = r.uniform(0.3, 0.7, b) * w
    rad = r.uniform(0.15, 0.3, b) * min(h, w)
    masks = ((yy[None] - cy[:, None, None]) ** 2
             + (xx[None] - cx[:, None, None]) ** 2
             < rad[:, None, None] ** 2).astype(np.float32)[..., None]
    imgs = 60.0 + 120.0 * masks + r.normal(0.0, 25.0, (b, h, w, 3))
    return np.clip(imgs, 0, 255).astype(np.uint8), masks


def mask_mismatch(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a != b).float().mean())


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device (torch.cuda."
                         "is_available() is False); this script runs on "
                         "the card only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    cap = torch.cuda.get_device_capability(0)
    info = dict(nvidia_smi=smi.splitlines()[0],
                name=torch.cuda.get_device_name(0),
                count=torch.cuda.device_count(), torch=torch.__version__,
                cuda=torch.version.cuda, capability=list(cap))
    emit("device", **info)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke.py: the kernels are built for sm_90a, "
                         f"this card is sm_{cap[0]}{cap[1]}")
    return info


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = K.build()
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[p.name for p in libs])


def phase_reference(seed: int) -> None:
    """Small input: kernels on the card vs plain versions on the CPU, and
    the f32 forward on the card vs the CPU (TF32 off for the check)."""
    aug = LW.build_augmentation(CONFIG2_BLOCK)
    imgs, masks = synthetic_batch(2, 128, 128, seed + 1)
    draws = aug.sample(torch.Generator().manual_seed(seed), 2, 128, 128)
    ci, cm = aug.apply(draws, torch.from_numpy(imgs), torch.from_numpy(masks))
    gi, gm = aug.apply(_to(draws, "cuda"), torch.from_numpy(imgs).cuda(),
                       torch.from_numpy(masks).cuda())
    aug_err = float((gi.cpu() - ci).abs().max())
    aug_mis = mask_mismatch(gm.cpu(), cm)

    model = MF.init_model(MF.create_model("Unet", "resnet34", 1,
                                          dtype="float32"), seed, "cpu")
    x = torch.from_numpy(imgs).float() / 127.5 - 1.0
    params, stats = MF.model_variables(model)
    want = MF.apply_model(model, params, stats, x)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        model.cuda()
        params, stats = MF.model_variables(model)
        got = MF.apply_model(model, params, stats, x.cuda()).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    fwd_err = float((got - want).abs().max() / want.abs().max())
    emit("reference", aug_max_err=aug_err, aug_mask_mismatch=aug_mis,
         forward_rel_err=fwd_err, shape=[2, 128, 128],
         tolerance=dict(aug_img_atol=REF_IMG_ATOL,
                        aug_mask_share=REF_MASK_SHARE, forward_rel=1e-3))
    check(aug_err <= REF_IMG_ATOL, ("aug image error", aug_err))
    check(aug_mis <= REF_MASK_SHARE, ("aug mask mismatch", aug_mis))
    # cuDNN's f32 algorithms against the CPU's
    check(fwd_err <= 1e-3, ("forward error", fwd_err))


def _to(draws, device):
    if isinstance(draws, torch.Tensor):
        return draws.to(device)
    if isinstance(draws, dict):
        return {k: _to(v, device) for k, v in draws.items()}
    return [_to(v, device) for v in draws]


def phase_capture(aug, imgs, masks, gen):
    """Run the augmentation once and record each kernel wrapper's
    arguments (the tensors the main path gives the kernel)."""
    captured = {}
    hooks = [(FW, "warp_x"), (FW, "warp_y"), (EL, "elastic_resample")]
    originals = {name: getattr(mod, name) for mod, name in hooks}

    def hook(name):
        def call(*args):
            captured[name] = args
            return originals[name](*args)
        return call

    for mod, name in hooks:
        setattr(mod, name, hook(name))
    try:
        b, h, w, c = imgs.shape
        out_i, out_m = aug.apply(aug.sample(gen, b, h, w, c), imgs, masks)
        torch.cuda.synchronize()
    finally:
        for mod, name in hooks:
            setattr(mod, name, originals[name])
    planes = captured["warp_x"][0]
    check(bool(torch.isfinite(out_i).all()), "augmented images finite")
    check(float(out_i.min()) >= 0.0 and float(out_i.max()) <= 255.0,
          "augmented images in [0, 255]")
    check(bool(((out_m == 0) | (out_m == 1)).all()), "masks binary")
    emit("capture", planes=list(planes.shape), px=captured["warp_x"][3],
         py=captured["warp_y"][3], k=captured["elastic_resample"][4],
         image_range=[float(out_i.min()), float(out_i.max())],
         mask_values=sorted(set(out_m.unique().tolist())))
    return {"warp_x": captured["warp_x"], "warp_y": captured["warp_y"],
            "elastic": captured["elastic_resample"]}


def phase_kernels(args_of) -> dict:
    calls = {
        "warp_x": (FW.warp_x, FW.warp_x_plain),
        "warp_y": (FW.warp_y, FW.warp_y_plain),
        "elastic": (EL.elastic_resample, EL.elastic_resample_plain),
    }
    rows = {}
    for name, (kernel, plain) in calls.items():
        args = args_of[name]
        planes, flags = args[0], args[1]
        got = kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        image = (flags == 0).view(1, -1, 1, 1).expand_as(got)
        err = float((got - want)[image].abs().max())
        mis = mask_mismatch(got[~image], want[~image])
        ms = cuda_ms(lambda: kernel(*args), 50)
        plain_ms = cuda_ms(lambda: plain(*args), 10)
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        nbytes = (sum(t.numel() * t.element_size() for t in tensors)
                  + got.numel() * got.element_size())
        ops = OPS_PER_PIXEL[name] * got.numel()
        t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / F32_FLOPS * 1e3
        rows[name] = dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=K.KERNELS[name].replaces, launches=None,
            max_abs_err=err, mask_mismatch=mis, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, shape=list(planes.shape), bytes=nbytes)
        emit("kernel", **rows[name])
        check(err <= IMG_ATOL, (name, "image error", err))
        check(mis <= MASK_SHARE, (name, "mask mismatch", mis))
    return rows


def phase_train(aug, imgs, masks, steps: int, seed: int,
                profile: str = "") -> dict:
    dev = imgs.device
    model = MF.init_model(MF.create_model("Unet", "resnet34", 1,
                                          dtype="bfloat16"), seed, dev)
    tx = OP.build_optimizer("Adam")
    state = ST.create_train_state(model, tx, dev)
    step = ST.build_train_step(
        model, tx, LO.build_loss(LOSS, "sigmoid"),
        {"dice": ME.get("dice"), "iou": ME.get("iou")}, "sigmoid", None,
        aug=aug)
    batch = {"image": imgs, "mask": masks}
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    K.reset_launches()
    for _ in range(steps):
        t0 = time.perf_counter()
        state, logs = step(state, batch, LR, gen=gen)
        loss = float(logs["loss"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    launches = K.launch_counts()
    b = imgs.shape[0]
    steady = times[1:] or times
    out = dict(steps=steps, batch=b, size=list(imgs.shape[1:3]),
               loss=losses, step_ms=times,
               img_per_s=b / (statistics.mean(steady) / 1e3),
               launches=launches, dice=float(logs["dice"]),
               iou=float(logs["iou"]),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    emit("train", **out)
    check(all(math.isfinite(v) for v in losses), ("finite loss", losses))
    check(statistics.mean(losses[-3:]) < losses[0], ("falling loss", losses))
    check(launches == {n: steps for n in K.KERNELS},
          ("one launch per kernel and step", launches))
    if profile:
        phase_profile(lambda: step(state, batch, LR, gen=gen), profile)
    return out


# kernel-name fragments → the layer they belong to, first match wins
_LAYERS = [("aug kernels", ("warp_x_kernel", "warp_y_kernel",
                            "elastic_kernel")),
           ("convolution", ("conv", "xmma", "gemm", "cutlass", "sm90_",
                            "winograd", "implicit")),
           ("batch norm", ("bn_", "batch_norm", "batchnorm", "welford")),
           ("optimizer", ("foreach", "multi_tensor")),
           ("elementwise and reductions", ("elementwise", "vectorized",
                                           "reduce", "upsample")),
           ("other", ("",))]


def phase_profile(run_step, path: str, steps: int = 3) -> None:
    """Three more steps under torch.profiler: device time by layer and
    by kernel, and the device's idle share of the window's wall time.
    The table of the top kernels goes to ``path``."""
    from torch.profiler import ProfilerActivity, profile

    run_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_layer = {name: 0.0 for name, _ in _LAYERS}
    for e in kernels:
        key = e.key.lower()
        layer = next(n for n, frags in _LAYERS
                     if any(f in key for f in frags))
        by_layer[layer] += e.self_device_time_total / 1e3 / steps
    busy_ms = sum(by_layer.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:40]
    with open(path, "w") as f:
        f.write(f"# {steps} steps, wall {wall_ms:.3f} ms, device busy "
                f"{busy_ms * steps:.3f} ms\n")
        for e in top:
            f.write(f"{e.self_device_time_total / 1e3 / steps:10.4f} ms/step"
                    f" {e.count // steps:6d} calls/step  {e.key[:150]}\n")
    emit("profile", steps=steps, step_wall_ms=wall_ms / steps,
         device_busy_ms=busy_ms, idle_share=(1.0 - busy_ms * steps / wall_ms
                                             if busy_ms else None),
         by_layer_ms=by_layer, kernels_per_step=sum(e.count for e in kernels)
         // steps, table=path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", default="",
                    help="also profile 3 steps; write the kernel table here")
    a = ap.parse_args(argv)

    info = phase_device()
    phase_build()
    phase_reference(SEED)

    aug = LW.build_augmentation(CONFIG2_BLOCK)
    imgs, masks = synthetic_batch(BATCH, SIZE, SIZE, SEED)
    imgs, masks = torch.from_numpy(imgs).cuda(), torch.from_numpy(masks).cuda()
    gen = torch.Generator(device=imgs.device).manual_seed(SEED)
    args_of = phase_capture(aug, imgs, masks, gen)
    rows = phase_kernels(args_of)
    train = phase_train(aug, imgs, masks, STEPS, SEED, a.profile)
    for name, row in rows.items():
        row["launches"] = train["launches"][name]
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
