#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA Hopper card and check it.

    python3 chip_smoke.py [--profile FILE]

Needs a CUDA card (sm_90a), PyTorch built for CUDA and ``nvcc``; imports
nothing of JAX.  Phases, each printing one JSON line and then a ``wall``
line with its seconds; any failure raises and the script exits non-zero:

  1. device: ``nvidia-smi`` name and power limit, torch, capability, the
     host's CPU count (``nproc``, the decode pool's default threads),
     whether ``cv2`` and ``msgpack`` import (the serve phase needs
     neither), and whether the system OpenCV C++ headers and libraries
     are there (a throwaway ``g++`` link);
  2. build: compile the CUDA kernels from ``csrc/`` (parallel ``nvcc``);
  3. reference: on a small input, the augmentation with the kernels on
     the card against the plain versions on the CPU (same draws), and the
     float32 forwards of Unet-resnet34, FPN-efficientnetb0, 8-class
     PSPNet- and Linknet-resnet50 and DeepLabV3 on the aligned Xception on
     the card against the CPU (TF32 off);
  4. capture: the config-2 augmentation once at the train shapes on each
     of its three paths (default: kernels X, Y, elastic;
     ``STP_FUSE_ELASTIC=1``: X, YE; ``STP_PALLAS_WARP=0``: the shear
     kernel twice around the f32 scale matmuls, then elastic), recording
     the tensors the path hands each kernel;
  5. kernel: per kernel, on those tensors, the kernel against its plain
     PyTorch version on the card (the kernels in ``EXACT``, now all five,
     bit for bit; any other with images within 1e-3 and at most 1e-4 of
     the mask entries mismatching) and both timed with CUDA events, the
     launches queued behind a 20 ms hold of the stream, beside the
     kernel's memory bound (``bound_share`` = bound / kernel time; the
     shear's counts only the source columns its outputs use); beside the
     elastic kernel, ``F.grid_sample`` on its planes, timed the same way
     (``library_ms``) with its difference from the kernel;
  6. warp_paths: the config-2 block at B16 512² through
     ``Augmentation.apply`` on one set of draws, the three paths timed
     (CUDA events, median), their launch counts read, and held against
     each other (YE against X→Y→elastic bit for bit; unfused against
     fused within the JAX test's 1e-2 and 2e-3);
  7. train: full-width Unet-resnet34 at 512², B16, bf16 autocast (f32
     head), bce + 0.25·dice, Adam at lr 5e-4, with the config-2 block,
     for 10 steps on a fixed synthetic batch; every launch count is reset
     just before and read just after: X, Y and elastic once per step;
  8. train_fpn: ``examples/fpn_augmented_512.yaml`` parsed by the port
     (FPN + efficientnetb0 at full width, 512², B16, bf16, its loss,
     optimizer, lr and augmentation) for 10 steps with
     ``STP_FUSE_ELASTIC=1``: X and YE once per step, nothing else;
  8b. train_deeplab: DeepLabV3 on the aligned Xception-65 at full width
     (output stride 16, 16 middle units, bonlime's decoder) with
     ``train``'s batch, loss, optimizer and block for 10 steps: X, Y and
     elastic once a step, each held bit for bit against its plain version
     on the arguments the first step gave it;
  8c. remat: ``train``'s model and block with ``remat`` off, then on
     (two 10-step runs, ``remat_off`` and ``remat_on``): peak memory and
     step time of each, the first step's loss equal within 1e-2;
  9. train_psp: BASELINE config 3, ``examples/multiclass_pspnet.yaml``
     parsed by the port, not cut (PSPNet-resnet50, 384², B16, bf16,
     8-class softmax, its composite loss, Adam at 5e-4) for 10 steps on a
     fixed batch of synthetic 3-class items: no augmentation block, so
     every kernel's launch count must stay 0;
  9b. zoo: every backbone outside the ResNet family and EfficientNet
     (Unet; DeepLabV3 for ``xception_aligned``) and resnet34's
     ``keras-preact`` graph at 256² B4: the f32 forward on the card
     against the CPU (TF32 off) within 1e-3, one bf16 train step with a
     finite loss and no kernel launch, the bf16 forward's ms; one line
     each;
  10. serve: BASELINE config 5, ``examples/tta_ensemble_predict.yaml``
     parsed by the port (Unet-resnet34 at 256², B16, bf16, flip TTA, 5
     folds) in a temporary directory: 5 fold checkpoints written with the
     port's ``save_checkpoint`` (``init_model`` at seeds 0-4) and read back
     bit for bit; ``cfg.load`` of all 5 folds and flip-TTA img/s of
     ``predict_probs`` on a fixed uint8 batch (median of 20 calls after 3
     warm-up calls, each ending in a synchronise) with the peak memory;
     ``cfg.predict_on_dataset`` over 40 images (the last chunk partial)
     equal to ``predict_probs``; a float32 bundle on the card against the
     same on the CPU at B2 (TF32 off), and the bf16 probabilities against
     the float32 ones; no hand-written kernel launched;
  11. fit: BASELINE config 4, ``examples/kfold_multistage.yaml`` parsed by
     the port (Unet-resnet34 at 256², B16, bf16, bce + 0.25·dice, Adam,
     two stages: the encoder frozen at lr 1e-3 with ``negatives: none``,
     then unfrozen at lr 1e-4 with ``negatives: real``, ReduceLROnPlateau
     and EarlyStopping; Fliplr + Affine rotate ±10°) trained through
     ``fit_pipeline`` (what ``cfg.fit`` calls, here with per-epoch
     timings) on fold 0 of 320 synthetic PNGs (a quarter of the masks
     empty) read by ``DirectoryDataSet``, the epochs cut to 2 and 3.
     First the block once on the fit's first batch, with kernels X and Y
     held bit for bit against their plain versions at those shapes and
     draws; then the fit: X and Y once per train step and nothing else,
     the encoder bit for bit after the frozen stage with its BatchNorm
     statistics moved and every encoder parameter changed by the
     unfrozen stage, ``done`` checkpoints that a second ``cfg.fit``
     skips, and ``cfg.load`` serving the fit's checkpoint; train img/s
     over the epochs after each stage's first (also without each epoch's
     wait for its first batch), the epoch split into train, validation
     and checkpoint, a batch's PNG decode on the host alone (the decode
     pool, its thread count beside it), and the peak memory;
  12. fit_psp: config 3 through ``fit_pipeline`` on fold 0 of 128
     synthetic 384² PNGs with class-index masks, the epochs cut from 40
     to 2: the JAX CSV columns, a ``done`` checkpoint, no kernel launch,
     then ``cfg.load`` and ``predict_all_to_dir`` writing class-index
     masks in [0, 7]; train img/s, the epoch split and peak memory;
  12b. pretrained: ``encoder_weights: imagenet`` from a temporary
     ``STP_PRETRAINED_DIR`` (``STP_REQUIRE_PRETRAINED`` set): a
     torchvision-named resnet34 state dict written from the seed with
     ``torch.save`` loads into Unet-resnet34, whose encoder on the card
     equals the file bit for bit, and its ``.npz`` export loads to the same
     tensors; with ``h5py`` (its presence is on the device line), a
     Keras-named preact resnet34 ``.h5`` makes the factory build
     ``keras-preact`` and loads bit for bit; then 10 bf16 train steps at
     512² B16 from the ``.pt`` under ``GEO_BLOCK`` (the geometric entries
     of ``examples/kitchen_sink.yaml``, its fixed sizes scaled to 512²),
     which takes the exact gather (K far above 64): every X, Y or elastic
     launch of the first step held bit for bit (none on that route), the
     route printed, a falling loss, img/s, peak memory, and three profiled
     steps for the device's busy and idle time;
  12c. geo_paths: each geometric name alone through ``Augmentation.apply``
     at 512² B16, Rot90 also on a 384×512 frame, two field blocks with
     K ≤ 64 and ``GEO_BLOCK``: the route, the block's ms (CUDA events,
     median of 10), one block's launches (its route's kernels once each),
     each launch held bit for bit against its plain version; on the
     gather's blocks the card against the CPU on the same draws, and
     ``warp_joint`` itself on one set of matrices and field on both
     devices (TF32 off);
  13. the ``kernels`` summary line, then the last line
     ``{"ok": true, "device": {...}}``.

``--profile FILE`` profiles three more steps of each train phase and
three more ``predict_probs`` calls of the serve phase (``FILE`` for Unet,
``FILE`` with ``_fpn``, ``_deeplab``, ``_psp``, ``_serve`` or
``_pretrained`` before its suffix for FPN, DeepLab, PSPNet, serve and the
pretrained phase, whose three steps are profiled in every run), and traces
epoch 1 of each fit stage (the fits' own ``profile:``) for its device busy
time.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from segmentation_training_pipeline_tpu_torch import config as CF
from segmentation_training_pipeline_tpu_torch import kernels as K
from segmentation_training_pipeline_tpu_torch.data import batcher as BA
from segmentation_training_pipeline_tpu_torch.data import synthetic as SY
from segmentation_training_pipeline_tpu_torch.data.datasets import (
    DirectoryDataSet, LambdaDataSet)
from segmentation_training_pipeline_tpu_torch.models import bridge as BR
from segmentation_training_pipeline_tpu_torch.models import factory as MF
from segmentation_training_pipeline_tpu_torch.models import pretrained as PT
from segmentation_training_pipeline_tpu_torch.ops import losses as LO
from segmentation_training_pipeline_tpu_torch.ops import metrics as ME
from segmentation_training_pipeline_tpu_torch.ops.aug import elastic as EL
from segmentation_training_pipeline_tpu_torch.ops.aug import fast_warp as MP
from segmentation_training_pipeline_tpu_torch.ops.aug import fused_warp as FW
from segmentation_training_pipeline_tpu_torch.ops.aug import lowering as LW
from segmentation_training_pipeline_tpu_torch.ops.aug import shear as SH
from segmentation_training_pipeline_tpu_torch.ops.aug import warp as WP
from segmentation_training_pipeline_tpu_torch.train import checkpoint as CK
from segmentation_training_pipeline_tpu_torch.train import optimizers as OP
from segmentation_training_pipeline_tpu_torch.train import stage as SG
from segmentation_training_pipeline_tpu_torch.train import step as ST
from segmentation_training_pipeline_tpu_torch.utils import msgpack_tree as MT

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
FPN_YAML = "examples/fpn_augmented_512.yaml"
SERVE_YAML = "examples/tta_ensemble_predict.yaml"
SERVE_CALLS, SERVE_WARMUP, SERVE_IMAGES, SERVE_REF_BATCH = 20, 3, 40, 2
FIT_YAML = "examples/kfold_multistage.yaml"
# synthetic PNG set for the fit: images, share of empty masks, and the
# epochs of the two stages (the YAML's 5 and 40 cut to fit the time limit)
FIT_IMAGES, FIT_EMPTY, FIT_EPOCHS = 320, 0.25, (2, 3)
FIT_CSV = ["epoch", "lr", "dice", "iou", "loss", "val_dice", "val_iou",
           "val_loss", "time"]
PSP_YAML = "examples/multiclass_pspnet.yaml"
# config 3's fit: synthetic 3-class PNGs, the YAML's 40 epochs cut to 2
PSP_IMAGES, PSP_EPOCHS, PSP_PREDICT = 128, 2, 4
PSP_CSV = ["epoch", "lr", "accuracy", "dice", "iou", "loss", "val_accuracy",
           "val_dice", "val_iou", "val_loss", "time"]
# the zoo phase: every backbone outside the ResNet family and EfficientNet
# (Unet, or DeepLabV3 for the aligned Xception) and resnet34's keras-preact
# graph, at 256² B4
ZOO = [(n, "") for n in (
    "senet154", "vgg16", "vgg19", "mobilenet", "mobilenetv1", "mobilenetv2",
    "densenet121", "densenet169", "densenet201", "xception",
    "xception_aligned", "inceptionv3", "inceptionresnetv2")] + [
    ("resnet34", "keras-preact")]
ZOO_BATCH, ZOO_SIZE = 4, 256
# remat off against on: the first step's loss, whose forward both run the
# same way, within bf16 rounding
REMAT_LOSS_REL = 1e-2
FORWARD_REL = 1e-3   # f32 on the card (TF32 off) against the CPU
IMG_ATOL = 1e-3
MASK_SHARE = 1e-4
# kernels that change only index math, data movement and reuse against
# their plain versions: every f32 operation in the same order, so equal
EXACT = ("warp_x", "warp_y", "elastic", "shear", "warp_ye")
# unfused against fused warp with an elastic field: the JAX test's own
# tolerances for that comparison (tests/test_pallas_warp.py,
# test_unfused_disp_fallback: images 1e-2 on 0..255, masks 2e-3).  The two
# paths round their sample coordinates in different orders; at 512² a
# canvas coordinate near 700 has an f32 spacing of 6e-5 px, times an image
# gradient of up to 255 per px
PATH_IMG_ATOL = 1e-2
PATH_MASK_SHARE = 2e-3
# card vs CPU end to end: sin/cos/exp and the blur's sums round differently
# there, moving a sample coordinate by ~1e-5 px, which moves a noisy image
# value by up to |grad I|·1e-5 and can flip a mask pixel sitting on a tie
REF_IMG_ATOL = 0.05
REF_MASK_SHARE = 1e-3

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s outside the
# tensor cores
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
# the SM clock at full boost, for torch.cuda._sleep's cycle count
HOLD_CLOCK_HZ = 1.98e9
# f32 operations per output pixel, counted from the kernel sources (Y: one
# y-scaled value and one y-shear blend; elastic: one row blend and one
# x-blend; shear: the source coordinate, its two frame tests, the blend
# and its two edge clamps, the line's floor and fraction counted once)
OPS_PER_PIXEL = {"warp_x": 25, "warp_y": 28, "elastic": 34, "shear": 9,
                 "warp_ye": 150}
_CSRC = "segmentation_training_pipeline_tpu_torch/csrc/"
SOURCES = {"warp_x": _CSRC + "warp_xy.cu", "warp_y": _CSRC + "warp_xy.cu",
           "elastic": _CSRC + "elastic.cu", "shear": _CSRC + "shear.cu",
           "warp_ye": _CSRC + "warp_xy.cu"}
# the geometric entries of examples/kitchen_sink.yaml, its PadToFixedSize
# (420) and CenterCropToFixedSize (352) scaled from its 384² frame to 512²
GEO_BLOCK = {
    "Fliplr": 0.5,
    "Rot90": [0, 3],
    "Affine": {"rotate": [-25, 25], "scale": {"x": [0.85, 1.2],
                                              "y": [0.85, 1.2]},
               "translate_percent": [-0.05, 0.05], "shear": [-8, 8],
               "cval": [0, 255]},
    "CropAndPad": {"percent": [-0.08, 0.08]},
    "PadToFixedSize": {"width": 560, "height": 560, "pad_cval": 16},
    "CenterCropToFixedSize": {"width": 469, "height": 469},
    "ElasticTransformation": {"alpha": [0, 30], "sigma": [4, 7]},
    "PiecewiseAffine": {"scale": [0.01, 0.03]},
}
# the geo_paths phase: each geometric name alone at 512² (and Rot90 on a
# 384×512 frame), two field ops with K ≤ 64 that reach the elastic
# kernel, and GEO_BLOCK whole: (case, frame, block)
GEO_CASES = [
    ("rot90", (SIZE, SIZE), {"Rot90": [0, 3]}),
    ("rot90_384x512", (384, SIZE), {"Rot90": [0, 3]}),
    ("crop", (SIZE, SIZE), {"Crop": {"percent": [0, 0.1]}}),
    ("cropandpad", (SIZE, SIZE), {"CropAndPad": {"percent": [-0.08, 0.08]}}),
    ("pad", (SIZE, SIZE), {"Pad": {"px": [0, 48]}}),
    ("croptofixedsize", (SIZE, SIZE),
     {"CropToFixedSize": {"width": 448, "height": 400}}),
    ("randomcrop", (SIZE, SIZE), {"RandomCrop": {"width": 448,
                                                 "height": 448}}),
    ("padtofixedsize", (SIZE, SIZE),
     {"PadToFixedSize": {"width": 560, "height": 560}}),
    ("centercroptofixedsize", (SIZE, SIZE),
     {"CenterCropToFixedSize": {"width": 469, "height": 469}}),
    ("piecewiseaffine", (SIZE, SIZE),
     {"PiecewiseAffine": {"scale": [0.01, 0.03]}}),
    ("perspectivetransform", (SIZE, SIZE),
     {"PerspectiveTransform": {"scale": [0.0, 0.06]}}),
    ("piecewiseaffine_k57", (SIZE, SIZE),
     {"PiecewiseAffine": {"scale": [0.005, 0.015]}}),
    ("affine_perspective_k57", (SIZE, SIZE),
     {"Affine": {"rotate": [-10, 10]},
      "PerspectiveTransform": {"scale": [0.0, 0.015]}}),
    ("kitchen_sink_geo", (SIZE, SIZE), GEO_BLOCK),
]
# the kernels each route launches once per block
ROUTE_KERNELS = {"flips": (), "gather": (), "multipass": ("warp_x", "warp_y"),
                 "elastic": ("elastic",),
                 "multipass+elastic": ("warp_x", "warp_y", "elastic"),
                 "multipass ye": ("warp_x", "warp_ye")}
# the exact gather on the card against the CPU on the same matrices and
# field: one IEEE operation per PyTorch op on either side
GATHER_IMG_ATOL = 1e-4

# the three paths of the warp and the environment that selects each
PATHS = {"default": {}, "fuse_elastic": {"STP_FUSE_ELASTIC": "1"},
         "unfused": {"STP_PALLAS_WARP": "0"}}


def check(ok: bool, what) -> None:
    """A failed check ends the run (asserts would vanish under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke.py check failed: {what}")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int, hold: bool = False) -> float:
    """Median time of one call of ``fn`` on the card (CUDA events).  With
    ``hold`` the stream waits 20 ms while the calls are queued, so a call
    faster than its wrapper's host work is timed on the device alone."""
    fn()
    torch.cuda.synchronize()
    if hold:
        torch.cuda._sleep(int(20e-3 * HOLD_CLOCK_HZ))
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


def train_shapes():
    """The config-2 block, the synthetic batch at B16 512² on the card and
    one set of the block's draws."""
    aug = LW.build_augmentation(CONFIG2_BLOCK)
    imgs, masks = synthetic_batch(BATCH, SIZE, SIZE, SEED)
    imgs, masks = torch.from_numpy(imgs).cuda(), torch.from_numpy(masks).cuda()
    gen = torch.Generator(device=imgs.device).manual_seed(SEED)
    return aug, imgs, masks, aug.sample(gen, BATCH, SIZE, SIZE)


def mask_mismatch(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a != b).float().mean())


def _opencv_probe() -> dict:
    """Whether the system OpenCV C++ headers and libraries that the JAX
    package's native loader builds against are here
    (``native/build.py``): the header's presence, and a throwaway
    ``g++`` link in a temporary directory; nothing is installed."""
    header = "/usr/include/opencv4/opencv2/core.hpp"
    out = {"header": header, "header_exists": os.path.exists(header),
           "gxx": shutil.which("g++")}
    if out["gxx"] is None:
        return out
    # with the headers, a program that uses cv::Mat; without, one that
    # only asks the linker for the three libraries
    code = ("#include <opencv2/core.hpp>\nint main() { cv::Mat m(2, 2, "
            "CV_8UC1); return m.rows == 2 ? 0 : 1; }\n"
            if out["header_exists"] else "int main() { return 0; }\n")
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cc")
        with open(src, "w") as f:
            f.write(code)
        r = subprocess.run(
            ["g++", "-I/usr/include/opencv4", src, "-o",
             os.path.join(tmp, "probe"), "-lopencv_core",
             "-lopencv_imgcodecs", "-lopencv_imgproc"],
            capture_output=True, text=True, timeout=120)
    out.update(links=r.returncode == 0, link_stderr=r.stderr[-400:])
    return out


def _imports(module: str) -> bool:
    """Whether ``module`` imports here (in a child process, so that this
    one stays without it: the serve phase needs neither)."""
    return subprocess.run([sys.executable, "-c", f"import {module}"],
                          capture_output=True, timeout=120).returncode == 0


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
                cuda=torch.version.cuda, capability=list(cap),
                nproc=os.cpu_count(),
                imports={m: _imports(m) for m in ("cv2", "msgpack",
                                                  "h5py")},
                opencv_cxx=_opencv_probe())
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


class env:
    """Set environment variables for a block, restoring them after."""

    def __init__(self, values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def no_tf32():
    """Full f32 convolutions and matmuls on the card for a block."""
    conv_tf32 = torch.backends.cudnn.allow_tf32
    mm = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv_tf32
        torch.set_float32_matmul_precision(mm)


def _card_vs_cpu(model, x) -> float:
    """Relative error of ``model``'s forward (f32, on the CPU) on the card
    against the CPU, with TF32 off for convolutions and matmuls; the model
    is left on the card."""
    with torch.no_grad():
        params, stats = MF.model_variables(model)
        want = MF.apply_model(model, params, stats, x)
        with no_tf32():
            model.cuda()
            params, stats = MF.model_variables(model)
            got = MF.apply_model(model, params, stats, x.cuda()).cpu()
    return float((got - want).abs().max() / want.abs().max())


def _forward_err(arch: str, backbone: str, x, seed: int,
                 classes: int = 1) -> float:
    """:func:`_card_vs_cpu` of a model initialised from ``seed``."""
    return _card_vs_cpu(MF.init_model(MF.create_model(
        arch, backbone, classes, dtype="float32"), seed, "cpu"), x)


def phase_reference(seed: int) -> None:
    """Small input: kernels on the card vs plain versions on the CPU, and
    the f32 forwards on the card vs the CPU (TF32 off for the check)."""
    aug = LW.build_augmentation(CONFIG2_BLOCK)
    imgs, masks = synthetic_batch(2, 128, 128, seed + 1)
    draws = aug.sample(torch.Generator().manual_seed(seed), 2, 128, 128)
    ci, cm = aug.apply(draws, torch.from_numpy(imgs), torch.from_numpy(masks))
    gi, gm = aug.apply(_to(draws, "cuda"), torch.from_numpy(imgs).cuda(),
                       torch.from_numpy(masks).cuda())
    aug_err = float((gi.cpu() - ci).abs().max())
    aug_mis = mask_mismatch(gm.cpu(), cm)
    x = torch.from_numpy(imgs).float() / 127.5 - 1.0
    fwd_err = _forward_err("Unet", "resnet34", x, seed)
    fpn_err = _forward_err("FPN", "efficientnetb0", x, seed)
    psp_err = _forward_err("PSPNet", "resnet50", x, seed, 8)
    link_err = _forward_err("Linknet", "resnet50", x, seed, 8)
    deeplab_err = _forward_err("DeepLabV3", "xception_aligned", x, seed)
    emit("reference", aug_max_err=aug_err, aug_mask_mismatch=aug_mis,
         forward_rel_err=fwd_err, fpn_forward_rel_err=fpn_err,
         pspnet_resnet50_forward_rel_err=psp_err,
         linknet_resnet50_forward_rel_err=link_err,
         deeplab_xception_aligned_forward_rel_err=deeplab_err,
         shape=[2, 128, 128],
         tolerance=dict(aug_img_atol=REF_IMG_ATOL,
                        aug_mask_share=REF_MASK_SHARE,
                        forward_rel=FORWARD_REL))
    check(aug_err <= REF_IMG_ATOL, ("aug image error", aug_err))
    check(aug_mis <= REF_MASK_SHARE, ("aug mask mismatch", aug_mis))
    # cuDNN's f32 algorithms against the CPU's
    check(fwd_err <= FORWARD_REL, ("forward error", fwd_err))
    check(fpn_err <= FORWARD_REL, ("FPN forward error", fpn_err))
    check(psp_err <= FORWARD_REL, ("PSPNet forward error", psp_err))
    check(link_err <= FORWARD_REL, ("Linknet forward error", link_err))
    check(deeplab_err <= FORWARD_REL, ("DeepLab forward error", deeplab_err))


def _to(draws, device):
    if isinstance(draws, torch.Tensor):
        return draws.to(device)
    if isinstance(draws, dict):
        return {k: _to(v, device) for k, v in draws.items()}
    return [_to(v, device) for v in draws]


def _check_augmented(out_i, out_m, what: str) -> None:
    check(bool(torch.isfinite(out_i).all()), (what, "images finite"))
    check(float(out_i.min()) >= 0.0 and float(out_i.max()) <= 255.0,
          (what, "images in [0, 255]"))
    check(bool(((out_m == 0) | (out_m == 1)).all()), (what, "masks binary"))


# each kernel's wrapper where the main path calls it: (module, attribute)
WRAPPERS = {"warp_x": (FW, "warp_x"), "warp_y": (FW, "warp_y"),
            "warp_ye": (FW, "warp_ye"), "elastic": (EL, "elastic_resample"),
            "shear": (MP, "shear_pass")}


@contextlib.contextmanager
def captured(names, store: dict):
    """Record in ``store`` (kernel name → list of argument tuples) the
    arguments of every call of the named kernels' wrappers in a block, the
    calls themselves unchanged."""
    originals = {n: getattr(*WRAPPERS[n]) for n in names}

    def hook(n):
        def call(*args):
            store.setdefault(n, []).append(args)
            return originals[n](*args)
        return call

    for n in names:
        setattr(*WRAPPERS[n], hook(n))
    try:
        yield store
    finally:
        for n in names:
            setattr(*WRAPPERS[n], originals[n])


def phase_capture(aug, imgs, masks, draws):
    """Run the augmentation once on each path and record each kernel
    wrapper's arguments (the tensors the main path gives the kernel)."""
    with captured(list(WRAPPERS), {}) as calls:
        for path, values in PATHS.items():
            with env(values):
                out_i, out_m = aug.apply(draws, imgs, masks)
            torch.cuda.synchronize()
            _check_augmented(out_i, out_m, path)
    # default path: X, Y, elastic; fused: X, YE; unfused: 2 shears, elastic
    check(len(calls["warp_ye"]) == 1 and len(calls["shear"]) == 2
          and len(calls["warp_y"]) == 1, ("captures", {
              k: len(v) for k, v in calls.items()}))
    args_of = {n: calls[n] if n == "shear" else calls[n][0]
               for n in WRAPPERS}
    emit("capture", planes=list(args_of["warp_x"][0].shape),
         px=args_of["warp_x"][3], py=args_of["warp_y"][3],
         k=args_of["elastic"][4], ye_py=args_of["warp_ye"][5],
         shear_lines=[list(a[0].shape) for a in args_of["shear"]])
    return args_of


def shear_bytes(x, offs, kinds, norig: int, src_shift: int, fill) -> int:
    """The bytes one shear pass must move on these inputs: its offsets,
    kinds and every output, and of each line only the source columns its
    in-frame outputs use.  An output whose source lies outside the frame
    takes fill and reads nothing; an image output uses both taps, only the
    upper one left of the frame and only the lower one at its right edge;
    a mask output uses the one tap it takes.  The columns a line uses are
    consecutive (mod N), so their count is the span of its taps."""
    n = x.shape[3]
    q = torch.arange(n, device=x.device, dtype=torch.float32)
    src = (q + offs[..., None]) - float(src_shift)       # (B, L, N), as run
    inside = ~((src < -0.5) | (src > norig - 0.5))
    kfloor = torch.floor(offs)[..., None]
    lower = q + kfloor                                   # unwrapped tap
    upper = lower + 1.0

    def columns(first, last):
        lo = torch.where(inside, first, math.inf).amin(-1)
        hi = torch.where(inside, last, -math.inf).amax(-1)
        return torch.where(inside.any(-1), (hi - lo + 1.0).clamp(max=n),
                           0.0).sum()

    near = torch.where(offs[..., None] - kfloor >= 0.5, upper, lower)
    per_image = columns(torch.where(src < 0.0, upper, lower),
                        torch.where(src >= norig - 1.0, lower, upper))
    n_mask = int((kinds == 1).sum())
    read = ((kinds.numel() - n_mask) * float(per_image)
            + n_mask * float(columns(near, near))) * x.element_size()
    return (int(read) + offs.numel() * offs.element_size()
            + kinds.numel() * kinds.element_size()
            + x.numel() * x.element_size())


def _errors(name, kernel, plain, args):
    """One kernel launch against its plain version on the same arguments:
    the largest image error and the share of mask entries that differ."""
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    flags = args[2] if name == "shear" else args[1]
    image = (flags == 0).view(1, -1, 1, 1).expand_as(got)
    return (got, float((got - want)[image].abs().max()),
            mask_mismatch(got[~image], want[~image]))


def _measure(name, kernel, plain, args) -> dict:
    """:func:`_errors`, both versions timed, with the launch's memory and
    operation bound."""
    got, err, mis = _errors(name, kernel, plain, args)
    ms = cuda_ms(lambda: kernel(*args), 50, hold=True)
    plain_ms = cuda_ms(lambda: plain(*args), 10, hold=True)
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    # the shear's fill outputs read nothing: count what its data uses
    nbytes = shear_bytes(*args) if name == "shear" else (
        sum(t.numel() * t.element_size() for t in tensors)
        + got.numel() * got.element_size())
    ops = OPS_PER_PIXEL[name] * got.numel()
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / F32_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    return dict(max_abs_err=err, mask_mismatch=mis, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_share=bound / ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                shape=list(got.shape), bytes=nbytes)


# each kernel's wrapper and its plain version
CALLS = {
    "warp_x": (FW.warp_x, FW.warp_x_plain),
    "warp_y": (FW.warp_y, FW.warp_y_plain),
    "elastic": (EL.elastic_resample, EL.elastic_resample_plain),
    "shear": (SH.shear_pass, SH.shear_pass_plain),
    "warp_ye": (FW.warp_ye, FW.warp_ye_plain),
}


def measure_kernel(name: str, args_of) -> dict:
    """:func:`_measure` on the tensors captured for kernel ``name``; for
    the shear, the x-pass and the y-pass of one warp, reported as their
    mean per launch and the worst error."""
    kernel, plain = CALLS[name]
    if name != "shear":
        return _measure(name, kernel, plain, args_of[name])
    passes = [_measure(name, kernel, plain, a) for a in args_of[name]]
    m = {k: statistics.mean(p[k] for p in passes)
         for k in ("ms", "plain_ms", "bound_ms", "bytes")}
    m.update(bound_share=m["bound_ms"] / m["ms"],
             max_abs_err=max(p["max_abs_err"] for p in passes),
             mask_mismatch=max(p["mask_mismatch"] for p in passes),
             bound_by=passes[0]["bound_by"],
             shape=passes[0]["shape"], passes=passes)
    return m


def elastic_library(args, got) -> dict:
    """``F.grid_sample`` on the elastic kernel's own planes and field, the
    nearest library call: bilinear with border padding and
    ``align_corners=True`` (pixel centres at integer coordinates) on the
    image planes, nearest on the mask planes, timed as the kernel is.  It
    is not the same function: the kernel's row blend reads each column's
    own dy, a source outside the frame takes the fill, an offset past K
    contributes 0, and its masks round ties up (grid_sample rounds half to
    even).  ``got`` is the kernel's output on ``args``."""
    planes, flags, dy, dx = args[:4]
    b, _, h, w = planes.shape
    yy = torch.arange(h, device=dy.device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dy.device, dtype=torch.float32)[None, :]
    grid = torch.stack([2.0 * (xx + dx) / (w - 1) - 1.0,
                        2.0 * (yy + dy) / (h - 1) - 1.0], -1)
    image = flags == 0
    imgs, masks = planes[:, image], planes[:, ~image]

    def images_call():
        return F.grid_sample(imgs, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    def masks_call():
        return F.grid_sample(masks, grid, mode="nearest",
                             padding_mode="border", align_corners=True)

    diff = (images_call() - got[:, image]).abs()
    sy, sx = yy + dy, xx + dx
    inside = ((sy >= -0.5) & (sy <= h - 0.5) & (sx >= -0.5)
              & (sx <= w - 0.5))[:, None].expand_as(diff)
    torch.cuda.synchronize()
    images_ms = cuda_ms(images_call, 50, hold=True)
    masks_ms = cuda_ms(masks_call, 50, hold=True)
    return dict(library="torch.nn.functional.grid_sample",
                library_images_ms=images_ms, library_masks_ms=masks_ms,
                library_ms=images_ms + masks_ms,
                library_vs_kernel_max_abs_err=float(diff.max()),
                library_vs_kernel_mean_abs_err=float(diff.mean()),
                library_vs_kernel_max_abs_err_in_frame=float(
                    diff[inside].max()),
                library_vs_kernel_mask_mismatch=mask_mismatch(
                    masks_call(), got[:, ~image]))


def phase_kernels(args_of) -> dict:
    rows = {}
    for name in CALLS:
        m = measure_kernel(name, args_of)
        lib = {"library_ms": None}
        if name == "elastic":
            lib = elastic_library(args_of[name], CALLS[name][0](
                *args_of[name]))
        rows[name] = dict(name=name, route="cuda", source=SOURCES[name],
                          replaces=K.KERNELS[name].replaces, launches=None,
                          **lib, **m)
        emit("kernel", **rows[name])
        atol, share = (0.0, 0.0) if name in EXACT else (IMG_ATOL, MASK_SHARE)
        check(m["max_abs_err"] <= atol,
              (name, "image error", m["max_abs_err"]))
        check(m["mask_mismatch"] <= share,
              (name, "mask mismatch", m["mask_mismatch"]))
    return rows


def phase_warp_paths(aug, imgs, masks, draws) -> dict:
    """The block through ``Augmentation.apply`` on each path: launches of
    one run (counts reset just before, read just after), median time, and
    the paths against each other."""
    outs, out = {}, {}
    for path, values in PATHS.items():
        with env(values):
            K.reset_launches()
            res = aug.apply(draws, imgs, masks)
            torch.cuda.synchronize()
            launches = {k: v for k, v in K.launch_counts().items() if v}
            ms = cuda_ms(lambda: aug.apply(draws, imgs, masks), 10)
        outs[path] = res
        out[path] = dict(ms=ms, launches=launches)
    want = {"default": {"warp_x": 1, "warp_y": 1, "elastic": 1},
            "fuse_elastic": {"warp_x": 1, "warp_ye": 1},
            "unfused": {"shear": 2, "elastic": 1}}
    (di, dm), (fi, fm), (ui, um) = (outs[p] for p in PATHS)
    cmp = dict(
        ye_vs_default=dict(max_abs_err=float((fi - di).abs().max()),
                           mask_mismatch=mask_mismatch(fm, dm)),
        unfused_vs_default=dict(max_abs_err=float((ui - di).abs().max()),
                                mask_mismatch=mask_mismatch(um, dm)))
    emit("warp_paths", batch=list(imgs.shape), paths=out, compare=cmp,
         tolerance=dict(ye_img_atol=0.0, ye_mask_share=0.0,
                        unfused_img_atol=PATH_IMG_ATOL,
                        unfused_mask_share=PATH_MASK_SHARE))
    for path in PATHS:
        check(out[path]["launches"] == want[path],
              (path, "launches", out[path]["launches"]))
    check(cmp["ye_vs_default"]["max_abs_err"] == 0.0, cmp)
    check(cmp["ye_vs_default"]["mask_mismatch"] == 0.0, cmp)
    check(cmp["unfused_vs_default"]["max_abs_err"] <= PATH_IMG_ATOL, cmp)
    check(cmp["unfused_vs_default"]["mask_mismatch"] <= PATH_MASK_SHARE, cmp)
    return out


def phase_train(name: str, cfg, imgs, masks, steps: int, seed: int,
                expect: dict, profile: str = "", hold: tuple = (),
                model=None, **extra) -> dict:
    """``steps`` train steps of ``cfg``'s model (``remat`` included; or
    ``model``, already on the card), loss (with its class weights),
    optimizer, lr and augmentation on the fixed batch; the launch counts
    of the run must be ``expect`` times ``steps`` (every other kernel 0).
    The kernels in ``hold`` are held bit for bit against their plain
    versions on the arguments the first step gave them, after the counts
    are read.  ``extra`` goes into the emitted line."""
    dev = imgs.device
    if model is None:
        model = MF.init_model(MF.create_model(
            cfg.architecture, cfg.backbone, cfg.classes, dtype=cfg.dtype,
            remat=cfg.remat), seed, dev)
    tx = OP.build_optimizer(cfg)
    state = ST.create_train_state(model, tx, dev)
    step = ST.build_train_step(
        model, tx, LO.build_loss(cfg.loss, cfg.activation, cfg.class_weights),
        {m: ME.get(m) for m in cfg.metrics}, cfg.activation, None,
        aug=(LW.build_augmentation(cfg.augmentation) if cfg.augmentation
             else None))
    batch = {"image": imgs, "mask": masks}
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    calls = {}
    K.reset_launches()
    for i in range(steps):
        t0 = time.perf_counter()
        with captured(hold if i == 0 else (), calls):
            state, logs = step(state, batch, cfg.lr, gen=gen)
        loss = float(logs["loss"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    launches = K.launch_counts()
    if hold:
        extra["held_to_plain"] = held_to_plain(calls, name)
    b = imgs.shape[0]
    steady = times[1:] or times
    out = dict(model=f"{cfg.architecture}-{cfg.backbone}", dtype=cfg.dtype,
               steps=steps, batch=b, size=list(imgs.shape[1:3]),
               classes=cfg.classes, activation=cfg.activation,
               loss_expr=cfg.loss,
               loss=losses, step_ms=times,
               img_per_s=b / (statistics.mean(steady) / 1e3),
               launches=launches,
               **{m: float(logs[m]) for m in cfg.metrics},
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               **extra)
    emit(name, **out)
    check(all(math.isfinite(v) for v in losses), ("finite loss", losses))
    check(statistics.mean(losses[-3:]) < losses[0], ("falling loss", losses))
    check(launches == {n: steps * expect.get(n, 0) for n in K.KERNELS},
          (name, "launches per step", launches))
    if profile:
        phase_profile(lambda: step(state, batch, cfg.lr, gen=gen), profile,
                      name)
    return out


def multiclass_batch(cfg, seed: int):
    """``cfg.batch`` synthetic 3-class items at ``cfg.shape`` on the card:
    uint8 images and one-hot float32 masks over ``cfg.classes``."""
    ds = SY.generate_multiclass_shapes_dataset(cfg.batch, cfg.shape[0], seed)
    imgs = np.stack([ds[i].x for i in range(len(ds))])
    masks = np.stack([BA.prepare_mask(ds[i].y, cfg.shape, cfg.classes,
                                      cfg.activation)
                      for i in range(len(ds))])
    return torch.from_numpy(imgs).cuda(), torch.from_numpy(masks).cuda()


def phase_train_psp(seed: int, profile: str = "") -> dict:
    """BASELINE config 3 as the port parses it, not cut: PSPNet-resnet50,
    384², B16, bf16, 8-class softmax, its composite loss, Adam at 5e-4."""
    cfg = CF.parse(PSP_YAML)
    check((cfg.architecture, cfg.backbone, cfg.shape, cfg.batch, cfg.dtype,
           cfg.classes, cfg.activation, cfg.augmentation)
          == ("PSPNet", "resnet50", (384, 384, 3), 16, "bfloat16", 8,
              "softmax", []), ("config 3", cfg.architecture, cfg.shape))
    imgs, masks = multiclass_batch(cfg, seed + 7)
    return phase_train("train_psp", cfg, imgs, masks, STEPS, seed, {},
                       profile, config=PSP_YAML,
                       kernels="config 3 has no augmentation block: no "
                               "hand-written kernel on its path")


# kernel-name fragments → the layer they belong to, first match wins
_LAYERS = [("aug kernels", ("warp_x_kernel", "warp_y_kernel",
                            "warp_ye_kernel", "elastic_kernel",
                            "shear_kernel")),
           # cuDNN's grouped kernels with one channel per group
           ("depthwise convolution", ("depthwise", "dwconv", "c1_k1_nhwc",
                                      "grouped_direct")),
           ("convolution", ("conv", "xmma", "gemm", "cutlass", "sm90_",
                            "winograd", "implicit")),
           ("batch norm", ("bn_", "batch_norm", "batchnorm", "welford")),
           ("optimizer", ("foreach", "multi_tensor")),
           ("elementwise and reductions", ("elementwise", "vectorized",
                                           "reduce", "upsample")),
           ("other", ("",))]


def phase_profile(run_step, path: str, name: str, steps: int = 3) -> None:
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
    emit("profile", of=name, steps=steps, step_wall_ms=wall_ms / steps,
         device_busy_ms=busy_ms, idle_share=(1.0 - busy_ms * steps / wall_ms
                                             if busy_ms else None),
         by_layer_ms=by_layer, kernels_per_step=sum(e.count for e in kernels)
         // steps, table=path)


def _fold_checkpoints(cfg, seed: int) -> None:
    """One checkpoint per fold at stage 0 from ``init_model`` at seeds
    ``seed``, ``seed + 1``, …, each read back and held to what was
    written: the port's own codec, on a machine where ``msgpack`` may be
    absent."""
    for f in range(cfg.folds_count):
        model = MF.init_model(MF.model_from_config(cfg), seed + f, "cpu")
        path = cfg.weights_path(f, 0)
        CK.save_checkpoint(path, model.state_dict(), {
            "architecture": cfg.architecture, "backbone": cfg.backbone,
            "fold": f, "stage": 0, "seed": seed + f, "encoder_variant": ""})
        back = CK.load_checkpoint(path, MF.model_from_config(cfg))
        check(all(torch.equal(back[k], v)
                  for k, v in model.state_dict().items()),
              ("checkpoint read back", path))
        with open(path, "rb") as fh:
            raw = fh.read()
        check(MT.packb(MT.unpackb(raw)) == raw, ("codec round trip", path))
        check(CK.checkpoint_meta(path)["fold"] == f, ("sidecar", path))


def phase_serve(seed: int, profile: str = "") -> dict:
    """BASELINE config 5 through the port's serving entry points."""
    cfg = CF.parse(SERVE_YAML)
    folds = list(range(cfg.folds_count))
    check((cfg.shape, cfg.batch, cfg.flipPred, cfg.folds_count, cfg.dtype)
          == ((256, 256, 3), 16, True, 5, "bfloat16"),
          ("config 5", cfg.shape, cfg.batch, cfg.folds_count, cfg.dtype))
    h, w, _ = cfg.shape
    imgs = synthetic_batch(SERVE_IMAGES, h, w, seed + 5)[0]
    batch = imgs[:cfg.batch]
    with tempfile.TemporaryDirectory() as tmp:
        cfg.directory = tmp
        _fold_checkpoints(cfg, seed)
        K.reset_launches()
        bundle = cfg.load(folds, 0)
        check(bundle.tta == "flip" and len(bundle.fold_vars) == 5,
              ("bundle", bundle.tta, len(bundle.fold_vars)))
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2 ** 30
        for _ in range(SERVE_WARMUP):
            probs = bundle.predict_probs(batch)
        times = []
        for _ in range(SERVE_CALLS):
            t0 = time.perf_counter()
            probs = bundle.predict_probs(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        # the normal entry point, 40 images in chunks of 16 (the last padded)
        items = list(cfg.predict_on_dataset(LambdaDataSet(list(imgs)),
                                            folds=folds, stage=0))
        direct = []
        for i in range(0, SERVE_IMAGES, cfg.batch):
            chunk = imgs[i:i + cfg.batch]
            pad = np.zeros((cfg.batch - len(chunk), *chunk.shape[1:]),
                           chunk.dtype)
            direct.append(bundle.predict_probs(
                np.concatenate([chunk, pad]))[:len(chunk)])
        direct = np.concatenate(direct)
        dataset_err = max(float(np.abs(it.prediction - d).max())
                          for it, d in zip(items, direct))
        # float32 on the card (TF32 off) against the CPU, and bf16 against
        # float32 on the card
        f32 = dataclasses.replace(cfg, dtype="float32")
        with no_tf32():
            card32 = f32.load(folds, 0)
            ref = batch[:SERVE_REF_BATCH]
            want = f32.load(folds, 0, device="cpu").predict_probs(ref)
            got = card32.predict_probs(ref)
            probs32 = card32.predict_probs(batch)
        launches = K.launch_counts()
        if profile:
            phase_profile(lambda: bundle.predict_probs(batch), profile,
                          "serve")
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    thr = cfg.threshold
    out = dict(config=SERVE_YAML, model=f"{cfg.architecture}-{cfg.backbone}",
               dtype=cfg.dtype, batch=cfg.batch, size=[h, w], folds=5,
               tta=bundle.tta, forwards_per_call=2 * len(folds),
               call_ms=times, img_per_s=cfg.batch / (
                   statistics.median(times) / 1e3),
               peak_mem_gib=peak, held_mem_gib=held, launches=launches,
               probs=dict(min=float(probs.min()), max=float(probs.max()),
                          mean=float(probs.mean())),
               dataset_items=len(items), dataset_max_abs_err=dataset_err,
               f32_card_vs_cpu_rel_err=rel, f32_ref_batch=SERVE_REF_BATCH,
               bf16_vs_f32_max_abs=float(np.abs(probs - probs32).max()),
               bf16_vs_f32_mask_agree=float(
                   ((probs >= thr) == (probs32 >= thr)).mean()),
               tolerance=dict(dataset=0.0, f32_card_vs_cpu_rel=FORWARD_REL))
    emit("serve", **out)
    check(probs.shape == (cfg.batch, h, w, 1) and bool(np.isfinite(
        probs).all()) and 0.0 <= probs.min() and probs.max() <= 1.0,
        ("serve probs", probs.shape))
    check(len(items) == SERVE_IMAGES and all(
        it.prediction.shape == (h, w, 1) for it in items), "dataset items")
    check(dataset_err == 0.0, ("predict_on_dataset vs predict_probs",
                               dataset_err))
    check(rel <= FORWARD_REL, ("f32 serve card vs CPU", rel))
    check(not any(launches.values()), ("serve launched kernels", launches))
    return out


def _trace_busy_s(trace_dir: str) -> float:
    """Device seconds of the kernels, copies and fills in the chrome trace
    that the fit's ``profile:`` wrote with ``torch.profiler``."""
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return sum(e.get("dur", 0) for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")) / 1e6


def _fit_block_vs_plain(aug, ds, cfg, seed: int) -> dict:
    """Config 4's block once on the card on the fit's first batch (fold 0,
    stage 0's plan) and draws from a generator seeded ``seed``, then kernels
    X and Y against their plain versions on the arguments the block gave
    them (``EXACT``: bit for bit)."""
    b = next(iter(BA.make_batches(ds, cfg.kfold(ds).epoch_indices(
        0, 0, cfg.stages[0].negatives), cfg.shape, cfg.classes,
        cfg.activation, cfg.batch)))
    imgs = torch.from_numpy(b["image"]).cuda()
    masks = torch.from_numpy(b["mask"]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    draws = aug.sample(gen, *imgs.shape)
    names = ("warp_x", "warp_y")
    with captured(names, {}) as calls:
        out_i, out_m = aug.apply(draws, imgs, masks)
    torch.cuda.synchronize()
    _check_augmented(out_i, out_m, "fit block")
    check({n: len(v) for n, v in calls.items()}
          == {n: 1 for n in names}, ("fit block captures", calls.keys()))
    return held_to_plain(calls, "fit block")


def held_to_plain(calls: dict, what: str) -> dict:
    """Each kernel's first captured call against its plain version on the
    same arguments: ``EXACT``, bit for bit."""
    out = {}
    for n, args in calls.items():
        _, err, mis = _errors(n, *CALLS[n], args[0])
        out[n] = dict(planes=list(args[0][0].shape), max_abs_err=err,
                      mask_mismatch=mis)
        check(err == 0.0 and mis == 0.0, (what, n, out[n]))
    return out


def phase_fit(seed: int, profile: bool = False) -> dict:
    """BASELINE config 4 through ``cfg.fit`` (the epochs cut), then a
    second fit that skips every stage and ``cfg.load`` of the result."""
    cfg = CF.parse(FIT_YAML)
    st = cfg.stages
    check((cfg.shape, cfg.batch, cfg.dtype, len(st), st[0].freeze_encoder,
           st[1].unfreeze_encoder, [a["name"] for a in cfg.augmentation])
          == ((256, 256, 3), 16, "bfloat16", 2, True, True,
              ["Fliplr", "Affine"]), ("config 4", cfg.shape, cfg.batch))
    reduced = {"epochs": [[s.epochs for s in st], list(FIT_EPOCHS)]}
    cfg.stages = [dataclasses.replace(s, epochs=e)
                  for s, e in zip(st, FIT_EPOCHS)]
    cfg.verbose = 0
    h, w, _ = cfg.shape
    with tempfile.TemporaryDirectory() as tmp:
        cfg.directory = os.path.join(tmp, "exp")
        if profile:
            cfg.profile = os.path.join(tmp, "profile")
        images, masks = SY.write_shapes_dataset(
            os.path.join(tmp, "data"), FIT_IMAGES, h, seed, p_empty=FIT_EMPTY)
        ds = DirectoryDataSet(images, masks)
        aug, _ = LW.build_transform_fn(cfg.transforms, cfg.augmentation)
        vs_plain = _fit_block_vs_plain(aug, ds, cfg, seed)
        # the fit initialises fold 0 at random_state + 0, drawn on the CPU
        start = MF.init_model(MF.model_from_config(cfg), cfg.random_state,
                              "cpu").state_dict()
        timings = []
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        summary = SG.fit_pipeline(cfg, ds, foldsToExecute=[0],
                                  timings=timings)
        fit_s = time.perf_counter() - t0
        launches = K.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        busy = {s: _trace_busy_s(os.path.join(cfg.profile, f"fold0.stage{s}"))
                for s in range(len(st))} if profile else {}
        again = cfg.fit(ds, foldsToExecute=[0])
        metas = [CK.checkpoint_meta(cfg.weights_path(0, s))
                 for s in range(len(st))]
        stage0, stage1 = (CK.load_checkpoint(cfg.weights_path(0, s),
                                             MF.model_from_config(cfg))
                          for s in range(2))
        csvs = []
        for s in range(len(st)):
            with open(cfg.metrics_path(0, s)) as f:
                csvs.append([r.split(",") for r in f.read().splitlines()])
        items = list(cfg.predict_on_dataset(
            LambdaDataSet([ds[i].x for i in range(cfg.batch)]), folds=[0],
            stage=1))
        probs = np.stack([it.prediction for it in items])
        # the host's share of a train loop: stage 1's plan decoded and
        # stacked alone, on this thread, with no step beside it
        decode = {}
        list(BA.make_batches(ds, cfg.kfold(ds).epoch_indices(0, 1),
                             cfg.shape, cfg.classes, cfg.activation,
                             cfg.batch, stats=decode))
    steps = sum(t["steps"] for t in timings)
    steady = [t for t in timings if t["epoch"] > 0]
    enc = [k for k in start if k.startswith("encoder.")]
    stats = ("running_mean", "running_var")
    moved = [k for k in enc if k.endswith(stats)
             and not torch.equal(stage0[k], start[k])]
    # the unfrozen stage updates every encoder parameter
    unmoved = [k for k in enc if not k.endswith(stats + ("num_batches_tracked",))
               and torch.equal(stage1[k], stage0[k])]
    # each epoch's train loop less the wait for its first batch (a new
    # prefetch thread decodes it while nothing else runs)
    fed_s = sum(t["train_s"] - t["first_batch_s"] for t in steady)
    steady_steps = sum(t["steps"] for t in steady)
    losses = [float(r[FIT_CSV.index(c)]) for rows in csvs for r in rows[1:]
              for c in ("loss", "val_loss")]
    epoch1 = {t["stage"]: t for t in timings if t["epoch"] == 1}
    out = dict(
        config=FIT_YAML, model=f"{cfg.architecture}-{cfg.backbone}",
        dtype=cfg.dtype, batch=cfg.batch, size=[h, w], images=FIT_IMAGES,
        empty_share=FIT_EMPTY, reduced=reduced, fit_s=fit_s,
        train_steps_per_stage=[sum(t["steps"] for t in timings
                                   if t["stage"] == s)
                               for s in range(len(st))],
        fit_train_img_per_s=(sum(t["images"] for t in steady)
                             / sum(t["train_s"] for t in steady)),
        steady_epochs=len(steady), steady_steps=steady_steps,
        steady_step_ms_after_first_batch=fed_s / steady_steps * 1e3,
        fit_train_img_per_s_after_first_batch=(
            steady_steps * cfg.batch / fed_s),
        epochs=[{k: t[k] for k in ("stage", "epoch", "steps", "images",
                                   "train_s", "first_batch_s", "val_s",
                                   "checkpoint_s")}
                for t in timings],
        decode_s_per_batch=decode["decode_s"] / decode["batches"],
        decode_threads=decode["decode_threads"],
        traced_epoch1_device_busy_s=busy or None,
        traced_epoch1_idle_share={
            s: 1.0 - b / (epoch1[s]["train_s"] + epoch1[s]["val_s"])
            for s, b in busy.items()} or None,
        launches=launches, peak_mem_gib=peak,
        csv=[dict(header=rows[0], rows=len(rows) - 1) for rows in csvs],
        summary=summary, refit=again,
        encoder_bit_identical=all(torch.equal(stage0[k], start[k])
                                  for k in enc if not k.endswith(stats)),
        encoder_bn_stats_moved=len(moved),
        unfrozen_encoder_unchanged=unmoved,
        block_vs_plain=vs_plain, block_vs_plain_tolerance=0.0,
        probs=dict(min=float(probs.min()), max=float(probs.max()),
                   mean=float(probs.mean())))
    emit("fit", **out)
    check(launches == {n: steps if n in ("warp_x", "warp_y") else 0
                       for n in K.KERNELS}, ("fit launches", launches, steps))
    check(all(math.isfinite(v) for v in losses), ("fit losses", losses))
    check(out["encoder_bit_identical"], "frozen encoder changed")
    check(len(moved) > 0, "encoder BatchNorm statistics did not move")
    check(not unmoved, ("unfrozen stage left encoder parameters", unmoved))
    check(all(m is not None and m["done"] is True for m in metas),
          ("done markers", metas))
    check(all(c["header"] == FIT_CSV for c in out["csv"]), out["csv"])
    check([c["rows"] for c in out["csv"]] == [t["epochs"] for t in
                                              summary.values()],
          (out["csv"], summary))
    check(list(again) == list(summary) and all(
        v.get("skipped") is True for v in again.values()), ("refit", again))
    check(probs.shape == (cfg.batch, h, w, 1) and bool(
        np.isfinite(probs).all()) and 0.0 <= probs.min()
        and probs.max() <= 1.0, ("served probs", probs.shape))
    return out

def _write_multiclass_pngs(out_dir: str, n: int, size: int, seed: int):
    """``n`` synthetic 3-class items as PNG files: RGB images and
    class-index masks (0 background, 1 ellipse, 2 rectangle)."""
    import cv2

    images, masks = (os.path.join(out_dir, d) for d in ("images", "masks"))
    os.makedirs(images)
    os.makedirs(masks)
    ds = SY.generate_multiclass_shapes_dataset(n, size, seed)
    for i in range(n):
        item = ds[i]
        cv2.imwrite(os.path.join(images, f"{item.id}.png"),
                    cv2.cvtColor(item.x, cv2.COLOR_RGB2BGR))
        cv2.imwrite(os.path.join(masks, f"{item.id}.png"), item.y)
    return images, masks


def phase_fit_psp(seed: int, profile: bool = False) -> dict:
    """BASELINE config 3 through ``fit_pipeline`` (what ``cfg.fit``
    calls) on fold 0 of synthetic 384² PNGs with class-index masks, the
    epochs cut; then ``cfg.load`` and ``predict_all_to_dir`` of its
    checkpoint."""
    import cv2

    cfg = CF.parse(PSP_YAML)
    check((cfg.architecture, cfg.backbone, cfg.shape, cfg.batch, cfg.dtype,
           cfg.classes, len(cfg.stages)) == ("PSPNet", "resnet50",
                                             (384, 384, 3), 16, "bfloat16",
                                             8, 1), ("config 3", cfg.shape))
    reduced = {"epochs": [cfg.stages[0].epochs, PSP_EPOCHS],
               "images": PSP_IMAGES, "folds": f"fold 0 of {cfg.folds_count}"}
    cfg.stages = [dataclasses.replace(cfg.stages[0], epochs=PSP_EPOCHS)]
    cfg.verbose = 0
    h, w, _ = cfg.shape
    with tempfile.TemporaryDirectory() as tmp:
        cfg.directory = os.path.join(tmp, "exp")
        if profile:
            cfg.profile = os.path.join(tmp, "profile")
        images, masks = _write_multiclass_pngs(os.path.join(tmp, "data"),
                                               PSP_IMAGES, h, seed)
        ds = DirectoryDataSet(images, masks)
        timings = []
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        summary = SG.fit_pipeline(cfg, ds, foldsToExecute=[0],
                                  timings=timings)
        fit_s = time.perf_counter() - t0
        launches = K.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        busy = _trace_busy_s(os.path.join(cfg.profile, "fold0.stage0")) \
            if profile else None
        meta = CK.checkpoint_meta(cfg.weights_path(0, 0))
        with open(cfg.metrics_path(0, 0)) as f:
            rows = [r.split(",") for r in f.read().splitlines()]
        bundle = cfg.load(0, 0)
        src = os.path.join(tmp, "predict")
        os.makedirs(src)
        names = sorted(os.listdir(images))[:PSP_PREDICT]
        for n in names:
            shutil.copy(os.path.join(images, n), src)
        written = cfg.predict_all_to_dir(src, os.path.join(tmp, "pred"),
                                         folds=[0], stage=0)
        preds = [cv2.imread(os.path.join(tmp, "pred", n),
                            cv2.IMREAD_UNCHANGED) for n in names]
        decode = {}
        list(BA.make_batches(ds, cfg.kfold(ds).epoch_indices(0, 0),
                             cfg.shape, cfg.classes, cfg.activation,
                             cfg.batch, stats=decode))
    steady = [t for t in timings if t["epoch"] > 0]
    losses = [float(r[PSP_CSV.index(c)]) for r in rows[1:]
              for c in ("loss", "val_loss")]
    epoch1 = next(t for t in timings if t["epoch"] == 1)
    out = dict(
        config=PSP_YAML, model=f"{cfg.architecture}-{cfg.backbone}",
        dtype=cfg.dtype, batch=cfg.batch, size=[h, w], classes=cfg.classes,
        activation=cfg.activation, reduced=reduced, fit_s=fit_s,
        train_steps=sum(t["steps"] for t in timings),
        fit_train_img_per_s=(sum(t["images"] for t in steady)
                             / sum(t["train_s"] for t in steady)),
        fit_train_img_per_s_after_first_batch=(
            sum(t["images"] for t in steady)
            / sum(t["train_s"] - t["first_batch_s"] for t in steady)),
        epochs=[{k: t[k] for k in ("stage", "epoch", "steps", "images",
                                   "train_s", "first_batch_s", "val_s",
                                   "checkpoint_s")}
                for t in timings],
        decode_s_per_batch=decode["decode_s"] / decode["batches"],
        decode_threads=decode["decode_threads"],
        traced_epoch1_device_busy_s=busy,
        traced_epoch1_idle_share=(
            1.0 - busy / (epoch1["train_s"] + epoch1["val_s"])
            if busy is not None else None),
        launches=launches, peak_mem_gib=peak,
        csv=dict(header=rows[0], rows=len(rows) - 1,
                 last={c: float(rows[-1][i]) for i, c in enumerate(PSP_CSV)
                       if c not in ("epoch", "time")}),
        summary=summary, done=meta and meta.get("done"),
        bundle_folds=len(bundle.fold_vars), predicted=written,
        predicted_classes=sorted(set(np.unique(np.stack(preds)).tolist())),
        kernels="config 3 has no augmentation block: no hand-written "
                "kernel on its path")
    emit("fit_psp", **out)
    check(launches == {n: 0 for n in K.KERNELS}, ("fit_psp launches",
                                                  launches))
    check(all(math.isfinite(v) for v in losses), ("fit_psp losses", losses))
    check(rows[0] == PSP_CSV, ("fit_psp CSV header", rows[0]))
    check(len(rows) - 1 == summary["fold0.stage0"]["epochs"] == PSP_EPOCHS,
          ("fit_psp epochs", len(rows) - 1, summary))
    check(meta is not None and meta["done"] is True, ("done marker", meta))
    check(written == PSP_PREDICT and all(
        p is not None and p.shape == (h, w) and p.dtype == np.uint8
        and int(p.max()) < cfg.classes for p in preds),
        ("predicted masks", written, [None if p is None else p.shape
                                      for p in preds]))
    return out


def phase_zoo(seed: int) -> list:
    """Every backbone outside the ResNet family and EfficientNet, in Unet
    (DeepLabV3 for ``xception_aligned``), and resnet34's ``keras-preact``
    variant, at ``ZOO_SIZE``² B``ZOO_BATCH``: the f32 forward on the card
    against the CPU (TF32 off), one bf16 train step (bce + 0.25·dice,
    Adam) with a finite loss and no hand-written kernel launched, and the
    bf16 eval forward's time (CUDA events, median of 10)."""
    imgs, masks = synthetic_batch(ZOO_BATCH, ZOO_SIZE, ZOO_SIZE, seed + 9)
    x = torch.from_numpy(imgs).float() / 127.5 - 1.0
    batch = {"image": torch.from_numpy(imgs).cuda(),
             "mask": torch.from_numpy(masks).cuda()}
    loss_fn = LO.build_loss(LOSS, "sigmoid")
    rows = []
    for backbone, variant in ZOO:
        t0 = time.perf_counter()
        arch = "DeepLabV3" if backbone == "xception_aligned" else "Unet"
        model = MF.init_model(MF.create_model(
            arch, backbone, 1, dtype="float32", encoder_variant=variant),
            seed, "cpu")
        err = _card_vs_cpu(model, x)
        model.dtype = torch.bfloat16              # the card's compute dtype
        tx = OP.build_optimizer(CF.parse_dict({"optimizer": "Adam",
                                               "lr": LR}))
        state = ST.create_train_state(model, tx, "cuda")
        step = ST.build_train_step(model, tx, loss_fn, {}, "sigmoid", None)
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        _, logs = step(state, batch, LR)
        loss = float(logs["loss"])
        launches = K.launch_counts()
        xg = x.cuda()
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: MF.apply_model(
                model, state.params, state.batch_stats, xg), 10)
        row = dict(model=f"{arch}-{backbone}", encoder_variant=variant,
                   batch=ZOO_BATCH, size=[ZOO_SIZE, ZOO_SIZE],
                   params=sum(p.numel() for p in state.params.values()),
                   f32_card_vs_cpu_rel_err=err, bf16_train_loss=loss,
                   bf16_forward_ms=fwd_ms,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   seconds=time.perf_counter() - t0,
                   tolerance=dict(f32_card_vs_cpu_rel=FORWARD_REL))
        emit("zoo", **row)
        check(err <= FORWARD_REL, (backbone, variant, "forward error", err))
        check(math.isfinite(loss), (backbone, variant, "train loss", loss))
        check(not any(launches.values()), (backbone, "launches", launches))
        rows.append(row)
        del model, state, step
        torch.cuda.empty_cache()
    return rows


def phase_remat(cfg, imgs, masks, seed: int) -> dict:
    """``cfg`` (Unet-resnet34 at 512² B16 with the config-2 block) with
    ``remat`` off and on, from the same weights, batch and draws: peak
    memory and steady step time of each, the first step's loss equal
    within bf16 rounding."""
    runs = {}
    for remat in (False, True):
        runs[remat] = phase_train(f"remat_{'on' if remat else 'off'}",
                                  dataclasses.replace(cfg, remat=remat),
                                  imgs, masks, STEPS, seed,
                                  {"warp_x": 1, "warp_y": 1, "elastic": 1})
        torch.cuda.empty_cache()
    off, on = runs[False], runs[True]
    first = abs(on["loss"][0] - off["loss"][0]) / abs(off["loss"][0])
    out = dict(model=off["model"], batch=off["batch"], size=off["size"],
               peak_mem_gib={"off": off["peak_mem_gib"],
                             "on": on["peak_mem_gib"]},
               img_per_s={"off": off["img_per_s"], "on": on["img_per_s"]},
               steady_step_ms={k: statistics.mean(r["step_ms"][1:])
                               for k, r in (("off", off), ("on", on))},
               first_loss={"off": off["loss"][0], "on": on["loss"][0]},
               first_loss_rel_diff=first,
               tolerance=dict(first_loss_rel=REMAT_LOSS_REL))
    emit("remat", **out)
    check(first <= REMAT_LOSS_REL, ("remat first loss", first))
    check(on["peak_mem_gib"] < off["peak_mem_gib"],
          ("remat peak memory", out["peak_mem_gib"]))
    return out


def _torchvision_key(name: str) -> str:
    """The port's ResNet encoder parameter ``name`` → its torchvision
    state-dict key (``stem_conv`` → ``conv1``, ``stage2_block1.bn_down`` →
    ``layer2.0.downsample.1``, …)."""
    mod, leaf = name.rsplit(".", 1)
    if mod in ("stem_conv", "stem_bn"):
        return f"{'conv1' if mod == 'stem_conv' else 'bn1'}.{leaf}"
    block, part = mod.split(".")
    stage, b = block[len("stage"):].split("_block")
    part = {"downsample": "downsample.0", "bn_down": "downsample.1"}.get(
        part, part)
    return f"layer{stage}.{int(b) - 1}.{part}.{leaf}"


def torchvision_resnet_state(model, seed: int) -> dict:
    """A torchvision-named state dict for ``model``'s ResNet encoder,
    values from ``seed`` at a trained network's scales (kernels
    N(0, 1/fan_in), BatchNorm near the identity), with torchvision's
    ``num_batches_tracked`` counters and its ``fc`` head."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in model.encoder.state_dict().items():
        r = torch.randn(t.shape, generator=gen)
        if t.dim() == 4:
            v = r / math.sqrt(t[0].numel())
        elif name.endswith("running_var"):
            v = 0.5 * r.abs() + 0.5
        elif name.endswith("weight"):
            v = 1.0 + 0.1 * r
        else:
            v = 0.1 * r
        key = _torchvision_key(name)
        out[key] = v
        if key.endswith("running_var"):
            out[key[:-len("running_var")] + "num_batches_tracked"] = (
                torch.tensor(1000))
    out["fc.weight"] = torch.randn((1000, 512), generator=gen) * 0.01
    out["fc.bias"] = torch.zeros(1000)
    return out


def _write_preact_h5(path: str, model, seed: int) -> dict:
    """A Keras-named (classification_models) pre-activation resnet34 file
    for ``model``'s ``keras-preact`` encoder, values from ``seed``; returns
    ``{layer: {weight: array}}`` as written."""
    import h5py

    tree = BR.jax_from_state_dict(model.state_dict())
    params, stats = tree["params"]["encoder"], tree["batch_stats"]["encoder"]
    r = np.random.RandomState(seed)
    layers = {}
    for name, sub in params.items():
        if "kernel" in sub:
            k = sub["kernel"]
            layers[name] = {"kernel": (r.randn(*k.shape) / math.sqrt(
                k[..., 0].size)).astype(np.float32)}
            continue
        n = sub["bias"].shape[0]
        w = {"beta": 0.1 * r.randn(n), "moving_mean": 0.1 * r.randn(n),
             "moving_variance": 0.5 * np.abs(r.randn(n)) + 0.5}
        if "scale" in sub:
            w["gamma"] = 1.0 + 0.1 * r.randn(n)
        layers[name] = {k: v.astype(np.float32) for k, v in w.items()}
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([n.encode() for n in layers])
        for name, ws in layers.items():
            g = f.create_group(name)
            g.attrs["weight_names"] = np.array(
                [f"{name}/{k}:0".encode() for k in ws])
            for k, v in ws.items():
                g.create_dataset(f"{name}/{k}:0", data=v)
    return layers


def _geo_cfg(**over):
    return CF.parse_dict({"architecture": "Unet", "backbone": "resnet34",
                          "loss": LOSS, "optimizer": "Adam", "lr": LR,
                          "batch": BATCH, "augmentation": GEO_BLOCK,
                          "metrics": ["dice", "iou"], **over})


def phase_pretrained(imgs, masks, seed: int, profile: str) -> dict:
    """``encoder_weights: imagenet`` from a temporary STP_PRETRAINED_DIR:
    a torchvision-named resnet34 ``.pt`` and its ``.npz`` export load into
    Unet-resnet34 on the card bit for bit; a Keras preact ``.h5`` (if
    ``h5py`` imports) selects ``keras-preact`` and loads bit for bit; then
    10 bf16 train steps at 512² B16 from the ``.pt`` under GEO_BLOCK, the
    kernels it launches held bit for bit on the first step, and three
    profiled steps for the device's busy and idle time."""
    tmp = tempfile.mkdtemp(prefix="stp_pretrained_")
    try:
        with env({"STP_PRETRAINED_DIR": tmp, "STP_REQUIRE_PRETRAINED": "1"}):
            return _pretrained(tmp, imgs, masks, seed, profile)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _pretrained(tmp, imgs, masks, seed, profile) -> dict:
    cfg = _geo_cfg(encoder_weights="imagenet")
    check(MF._variant_for_config(cfg) == "", "no .h5: the plain graph")
    model = MF.init_model(MF.model_from_config(cfg), seed, "cpu")
    state = torchvision_resnet_state(model, seed + 7)
    torch.save(state, os.path.join(tmp, "resnet34.pt"))
    t0 = time.perf_counter()
    check(PT.load_into_model(model, cfg.backbone, cfg.encoder_weights),
          "imagenet resolves to resnet34.pt")
    load_s = time.perf_counter() - t0
    model.cuda()
    on_card = {n: t.cpu() for n, t in model.encoder.state_dict().items()}
    pt_equal = all(torch.equal(t, state[_torchvision_key(n)])
                   for n, t in on_card.items())
    check(pt_equal, "encoder on the card equals the .pt bit for bit")
    npz = os.path.join(tmp, "resnet34-export.npz")
    PT.export_encoder_npz(npz, BR.jax_from_state_dict(
        {n: t.cpu() for n, t in model.state_dict().items()}))
    other = MF.init_model(MF.model_from_config(cfg), seed + 1, "cpu")
    PT.load_into_model(other, cfg.backbone, npz)
    npz_equal = all(torch.equal(t, on_card[n])
                    for n, t in other.encoder.state_dict().items())
    check(npz_equal, "the .npz export loads to the same tensors")
    h5 = _pretrained_h5(cfg, seed)
    aug = LW.build_augmentation(cfg.augmentation)
    routes = [seg.route(SIZE, SIZE) for seg in aug.segments]
    check(routes == ["gather"], ("GEO_BLOCK's route at 512²", routes))
    kbound = aug.segments[0].kbound(SIZE, SIZE)
    out = phase_train("pretrained", cfg, imgs, masks, STEPS, seed, {},
                      profile or os.path.join(tmp, "profile.txt"),
                      hold=("warp_x", "warp_y", "elastic"),
                      model=model, encoder_weights="imagenet (.pt)",
                      load_s=load_s, pt_bit_for_bit=pt_equal,
                      npz_bit_for_bit=npz_equal, h5=h5, routes=routes,
                      kbound=kbound)
    return out


def _pretrained_h5(cfg, seed) -> dict:
    """The Keras leg: with ``resnet34.h5`` in the directory, the factory
    builds ``keras-preact`` and the file loads bit for bit.  Reported, not
    skipped, when ``h5py`` is missing."""
    if not _imports("h5py"):
        return {"h5py": False}
    root = os.path.join(os.environ["STP_PRETRAINED_DIR"], "h5")
    os.makedirs(root)
    with env({"STP_PRETRAINED_DIR": root}):
        layers = _write_preact_h5(os.path.join(root, "resnet34.h5"),
                                  MF.create_model(
                                      "Unet", "resnet34",
                                      encoder_variant="keras-preact"),
                                  seed + 9)
        variant = MF._variant_for_config(cfg)
        check(variant == "keras-preact", ("an .h5 selects", variant))
        model = MF.init_model(MF.model_from_config(cfg), seed, "cpu")
        check(type(model.encoder).__name__ == "PreactResNetEncoder",
              "keras-preact graph")
        check(PT.load_into_model(model, cfg.backbone, cfg.encoder_weights),
              "imagenet resolves to resnet34.h5")
    model.cuda()
    tree = BR.jax_from_state_dict(
        {n: t.cpu() for n, t in model.state_dict().items()})
    enc_p, enc_s = tree["params"]["encoder"], tree["batch_stats"]["encoder"]
    names = {"gamma": ("scale", enc_p), "beta": ("bias", enc_p),
             "moving_mean": ("mean", enc_s),
             "moving_variance": ("var", enc_s), "kernel": ("kernel", enc_p)}
    equal = all(np.array_equal(names[k][1][layer][names[k][0]], v)
                for layer, ws in layers.items() for k, v in ws.items())
    check(equal, "the .h5 loads bit for bit")
    return {"h5py": True, "variant": variant, "layers": len(layers),
            "bit_for_bit": equal}


def phase_geo_paths(seed: int) -> dict:
    """Each geometric name alone through ``Augmentation.apply`` at 512²
    B16 (Rot90 also on a 384×512 frame), two field blocks with K ≤ 64 and
    GEO_BLOCK: the route, the block's ms (CUDA events, median of 10), the
    launches of one block (those of its route, once each), every launch
    held bit for bit against its plain version; the gather's blocks
    against the CPU on the same draws, and ``warp_joint`` itself on the
    same matrices and field (TF32 off)."""
    out = {}
    for case, (h, w), spec in GEO_CASES:
        aug = LW.build_augmentation(spec)
        route = aug.segments[0].route(h, w)
        imgs, masks = synthetic_batch(BATCH, h, w, seed + 3)
        imgs, masks = torch.from_numpy(imgs), torch.from_numpy(masks)
        draws = aug.sample(torch.Generator().manual_seed(seed), BATCH, h, w)
        gi, gm, gd = imgs.cuda(), masks.cuda(), _to(draws, "cuda")
        K.reset_launches()
        with captured(list(WRAPPERS), {}) as calls:
            out_i, out_m = aug.apply(gd, gi, gm)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        _check_augmented(out_i, out_m, case)
        want = {n: int(n in ROUTE_KERNELS[route]) for n in K.KERNELS}
        check(launches == want, (case, route, launches))
        row = dict(frame=[h, w], route=route,
                   kbound=aug.segments[0].kbound(h, w), launches=launches,
                   held_to_plain=held_to_plain(calls, case),
                   block_ms=cuda_ms(lambda: aug.apply(gd, gi, gm), 10))
        if route == "gather":
            with no_tf32():
                row.update(_gather_vs_cpu(aug, draws, imgs, masks, out_i,
                                          out_m, case))
        out[case] = row
        emit("geo_paths", case=case, **row)
    return out


def _gather_vs_cpu(aug, draws, imgs, masks, out_i, out_m, case) -> dict:
    """The card's block against the CPU's on the same draws (sin, cos and
    the fields round differently there: REF_IMG_ATOL, REF_MASK_SHARE), and
    ``warp_joint`` on the first segment's matrices and field as the card
    computed them, on both devices (GATHER_IMG_ATOL, masks equal)."""
    ci, cm = aug.apply(draws, imgs, masks)
    block_err = float((out_i.cpu() - ci).abs().max())
    block_mis = mask_mismatch(out_m.cpu(), cm)
    check(block_err <= REF_IMG_ATOL and block_mis <= REF_MASK_SHARE,
          (case, "gather block card vs CPU", block_err, block_mis))
    b, h, w = imgs.shape[:3]
    mats = WP.rot90s(h, w, torch.arange(b) % 4).cuda()
    r = torch.Generator().manual_seed(b + h)
    disp = tuple(4.0 * torch.randn((b, h, w), generator=r) for _ in range(2))
    g = WP.warp_joint(imgs.cuda().float(), masks.cuda(), mats,
                      tuple(d.cuda() for d in disp), 16.0, gather_u8=True)
    c = WP.warp_joint(imgs.float(), masks, mats.cpu(), disp, 16.0,
                      gather_u8=True)
    gather_err = float((g[0].cpu() - c[0]).abs().max())
    check(gather_err <= GATHER_IMG_ATOL and torch.equal(g[1].cpu(), c[1]),
          (case, "warp_joint card vs CPU", gather_err))
    return dict(cpu_block_max_err=block_err, cpu_block_mask_mismatch=block_mis,
                warp_joint_max_err=gather_err,
                tolerance=dict(block_img_atol=REF_IMG_ATOL,
                               block_mask_share=REF_MASK_SHARE,
                               warp_joint_img_atol=GATHER_IMG_ATOL))


def _profile_path(base: str, tag: str) -> str:
    """``base`` with ``_tag`` before its suffix ("" when not profiling)."""
    if not base:
        return ""
    stem, dot, suffix = base.rpartition(".")
    return f"{stem}_{tag}.{suffix}" if dot else f"{base}_{tag}"


def timed(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, then a line with its wall seconds and the
    card's memory cache emptied."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    emit("wall", of=name, seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", default="",
                    help="also profile 3 steps of each train phase and 3 "
                         "calls of the serve phase; write the kernel tables "
                         "here")
    a = ap.parse_args(argv)

    info = phase_device()
    timed("build", phase_build)
    timed("reference", phase_reference, SEED)

    aug, imgs, masks, draws = train_shapes()
    rows = timed("kernel", lambda: phase_kernels(phase_capture(
        aug, imgs, masks, draws)))
    paths = timed("warp_paths", phase_warp_paths, aug, imgs, masks, draws)

    unet = CF.parse_dict({"architecture": "Unet", "backbone": "resnet34",
                          "loss": LOSS, "optimizer": "Adam", "lr": LR,
                          "batch": BATCH, "augmentation": CONFIG2_BLOCK,
                          "metrics": ["dice", "iou"]})
    x_y_elastic = {"warp_x": 1, "warp_y": 1, "elastic": 1}
    train = timed("train", phase_train, "train", unet, imgs, masks, STEPS,
                  SEED, x_y_elastic, a.profile)
    fpn = CF.parse(FPN_YAML)
    check(fpn.shape[:2] == (SIZE, SIZE) and fpn.batch == BATCH,
          ("config 2 shape and batch", fpn.shape, fpn.batch))
    with env({"STP_FUSE_ELASTIC": "1"}):
        train_fpn = timed("train_fpn", phase_train, "train_fpn", fpn, imgs,
                          masks, STEPS, SEED, {"warp_x": 1, "warp_ye": 1},
                          _profile_path(a.profile, "fpn"))
    deeplab = dataclasses.replace(unet, architecture="DeepLabV3",
                                  backbone="xception_aligned")
    timed("train_deeplab", phase_train, "train_deeplab", deeplab, imgs,
          masks, STEPS, SEED, x_y_elastic, _profile_path(a.profile,
                                                         "deeplab"),
          hold=tuple(x_y_elastic), output_stride=16, middle_units=16)
    timed("remat", phase_remat, unet, imgs, masks, SEED)
    timed("train_psp", phase_train_psp, SEED,
          _profile_path(a.profile, "psp"))
    timed("zoo", phase_zoo, SEED)
    timed("serve", phase_serve, SEED, _profile_path(a.profile, "serve"))
    timed("fit", phase_fit, SEED, bool(a.profile))
    timed("fit_psp", phase_fit_psp, SEED, bool(a.profile))
    timed("pretrained", phase_pretrained, imgs, masks, SEED,
          _profile_path(a.profile, "pretrained"))
    timed("geo_paths", phase_geo_paths, SEED)
    # launches on each kernel's main path: X, Y and elastic in the Unet
    # step, YE in the FPN step, the shear in the unfused warp path
    launches = dict(train["launches"], warp_ye=train_fpn["launches"][
        "warp_ye"], shear=paths["unfused"]["launches"]["shear"])
    for name, row in rows.items():
        row["launches"] = launches[name]
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
