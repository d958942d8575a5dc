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
  5b. batchnorm: the four train-mode batch-norm kernels (``bn_stats``,
     ``bn_apply``, ``bn_grad_stats``, ``bn_grad_apply``) on the train
     step's stem (B16, 64, 256²) and layer-4 (B16, 512, 16²) maps, bf16
     and f32, channels-last (as the step gives them) and NCHW, and the
     stem's in f16 (a ``dtype: float16`` config's), channels-last: the
     float64 sums within 1e-12 of their plain versions' (relative to
     their terms' magnitudes), every output derived from given sums equal
     to the plain version's, two launches bit for bit equal, each timed
     as the kernel phase times (median of 50 behind the hold) beside its
     memory bound, its plain version and PyTorch's one-call counterpart
     (SyncBatchNorm's ``batch_norm_stats``, ``batch_norm_elemt``,
     ``batch_norm_backward_reduce``, ``batch_norm_backward_elemt``), and
     ``F.batch_norm`` forward and forward+backward on the same tensors,
     ``bn_apply``'s bytes streamed by one ``copy_`` and
     ``bn_grad_apply``'s by one ``torch.add(dy, x, out=dx)``; the same on the
     train step's five other maps in bf16 channels-last, and over its
     seven maps the totals of one step (Σ launches × ms, bound and
     library: ``batchnorm_step``); a layer's forward and backward on the
     host clock, through the kernels and through ``F.batch_norm``
     (``batchnorm_host``);
  6. warp_paths: the config-2 block at B16 512² through
     ``Augmentation.apply`` on one set of draws, the three paths timed
     (CUDA events, median), their launch counts read, and held against
     each other (YE against X→Y→elastic bit for bit; unfused against
     fused within the JAX test's 1e-2 and 2e-3);
  7. train: full-width Unet-resnet34 at 512², B16, bf16 autocast (f32
     head), bce + 0.25·dice, Adam at lr 5e-4, with the config-2 block,
     for 10 steps on a fixed synthetic batch; every launch count is reset
     just before and read just after: X, Y and elastic once per step,
     each batch-norm kernel once per layer and step (46 layers).  Every
     train phase (and fit) holds the batch-norm launches to its layers'
     train-mode calls (``bn_calls``): a forward launches ``bn_stats`` and
     ``bn_apply``, a backward ``bn_grad_stats`` and, where the input
     takes a gradient, ``bn_grad_apply``; eval and serve launch none;
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
  12d. train_photo: ``train``'s model, loss, optimizer and batch under
     ``PHOTO_BLOCK`` (Fliplr, the Affine sugar Rotate, ElasticTransformation
     in a Sometimes child, OneOf contrasts, SomeOf of noise and dropouts,
     Resize) parsed by the port: X, Y and elastic once a step (their
     routes read from the block), each held bit for bit on the first
     step's arguments; each segment of the block in f32 on the card
     against the CPU on the same draws and input, a segment that warps
     also on the CPU's matrices and fields (``_segments_vs_cpu``), the
     block's ms, a falling loss, img/s and peak memory;
  12e. photo_paths: each name of the slice alone at 512² B16
     (``PHOTO_CASES``; the combinators with a child that reaches a
     kernel; the colour names, the histogram names and the four channel
     and colourspace scopes; the filters, BilateralBlur and MeanShiftBlur
     at radius 5): its launches, each launch held bit for bit, the
     block's ms and peak memory above its inputs, and the card against
     the CPU on the same draws, TF32 at its default (``CPU_HEAD``'s tap
     loops and the segment quantisers on the first 4 images of the timed
     B16 output); the weather names, the quantisers, Jigsaw and the
     blends with the four aliases (a blend with a Rotate child
     reaching X and Y), the quantisers held to a share of values off by
     more than half a gray level (``SEGMENT_SHARE``: a near-tie argmin
     recolours a pixel and moves its cells' means);
  12f. train_filter: ``train``'s model, loss, optimizer and batch under
     ``FILTER_BLOCK`` (Affine, ElasticTransformation, a OneOf of
     GaussianBlur, MotionBlur, MedianBlur, Sharpen and JpegCompression):
     X, Y and elastic once a step, each held bit for bit on the first
     step's arguments; each segment in f32 on the card against the CPU,
     the block's ms, a falling loss, img/s and peak memory;
  12f2. train_kitchen: ``examples/kitchen_sink.yaml`` as the port parses
     it, unchanged (FPN-seresnext50 384² B32, 4-class softmax, ``remat``,
     the encoder frozen as its first stage freezes it, its composite loss
     with class weights, AdamW with weight decay and clipnorm, its
     ``transforms:`` and its whole augmentation block) on synthetic
     4-class data for ``KITCHEN_STEPS`` steps: a finite, falling loss, the
     block's ms (CUDA events, median of 10), img/s, peak memory, the
     geometric run's route and the block's launches, and each segment
     of the block on the card against the CPU in f32 on the same draws,
     on the first 4 images, TF32 at its default;
  12g. accuracy: ``examples/accuracy_evidence_torch.py`` config 1 cut to
     64 images and 2 epochs through its ``main``: the evaluate dict,
     finite and in [0, 1], no kernel launch, the fit's and evaluate's
     seconds;
  12h. train_ddp: data parallelism rehearsed on the one card: two gloo
     ranks (``--ddp-worker`` subprocesses of this script, a file store in
     a temporary directory, each with its own timeout), each training its
     8 rows of ``train``'s B16 batch (Unet-resnet34 at full width, 512²,
     f32 with TF32 off, SGD at 1e-3, the config-2 block) for 3 steps from
     one init and one generator seed, against the same run in one
     process: the summed loss within 1e-5, parameters within 5e-4, the
     BatchNorm statistics within 1e-4, the ranks' parameters bit for bit
     equal, X, Y and elastic once a step on each rank, each held bit for
     bit on the first step's arguments, each rank's rows of the block on
     the card (``take``) bit for bit the batch's; the statistics after
     the first step beside those after the third; each step's ms, the
     all-reduces a step and their bytes (gloo stages through the host:
     not speeds);
  12i. fit_ddp: ``fit``'s config 4, cut the same way, through the CLI's
     ``fit`` under ``torch.distributed.run --nproc-per-node 1`` (NCCL at
     world size 1: every collective runs), its steady step ms beside
     ``fit``'s; then the same fit on two gloo ranks sharing the card
     (rank 1's checkpoint, CSV and event writers raise if called), and
     again, which skips every stage on both ranks; the JAX layout's files
     with their ``done`` markers;
  12j. train_space: the ``space`` axis, JAX's flagship space test on the
     one card: four gloo ranks at ``mesh: {data: 2, space: 2}``
     (``--ddp-worker space``), each holding 256 rows of its data block's
     two images, train Unet-resnet34 at 512² (full width), f32 with TF32
     off, bce, SGD at 1e-2, global B4, against the same step in one
     process (one batch-norm formula, the kernels', in every process):
     the summed loss (rtol 2e-5, atol 2e-6), the stem and ``up5.conv2``
     kernels (rtol 1e-4, atol 1e-6), every parameter within 5e-4, the
     BatchNorm statistics within 1e-4, every tensor's gradient (a step at
     lr 1) within 10% of its norm or 1e-5 of the median tensor's; one
     rank in a group of one ("solo") against the same step with the same
     bars (bit for bit equality reported, beside how far a second run of
     the one-process step lies from the first); the stem gradients' distances
     from the step in float64; the ranks' variables bit for bit equal,
     2·46 + 1 world all-reduces a step; then 2 steps under
     the config-2 block, X, Y and elastic launched on every rank's whole
     images, once a step, bit for bit with their plain versions on the
     first step's arguments; each step's ms, the world's all-reduces and
     the group's halo exchanges, gathers and group sums a step with their
     bytes (gloo stages through the host: not speeds);
  13. the ``kernels`` summary line (the batch-norm kernels' times from
     ``batchnorm``'s stem case in bf16 channels-last; ``launches`` from
     ``train``, beside
     them ``launches_train_photo``, ``launches_train_filter``,
     ``launches_train_kitchen``, ``launches_train_ddp_per_rank`` and
     ``launches_train_space_per_rank``), then
     the last line
     ``{"ok": true, "device": {...}}``.

``--profile FILE`` profiles three more steps of each train phase and
three more ``predict_probs`` calls of the serve phase (``FILE`` for Unet,
``FILE`` with ``_fpn``, ``_deeplab``, ``_psp``, ``_serve``, ``_photo``,
``_filter``, ``_kitchen`` or ``_pretrained`` before its suffix for FPN,
DeepLab, PSPNet, serve, ``train_photo``, ``train_filter``,
``train_kitchen`` and the pretrained phase, whose
three steps are profiled
in every run), and traces epoch 1 of each fit stage (the fits' own
``profile:``) for its device busy time.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import signal
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
from segmentation_training_pipeline_tpu_torch.models import batchnorm as BN
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
from segmentation_training_pipeline_tpu_torch.parallel import (
    distributed as DI)
from segmentation_training_pipeline_tpu_torch.parallel import mesh as PM
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
           "warp_ye": _CSRC + "warp_xy.cu",
           **{n: _CSRC + "batchnorm.cu" for n in (
               "bn_stats", "bn_apply", "bn_grad_stats", "bn_grad_apply")}}
# the augmentation's kernels and the train-mode batch norm's
AUG_KERNELS = EXACT
BN_KERNELS = ("bn_stats", "bn_apply", "bn_grad_stats", "bn_grad_apply")
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

# the train_photo block: the Affine sugar (Rotate: kernels X and Y), the
# elastic kernel in a Sometimes child, the choice combinators and the
# pixelwise photometrics, then Resize
PHOTO_BLOCK = [
    {"Fliplr": 0.5},
    {"Rotate": [-15, 15]},
    {"Sometimes": {"p": 0.5, "then": [{"ElasticTransformation": {
        "alpha": [0, 40], "sigma": 6}}]}},
    {"OneOf": [{"GammaContrast": [0.7, 1.4]}, {"LinearContrast": [0.9, 1.1]},
               {"SigmoidContrast": {"gain": [6, 10]}}]},
    {"SomeOf": {"n": [0, 2], "children": [
        {"AdditiveGaussianNoise": {"scale": [0, 10]}}, {"SaltAndPepper": 0.02},
        {"CoarseDropout": {"p": 0.05}},
        {"Cutout": {"nb_iterations": [1, 3], "size": 0.15, "cval": 128}}]}},
    {"Resize": 0.75},
]
# the photo_paths phase: each name of the slice alone at 512² (the
# combinators with a child that reaches a kernel)
PHOTO_CASES = [
    ("rotate", {"Rotate": [-15, 15]}),
    ("translatex", {"TranslateX": [-0.1, 0.1]}),
    ("translatey", {"TranslateY": {"px": [-20, 20]}}),
    ("scalex", {"ScaleX": [0.8, 1.2]}),
    ("scaley", {"ScaleY": [0.8, 1.2]}),
    ("shearx", {"ShearX": [-10, 10]}),
    ("sheary", {"ShearY": [-10, 10]}),
    ("resize", {"Resize": 0.75}),
    ("sometimes", {"Sometimes": {"p": 0.5, "then": [
        {"ElasticTransformation": {"alpha": [0, 40], "sigma": 6}}]}}),
    ("oneof", {"OneOf": [{"Rotate": [-10, 10]}, {"Add": 20},
                         {"Invert": 1.0}]}),
    ("someof", {"SomeOf": {"n": [0, 2], "children": [
        {"Flipud": 1.0}, {"Salt": 0.05}, {"ShearX": [-5, 5]}]}}),
    ("add", {"Add": {"value": [-20, 20], "per_channel": True}}),
    ("addelementwise", {"AddElementwise": [-20, 20]}),
    ("multiplyelementwise", {"MultiplyElementwise": [0.8, 1.2]}),
    ("linearcontrast", {"LinearContrast": [0.6, 1.4]}),
    ("gammacontrast", {"GammaContrast": {"gamma": [0.7, 1.7],
                                         "per_channel": True}}),
    ("sigmoidcontrast", {"SigmoidContrast": {"gain": [5, 10],
                                             "cutoff": [0.3, 0.6]}}),
    ("logcontrast", {"LogContrast": [0.4, 1.6]}),
    ("invert", {"Invert": 0.5}),
    ("solarize", {"Solarize": {"p": [0.2, 0.8], "threshold": [64, 192]}}),
    ("posterize", {"Posterize": [1, 8]}),
    ("additivegaussiannoise", {"AdditiveGaussianNoise": [0, 15]}),
    ("additivelaplacenoise", {"AdditiveLaplaceNoise": [0, 15]}),
    ("additivepoissonnoise", {"AdditivePoissonNoise": [0, 15]}),
    ("impulsenoise", {"ImpulseNoise": 0.1}),
    ("salt", {"Salt": 0.1}),
    ("pepper", {"Pepper": 0.1}),
    ("saltandpepper", {"SaltAndPepper": 0.1}),
    ("coarsesaltandpepper", {"CoarseSaltAndPepper": 0.2}),
    ("coarsesalt", {"CoarseSalt": {"p": 0.2, "size_percent": 0.05}}),
    ("coarsepepper", {"CoarsePepper": 0.2}),
    ("dropout", {"Dropout": [0, 0.2]}),
    ("dropout2d", {"Dropout2d": 0.5}),
    ("totaldropout", {"TotalDropout": 0.5}),
    ("coarsedropout", {"CoarseDropout": {"p": 0.3, "size_percent": 0.1}}),
    ("cutout", {"Cutout": {"nb_iterations": [1, 3], "size": 0.15,
                           "cval": 128}}),
    ("replaceelementwise", {"ReplaceElementwise": {
        "mask": 0.1, "replacement": [0, 255], "per_channel": True}}),
    ("channelshuffle", {"ChannelShuffle": 0.5}),
    ("noop", {"Noop": None}),
    # the colour names and their scopes
    ("grayscale", {"Grayscale": [0.0, 1.0]}),
    ("addtohueandsaturation", {"AddToHueAndSaturation": {
        "value_hue": [-50, 50], "value_saturation": [-30, 30]}}),
    ("addtohue", {"AddToHue": [-255, 255]}),
    ("addtosaturation", {"AddToSaturation": [-75, 75]}),
    ("multiplyhueandsaturation", {"MultiplyHueAndSaturation": [0.5, 1.5]}),
    ("multiplyhue", {"MultiplyHue": [-3.0, 3.0]}),
    ("multiplysaturation", {"MultiplySaturation": [0.0, 3.0]}),
    ("removesaturation", {"RemoveSaturation": [0.2, 1.0]}),
    ("changecolortemperature", {"ChangeColorTemperature": [1000, 11000]}),
    ("changecolorspace_hsv", {"ChangeColorspace": "HSV"}),
    ("changecolorspace_hls", {"ChangeColorspace": {
        "to_colorspace": "HLS", "alpha": [0.5, 1.0]}}),
    ("changecolorspace_ycrcb", {"ChangeColorspace": "YCrCb"}),
    ("changecolorspace_gray", {"ChangeColorspace": "GRAY"}),
    ("changecolorspace_bgr", {"ChangeColorspace": "BGR"}),
    ("autocontrast", {"Autocontrast": {"cutoff": 2}}),
    ("auto_contrast", {"auto_contrast": None}),
    ("histogramequalization", {"HistogramEqualization": None}),
    ("allchannelshistogramequalization",
     {"AllChannelsHistogramEqualization": None}),
    ("clahe", {"CLAHE": [1, 10]}),
    # 5×5 tiles of 103 px: the frame pads (reflect-101), odd tiles
    ("allchannelsclahe", {"AllChannelsCLAHE": {"clip_limit": 4,
                                               "tile_grid_size": 5}}),
    ("withchannels", {"WithChannels": {"channels": [0, 1], "children": [
        {"Add": [-30, 30]}, {"GammaContrast": [0.7, 1.4]}]}}),
    ("withhueandsaturation", {"WithHueAndSaturation": {"children": [
        {"Add": {"value": [-40, 40], "per_channel": True}}]}}),
    ("withbrightnesschannels", {"WithBrightnessChannels": {"children": [
        {"Add": [-50, 50]}]}}),
    ("withcolorspace", {"WithColorspace": {
        "to_colorspace": "HSV", "children": [
            {"Multiply": {"mul": [0.7, 1.3], "per_channel": True}}]}}),
    # the filters; BilateralBlur and MeanShiftBlur at their cap, radius 5
    # (121 taps)
    ("averageblur", {"AverageBlur": [1, 7]}),
    ("gaussianblur", {"GaussianBlur": [0.0, 3.0]}),
    ("sharpen", {"Sharpen": {"alpha": [0, 1], "lightness": [0.75, 1.5]}}),
    ("emboss", {"Emboss": [0, 1]}),
    ("edgedetect", {"EdgeDetect": [0, 0.75]}),
    ("directededgedetect", {"DirectedEdgeDetect": None}),
    ("motionblur", {"MotionBlur": {"k": [3, 7], "angle": [0, 360]}}),
    ("averagepooling", {"AveragePooling": 2}),
    ("maxpooling", {"MaxPooling": 3}),
    ("minpooling", {"MinPooling": 2}),
    ("medianpooling", {"MedianPooling": 2}),
    ("medianblur", {"MedianBlur": 3}),
    ("medianblur_k5", {"MedianBlur": 5}),
    ("bilateralblur_r5", {"BilateralBlur": {"d": [3, 11]}}),
    ("jpegcompression", {"JpegCompression": [0, 100]}),
    ("canny", {"Canny": None}),
    ("meanshiftblur_r5", {"MeanShiftBlur": None}),
    ("cartoon", {"Cartoon": None}),
    # weather, the quantisers and Jigsaw; the Voronoi names at
    # their default capacities (UniformVoronoi 500 seeds, RegularGrid
    # 30 × 30: four and eight chunks of 128)
    ("clouds", {"Clouds": [0.2, 0.6]}),
    ("fog", {"Fog": [0.1, 0.4]}),
    ("snowflakes", {"Snowflakes": {"density": [0.005, 0.05],
                                   "speed": [0.007, 0.03]}}),
    ("rain", {"Rain": None}),
    ("fastsnowylandscape", {"FastSnowyLandscape": None}),
    ("uniformcolorquantization", {"UniformColorQuantization": [2, 16]}),
    ("superpixels", {"Superpixels": {"p_replace": [0.5, 1.0],
                                     "n_segments": [60, 120]}}),
    ("uniformvoronoi", {"UniformVoronoi": None}),
    ("regulargridvoronoi", {"RegularGridVoronoi": None}),
    ("relativeregulargridvoronoi", {"RelativeRegularGridVoronoi": None}),
    ("kmeanscolorquantization", {"KMeansColorQuantization": None}),
    ("jigsaw", {"Jigsaw": None}),
    # the blends and their four aliases (photometric children: the masks
    # stay; BlendAlpha's per-image factor routes a Rotate child's masks)
    ("blendalpha", {"BlendAlpha": {
        "factor": [0, 1], "per_channel": True, "foreground": {"Add": 40},
        "background": {"Multiply": 0.8}}}),
    ("blendalpha_rotate", {"BlendAlpha": {
        "factor": [0, 1], "foreground": {"Rotate": [-15, 15]}}}),
    ("alpha", {"Alpha": {"foreground": {"Add": -40}}}),
    ("blendalphaelementwise", {"BlendAlphaElementwise": {
        "foreground": {"Add": 40}}}),
    ("alphaelementwise", {"AlphaElementwise": {"foreground": {"Add": 40}}}),
    ("blendalphaverticallineargradient", {
        "BlendAlphaVerticalLinearGradient": {"foreground": {"Add": 40}}}),
    ("blendalphahorizontallineargradient", {
        "BlendAlphaHorizontalLinearGradient": {"foreground": {"Add": 40}}}),
    ("blendalpharegulargrid", {"BlendAlphaRegularGrid": {
        "foreground": {"Add": 40}}}),
    ("blendalphacheckerboard", {"BlendAlphaCheckerboard": {
        "foreground": {"Add": 40}}}),
    ("blendalphasimplexnoise", {"BlendAlphaSimplexNoise": {
        "foreground": {"Add": 40}}}),
    ("simplexnoisealpha", {"SimplexNoiseAlpha": {
        "foreground": {"Add": 40}}}),
    ("blendalphafrequencynoise", {"BlendAlphaFrequencyNoise": {
        "foreground": {"Add": 40}}}),
    ("frequencynoisealpha", {"FrequencyNoiseAlpha": {
        "foreground": {"Add": 40}}}),
    ("blendalphasomecolors", {"BlendAlphaSomeColors": {
        "foreground": {"MultiplySaturation": [1.2, 1.8]}}}),
    ("blendalphasegmapclassids", {"BlendAlphaSegMapClassIds": {
        "class_ids": [1], "foreground": {"AdditiveGaussianNoise": [0, 8]}}}),
]
# cases whose timed B16 output is held to the CPU on its first CPU_IMAGES
# images (same draws): the tap loops take tens of seconds for B16 512² on
# the host
CPU_HEAD = {"bilateralblur_r5", "meanshiftblur_r5", "cartoon",
            "superpixels", "uniformvoronoi", "regulargridvoronoi",
            "relativeregulargridvoronoi", "kmeanscolorquantization"}
CPU_IMAGES = 4
# the segment quantisers assign pixels by an argmin of float32 distances
# (cuBLAS's and the CPU's products, and the downscale's, sum in other
# orders): a near tie can fall the other way and recolour a pixel, and it
# moves its cells' means, over Superpixels' and k-means' rounds other
# cells' too, by a fraction of a gray level, every pixel of those cells
# with them (on the CPU alone, 1e-4 of noise on the input moves 8% and
# 12% of their values by more than 1e-3, 0.08% and 0.01% by more than
# 0.5).  A segment holding one is held to a share of image values off
# by more than half a gray level
SEGMENT_NAMES = {"superpixels", "uniformvoronoi", "regulargridvoronoi",
                 "relativeregulargridvoronoi", "kmeanscolorquantization"}
SEGMENT_ATOL = 0.5
SEGMENT_SHARE = 1e-2
# the train_kitchen phase: examples/kitchen_sink.yaml, unchanged
KITCHEN_YAML = "examples/kitchen_sink.yaml"
KITCHEN_STEPS = 5
# the train_filter block: Affine and ElasticTransformation (kernels X, Y
# and elastic, one warp) and a OneOf of filters
FILTER_BLOCK = [
    {"Affine": {"rotate": [-15, 15], "scale": [0.85, 1.15]}},
    {"ElasticTransformation": {"alpha": [0, 40], "sigma": 6}},
    {"OneOf": [{"GaussianBlur": [0.0, 3.0]}, {"MotionBlur": {"k": [3, 7]}},
               {"MedianBlur": 3}, {"Sharpen": [0.0, 0.5]},
               {"JpegCompression": [50, 90]}]},
]
# photo_paths and train_photo, each segment on the card against the port on
# the CPU on the same draws and the same input: images within 1e-3 on
# 0..255 (pow, exp and log2 round differently there), masks equal.  A
# segment that warps computes its matrices and fields (sin, cos, the
# elastic blur) on each device: from the draws its images are held to the
# reference phase's REF_IMG_ATOL, and on the CPU's matrices and fields on
# both devices to 1e-3; masks equal in both.  The same warp on geometry
# moved by WARP_FAULT_PX must read above REF_IMG_ATOL
PHOTO_IMG_ATOL = 1e-3
WARP_FAULT_PX = 1.0 / 64.0

# the three paths of the warp and the environment that selects each
PATHS = {"default": {}, "fuse_elastic": {"STP_FUSE_ELASTIC": "1"},
         "unfused": {"STP_PALLAS_WARP": "0"}}


def check(ok: bool, what) -> None:
    """A failed check ends the run (asserts would vanish under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke.py check failed: {what}")


@contextlib.contextmanager
def bn_calls():
    """The kernels each train-mode BatchNorm call of the block should
    launch, counted from the calls themselves: a forward ``bn_stats`` and
    ``bn_apply``, a backward ``bn_grad_stats`` and, where the input takes
    a gradient, ``bn_grad_apply``."""
    counts = {n: 0 for n in BN_KERNELS}
    fn = BN.BatchNormTrain
    forward, backward = fn.forward, fn.backward

    def counted_forward(ctx, *args):
        counts["bn_stats"] += 1
        counts["bn_apply"] += 1
        return forward(ctx, *args)

    def counted_backward(ctx, *grads):
        counts["bn_grad_stats"] += 1
        counts["bn_grad_apply"] += int(ctx.needs_input_grad[0])
        return backward(ctx, *grads)

    fn.forward, fn.backward = (staticmethod(counted_forward),
                               staticmethod(counted_backward))
    try:
        yield counts
    finally:
        fn.forward, fn.backward = staticmethod(forward), staticmethod(
            backward)


def bn_layers(model) -> int:
    return sum(isinstance(m, BN.BatchNorm) for m in model.modules())


def check_launches(what, launches: dict, aug: dict, bn: dict) -> None:
    """The augmentation's kernels launched ``aug`` times (each other one
    0) and the batch norm's ``bn`` times; a train run (``bn`` not all
    0) launched every batch-norm kernel."""
    check({n: launches[n] for n in AUG_KERNELS}
          == {n: aug.get(n, 0) for n in AUG_KERNELS},
          (what, "augmentation launches", launches, aug))
    check({n: launches[n] for n in BN_KERNELS} == dict(bn),
          (what, "batch norm launches", launches, bn))
    check(not any(bn.values()) or all(bn.values()),
          (what, "a batch norm kernel never launched", bn))


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


# the batchnorm phase: the four kernels at the train step's shapes
# (Unet-resnet34 512² B16: the stem's map and layer 4's), in the card's
# channels-last layout in bf16 (the train phase's) and f32, and in NCHW;
# the stem's also in f16 (a ``dtype: float16`` config's); then the step's
# five other batch-norm maps in bf16 channels-last, so that with the stem
# and layer 4 the cases hold every map the step gives its 46 layers
# (``BN_STEP_LAUNCHES``: each map's launches of each kernel a step).
# Tolerances: the float64 sums against the plain version's within 1e-12
# of the sum of their terms' magnitudes (the two add in other orders);
# the outputs that derive from given sums (y, the saved mean and invstd,
# the running statistics, dx; dw and db from the kernel's own sums)
# within BN_ULPS units in the last place of their type: none, since both
# sides take each float32 and float64 operation in the same order (the
# build's -fmad=false; the sums' fused multiply-adds take exact products)
# and round to bf16 to nearest even
BN_CASES = [("stem", (BATCH, 64, SIZE // 2, SIZE // 2), dtype, layout)
            for dtype, layout in ((torch.bfloat16, "channels_last"),
                                  (torch.float32, "channels_last"),
                                  (torch.bfloat16, "nchw"))] + [
    ("layer4", (BATCH, 512, SIZE // 32, SIZE // 32), dtype, layout)
    for dtype, layout in ((torch.bfloat16, "channels_last"),
                          (torch.float32, "channels_last"),
                          (torch.float32, "nchw"))] + [
    ("stem", (BATCH, 64, SIZE // 2, SIZE // 2), torch.float16,
     "channels_last")] + [
    (name, (BATCH, c, SIZE // f, SIZE // f), torch.bfloat16,
     "channels_last")
    for name, c, f in (("layer1", 64, 4), ("layer2", 128, 8),
                       ("layer3", 256, 16), ("decoder4", 32, 2),
                       ("decoder5", 16, 1))]
BN_STEP_LAUNCHES = {(BATCH, 64, SIZE // 2, SIZE // 2): 1,
                    (BATCH, 64, SIZE // 4, SIZE // 4): 8,
                    (BATCH, 128, SIZE // 8, SIZE // 8): 11,
                    (BATCH, 256, SIZE // 16, SIZE // 16): 15,
                    (BATCH, 512, SIZE // 32, SIZE // 32): 7,
                    (BATCH, 32, SIZE // 2, SIZE // 2): 2,
                    (BATCH, 16, SIZE, SIZE): 2}
BN_SUM_REL = 1e-12
BN_ULPS = 0
BN_MOMENTUM, BN_EPS = 0.9, 1e-5
# H100 SXM FP64 outside the tensor cores (NVIDIA data sheet)
FP64_FLOPS = 34e12
# operations per value: (f32, f64) of each kernel, from the source
BN_OPS = {"bn_stats": (0, 3), "bn_apply": (3, 0), "bn_grad_stats": (1, 3),
          "bn_grad_apply": (5, 0)}
# each kernel's one-call counterpart in PyTorch (SyncBatchNorm's)
LIBRARY_OF = {"bn_stats": "batch_norm_stats", "bn_apply": "batch_norm_elemt",
              "bn_grad_stats": "batch_norm_backward_reduce",
              "bn_grad_apply": "batch_norm_backward_elemt"}


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance of ``a`` from ``b`` in units in the last
    place of their type (0: equal)."""
    if torch.equal(a, b):
        return 0
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16, torch.float64: torch.int64}[a.dtype]
    return int((a.contiguous().view(ints).long()
                - b.contiguous().view(ints).long()).abs().max())


def _sum_err(got: torch.Tensor, want: torch.Tensor,
             scale: torch.Tensor) -> float:
    """The largest distance of two float64 sums over the sum of their
    terms' magnitudes."""
    return float(((got - want).abs() / scale.clamp(min=1e-300)).max())


def _bn_inputs(shape, dtype, layout, seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[1]
    fmt = (torch.channels_last if layout == "channels_last"
           else torch.contiguous_format)

    def normal(*size):
        return torch.randn(*size, generator=gen, device="cuda")

    spread = 0.5 + 1.5 * torch.rand(1, c, 1, 1, generator=gen,
                                    device="cuda")
    x = (3.0 + 2.0 * spread * normal(*shape)).to(dtype).contiguous(
        memory_format=fmt)
    dy = normal(*shape).to(dtype).contiguous(memory_format=fmt)
    return dict(x=x, dy=dy, w=0.5 + torch.rand(c, generator=gen,
                                               device="cuda"),
                b=normal(c) * 0.1, rm=normal(c) * 0.1,
                rv=1.0 + torch.rand(c, generator=gen, device="cuda"))


def _bn_case(name: str, shape, dtype, layout, seed: int,
             yardsticks: bool = True, strict: bool = True) -> dict:
    """The four kernels against their plain versions on one case, two
    launches of each, their times beside their bounds and, with
    ``yardsticks``, the plain versions' and PyTorch's one-call
    counterparts (SyncBatchNorm's ``batch_norm_stats``,
    ``batch_norm_elemt``, ``batch_norm_backward_reduce``,
    ``batch_norm_backward_elemt``), one ``copy_`` of x (``bn_apply``'s
    bytes, read once and written once), one ``torch.add(dy, x, out=dx)``
    (``bn_grad_apply``'s: two read, one written) and ``F.batch_norm``
    forward and backward on the same tensors.  ``strict`` fails the run on a check;
    without it the case is only reported (``compare_kernels.py``)."""
    t = _bn_inputs(shape, dtype, layout, seed)
    x, dy, w, b, rm, rv = (t[k] for k in ("x", "dy", "w", "b", "rm", "rv"))
    c, dims = shape[1], (0, 2, 3)
    n = x.numel() // c
    xd, dyd = x.double(), dy.double()
    acc = torch.float32
    # the kernels, twice each, and the plain versions on the same inputs
    sums, sums2 = BN.bn_stats(x), BN.bn_stats(x)
    psums = BN.bn_stats_plain(x)
    app = BN.bn_apply(x, sums, w, b, rm, rv, BN_MOMENTUM, BN_EPS)
    app2 = BN.bn_apply(x, sums, w, b, rm, rv, BN_MOMENTUM, BN_EPS)
    papp = BN.bn_apply_plain(x, sums, w, b, rm, rv, BN_MOMENTUM, BN_EPS)
    mean, invstd = app[1], app[2]
    gs, dw, db = BN.bn_grad_stats(dy, x, mean, invstd, w)
    gs2, dw2, db2 = BN.bn_grad_stats(dy, x, mean, invstd, w)
    pgs = BN.bn_grad_stats_plain(dy, x, mean, invstd, w)[0]
    dx = BN.bn_grad_apply(dy, x, gs, sums, mean, invstd, w)
    dx2 = BN.bn_grad_apply(dy, x, gs, sums, mean, invstd, w)
    pdx = BN.bn_grad_apply_plain(dy, x, gs, sums, mean, invstd, w)
    torch.cuda.synchronize()
    d = (x.to(acc) - mean.view(1, -1, 1, 1)).double()
    scales = {"bn_stats": torch.cat([xd.abs().sum(dims), (xd * xd).sum(
        dims), xd.new_ones(1)]),
              "bn_grad_stats": torch.cat([dyd.abs().sum(dims),
                                          (dyd * d).abs().sum(dims)])}
    errs = {
        "bn_stats": dict(sum_rel=_sum_err(sums, psums, scales["bn_stats"]),
                         n_exact=float(sums[2 * c]) == n),
        "bn_apply": dict(ulps=max(_ulps(g, p) for g, p in zip(app, papp))),
        "bn_grad_stats": dict(
            sum_rel=_sum_err(gs, pgs, scales["bn_grad_stats"]),
            ulps=max(_ulps(dw, (gs[c:] * invstd.double()).to(acc)),
                     _ulps(db, gs[:c].to(acc)))),
        "bn_grad_apply": dict(ulps=_ulps(dx, pdx)),
    }
    repeat = {"bn_stats": torch.equal(sums, sums2),
              "bn_apply": all(torch.equal(g, h) for g, h in zip(app, app2)),
              "bn_grad_stats": all(torch.equal(g, h) for g, h in (
                  (gs, gs2), (dw, dw2), (db, db2))),
              "bn_grad_apply": torch.equal(dx, dx2)}
    # the largest difference of the kernel's main output from the plain
    # version's: the sums, y and dx
    for k, (got, want) in {"bn_stats": (sums, psums),
                           "bn_apply": (app[0], papp[0]),
                           "bn_grad_stats": (gs, pgs),
                           "bn_grad_apply": (dx, pdx)}.items():
        errs[k]["max_abs_err"] = float((got.double() - want.double())
                                       .abs().max())
    calls = {
        "bn_stats": (lambda: BN.bn_stats(x), lambda: BN.bn_stats_plain(x)),
        "bn_apply": (lambda: BN.bn_apply(x, sums, w, b, rm, rv, BN_MOMENTUM,
                                         BN_EPS),
                     lambda: BN.bn_apply_plain(x, sums, w, b, rm, rv,
                                               BN_MOMENTUM, BN_EPS)),
        "bn_grad_stats": (lambda: BN.bn_grad_stats(dy, x, mean, invstd, w),
                          lambda: BN.bn_grad_stats_plain(dy, x, mean,
                                                         invstd, w)),
        "bn_grad_apply": (lambda: BN.bn_grad_apply(dy, x, gs, sums, mean,
                                                   invstd, w),
                          lambda: BN.bn_grad_apply_plain(dy, x, gs, sums,
                                                         mean, invstd, w)),
    }
    smean, sinv = torch.batch_norm_stats(x, BN_EPS)
    red = torch.batch_norm_backward_reduce(dy, x, smean, sinv, w, True,
                                           True, True)
    count = torch.full((1,), n, dtype=torch.int32, device="cuda")
    library = {
        "bn_stats": lambda: torch.batch_norm_stats(x, BN_EPS),
        "bn_apply": lambda: torch.batch_norm_elemt(x, w, b, smean, sinv,
                                                   BN_EPS),
        "bn_grad_stats": lambda: torch.batch_norm_backward_reduce(
            dy, x, smean, sinv, w, True, True, True),
        "bn_grad_apply": lambda: torch.batch_norm_backward_elemt(
            dy, x, smean, sinv, w, red[0], red[1], count),
    }
    xg = x.detach().requires_grad_(True)
    wg, bg = w.detach().requires_grad_(True), b.detach().requires_grad_(True)

    def f_forward():
        return F.batch_norm(xg, None, None, wg, bg, True, 0.1, BN_EPS)

    def f_both():
        torch.autograd.grad(f_forward(), (xg, wg, bg), dy)

    nbytes = {
        "bn_stats": x.numel() * x.element_size() + 8 * (2 * c + 1),
        "bn_apply": 2 * x.numel() * x.element_size() + 8 * (2 * c + 1)
        + 4 * 8 * c,
        "bn_grad_stats": 2 * x.numel() * x.element_size() + 8 * 2 * c
        + 4 * 4 * c,
        "bn_grad_apply": 3 * x.numel() * x.element_size() + 8 * (4 * c + 1)
        + 4 * 3 * c,
    }
    rows = {}
    for k, (kernel, plain) in calls.items():
        f32_ops, f64_ops = BN_OPS[k]
        t_bytes = nbytes[k] / HBM_BYTES_S * 1e3
        t_ops = (f32_ops * x.numel() / F32_FLOPS
                 + f64_ops * x.numel() / FP64_FLOPS) * 1e3
        ms = cuda_ms(kernel, 50, hold=True)
        rows[k] = dict(**errs[k], bit_identical_launches=repeat[k], ms=ms,
                       plain_ms=None, library_ms=None,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       bytes=nbytes[k])
        if yardsticks:
            rows[k].update(plain_ms=cuda_ms(plain, 10, hold=True),
                           library_ms=cuda_ms(library[k], 50, hold=True))
        rows[k]["bound_share"] = rows[k]["bound_ms"] / ms
    out = dict(case=name, shape=list(shape), dtype=str(dtype).split(".")[-1],
               layout=layout, kernels=rows,
               kernels_forward_ms=rows["bn_stats"]["ms"]
               + rows["bn_apply"]["ms"],
               kernels_forward_backward_ms=sum(r["ms"] for r in rows.values()),
               tolerance=dict(sum_rel=BN_SUM_REL, ulps=BN_ULPS))
    if yardsticks:
        y = torch.empty_like(x)
        rows["bn_apply"]["copy_ms"] = cuda_ms(lambda: y.copy_(x), 50,
                                              hold=True)
        rows["bn_grad_apply"]["add_ms"] = cuda_ms(
            lambda: torch.add(dy, x, out=y), 50, hold=True)
        out.update(f_batch_norm_forward_ms=cuda_ms(f_forward, 20, hold=True),
                   f_batch_norm_forward_backward_ms=cuda_ms(f_both, 20,
                                                            hold=True))
    # two launches bit for bit, the sums within BN_SUM_REL, every derived
    # output within BN_ULPS, the count exact
    out["ok"] = all(
        r["bit_identical_launches"] and r.get("sum_rel", 0.0) <= BN_SUM_REL
        and r.get("ulps", 0) <= BN_ULPS for r in rows.values()) and errs[
            "bn_stats"]["n_exact"]
    if strict:
        emit("batchnorm", **out)
        check(out["ok"], (name, float(sums[2 * c]), rows))
    return out


def _bn_host_us(seed: int, calls: int = 200) -> dict:
    """Microseconds a layer's train-mode forward and backward take on the
    host clock, through the kernels' Function and through
    ``F.batch_norm``, on layer 4's bf16 channels-last map: ``calls``
    calls queued back to back and one synchronise, so a call whose device
    work is shorter than its host work is timed at the host's pace."""
    t = _bn_inputs(BN_CASES[3][1], torch.bfloat16, "channels_last", seed)
    x = t["x"].detach().requires_grad_(True)
    w = t["w"].detach().requires_grad_(True)
    b = t["b"].detach().requires_grad_(True)

    def kernels():
        y = BN.BatchNormTrain.apply(x, w, b, t["rm"], t["rv"], BN_MOMENTUM,
                                    BN_EPS)[0]
        torch.autograd.grad(y, (x, w, b), t["dy"])

    def library():
        y = F.batch_norm(x, t["rm"].clone(), t["rv"].clone(), w, b, True,
                         1.0 - BN_MOMENTUM, BN_EPS)
        torch.autograd.grad(y, (x, w, b), t["dy"])

    out = {}
    for name, fn in (("kernels", kernels), ("f_batch_norm", library),
                     ("kernels_again", kernels)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
    return out


def bn_step_totals(cases) -> dict:
    """Per kernel, the ms of one ``train`` step's launches on its seven
    maps: Σ launches × ms over the cases in ``BN_STEP_LAUNCHES`` (bf16,
    channels-last), and the same sums of the bounds and of the one-call
    counterparts (None where one was not timed)."""
    step = [c for c in cases if c["dtype"] == "bfloat16"
            and c["layout"] == "channels_last"
            and tuple(c["shape"]) in BN_STEP_LAUNCHES]
    check(len(step) == len(BN_STEP_LAUNCHES), ("step maps", len(step)))
    out = {}
    for k in BN_KERNELS:
        sums = {}
        for f in ("ms", "bound_ms", "library_ms"):
            vals = [BN_STEP_LAUNCHES[tuple(c["shape"])] * c["kernels"][k][f]
                    for c in step if c["kernels"][k][f] is not None]
            sums[f] = sum(vals) if len(vals) == len(step) else None
        out[k] = sums
    return out


def phase_batchnorm(seed: int) -> dict:
    """Each batch-norm kernel against its plain version on ``BN_CASES``,
    the step-weighted totals (``bn_step_totals``) and a layer's host time
    (``_bn_host_us``); each kernel's row in the ``kernels`` line from the
    first case (the stem in bf16, channels-last: the train step's largest
    batch norm, as it runs)."""
    cases = [_bn_case(name, shape, dtype, layout, seed + i)
             for i, (name, shape, dtype, layout) in enumerate(BN_CASES)]
    emit("batchnorm_step", launches=[
        dict(shape=list(s), launches=n) for s, n in BN_STEP_LAUNCHES.items()],
         totals_ms=bn_step_totals(cases))
    emit("batchnorm_host", shape=list(BN_CASES[3][1]), dtype="bfloat16",
         layout="channels_last", forward_backward_us=_bn_host_us(seed))
    rows = {}
    for k in BN_KERNELS:
        first = cases[0]["kernels"][k]
        rows[k] = dict(
            name=k, route="cuda", source=SOURCES[k],
            replaces=K.KERNELS[k].replaces, launches=None,
            max_abs_err=max(c["kernels"][k]["max_abs_err"] for c in cases),
            ms=first["ms"], plain_ms=first["plain_ms"],
            bound_ms=first["bound_ms"], bound_by=first["bound_by"],
            bound_share=first["bound_share"],
            library_ms=first["library_ms"],
            library=f"torch.{LIBRARY_OF[k]}",
            shape=cases[0]["shape"], dtype=cases[0]["dtype"],
            layout=cases[0]["layout"],
            cases=[dict(case=c["case"], dtype=c["dtype"], layout=c["layout"],
                        **{f: c["kernels"][k][f] for f in (
                            "ms", "bound_ms", "library_ms", "max_abs_err")})
                   for c in cases])
        if k == "bn_apply":
            rows[k]["copy_ms"] = first["copy_ms"]
        if k == "bn_grad_apply":
            rows[k]["add_ms"] = first["add_ms"]
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
                model=None, transform=None, freeze_encoder: bool = False,
                bn_exact: bool = False, **extra) -> dict:
    """``steps`` train steps of ``cfg``'s model (``remat`` included; or
    ``model``, already on the card), loss (with its class weights),
    optimizer (the encoder frozen with ``freeze_encoder``), lr, its
    ``transform`` (``transforms:``) and augmentation on the fixed batch;
    the augmentation kernels' launch counts of the run must be ``expect``
    times ``steps`` (every other one 0), the batch norm's those of its
    train-mode calls (``bn_calls``; with ``bn_exact`` every layer once a
    step), and the loss finite and falling.  The
    kernels in ``hold`` are held bit for bit against their
    plain versions on the arguments the first step gave them, after the
    counts are read.  ``extra`` goes into the emitted line."""
    dev = imgs.device
    if model is None:
        model = MF.init_model(MF.create_model(
            cfg.architecture, cfg.backbone, cfg.classes, dtype=cfg.dtype,
            remat=cfg.remat), seed, dev)
    tx = OP.build_optimizer(cfg, freeze_encoder=freeze_encoder)
    state = ST.create_train_state(model, tx, dev)
    step = ST.build_train_step(
        model, tx, LO.build_loss(cfg.loss, cfg.activation, cfg.class_weights),
        {m: ME.get(m) for m in cfg.metrics}, cfg.activation, None,
        aug=(LW.build_augmentation(cfg.augmentation) if cfg.augmentation
             else None), transform=transform)
    batch = {"image": imgs, "mask": masks}
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    calls = {}
    K.reset_launches()
    with bn_calls() as bn_want:
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
               launches=launches, bn_layers=bn_layers(model),
               **{m: float(logs[m]) for m in cfg.metrics},
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               **extra)
    emit(name, **out)
    check(all(math.isfinite(v) for v in losses), ("finite loss", losses))
    check(statistics.mean(losses[-3:]) < losses[0], ("falling loss", losses))
    check_launches(name, launches, {n: steps * v for n, v in expect.items()},
                   bn_want)
    if bn_exact:
        # every layer once a step through each of the four kernels
        check(bn_want == {n: steps * bn_layers(model) for n in BN_KERNELS},
              (name, "batch norm calls", bn_want, bn_layers(model)))
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
        with bn_calls() as bn_want:
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
    check_launches("fit", launches, {"warp_x": steps, "warp_y": steps},
                   bn_want)
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
        with bn_calls() as bn_want:
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
    check_launches("fit_psp", launches, {}, bn_want)
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
    Adam) with a finite loss and no kernel launched but the batch norm's
    (``bn_calls``), and the bf16 eval forward's time (CUDA events, median
    of 10)."""
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
        with bn_calls() as bn_want:
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
        check_launches((backbone, variant), launches, {}, bn_want)
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


def block_launches(aug, h: int, w: int) -> dict:
    """The kernels ``aug`` launches once at H×W: those of each geometric
    run's route, children's included (a combinator runs every child)."""
    out = {n: 0 for n in K.KERNELS}
    for run in aug.geo_runs():
        for n in ROUTE_KERNELS[run.route(h, w)]:
            out[n] += 1
    return out


def _warps(seg, h: int, w: int) -> bool:
    """Whether a segment runs a warp at H×W (a geometric run past flips,
    or one in a combinator's child)."""
    runs = ([seg] if isinstance(seg, LW._GeoRun) else
            [r for ch in seg.children for r in ch.geo_runs()]
            if isinstance(seg, (LW._Meta, LW._Blend)) else [])
    return any(r.route(h, w) != "flips" for r in runs)


@contextlib.contextmanager
def cpu_geometry(shift: float = 0.0):
    """Every ``_GeoRun`` in a block computes its matrices and fields on
    the CPU from the CPU's copy of its draws, then moves them to the
    draws' device; ``shift`` px is added to each (a deliberate fault)."""
    original = LW._GeoRun.geometry

    def on_cpu(run, draws, b, h, w, device):
        mats, disp = original(run, _to(draws, "cpu"), b, h, w, "cpu")
        if shift:
            mats = WP.compose(WP.translation(torch.full((b,), shift),
                                             torch.full((b,), shift)), mats)
            disp = None if disp is None else tuple(v + shift for v in disp)
        return mats.to(device), (None if disp is None
                                 else tuple(v.to(device) for v in disp))

    LW._GeoRun.geometry = on_cpu
    try:
        yield
    finally:
        LW._GeoRun.geometry = original


def _head(draws, n: int, batch: int = BATCH):
    """``draws`` with every per-image tensor (batch first) cut to its
    first ``n`` images."""
    if isinstance(draws, dict):
        return {k: _head(v, n, batch) for k, v in draws.items()}
    if isinstance(draws, (list, tuple)):
        return [_head(v, n, batch) for v in draws]
    if isinstance(draws, torch.Tensor) and draws.dim() and \
            draws.shape[0] == batch:
        return draws[:n]
    return draws


def _names(seg) -> set:
    """The augmenter names a segment runs, its children's included."""
    if isinstance(seg, LW._GeoRun):
        return set(seg.names)
    kids = ([seg.child] if isinstance(seg, LW._Scope)
            and seg.name == "withchannels" else
            getattr(seg, "children", []))
    out = {seg.name}
    for ch in kids:
        out |= (set().union(*map(_names, ch.segments))
                if isinstance(ch, LW.Augmentation) else _names(ch))
    return out


def _vs(gi, gm, ci, cm) -> tuple:
    return float((gi.cpu() - ci).abs().max()), mask_mismatch(gm.cpu(), cm)


def _segments_vs_cpu(aug, draws, imgs, masks, card=None) -> list:
    """Each segment of ``aug`` on the card against the port on the CPU,
    both on the card's input to it and on the same draws: its errors and
    whether they are within its tolerance.  The card runs at the
    training path's TF32 settings (cuDNN's TF32 on): the augmenters turn
    it off where they need full f32.  ``card``, the card's output of a
    lone segment that does not warp, is compared instead of running the
    card again.  A segment that warps is also run on the card with the
    CPU's matrices and fields (``same_geometry_*``), and with them moved
    by WARP_FAULT_PX (``fault_max_err``, which must exceed
    REF_IMG_ATOL)."""
    rows = []
    x, m = imgs.cuda(), masks.cuda()
    if card is not None:
        check(len(aug.segments) == 1
              and not _warps(aug.segments[0], x.shape[1], x.shape[2]),
              "a card output is compared only for a lone segment that "
              "does not warp")
    for seg, d in zip(aug.segments, draws):
        gd = _to(d, "cuda")
        gi, gm = card if card is not None else seg.apply(gd, x, m)
        ci, cm = seg.apply(d, x.cpu(), m.cpu())
        err, mis = _vs(gi, gm, ci, cm)
        warps = _warps(seg, x.shape[1], x.shape[2])
        row = dict(segment=seg.name if hasattr(seg, "name")
                   else "+".join(seg.names), warps=warps,
                   cpu_max_err=err, cpu_mask_mismatch=mis)
        ok = mis == 0.0 and err <= (REF_IMG_ATOL if warps
                                    else PHOTO_IMG_ATOL)
        if _names(seg) & SEGMENT_NAMES:
            diff = (gi.cpu() - ci).abs()
            share = float((diff > SEGMENT_ATOL).float().mean())
            row.update(cpu_off_share=share,
                       cpu_off_share_1e3=float((diff > PHOTO_IMG_ATOL)
                                               .float().mean()),
                       off_atol=SEGMENT_ATOL, off_share_bound=SEGMENT_SHARE)
            ok = mis == 0.0 and (warps or share <= SEGMENT_SHARE)
        if warps:
            with cpu_geometry():
                same_err, same_mis = _vs(*seg.apply(gd, x, m), ci, cm)
            with cpu_geometry(WARP_FAULT_PX):
                fault_err, _ = _vs(*seg.apply(gd, x, m), ci, cm)
            row.update(same_geometry_max_err=same_err,
                       same_geometry_mask_mismatch=same_mis,
                       fault_px=WARP_FAULT_PX, fault_max_err=fault_err)
            ok = (ok and same_err <= PHOTO_IMG_ATOL and same_mis == 0.0
                  and fault_err > REF_IMG_ATOL)
        rows.append(dict(row, ok=ok))
        x, m = gi, gm
    return rows


def phase_photo_paths(seed: int) -> dict:
    """Each name of the slice alone through ``Augmentation.apply`` at 512²
    B16: its launches (those of its routes), each launch held bit for bit
    against its plain version, the block's ms (CUDA events, median of 10)
    and the card against the port on the CPU on the same draws
    (``_segments_vs_cpu``)."""
    out, failed = {}, []
    imgs, masks = synthetic_batch(BATCH, SIZE, SIZE, seed + 5)
    imgs, masks = torch.from_numpy(imgs), torch.from_numpy(masks)
    gi, gm = imgs.cuda(), masks.cuda()
    for case, spec in PHOTO_CASES:
        aug = LW.build_augmentation(spec)
        draws = aug.sample(torch.Generator().manual_seed(seed), BATCH, SIZE,
                           SIZE)
        gd = _to(draws, "cuda")
        K.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with captured(list(WRAPPERS), {}) as calls:
            out_i, out_m = aug.apply(gd, gi, gm)
        torch.cuda.synchronize()
        # the block's own peak, above what was resident before it
        peak_mib = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        launches = K.launch_counts()
        _check_augmented(out_i, out_m, case)
        want = block_launches(aug, SIZE, SIZE)
        check(launches == want, (case, launches, want))
        n = CPU_IMAGES if case in CPU_HEAD else BATCH
        (vs,) = _segments_vs_cpu(
            aug, _head(draws, n), imgs[:n], masks[:n],
            card=(out_i[:n], out_m[:n]) if case in CPU_HEAD else None)
        row = dict(launches={n: v for n, v in launches.items() if v},
                   held_to_plain=held_to_plain(calls, case),
                   block_ms=cuda_ms(lambda: aug.apply(gd, gi, gm), 10),
                   peak_mib=peak_mib, cpu_images=n,
                   masks_moved=not torch.equal(out_m, gm), **vs)
        if not vs["ok"]:
            failed.append(case)
        out[case] = row
        emit("photo_paths", case=case, **row)
    check(not failed, ("photo_paths card vs CPU", failed))
    return out


def phase_train_photo(imgs, masks, seed: int, profile: str) -> dict:
    """``train``'s model, loss, optimizer and batch under PHOTO_BLOCK,
    parsed by the port: the block's launches (X and Y for Rotate, elastic
    in the Sometimes child: once each a step), the block's ms and each of
    its segments in f32 on the card against the CPU on the same draws;
    then 10 bf16 train steps, X, Y and elastic held bit for bit on the
    first step's arguments."""
    cfg = CF.parse_dict({"architecture": "Unet", "backbone": "resnet34",
                         "loss": LOSS, "optimizer": "Adam", "lr": LR,
                         "batch": BATCH, "augmentation": PHOTO_BLOCK,
                         "metrics": ["dice", "iou"]})
    aug = LW.build_augmentation(cfg.augmentation)
    per_block = block_launches(aug, SIZE, SIZE)
    x_y_elastic = {"warp_x": 1, "warp_y": 1, "elastic": 1}
    check(per_block == {n: x_y_elastic.get(n, 0) for n in K.KERNELS},
          ("train_photo block launches", per_block))
    draws = aug.sample(torch.Generator().manual_seed(seed + 4), BATCH, SIZE,
                       SIZE)
    gd = _to(draws, "cuda")
    out_i, out_m = aug.apply(gd, imgs, masks)
    torch.cuda.synchronize()
    _check_augmented(out_i, out_m, "train_photo block")
    segments = _segments_vs_cpu(aug, draws, imgs, masks)
    block_ms = cuda_ms(lambda: aug.apply(gd, imgs, masks), 10)
    out = phase_train("train_photo", cfg, imgs, masks, STEPS, seed,
                      x_y_elastic, profile, hold=tuple(x_y_elastic),
                      block_ms=block_ms, segments_vs_cpu=segments,
                      routes=[r.route(SIZE, SIZE) for r in aug.geo_runs()])
    check(all(r["ok"] for r in segments),
          ("train_photo segments card vs CPU", segments))
    return out


def phase_train_filter(imgs, masks, seed: int, profile: str) -> dict:
    """``train``'s model, loss, optimizer and batch under FILTER_BLOCK,
    parsed by the port: X, Y and elastic once a step (one warp), each
    held bit for bit on the first step's arguments; each segment of the
    block (the OneOf runs all five filters on the batch) in f32 on the
    card against the CPU on the same draws; the block's ms, img/s, a
    falling loss and peak memory over 10 bf16 steps."""
    cfg = CF.parse_dict({"architecture": "Unet", "backbone": "resnet34",
                         "loss": LOSS, "optimizer": "Adam", "lr": LR,
                         "batch": BATCH, "augmentation": FILTER_BLOCK,
                         "metrics": ["dice", "iou"]})
    aug = LW.build_augmentation(cfg.augmentation)
    per_block = block_launches(aug, SIZE, SIZE)
    x_y_elastic = {"warp_x": 1, "warp_y": 1, "elastic": 1}
    check(per_block == {n: x_y_elastic.get(n, 0) for n in K.KERNELS},
          ("train_filter block launches", per_block))
    draws = aug.sample(torch.Generator().manual_seed(seed + 6), BATCH, SIZE,
                       SIZE)
    gd = _to(draws, "cuda")
    out_i, out_m = aug.apply(gd, imgs, masks)
    torch.cuda.synchronize()
    _check_augmented(out_i, out_m, "train_filter block")
    segments = _segments_vs_cpu(aug, draws, imgs, masks)
    block_ms = cuda_ms(lambda: aug.apply(gd, imgs, masks), 10)
    out = phase_train("train_filter", cfg, imgs, masks, STEPS, seed,
                      x_y_elastic, profile, hold=tuple(x_y_elastic),
                      block_ms=block_ms, segments_vs_cpu=segments,
                      routes=[r.route(SIZE, SIZE) for r in aug.geo_runs()])
    check(all(r["ok"] for r in segments),
          ("train_filter segments card vs CPU", segments))
    return out


def kitchen_batch(cfg, seed: int):
    """``cfg.batch`` synthetic 4-class items at ``cfg.shape`` on the card:
    the 3-class shapes (background, ellipse, rectangle) with a square of
    class 3 laid over each; uint8 images, one-hot float32 masks."""
    h = cfg.shape[0]
    ds = SY.generate_multiclass_shapes_dataset(cfg.batch, h, seed)
    r = np.random.RandomState(seed)
    imgs, masks = [], []
    for i in range(len(ds)):
        x, y = ds[i].x.copy(), ds[i].y.copy()
        side = int(r.randint(h // 8, h // 4))
        top, left = (int(v) for v in r.randint(0, h - side, 2))
        x[top:top + side, left:left + side] = r.randint(0, 256, 3)
        y[top:top + side, left:left + side] = 3
        imgs.append(x)
        masks.append(BA.prepare_mask(y, cfg.shape, cfg.classes,
                                     cfg.activation))
    return (torch.from_numpy(np.stack(imgs)).cuda(),
            torch.from_numpy(np.stack(masks)).cuda())


def phase_train_kitchen(seed: int, profile: str) -> dict:
    """``examples/kitchen_sink.yaml`` as the port parses it, unchanged:
    FPN-seresnext50 384² B32 with remat, 4-class softmax, its loss with
    class weights, AdamW, the encoder frozen (its first stage), its
    ``transforms:`` (Grayscale) and its whole block on synthetic 4-class
    data; the block once on the transformed batch (its ms, CUDA events,
    median of 10; the geometric run's route and launches; each segment
    on the card against the CPU on the first 4 images), then
    ``KITCHEN_STEPS`` train steps: a finite, falling loss, img/s, peak
    memory."""
    cfg = CF.parse(KITCHEN_YAML)
    check((cfg.architecture, cfg.backbone, cfg.shape, cfg.batch, cfg.classes,
           cfg.activation, cfg.remat, cfg.freeze_encoder, cfg.optimizer)
          == ("FPN", "seresnext50", (384, 384, 3), 32, 4, "softmax", True,
              True, "AdamW"), ("kitchen sink config", cfg.to_dict()))
    h, w = cfg.shape[:2]
    imgs, masks = kitchen_batch(cfg, seed + 8)
    aug, transform = LW.build_transform_fn(cfg.transforms, cfg.augmentation)
    ti, tm = transform(imgs, masks)
    draws = aug.sample(torch.Generator().manual_seed(seed + 9), cfg.batch, h,
                       w)
    gd = _to(draws, "cuda")
    K.reset_launches()
    out_i, out_m = aug.apply(gd, ti, tm)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    _check_augmented(out_i, out_m, "train_kitchen block")
    per_block = block_launches(aug, h, w)
    check(launches == per_block, ("train_kitchen block launches", launches,
                                  per_block))
    block_ms = cuda_ms(lambda: aug.apply(gd, ti, tm), 10)
    segments = _segments_vs_cpu(
        aug, _head(draws, CPU_IMAGES, cfg.batch), ti[:CPU_IMAGES].cpu(),
        tm[:CPU_IMAGES].cpu())
    model = MF.init_model(MF.model_from_config(cfg), seed, imgs.device)
    out = phase_train("train_kitchen", cfg, imgs, masks, KITCHEN_STEPS, seed,
                      per_block, profile, model=model, transform=transform,
                      freeze_encoder=cfg.freeze_encoder,
                      config=KITCHEN_YAML, block_ms=block_ms,
                      routes=[r.route(h, w) for r in aug.geo_runs()],
                      block_launches={n: v for n, v in launches.items()
                                      if v},
                      segments_vs_cpu=segments)
    check(all(r["ok"] for r in segments),
          ("train_kitchen segments card vs CPU", segments))
    return out


ACCURACY_SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "examples", "accuracy_evidence_torch.py")


def phase_accuracy(seed: int) -> dict:
    """``examples/accuracy_evidence_torch.py``'s config 1 (Unet-resnet34
    128², bce + 0.25·dice, the JAX script's dict) cut to 64 synthetic
    images and 2 epochs through its ``main`` on the card: its evaluate
    dict, every value finite and in [0, 1], and the launches (config 1
    has no augmentation block: the batch norm's only)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("accuracy_evidence_torch",
                                                  ACCURACY_SCRIPT)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    with tempfile.TemporaryDirectory() as tmp:
        K.reset_launches()
        with bn_calls() as bn_want:
            res = script.main(["--config", "1", "--n", "64", "--epochs",
                               "2", "--seed", str(seed), "--out", tmp])
        launches = K.launch_counts()
        with open(os.path.join(tmp, "run.json")) as f:
            seconds = json.load(f)["seconds"]
    ev = res[script.KEYS["1"]]
    check(set(ev) == {"iou", "dice"} and all(
        math.isfinite(v) and 0.0 <= v <= 1.0 for v in ev.values()),
        ("accuracy evaluate", ev))
    check_launches("accuracy", launches, {}, bn_want)
    out = dict(evaluate=ev, seconds=seconds[script.KEYS["1"]],
               launches=launches)
    emit("accuracy", **out)
    return out


# the train_ddp phase: DDP_WORLD gloo ranks share the one card (NCCL
# refuses two ranks on one device) and train ``train``'s model in f32
# with TF32 off, SGD at DDP_LR, the config-2 block, DDP_STEPS steps of the
# global batch BATCH, against the same run in one process; the bounds of
# tests/test_sharding.py (SGD, as there: Adam's first step is ±lr·sign(g)
# and turns reduction-order noise into 2·lr flips).  Each rank process
# has its own timeout and init timeout
DDP_WORLD, DDP_STEPS, DDP_LR, DDP_TIMEOUT_S = 2, 3, 1e-3, 600
DDP_LOSS_ATOL, DDP_PARAM_ATOL, DDP_STAT_ATOL = 1e-5, 5e-4, 1e-4
DDP_KERNELS = ("warp_x", "warp_y", "elastic")


def _ddp_steps(seed: int, mesh=None) -> dict:
    """DDP_STEPS f32 steps of Unet-resnet34 512² under the config-2 block
    from the seed's init, on the whole batch (``mesh`` None) or on this
    rank's rows; each step's loss (the rank's share), ms, the launches and
    all-reduces of the run, the first step's X, Y and elastic held to
    their plain versions, the BatchNorm statistics after the first step
    and the final variables, on the CPU."""
    cfg = CF.parse_dict({"architecture": "Unet", "backbone": "resnet34",
                         "loss": LOSS, "optimizer": "SGD", "lr": DDP_LR,
                         "dtype": "float32", "batch": BATCH,
                         "augmentation": CONFIG2_BLOCK})
    model = MF.init_model(MF.create_model("Unet", "resnet34", 1,
                                          dtype="float32"), seed, "cpu")
    tx = OP.build_optimizer(cfg)
    state = ST.create_train_state(model, tx, "cuda")
    step = ST.build_train_step(
        model, tx, LO.build_loss(cfg.loss, cfg.activation), {},
        cfg.activation, None, aug=LW.build_augmentation(CONFIG2_BLOCK),
        mesh=mesh)
    imgs, masks = synthetic_batch(BATCH, SIZE, SIZE, seed)
    batch = {"image": torch.from_numpy(imgs).cuda(),
             "mask": torch.from_numpy(masks).cuda(),
             "weight": torch.ones(BATCH, device="cuda")}
    if mesh is not None:
        batch = PM.shard_batch(batch, mesh)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    losses, times, calls = [], [], {}
    with no_tf32():
        K.reset_launches()
        DI.reset_counts()
        for i in range(DDP_STEPS):
            t0 = time.perf_counter()
            with captured(DDP_KERNELS if i == 0 else (), calls):
                state, logs = step(state, batch, DDP_LR, gen=gen)
            losses.append(float(logs["loss"]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                stats1 = {k: v.cpu() for k, v in state.batch_stats.items()}
        launches = K.launch_counts()
        counts = DI.counts()
    grad_bytes = sum(4 * state.params[k].numel()
                     for k in tx.trainable(state.params))
    return dict(loss=losses, step_ms=times, launches=launches,
                bn_layers=bn_layers(model),
                all_reduces_per_step=counts["all_reduce"] / DDP_STEPS,
                all_reduce_bytes_per_step=counts["bytes"] / DDP_STEPS,
                grad_all_reduce_bytes_per_step=grad_bytes,
                held_to_plain=held_to_plain(calls, "train_ddp"),
                stats_step1=stats1,
                params={k: v.cpu() for k, v in state.params.items()},
                stats={k: v.cpu() for k, v in state.batch_stats.items()})


def _spawn_ranks(mode: str, out: str, *extra: str,
                 world: int = DDP_WORLD) -> list:
    """Run ``world`` ``--ddp-worker`` processes of this script (gloo, one
    file store in ``out``), each waited for with its own timeout and
    killed on failure; their outputs."""
    store = os.path.join(out, f"store-{mode}")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--ddp-worker", mode,
         str(r), str(world), store, out, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DDP_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, o) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, (mode, f"rank {r}", o[-3000:]))
    return outs


def _max_diff(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def _rows_augment_alike(seed: int) -> bool:
    """Each rank's rows of the config-2 block on the card (its ``take`` of
    the global draws) equal the whole batch's rows bit for bit."""
    aug = LW.build_augmentation(CONFIG2_BLOCK)
    imgs, masks = synthetic_batch(BATCH, SIZE, SIZE, seed)
    imgs, masks = torch.from_numpy(imgs).cuda(), torch.from_numpy(masks).cuda()
    draws = aug.sample(torch.Generator(device="cuda").manual_seed(seed + 2),
                       BATCH, SIZE, SIZE)
    out_i, out_m = aug.apply(draws, imgs, masks)
    per = BATCH // DDP_WORLD
    for r in range(DDP_WORLD):
        rows = slice(r * per, (r + 1) * per)
        ri, rm = aug.apply(aug.take(draws, rows), imgs[rows], masks[rows])
        if not (torch.equal(ri, out_i[rows]) and torch.equal(rm,
                                                             out_m[rows])):
            return False
    return True


def phase_train_ddp(seed: int) -> dict:
    """Two gloo ranks on the card against one process (see DDP_WORLD)."""
    rows_alike = _rows_augment_alike(seed)
    one = _ddp_steps(seed)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        _spawn_ranks("train", tmp, str(seed))
        ranks = [torch.load(os.path.join(tmp, f"train-{r}.pt"))
                 for r in range(DDP_WORLD)]
    loss = [sum(r["loss"][i] for r in ranks) for i in range(DDP_STEPS)]
    r0, r1 = ranks[0], ranks[1]
    out = dict(
        model="Unet-resnet34", dtype="float32", tf32=False, optimizer="SGD",
        lr=DDP_LR, batch=BATCH, rows_per_rank=BATCH // DDP_WORLD,
        size=[SIZE, SIZE], steps=DDP_STEPS, world=DDP_WORLD,
        backend="gloo (rehearsal: two ranks share one card)",
        loss_one_process=one["loss"], loss_ranks=loss,
        loss_max_diff=max(abs(a - b) for a, b in zip(loss, one["loss"])),
        param_max_diff=_max_diff(r0["params"], one["params"]),
        stat_max_diff=_max_diff(r0["stats"], one["stats"]),
        stat_max_diff_step1=_max_diff(r0["stats_step1"],
                                      one["stats_step1"]),
        rows_augmented_bit_equal=rows_alike,
        stat_worst=sorted(([k, float((r0["stats"][k] - one["stats"][k])
                                     .abs().max()),
                            float(one["stats"][k].abs().max())]
                           for k in one["stats"]),
                          key=lambda t: -t[1])[:3],
        ranks_bit_equal=all(torch.equal(r0[p][k], r1[p][k])
                            for p in ("params", "stats") for k in r0[p]),
        step_ms_one_process=one["step_ms"],
        step_ms_ranks=[r["step_ms"] for r in ranks],
        all_reduces_per_step=[r["all_reduces_per_step"] for r in ranks],
        all_reduce_bytes_per_step=[r["all_reduce_bytes_per_step"]
                                   for r in ranks],
        grad_all_reduce_bytes_per_step=r0["grad_all_reduce_bytes_per_step"],
        launches_one_process=one["launches"],
        launches_per_rank=[r["launches"] for r in ranks],
        held_to_plain_per_rank=[r["held_to_plain"] for r in ranks],
        tolerance=dict(loss=DDP_LOSS_ATOL, params=DDP_PARAM_ATOL,
                       stats=DDP_STAT_ATOL))
    emit("train_ddp", **out)
    # Unet-resnet34, every parameter trained: each layer once a step
    # through each batch-norm kernel, as ``train`` checks
    bn = {n: DDP_STEPS * one["bn_layers"] for n in BN_KERNELS}
    for r in ranks + [one]:
        check_launches("train_ddp", r["launches"],
                       {n: DDP_STEPS for n in DDP_KERNELS}, bn)
    check(out["loss_max_diff"] < DDP_LOSS_ATOL, ("train_ddp loss", loss,
                                                 one["loss"]))
    check(out["param_max_diff"] < DDP_PARAM_ATOL,
          ("train_ddp params", out["param_max_diff"]))
    check(out["stat_max_diff"] < DDP_STAT_ATOL,
          ("train_ddp BN statistics", out["stat_max_diff"]))
    check(out["ranks_bit_equal"], "train_ddp: the ranks' parameters differ")
    check(rows_alike, "train_ddp: a rank's augmented rows differ")
    return out


# the train_space phase: the space axis, JAX's flagship
# (tests/test_sharding.py::test_flagship_shape_space2_matches_single_device):
# Unet-resnet34 512², f32 with TF32 off, bce, SGD at SPACE_LR, global
# batch SPACE_BATCH, on SPACE_DATA × SPACE_SPACE gloo ranks sharing the
# card, against the same step in one process.  Every process takes
# BatchNorm's statistics by one formula (models/batchnorm.py's kernels),
# as JAX's single-device and sharded steps do, so the ranks are held to
# the one-process step with every bar of the flagship: loss rtol 2e-5 /
# atol 2e-6, the stem and up5.conv2 kernels rtol 1e-4 / atol 1e-6, every
# parameter within 5e-4 and BatchNorm statistic within 1e-4, every
# tensor's gradient (a step at lr 1: its update) within 10% of its norm
# or 1e-5 of the median tensor's (a doubled or halved gradient fails for
# every tensor above that floor).  "solo", one rank in a group of one,
# checks that a group of one computes what one process computes (the
# same bars; whether bit for bit is reported, beside how far two runs of
# the one-process step lie apart: the step's convolution and upsampling
# backward kernels need not repeat bit for bit, so neither need a group
# of one).  The stem gradients of
# the three runs against the same step in float64 are printed as the
# witness of float32 rounding (at this init the stem gradient is
# ill-conditioned: two float32 formulas of batch norm were 0.3% of its
# norm apart); then SPACE_BLOCK_STEPS steps under the config-2 block:
# its kernels on every rank's whole images, bit for bit with their plain
# versions, and its first step's loss
SPACE_DATA, SPACE_SPACE, SPACE_BATCH, SPACE_LR = 2, 2, 4, 1e-2
SPACE_BLOCK_STEPS = 2
SPACE_LOSS = "binary_crossentropy"
SPACE_LOSS_RTOL, SPACE_LOSS_ATOL = 2e-5, 2e-6
SPACE_KERNEL_RTOL, SPACE_KERNEL_ATOL = 1e-4, 1e-6
SPACE_STEM, SPACE_UP5 = ("encoder.stem_conv.weight",
                         "decoder.up5.conv2.conv.weight")
SPACE_GRAD_NORM_REL, SPACE_GRAD_FLOOR = 0.1, 1e-5


def _space_model(seed: int):
    """The seed's Unet-resnet34 init on the CPU, its config, optimizer and
    loss, and the global batch on the card."""
    cfg = CF.parse_dict({"architecture": "Unet", "backbone": "resnet34",
                         "loss": SPACE_LOSS, "optimizer": "SGD",
                         "lr": SPACE_LR, "dtype": "float32",
                         "batch": SPACE_BATCH})
    model = MF.init_model(MF.create_model("Unet", "resnet34", 1,
                                          dtype="float32"), seed, "cpu")
    imgs, masks = synthetic_batch(SPACE_BATCH, SIZE, SIZE, seed)
    batch = {"image": torch.from_numpy(imgs).cuda(),
             "mask": torch.from_numpy(masks).cuda(),
             "weight": torch.ones(SPACE_BATCH, device="cuda")}
    return (cfg, model, OP.build_optimizer(cfg),
            LO.build_loss(cfg.loss, cfg.activation), batch)


def _space_steps(seed: int, mesh=None) -> dict:
    """From the seed's Unet-resnet34 init, on the whole global batch
    (``mesh`` None) or on this rank's rows and slab: one plain SGD step at
    SPACE_LR, one at lr 1 (its update is the gradient), then
    SPACE_BLOCK_STEPS steps under the config-2 block; each step's loss
    (the rank's logs) and ms, the collectives of the plain step, the
    block's launches with its first step's X, Y and elastic held to their
    plain versions; the variables on the CPU."""
    cfg, model, tx, loss_fn, batch = _space_model(seed)
    plain = ST.build_train_step(model, tx, loss_fn, {}, cfg.activation,
                                None, mesh=mesh)
    block = ST.build_train_step(model, tx, loss_fn, {}, cfg.activation,
                                None, aug=LW.build_augmentation(
                                    CONFIG2_BLOCK), mesh=mesh)
    init = ST.create_train_state(model, tx, "cuda")
    if mesh is not None:
        batch = PM.shard_batch(batch, mesh)

    def run(step, state, lr, **kw):
        t0 = time.perf_counter()
        state, logs = step(state, batch, lr, **kw)
        loss = float(logs["loss"])    # waits for the step's last kernel
        return state, loss, (time.perf_counter() - t0) * 1e3

    cpu = lambda d: {k: v.cpu() for k, v in d.items()}  # noqa: E731
    out = {}
    with no_tf32():
        DI.reset_counts()
        new, out["loss"], ms = run(plain, init, SPACE_LR)
        out["counts"], out["space_counts"] = DI.counts(), DI.space_counts()
        out["params"], out["stats"] = cpu(new.params), cpu(new.batch_stats)
        grad, _, ms1 = run(plain, init, 1.0)
        out["grads"] = {k: (init.params[k] - grad.params[k]).cpu()
                        for k in grad.params}
        gen = torch.Generator(device="cuda").manual_seed(seed + 2)
        K.reset_launches()
        calls, state, losses, times = {}, init, [], []
        for i in range(SPACE_BLOCK_STEPS):
            with captured(DDP_KERNELS if i == 0 else (), calls):
                state, loss, t = run(block, state, SPACE_LR, gen=gen)
            losses.append(loss)
            times.append(t)
        out["launches"] = K.launch_counts()
    out.update(step_ms=[ms, ms1], block_loss=losses, block_step_ms=times,
               bn_layers=bn_layers(model),
               held_to_plain=held_to_plain(calls, "train_space"),
               block_params=cpu(state.params))
    return out


def _space_grads_f64(seed: int) -> dict:
    """The plain step's gradient (its update at lr 1) from the same init
    and batch in one process with every layer in float64 (the head's
    logits and the loss stay float32): the witness of how far float32
    rounding moves each float32 step."""
    cfg, model, tx, loss_fn, batch = _space_model(seed)
    model.double()
    model.dtype = torch.float64       # the input's cast and every layer
    step = ST.build_train_step(model, tx, loss_fn, {}, cfg.activation,
                               None)
    init = ST.create_train_state(model, tx, "cuda")
    grad, _ = step(init, batch, 1.0)
    return {k: (init.params[k] - grad.params[k]).cpu() for k in grad.params}


def _grad_misses(got: dict, want: dict) -> list:
    """Tensors whose gradient is farther from ``want``'s than
    SPACE_GRAD_NORM_REL of its norm and the floor."""
    norms = {k: float(v.norm()) for k, v in want.items()}
    floor = SPACE_GRAD_FLOOR * float(np.median(list(norms.values())))
    return [(k, float((got[k] - want[k]).norm()), norms[k]) for k in want
            if float((got[k] - want[k]).norm())
            > max(SPACE_GRAD_NORM_REL * norms[k], floor)]


def _space_ranks(seed: int, data: int, space: int) -> list:
    """:func:`_space_steps` on ``data × space`` gloo ranks."""
    with tempfile.TemporaryDirectory() as tmp:
        _spawn_ranks("space", tmp, str(seed), str(data), str(space),
                     world=data * space)
        return [torch.load(os.path.join(tmp, f"space-{r}.pt"))
                for r in range(data * space)]


def _kernel_over(got: torch.Tensor, ref: torch.Tensor) -> float:
    """How far the worst element of ``got`` lies past the kernel bar
    around ``ref`` (≤ 0: within it)."""
    return float(((got - ref).abs() - SPACE_KERNEL_ATOL
                  - SPACE_KERNEL_RTOL * ref.abs()).max())


def phase_train_space(seed: int) -> dict:
    """SPACE_DATA × SPACE_SPACE gloo ranks (``--ddp-worker space``) on the
    card against one process; "solo", one rank in a group of one, against
    the same; the float64 witness (see SPACE_DATA)."""
    one = _space_steps(seed)
    one_again = _space_steps(seed)
    f64 = _space_grads_f64(seed)
    torch.cuda.empty_cache()
    solo = _space_ranks(seed, 1, 1)[0]
    world = SPACE_DATA * SPACE_SPACE
    ranks = _space_ranks(seed, SPACE_DATA, SPACE_SPACE)
    r0 = ranks[0]
    # the group's logs count once: the ranks' losses sum to the batch's
    loss = sum(r["loss"] for r in ranks)
    block_loss = [sum(r["block_loss"][i] for r in ranks)
                  for i in range(SPACE_BLOCK_STEPS)]
    norms = [float(v.norm()) for v in one["grads"].values()]
    grad_floor = SPACE_GRAD_FLOOR * float(np.median(norms))

    def rel(got, ref, k):
        return float((got[k] - ref[k]).norm() / ref[k].norm())

    def against(run: dict, run_loss: float, run_block_loss: list) -> dict:
        rels = {k: rel(run["grads"], one["grads"], k) for k in one["grads"]
                if float(one["grads"][k].norm()) > grad_floor}
        return dict(
            loss=run_loss, loss_diff=abs(run_loss - one["loss"]),
            block_loss=run_block_loss,
            kernel_max_diff={k: float((run["params"][k] - one["params"][k])
                                      .abs().max())
                             for k in (SPACE_STEM, SPACE_UP5)},
            kernel_over_bar={k: _kernel_over(run["params"][k],
                                             one["params"][k])
                             for k in (SPACE_STEM, SPACE_UP5)},
            param_max_diff=_max_diff(run["params"], one["params"]),
            stat_max_diff=_max_diff(run["stats"], one["stats"]),
            grad_norm_rel_worst=sorted(rels.items(),
                                       key=lambda t: -t[1])[:3],
            grad_misses=_grad_misses(run["grads"], one["grads"])[:5])

    vs = {"ranks": against(r0, loss, block_loss),
          "solo": against(solo, solo["loss"], solo["block_loss"])}

    def bit_equal(run: dict) -> bool:
        return all(torch.equal(run[p][k], one[p][k])
                   for p in ("params", "stats", "grads", "block_params")
                   for k in one[p])

    def kernel_diffs(run: dict) -> dict:
        return {k: float((run["params"][k] - one["params"][k]).abs().max())
                for k in (SPACE_STEM, SPACE_UP5)}
    stem_vs_f64 = {name: rel(run["grads"], f64, SPACE_STEM)
                   for name, run in (("one", one), ("solo", solo),
                                     ("ranks", r0))}
    out = dict(
        model="Unet-resnet34", dtype="float32", tf32=False, optimizer="SGD",
        lr=SPACE_LR, loss_fn=SPACE_LOSS, batch=SPACE_BATCH,
        size=[SIZE, SIZE],
        mesh={"data": SPACE_DATA, "space": SPACE_SPACE}, world=world,
        backend="gloo (rehearsal: four ranks share one card)",
        slab_rows=SIZE // SPACE_SPACE, loss_one_process=one["loss"],
        block_loss_one_process=one["block_loss"],
        step_ms_one_process=one["step_ms"],
        block_step_ms_one_process=one["block_step_ms"],
        ranks_against_one=vs["ranks"], solo_against_one=vs["solo"],
        solo_bit_equal_one=bit_equal(solo),
        one_process_twice=dict(bit_equal=bit_equal(one_again),
                               kernel_max_diff=kernel_diffs(one_again),
                               param_max_diff=_max_diff(one_again["params"],
                                                        one["params"])),
        stem_grad_rel_to_float64=stem_vs_f64,
        grad_floor=grad_floor,
        grad_tensors_below_floor=sum(n <= grad_floor for n in norms),
        ranks_bit_equal=all(torch.equal(r0[p][k], r[p][k])
                            for r in ranks[1:]
                            for p in ("params", "stats", "block_params")
                            for k in r0[p]),
        step_ms_ranks=[r["step_ms"] for r in ranks],
        block_step_ms_ranks=[r["block_step_ms"] for r in ranks],
        all_reduces_per_step=[r["counts"]["all_reduce"] for r in ranks],
        all_reduce_bytes_per_step=[r["counts"]["bytes"] for r in ranks],
        space_per_step=[r["space_counts"] for r in ranks],
        launches_one_process=one["launches"], launches_solo=solo["launches"],
        launches_per_rank=[r["launches"] for r in ranks],
        held_to_plain_per_rank=[r["held_to_plain"] for r in ranks],
        tolerance=dict(loss=[SPACE_LOSS_RTOL, SPACE_LOSS_ATOL],
                       kernels=[SPACE_KERNEL_RTOL, SPACE_KERNEL_ATOL],
                       params=DDP_PARAM_ATOL, stats=DDP_STAT_ATOL,
                       grad_norm_rel=SPACE_GRAD_NORM_REL,
                       grad_floor_of_median=SPACE_GRAD_FLOOR))
    emit("train_space", **out)
    bn = {n: SPACE_BLOCK_STEPS * one["bn_layers"] for n in BN_KERNELS}
    for r in ranks + [solo, one]:
        check_launches("train_space", r["launches"],
                       {n: SPACE_BLOCK_STEPS for n in DDP_KERNELS}, bn)

    def close(got, ref, rtol, atol):
        return abs(got - ref) <= atol + rtol * abs(ref)

    for name, v in vs.items():
        check(close(v["loss"], one["loss"], SPACE_LOSS_RTOL,
                    SPACE_LOSS_ATOL),
              ("train_space loss", name, v["loss"], one["loss"]))
        # the block's first step from the shared init; the second's loss
        # is reported, not held: one update's rounding moves the next
        # step's gradients far (on the CPU at 64², 30% of their norm in a
        # data-parallel step without the space axis, 8% with it)
        check(close(v["block_loss"][0], one["block_loss"][0],
                    SPACE_LOSS_RTOL, SPACE_LOSS_ATOL),
              ("train_space block loss", name, v["block_loss"],
               one["block_loss"]))
        for k in (SPACE_STEM, SPACE_UP5):
            check(v["kernel_over_bar"][k] <= 0.0,
                  ("train_space kernel", k, name, v["kernel_max_diff"][k]))
        check(v["param_max_diff"] < DDP_PARAM_ATOL,
              ("train_space params", name, v["param_max_diff"]))
        check(v["stat_max_diff"] < DDP_STAT_ATOL,
              ("train_space BN statistics", name, v["stat_max_diff"]))
        check(not v["grad_misses"],
              ("train_space gradients", name, v["grad_misses"]))
    check(out["ranks_bit_equal"],
          "train_space: the ranks' parameters differ")
    # one all-reduce of each layer's sums forward and backward, one of the
    # gradients
    check(all(r["counts"]["all_reduce"] == 2 * one["bn_layers"] + 1
              for r in ranks), ("train_space all-reduces",
                                out["all_reduces_per_step"]))
    check(all(r["space_counts"]["halo"] > 0 for r in ranks),
          ("train_space halos", out["space_per_step"]))
    return out


def _fit_yaml(path: str, profile: str = "") -> None:
    """``FIT_YAML`` with its epochs cut to ``FIT_EPOCHS`` (and the fit's
    own ``profile:`` trace written under ``profile``, if given), written to
    ``path`` (its directory is the experiment's)."""
    import yaml

    with open(FIT_YAML) as f:
        d = yaml.safe_load(f)
    for s, e in zip(d["stages"], FIT_EPOCHS):
        s["epochs"] = e
    if profile:
        d["profile"] = profile
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(d, f)


def _steady_step_ms(timings: list) -> float:
    """``phase_fit``'s steady step ms: the epochs after each stage's first,
    each less its wait for its first batch."""
    steady = [t for t in timings if t["epoch"] > 0]
    return (sum(t["train_s"] - t["first_batch_s"] for t in steady)
            / sum(t["steps"] for t in steady) * 1e3)


def phase_fit_ddp(seed: int, fit: dict, profile: bool = False) -> dict:
    """Config 4 as ``phase_fit`` cuts it: the CLI's ``fit`` under
    ``torch.distributed.run`` at world size 1 (NCCL), then the same fit on
    two gloo ranks sharing the card, and that fit again, which skips.
    ``profile``: the NCCL fit traces epoch 1 of each stage, as ``fit``
    does, for its device busy and idle share."""
    with tempfile.TemporaryDirectory() as tmp:
        h = CF.parse(FIT_YAML).shape[0]
        images, masks = SY.write_shapes_dataset(
            os.path.join(tmp, "data"), FIT_IMAGES, h, seed, p_empty=FIT_EMPTY)
        yml = os.path.join(tmp, "nccl", "cfg.yaml")
        traces = os.path.join(tmp, "profile") if profile else ""
        _fit_yaml(yml, traces)
        times = os.path.join(tmp, "timings.json")
        t0 = time.perf_counter()
        # its own session, so a timeout ends torchrun's workers with it
        run = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "1", "-m",
             "segmentation_training_pipeline_tpu_torch", "fit", yml,
             "--images", images, "--masks", masks, "--folds", "0",
             "--timings", times], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            stdout, stderr = run.communicate(timeout=DDP_TIMEOUT_S)
        finally:
            if run.poll() is None:
                os.killpg(run.pid, signal.SIGKILL)
                run.communicate()
        nccl_s = time.perf_counter() - t0
        check(run.returncode == 0, ("fit_ddp torchrun", stdout[-2000:],
                                    stderr[-3000:]))
        with open(times) as f:
            timings = json.load(f)
        busy = {s: _trace_busy_s(os.path.join(traces, f"fold0.stage{s}"))
                for s in range(len(FIT_EPOCHS))} if profile else {}
        epoch1 = {t["stage"]: t for t in timings if t["epoch"] == 1}
        nccl = CF.parse(yml)
        nccl_files = _fit_files(nccl)
        gloo_yml = os.path.join(tmp, "gloo", "cfg.yaml")
        _fit_yaml(gloo_yml)
        t0 = time.perf_counter()
        _spawn_ranks("fit", tmp, gloo_yml, images, masks)
        gloo_s = time.perf_counter() - t0
        gloo = CF.parse(gloo_yml)
        gloo_files = _fit_files(gloo)
        summaries = []
        for r in range(DDP_WORLD):
            with open(os.path.join(tmp, f"fit-{r}.json")) as f:
                summaries.append(json.load(f))
    keys = [f"fold0.stage{s}" for s in range(len(FIT_EPOCHS))]
    out = dict(
        config=FIT_YAML, reduced={"epochs": list(FIT_EPOCHS)},
        images=FIT_IMAGES,
        nccl_world1=dict(launcher="torch.distributed.run --nproc-per-node 1",
                         seconds=nccl_s,
                         steady_step_ms=_steady_step_ms(timings),
                         traced_epoch1_device_busy_s=busy or None,
                         traced_epoch1_idle_share={
                             s: 1.0 - b / (epoch1[s]["train_s"]
                                           + epoch1[s]["val_s"])
                             for s, b in busy.items()} or None,
                         files=nccl_files),
        fit_steady_step_ms=fit["steady_step_ms_after_first_batch"],
        fit_traced_epoch1_idle_share=fit["traced_epoch1_idle_share"],
        gloo_world2=dict(seconds=gloo_s, files=gloo_files,
                         best=[s["first"][k]["best"] for s in summaries
                               for k in keys],
                         steady_step_ms=[s["steady_step_ms"]
                                         for s in summaries],
                         refit=[s["again"] for s in summaries]))
    out["nccl_world1_over_fit_step"] = (out["nccl_world1"]["steady_step_ms"]
                                        / out["fit_steady_step_ms"])
    emit("fit_ddp", **out)
    for files in (nccl_files, gloo_files):
        check(all(files.values()), ("fit_ddp files", files))
    for s in summaries:
        check(list(s["again"]) == keys and all(
            s["again"][k].get("skipped") is True for k in keys),
            ("fit_ddp refit", s["again"]))
    check(summaries[0]["first"] == summaries[1]["first"],
          ("fit_ddp ranks' summaries", summaries))
    return out


def _fit_files(cfg) -> dict:
    """Each file of the JAX layout a fold-0 fit writes: present and done."""
    out = {}
    for s in range(len(FIT_EPOCHS)):
        w = cfg.weights_path(0, s)
        meta = CK.checkpoint_meta(w) or {}
        out[os.path.relpath(w, cfg.directory)] = (
            os.path.exists(w) and meta.get("done") is True)
        out[os.path.relpath(cfg.metrics_path(0, s), cfg.directory)] = \
            os.path.exists(cfg.metrics_path(0, s))
    return out


def _forbid_writes() -> None:
    """A non-primary rank's checkpoint, CSV and event-file writers raise
    if called: primary-only IO by construction."""
    from segmentation_training_pipeline_tpu_torch.utils import tfevents

    def forbidden(*a, **k):
        raise RuntimeError("a non-primary rank wrote a checkpoint")

    class Forbidden:
        def __init__(self, *a, **k):
            raise RuntimeError("a non-primary rank opened a writer")

    SG.save_checkpoint = forbidden
    SG.cb.CSVLogger = Forbidden
    tfevents.EventFileWriter = Forbidden


def ddp_worker(argv) -> int:
    """One gloo rank of ``train_ddp``, ``fit_ddp`` or ``train_space`` on
    the card."""
    mode, rank, world, store, out, *rest = argv
    rank = int(rank)
    DI.maybe_initialize(force=True, backend="gloo",
                        init_method=f"file://{store}",
                        world_size=int(world), rank=rank,
                        timeout_s=DDP_TIMEOUT_S)
    if mode == "space":
        seed, data, space = rest
        mesh = PM.build_mesh(PM.MeshSpec(data=int(data), space=int(space)))
        torch.save(_space_steps(int(seed), mesh),
                   os.path.join(out, f"space-{rank}.pt"))
        DI.shutdown()
        return 0
    mesh = PM.build_mesh()
    if mode == "train":
        torch.save(_ddp_steps(int(rest[0]), mesh),
                   os.path.join(out, f"train-{rank}.pt"))
    else:
        yml, images, masks = rest
        if rank != 0:
            _forbid_writes()
        cfg = CF.parse(yml)
        ds = DirectoryDataSet(images, masks)
        timings = []
        first = cfg.fit(ds, foldsToExecute=[0], verbose=0, timings=timings)
        again = cfg.fit(ds, foldsToExecute=[0], verbose=0)
        with open(os.path.join(out, f"fit-{rank}.json"), "w") as f:
            json.dump({"first": first, "again": again,
                       "steady_step_ms": _steady_step_ms(timings)}, f)
    DI.shutdown()
    return 0


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
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--ddp-worker"]:
        return ddp_worker(argv[1:])
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
    rows.update(timed("batchnorm", phase_batchnorm, SEED))
    paths = timed("warp_paths", phase_warp_paths, aug, imgs, masks, draws)

    unet = CF.parse_dict({"architecture": "Unet", "backbone": "resnet34",
                          "loss": LOSS, "optimizer": "Adam", "lr": LR,
                          "batch": BATCH, "augmentation": CONFIG2_BLOCK,
                          "metrics": ["dice", "iou"]})
    x_y_elastic = {"warp_x": 1, "warp_y": 1, "elastic": 1}
    train = timed("train", phase_train, "train", unet, imgs, masks, STEPS,
                  SEED, x_y_elastic, a.profile, bn_exact=True)
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
    fit = timed("fit", phase_fit, SEED, bool(a.profile))
    timed("fit_psp", phase_fit_psp, SEED, bool(a.profile))
    timed("pretrained", phase_pretrained, imgs, masks, SEED,
          _profile_path(a.profile, "pretrained"))
    timed("geo_paths", phase_geo_paths, SEED)
    photo = timed("train_photo", phase_train_photo, imgs, masks, SEED,
                  _profile_path(a.profile, "photo"))
    timed("photo_paths", phase_photo_paths, SEED)
    filt = timed("train_filter", phase_train_filter, imgs, masks, SEED,
                 _profile_path(a.profile, "filter"))
    kitchen = timed("train_kitchen", phase_train_kitchen, SEED,
                    _profile_path(a.profile, "kitchen"))
    timed("accuracy", phase_accuracy, SEED)
    ddp = timed("train_ddp", phase_train_ddp, SEED)
    timed("fit_ddp", phase_fit_ddp, SEED, fit, bool(a.profile))
    space = timed("train_space", phase_train_space, SEED)
    # launches on each kernel's main path: X, Y and elastic in the Unet
    # step, YE in the FPN step, the shear in the unfused warp path
    launches = dict(train["launches"], warp_ye=train_fpn["launches"][
        "warp_ye"], shear=paths["unfused"]["launches"]["shear"])
    for name, row in rows.items():
        row["launches"] = launches[name]
        row["launches_train_photo"] = photo["launches"][name]
        row["launches_train_filter"] = filt["launches"][name]
        row["launches_train_kitchen"] = kitchen["launches"][name]
        row["launches_train_ddp_per_rank"] = [
            r[name] for r in ddp["launches_per_rank"]]
        row["launches_train_space_per_rank"] = [
            r[name] for r in space["launches_per_rank"]]
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
