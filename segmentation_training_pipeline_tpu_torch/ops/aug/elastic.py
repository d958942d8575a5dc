"""Bounded-displacement joint resample (the elastic warp).

Counterpart of ``segmentation_training_pipeline_tpu/ops/aug/
pallas_elastic.py`` (``elastic_resample_joint_tpu`` /
``warp_elastic_joint``).  Displacements are bounded (|d| ≤ K, a static
bound from the config), and the resample is SEPARABLE, as on the TPU:

  row(y, x') = y-blend of rows y + iy and y + iy + 1 at column x', with
               (iy, fy) from dy at (y, x') — that column's own dy;
  out(y, x)  = x-blend of row(y, x + ix) and row(y, x + ix + 1), with
               (ix, fx) from dx at (y, x).

Displacements are clamped so every tap stays in the frame; an integer
offset outside [-K, K] contributes 0; a pixel whose unclamped source lies
outside the frame gets ``fill``.  Image channels blend bilinearly, mask
channels take the rounded tap (floor(f + 0.5)) from the same blends.

The CUDA kernel lives in ``csrc/elastic.cu``; its plain PyTorch version
below runs for CPU tensors only, and a CUDA tensor launches the kernel or
raises.  The kernel keeps full-width rows of dy, dx and the row blends in
one block's shared memory, so the wrapper refuses a row too wide for it.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ... import kernels as K
from .fused_warp import elastic_tail_plain, joint_planes, split_planes

Tensor = torch.Tensor


def elastic_resample_plain(planes: Tensor, flags: Tensor, dy: Tensor,
                           dx: Tensor, k: int, fill: float = 0.0) -> Tensor:
    """Plain PyTorch elastic resample: planes (B, C, H, W) f32, flags (C,)
    i32 (non-zero = nearest channel), dy/dx (B, H, W) f32 → (B, C, H, W)."""
    padded = F.pad(planes, (0, 0, 0, 1), value=fill)   # row H reads fill
    near = (flags != 0).view(1, -1, 1, 1)
    return elastic_tail_plain(padded, 0, near, dy, dx, k, fill)


def elastic_resample(planes: Tensor, flags: Tensor, dy: Tensor, dx: Tensor,
                     k: int, fill: float = 0.0) -> Tensor:
    """The elastic kernel on CUDA tensors; its plain version on CPU ones."""
    if planes.device.type == "cpu":
        return elastic_resample_plain(planes, flags, dy, dx, k, fill)
    b, c, h, w = planes.shape
    # at least one row each of dy, dx and the row blends
    K.check_block("elastic", planes, 12 * w, b)
    K.check_plane_args("elastic", planes, flags, (dy, dx))
    for t in (dy, dx):
        if t.dtype != torch.float32 or t.shape != (b, h, w):
            raise ValueError(f"elastic: displacements must be ({b}, {h}, {w})"
                             f" float32, got {tuple(t.shape)} {t.dtype}")
    out = torch.empty_like(planes)
    K.KERNELS["elastic"].launch(planes.data_ptr(), flags.data_ptr(),
                                dy.data_ptr(), dx.data_ptr(), out.data_ptr(),
                                b, c, h, w, int(k), float(fill),
                                K.stream_of(planes))
    return out


def warp_elastic_joint(images: Tensor, masks: Tensor, dy: Tensor, dx: Tensor,
                       k: int, fill: float = 0.0) -> Tuple[Tensor, Tensor]:
    """Elastic-only joint warp of NHWC images (bilinear) and masks
    (nearest) in one launch → same shapes."""
    planes, flags = joint_planes(images, masks)
    out = elastic_resample(planes, flags, dy.float().contiguous(),
                           dx.float().contiguous(), k, fill)
    return split_planes(out, images.shape[-1], masks.dtype)
