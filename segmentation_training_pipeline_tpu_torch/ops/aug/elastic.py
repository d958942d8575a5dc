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
raises.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ... import kernels as K
from .fused_warp import joint_planes, split_planes

Tensor = torch.Tensor


def elastic_resample_plain(planes: Tensor, flags: Tensor, dy: Tensor,
                           dx: Tensor, k: int, fill: float = 0.0) -> Tensor:
    """Plain PyTorch elastic resample: planes (B, C, H, W) f32, flags (C,)
    i32 (non-zero = nearest channel), dy/dx (B, H, W) f32 → (B, C, H, W)."""
    b, c, h, w = planes.shape
    dev = planes.device
    near = (flags != 0).view(1, c, 1, 1)
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]

    # y taps at every (y, x'), from the dy of column x'
    d = torch.clamp(yy + dy, 0.0, h - 1.0) - yy                    # (B,H,W)
    iy = torch.floor(d)
    fy = torch.where(near, torch.floor((d - iy)[:, None] + 0.5),
                     (d - iy)[:, None])
    r0 = (yy.long() + iy.long()).clamp(0, h)
    padded = F.pad(planes, (0, 0, 0, 1), value=fill)   # row h reads fill
    g0 = torch.gather(padded, 2, r0[:, None].expand(b, c, h, w))
    g1 = torch.gather(padded, 2, (r0 + 1).clamp(max=h)[:, None].expand(
        b, c, h, w))
    row = (1.0 - fy) * g0 + fy * g1
    row = torch.where(((iy >= -k) & (iy <= k))[:, None], row, 0.0)

    # x taps at (y, x), read from row at the shifted columns (mod W: the
    # wrapped tap only ever carries weight 0)
    d = torch.clamp(xx + dx, 0.0, w - 1.0) - xx
    ix = torch.floor(d)
    fx = torch.where(near, torch.floor((d - ix)[:, None] + 0.5),
                     (d - ix)[:, None])
    x0 = torch.remainder(xx.long() + ix.long(), w)
    x1 = torch.remainder(x0 + 1, w)
    out = ((1.0 - fx) * torch.gather(row, 3, x0[:, None].expand(b, c, h, w))
           + fx * torch.gather(row, 3, x1[:, None].expand(b, c, h, w)))
    out = torch.where(((ix >= -k) & (ix <= k))[:, None], out, 0.0)

    sy = yy + dy
    sx = xx + dx
    oob = (sy < -0.5) | (sy > h - 0.5) | (sx < -0.5) | (sx > w - 0.5)
    return torch.where(oob[:, None], fill, out)


def elastic_resample(planes: Tensor, flags: Tensor, dy: Tensor, dx: Tensor,
                     k: int, fill: float = 0.0) -> Tensor:
    """The elastic kernel on CUDA tensors; its plain version on CPU ones."""
    if planes.device.type == "cpu":
        return elastic_resample_plain(planes, flags, dy, dx, k, fill)
    K.check_plane_args("elastic", planes, flags, (dy, dx))
    b, c, h, w = planes.shape
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
