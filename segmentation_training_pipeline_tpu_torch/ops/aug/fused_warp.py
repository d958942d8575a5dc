"""Fused affine warp: kernel X (x-pipeline) and kernel Y (y-pipeline).

Counterpart of ``segmentation_training_pipeline_tpu/ops/aug/pallas_warp.py``
(``warp_fused_tpu`` / ``warp_joint_fused``).  The multipass warp factors
each inverse affine into rot90 · x-shear · scale+translate · y-shear
(``fast_warp``); after the rot90 pre-pass these two launches do the rest
on (B, C, H, W) f32 planes that stack image channels (bilinear) and mask
channels (nearest: the same blends with the fractions rounded, selected by
a per-channel kind flag):

  kernel X, per plane: x-pad by ``px`` with ``fill``; x-shear
    ``src_x = x + s1·(y − cy)``; x-scale+translate ``col = e1·j + tx + px``.
  kernel Y, per plane: y-scale+translate onto an (H + 2py) canvas with
    validity against the original H; y-shear ``src_y = y + s2·(x − cx)``;
    rows [py, py + H).

The CUDA kernels live in ``csrc/warp_xy.cu``.  Beside each is its plain
PyTorch version (gather and index ops in f32), which the wrapper runs for
CPU tensors only; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ... import kernels as K

Tensor = torch.Tensor


def _kind_mask(kinds: Tensor) -> Tensor:
    return (kinds == 1).view(1, -1, 1, 1)


def _round_if(mask: Tensor, f: Tensor) -> Tensor:
    """Nearest channels take the rounded fraction: floor(f + 0.5), which
    sends a .5 tie up (never half-to-even)."""
    return torch.where(mask, torch.floor(f + 0.5), f)


def warp_x_plain(planes: Tensor, kinds: Tensor, scalars: Tensor, px: int,
                 fill: float = 0.0) -> Tensor:
    """Plain PyTorch kernel X: planes (B, C, H, W) f32, kinds (C,) i32,
    scalars (B, 6) f32 = (s1, e1, tx, e2, ty, s2) → (B, C, H, W)."""
    b, c, h, w = planes.shape
    wp = w + 2 * px
    dev = planes.device
    is_mask = _kind_mask(kinds)
    s1, e1, tx = scalars[:, 0], scalars[:, 1], scalars[:, 2]

    # x-shear: canvas column q holds P[(q + kmod) mod wp] blended with its
    # right neighbour, edge-clamped, fill outside the original frame
    ii = torch.arange(h, device=dev, dtype=torch.float32)
    offs = s1[:, None] * (ii[None, :] - (h - 1) / 2.0)           # (B, H)
    kfloor = torch.floor(offs)
    frac = _round_if(is_mask, (offs - kfloor)[:, None, :, None])
    kmod = torch.remainder(kfloor.long(), wp)
    padded = F.pad(planes, (px, px), value=fill)                  # (B,C,H,wp)
    q = torch.arange(wp, device=dev)
    a = torch.remainder(q[None, None, :] + kmod[:, :, None], wp)  # (B,H,wp)
    a1 = torch.remainder(a + 1, wp)
    o = torch.gather(padded, 3, a[:, None].expand(b, c, h, wp))
    n = torch.gather(padded, 3, a1[:, None].expand(b, c, h, wp))
    src = ((q.float()[None, None, :] + offs[:, :, None]) - float(px))[:, None]
    res = (1.0 - frac) * o + frac * n
    res = torch.where(src >= w - 1.0, o, res)
    res = torch.where(src < 0.0, n, res)
    canvas = torch.where((src < -0.5) | (src > w - 0.5), fill, res)

    # x-scale+translate: destination column j reads canvas column col
    jj = torch.arange(w, device=dev, dtype=torch.float32)
    col = (e1[:, None] * jj[None, :] + tx[:, None]) + float(px)  # (B, W)
    s0 = torch.floor(col)
    f = _round_if(is_mask, (col - s0)[:, None, None, :])
    i0 = s0.clamp(0, wp - 1).long()[:, None, None, :].expand(b, c, h, w)
    i1 = (s0 + 1).clamp(0, wp - 1).long()[:, None, None, :].expand(b, c, h, w)
    out = (1.0 - f) * torch.gather(canvas, 3, i0) + f * torch.gather(
        canvas, 3, i1)
    col = col[:, None, None, :]
    out = torch.where(col >= wp - 1.0, canvas[..., wp - 1:], out)
    out = torch.where(col < 0.0, canvas[..., :1], out)
    return torch.where((col >= -0.5) & (col <= wp - 0.5), out, fill)


def warp_y_plain(planes: Tensor, kinds: Tensor, scalars: Tensor, py: int,
                 fill: float = 0.0) -> Tensor:
    """Plain PyTorch kernel Y (same arguments as :func:`warp_x_plain`)."""
    b, c, h, w = planes.shape
    hp = h + 2 * py
    dev = planes.device
    is_mask = _kind_mask(kinds)
    e2, ty, s2 = scalars[:, 3], scalars[:, 4], scalars[:, 5]

    # y-scale+translate onto the (hp, W) canvas: row r reads source row
    # e2·(r − py) + ty, clamps and validity against the original H
    rr = torch.arange(hp, device=dev, dtype=torch.float32)
    srcy = e2[:, None] * (rr[None, :] - float(py)) + ty[:, None]  # (B, hp)
    s0 = torch.floor(srcy)
    f = _round_if(is_mask, (srcy - s0)[:, None, :, None])
    i0 = s0.clamp(0, h - 1).long()[:, None, :, None].expand(b, c, hp, w)
    i1 = (s0 + 1).clamp(0, h - 1).long()[:, None, :, None].expand(b, c, hp, w)
    canvas = (1.0 - f) * torch.gather(planes, 2, i0) + f * torch.gather(
        planes, 2, i1)
    sy = srcy[:, None, :, None]
    canvas = torch.where(sy >= h - 1.0, planes[:, :, h - 1:], canvas)
    canvas = torch.where(sy < 0.0, planes[:, :, :1], canvas)
    canvas = torch.where((sy >= -0.5) & (sy <= h - 0.5), canvas, fill)

    # y-shear per column, output rows [py, py + H) of the canvas
    jj = torch.arange(w, device=dev, dtype=torch.float32)
    offs = s2[:, None] * (jj[None, :] - (w - 1) / 2.0)           # (B, W)
    kfloor = torch.floor(offs)
    frac = _round_if(is_mask, (offs - kfloor)[:, None, None, :])
    kmod = torch.remainder(kfloor.long(), hp)
    r = torch.arange(py, py + h, device=dev)
    a = torch.remainder(r[None, :, None] + kmod[:, None, :], hp)  # (B, H, W)
    a1 = torch.remainder(a + 1, hp)
    o = torch.gather(canvas, 2, a[:, None].expand(b, c, h, w))
    n = torch.gather(canvas, 2, a1[:, None].expand(b, c, h, w))
    src = (r.float()[None, :, None] + offs[:, None, :])[:, None]  # (B,1,H,W)
    res = (1.0 - frac) * o + frac * n
    res = torch.where(src >= hp - 1.0, o, res)
    res = torch.where(src < 0.0, n, res)
    return torch.where((src < -0.5) | (src > hp - 0.5), fill, res)


def _check_scalars(kernel: str, planes: Tensor, scalars: Tensor) -> None:
    if (scalars.dtype != torch.float32
            or scalars.shape != (planes.shape[0], 6)):
        raise ValueError(f"{kernel}: scalars must be ({planes.shape[0]}, 6) "
                         f"float32, got {tuple(scalars.shape)} "
                         f"{scalars.dtype}")


def _launch(name: str, planes: Tensor, kinds: Tensor, scalars: Tensor,
            pad: int, fill: float) -> Tensor:
    K.check_plane_args(name, planes, kinds, (scalars,))
    _check_scalars(name, planes, scalars)
    b, c, h, w = planes.shape
    out = torch.empty_like(planes)
    K.KERNELS[name].launch(planes.data_ptr(), kinds.data_ptr(),
                           scalars.data_ptr(), out.data_ptr(), b, c, h, w,
                           int(pad), float(fill), K.stream_of(planes))
    return out


def warp_x(planes: Tensor, kinds: Tensor, scalars: Tensor, px: int,
           fill: float = 0.0) -> Tensor:
    """Kernel X on CUDA tensors; its plain version on CPU tensors."""
    if planes.device.type == "cpu":
        return warp_x_plain(planes, kinds, scalars, px, fill)
    return _launch("warp_x", planes, kinds, scalars, px, fill)


def warp_y(planes: Tensor, kinds: Tensor, scalars: Tensor, py: int,
           fill: float = 0.0) -> Tensor:
    """Kernel Y on CUDA tensors; its plain version on CPU tensors."""
    if planes.device.type == "cpu":
        return warp_y_plain(planes, kinds, scalars, py, fill)
    return _launch("warp_y", planes, kinds, scalars, py, fill)


def joint_planes(images: Tensor, masks: Tensor) -> Tuple[Tensor, Tensor]:
    """NHWC images (C channels) + masks (M channels) → (B, C+M, H, W) f32
    planes and the (C+M,) i32 kind flags (0 image, 1 mask)."""
    ci, cm = images.shape[-1], masks.shape[-1]
    planes = torch.cat([images.float(), masks.float()], dim=-1)
    planes = planes.permute(0, 3, 1, 2).contiguous()
    kinds = torch.cat([
        torch.zeros(ci, dtype=torch.int32, device=images.device),
        torch.ones(cm, dtype=torch.int32, device=images.device)])
    return planes, kinds


def split_planes(out: Tensor, ci: int, mask_dtype) -> Tuple[Tensor, Tensor]:
    out = out.permute(0, 2, 3, 1)
    return out[..., :ci], out[..., ci:].to(mask_dtype)


def warp_joint_fused(images: Tensor, masks: Tensor, s1: Tensor, e1: Tensor,
                     e2: Tensor, tx: Tensor, ty: Tensor, s2: Tensor,
                     px: int, py: int,
                     fill: float = 0.0) -> Tuple[Tensor, Tensor]:
    """The x- then y-pipeline on NHWC images (B, H, W, C) and masks
    (B, H, W, M), with the per-image factors of ``fast_warp``'s
    decomposition (rot90 already applied, shears centred) → same shapes."""
    planes, kinds = joint_planes(images, masks)
    scalars = torch.stack([s1, e1, tx, e2, ty, s2], dim=1).float().contiguous()
    out = warp_y(warp_x(planes, kinds, scalars, px, fill), kinds, scalars,
                 py, fill)
    return split_planes(out, images.shape[-1], masks.dtype)
