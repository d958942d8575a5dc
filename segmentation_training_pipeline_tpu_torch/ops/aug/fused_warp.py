"""Fused affine warp: kernel X (x-pipeline), kernel Y (y-pipeline) and
kernel YE (y-pipeline + elastic resample).

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
  kernel YE: kernel Y's canvas, then the elastic resample of
    ``elastic.py`` read from it: output (y, x) x-blends the row blends at
    columns x + ix and x + ix + 1 (mod W), each taken with that column's
    own dy from canvas rows py + y + iy and py + y + iy + 1.  Those rows
    are y-sheared content (the clamp of y + dy keeps them inside the frame
    rows, plus one neighbour of weight 0), which needs py ≥ K + 1.

The CUDA kernels live in ``csrc/warp_xy.cu``.  Beside each is its plain
PyTorch version (gather and index ops in f32), which the wrapper runs for
CPU tensors only; a CUDA tensor launches the kernel or raises.  Kernels X
and YE keep rows of the frame in one block's shared memory, so their
wrappers refuse a row too wide for it, and every kernel runs on a 3-D
grid, so its wrapper refuses what a grid axis cannot hold
(:func:`..kernels.check_block`).
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def _y_canvas_plain(planes: Tensor, kinds: Tensor, scalars: Tensor, py: int,
                    fill: float, rows: Tensor) -> Tensor:
    """Kernel Y's y-sheared canvas (H + 2py rows) at canvas ``rows``."""
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

    # y-shear per column at the requested canvas rows
    jj = torch.arange(w, device=dev, dtype=torch.float32)
    offs = s2[:, None] * (jj[None, :] - (w - 1) / 2.0)           # (B, W)
    kfloor = torch.floor(offs)
    frac = _round_if(is_mask, (offs - kfloor)[:, None, None, :])
    kmod = torch.remainder(kfloor.long(), hp)
    n = rows.numel()
    a = torch.remainder(rows[None, :, None] + kmod[:, None, :], hp)  # (B,n,W)
    a1 = torch.remainder(a + 1, hp)
    o = torch.gather(canvas, 2, a[:, None].expand(b, c, n, w))
    nx = torch.gather(canvas, 2, a1[:, None].expand(b, c, n, w))
    src = (rows.float()[None, :, None] + offs[:, None, :])[:, None]  # (B,1,n,W)
    res = (1.0 - frac) * o + frac * nx
    res = torch.where(src >= hp - 1.0, o, res)
    res = torch.where(src < 0.0, nx, res)
    return torch.where((src < -0.5) | (src > hp - 0.5), fill, res)


def warp_y_plain(planes: Tensor, kinds: Tensor, scalars: Tensor, py: int,
                 fill: float = 0.0) -> Tensor:
    """Plain PyTorch kernel Y (same arguments as :func:`warp_x_plain`):
    canvas rows [py, py + H)."""
    h = planes.shape[2]
    rows = torch.arange(py, py + h, device=planes.device)
    return _y_canvas_plain(planes, kinds, scalars, py, fill, rows)


def elastic_tail_plain(source: Tensor, row0: int, near: Tensor, dy: Tensor,
                       dx: Tensor, k: int, fill: float) -> Tensor:
    """The separable elastic resample (``elastic.py``) of frame rows that
    sit at rows ``row0 + y`` of ``source`` (B, C, R, W); rows past the
    frame must be readable (``row0 + H < R``).  ``near`` (1, C, 1, 1)
    marks the rounded channels; dy/dx (B, H, W) → (B, C, H, W)."""
    b, c, _, w = source.shape
    h = dy.shape[1]
    dev = source.device
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]

    # y taps at every (y, x'), from the dy of column x'
    d = torch.clamp(yy + dy, 0.0, h - 1.0) - yy                    # (B,H,W)
    iy = torch.floor(d)
    fy = torch.where(near, torch.floor((d - iy)[:, None] + 0.5),
                     (d - iy)[:, None])
    r0 = row0 + yy.long() + iy.long()             # y + iy ∈ [0, H − 1]
    g0 = torch.gather(source, 2, r0[:, None].expand(b, c, h, w))
    g1 = torch.gather(source, 2, (r0 + 1)[:, None].expand(b, c, h, w))
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


def warp_ye_plain(planes: Tensor, kinds: Tensor, scalars: Tensor, dy: Tensor,
                  dx: Tensor, py: int, k: int, fill: float = 0.0) -> Tensor:
    """Plain PyTorch kernel YE: kernel Y's whole canvas, then the elastic
    resample read from its rows py − K … py + H + K; dy/dx (B, H, W) f32."""
    _check_band(py, k)
    hp = planes.shape[2] + 2 * py
    canvas = _y_canvas_plain(planes, kinds, scalars, py, fill,
                             torch.arange(hp, device=planes.device))
    return elastic_tail_plain(canvas, py, _kind_mask(kinds), dy, dx, k, fill)


def _check_band(py: int, k: int) -> None:
    if k + 1 > py:
        raise ValueError(f"warp_ye: elastic bound K={k} needs a y-pad of at "
                         f"least K+1, got {py}")


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
    b, c, _, w = planes.shape
    # the input row (padded to 4 floats) and its x-sheared canvas row
    K.check_block("warp_x", planes, 4 * ((w + 3) // 4 * 4 + w + 2 * px),
                  b * c)
    return _launch("warp_x", planes, kinds, scalars, px, fill)


def warp_y(planes: Tensor, kinds: Tensor, scalars: Tensor, py: int,
           fill: float = 0.0) -> Tensor:
    """Kernel Y on CUDA tensors; its plain version on CPU tensors."""
    if planes.device.type == "cpu":
        return warp_y_plain(planes, kinds, scalars, py, fill)
    # no shared memory: a thread walks a tile of rows of one column
    K.check_block("warp_y", planes, 0, planes.shape[0] * planes.shape[1])
    return _launch("warp_y", planes, kinds, scalars, py, fill)


def warp_ye(planes: Tensor, kinds: Tensor, scalars: Tensor, dy: Tensor,
            dx: Tensor, py: int, k: int, fill: float = 0.0) -> Tensor:
    """Kernel YE on CUDA tensors; its plain version on CPU tensors."""
    if planes.device.type == "cpu":
        return warp_ye_plain(planes, kinds, scalars, dy, dx, py, k, fill)
    _check_band(py, k)
    b, c, h, w = planes.shape
    # at least one row each of dy, dx and the row blends
    K.check_block("warp_ye", planes, 12 * w, b)
    K.check_plane_args("warp_ye", planes, kinds, (scalars, dy, dx))
    _check_scalars("warp_ye", planes, scalars)
    for t in (dy, dx):
        if t.dtype != torch.float32 or t.shape != (b, h, w):
            raise ValueError(f"warp_ye: displacements must be ({b}, {h}, "
                             f"{w}) float32, got {tuple(t.shape)} {t.dtype}")
    out = torch.empty_like(planes)
    K.KERNELS["warp_ye"].launch(planes.data_ptr(), kinds.data_ptr(),
                                scalars.data_ptr(), dy.data_ptr(),
                                dx.data_ptr(), out.data_ptr(), b, c, h, w,
                                int(py), int(k), float(fill),
                                K.stream_of(planes))
    return out


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
                     px: int, py: int, fill: float = 0.0,
                     dy: Optional[Tensor] = None, dx: Optional[Tensor] = None,
                     k: int = 0) -> Tuple[Tensor, Tensor]:
    """The x- then y-pipeline on NHWC images (B, H, W, C) and masks
    (B, H, W, M), with the per-image factors of ``fast_warp``'s
    decomposition (rot90 already applied, shears centred) → same shapes.
    With dy/dx ((B, H, W), |d| ≤ k ≤ py − 1) the elastic resample runs in
    the y-launch (kernel YE)."""
    planes, kinds = joint_planes(images, masks)
    scalars = torch.stack([s1, e1, tx, e2, ty, s2], dim=1).float().contiguous()
    mid = warp_x(planes, kinds, scalars, px, fill)
    if dy is None:
        out = warp_y(mid, kinds, scalars, py, fill)
    else:
        out = warp_ye(mid, kinds, scalars, dy.float().contiguous(),
                      dx.float().contiguous(), py, k, fill)
    return split_planes(out, images.shape[-1], masks.dtype)
