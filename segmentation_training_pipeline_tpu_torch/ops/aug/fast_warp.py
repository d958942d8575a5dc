"""Gather-free affine warp: the multipass decomposition.

Counterpart of ``segmentation_training_pipeline_tpu/ops/aug/fast_warp.py``
(``warp_joint_multipass``).  Each inverse affine is factored as

    A = R90^k · S1(x-shear) · D(scale+translate) · S2(y-shear)

(Catmull & Smith 1980; Paeth 1986).  The rot90 pre-pass is a per-image
select of four flips/transposes; the shears are centred on the image.
Images resample bilinearly, masks take the nearest tap from the same
passes.  The rest runs on one of two paths, chosen as in the JAX module by
``fused`` or, when it is None, by ``STP_PALLAS_WARP`` (unset: fused):

  * fused (the default, the path the TPU runs): the two fused warp kernels
    X and Y (``fused_warp``) on canvases padded by ``px``/``py``; with an
    elastic displacement field, kernel YE takes the place of Y.
  * unfused (``STP_PALLAS_WARP=0``): x-pad, the x-shear kernel
    (``shear``), the separable scale pass as two batched f32 matmuls
    against full tap matrices, the y-shear kernel; with a displacement
    field, the elastic kernel (``elastic``) after.

Either way every resample of a CUDA tensor is a hand-written kernel: the
switch picks between kernels and never reaches a plain version.
"""

from __future__ import annotations

import math
import os
from contextlib import contextmanager
from typing import Optional, Tuple

import torch

from .elastic import warp_elastic_joint
from .fused_warp import warp_joint_fused
from .shear import shear_pass

Tensor = torch.Tensor


def _decompose(mats: Tensor, h: int, w: int):
    """Split (B, 3, 3) inverse affines into rot90-k + shear/scale factors
    → (k, s1, e1, e2, tx, ty, s2), all (B,), with
    A ≈ R90(k) · [[1,s1],[0,1]] · [[e1,0],[0,e2]] · [[1,0],[s2,1]] (+t).
    k = round(θ/90°) keeps the residual rotation within ±45°, so the
    factorisation never degenerates."""
    a, b, c, d = mats[:, 0, 0], mats[:, 0, 1], mats[:, 1, 0], mats[:, 1, 1]
    tx, ty = mats[:, 0, 2], mats[:, 1, 2]
    # det < 0 (odd flip count): A = Fx·M̃, take M̃'s angle; the residual
    # then carries the flip in a negative e1
    flip = (a * d - b * c) < 0
    a_ = torch.where(flip, -a, a)
    b_ = torch.where(flip, -b, b)
    theta = torch.atan2(-b_, a_)
    k = torch.remainder(torch.round(theta / (math.pi / 2.0)).to(torch.int32),
                        4)
    # residual Mr = M_k⁻¹ · A (left-multiply by the inverse rot90 about the
    # centre)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    ang = -k.float() * (math.pi / 2.0)
    ck, sk = torch.cos(ang), torch.sin(ang)
    r00, r01, r10, r11 = ck, -sk, sk, ck
    rt0 = cx - r00 * cx - r01 * cy
    rt1 = cy - r10 * cx - r11 * cy
    m00 = r00 * a + r01 * c
    m01 = r00 * b + r01 * d
    m02 = r00 * tx + r01 * ty + rt0
    m10 = r10 * a + r11 * c
    m11 = r10 * b + r11 * d
    m12 = r10 * tx + r11 * ty + rt1
    s1, e1, e2, tpx, tpy, s2 = _shear_scale(m00, m01, m02, m10, m11, m12)
    return k, s1, e1, e2, tpx, tpy, s2


def _shear_scale(m00, m01, m02, m10, m11, m12):
    """S1·D·S2 factorisation of [[m00, m01], [m10, m11]] with t' = S1⁻¹·t."""
    m11s = torch.where(torch.abs(m11) < 1e-6, torch.full_like(m11, 1e-6), m11)
    s1 = m01 / m11s
    s2 = m10 / m11s
    e1 = m00 - m01 * m10 / m11s
    return s1, e1, m11s, m02 - s1 * m12, m12, s2


def _decompose_nok(mats: Tensor):
    """The decomposition with k forced to 0 (non-square frames)."""
    s1, e1, e2, tpx, tpy, s2 = _shear_scale(
        mats[:, 0, 0], mats[:, 0, 1], mats[:, 0, 2],
        mats[:, 1, 0], mats[:, 1, 1], mats[:, 1, 2])
    return s1, e1, e2, tpx, tpy, s2


def rot90_select(x: Tensor, k: Tensor) -> Tensor:
    """Per-image np.rot90 by k ∈ {0..3} of a square NHWC batch."""
    kb = k[:, None, None, None]
    t = x.transpose(1, 2)
    out = torch.where(kb == 1, t.flip(1), x)
    out = torch.where(kb == 2, x.flip((1, 2)), out)
    return torch.where(kb == 3, t.flip(2), out)


def round_pad(p: int, dim: int) -> int:
    """Canvas pad rounded up as on the TPU (64 for 128-multiple sizes of at
    least 256, else 4), so both ports pad alike."""
    q = 64 if dim % 128 == 0 and dim >= 256 else 4
    return max(q, ((p + q - 1) // q) * q)


def canvas_pads(h: int, w: int, pad_frac: float) -> Tuple[int, int]:
    return (round_pad(int(math.ceil(w * pad_frac)), w),
            round_pad(int(math.ceil(h * pad_frac)), h))


def _env_fused() -> bool:
    """``STP_PALLAS_WARP`` as the JAX module reads it; unset means fused."""
    env = os.environ.get("STP_PALLAS_WARP")
    return env is None or env.lower() not in ("0", "false")


def _shear_pass(img: Tensor, mask: Tensor, offs: Tensor, axis: int,
                fill: float, src_shift: int = 0,
                orig_n: Optional[int] = None,
                out_slice: Optional[Tuple[int, int]] = None
                ) -> Tuple[Tensor, Tensor]:
    """Resample NHWC ``img``/``mask`` along ``axis`` (2: W, 1: H) with the
    per-line displacement ``offs`` (B, R), R the other spatial axis: the
    source of index i is i + offs[line].  Image and mask channels join one
    (B, C, L, N) tensor with the sheared axis last for the kernel.  The
    original source coordinate is ``i + offs − src_shift``, tested against
    ``orig_n`` (default: the canvas); ``out_slice=(start, len)`` crops the
    output along ``axis``."""
    n = img.shape[axis]
    norig = n if orig_n is None else orig_n
    c = img.shape[-1]
    joint = torch.cat([img, mask.to(img.dtype)], dim=-1)
    perm = (0, 3, 1, 2) if axis == 2 else (0, 3, 2, 1)
    x = joint.permute(*perm).contiguous()
    kinds = torch.tensor([0] * c + [1] * mask.shape[-1], dtype=torch.int32,
                         device=img.device)
    out = shear_pass(x, offs.float().contiguous(), kinds, norig, src_shift,
                     fill)
    out = out.permute(0, 2, 3, 1) if axis == 2 else out.permute(0, 3, 2, 1)
    if out_slice is not None:
        start, length = out_slice
        out = out.narrow(axis, start, length)
    return out[..., :c], out[..., c:].to(mask.dtype)


def _resample_matrices(e: Tensor, t: Tensor, n_dst: int, n_src: int,
                       orig_n: int, dst_shift: int, src_shift: int):
    """(B,) scale/offset → (B, n_dst, n_src) bilinear and nearest tap
    matrices and the (B, n_dst) validity.  Row i takes source coordinate
    ``e·(i − dst_shift) + t`` of the original frame, at column
    ``src + src_shift`` of the padded source; rows outside the frame are
    zero (the caller adds the fill)."""
    dev = e.device
    dst = torch.arange(n_dst, device=dev, dtype=torch.float32) - float(
        dst_shift)
    src = e[:, None] * dst[None, :] + t[:, None]            # (B, n_dst)
    col = src + float(src_shift)
    s0 = torch.floor(col)
    f = col - s0
    cols = torch.arange(n_src, device=dev, dtype=torch.float32)[None, None]
    s0e = s0[:, :, None]
    bil = ((1.0 - f)[:, :, None] * (cols == s0e)
           + f[:, :, None] * (cols == s0e + 1.0))
    # edge clamps: src in [n − 1, n − 0.5] takes the last original column,
    # src in (−0.5, 0) the first
    last = float(orig_n - 1 + src_shift)
    first = float(src_shift)
    bil = torch.where((src >= orig_n - 1.0)[:, :, None],
                      (cols == last).float(), bil)
    bil = torch.where((src < 0.0)[:, :, None], (cols == first).float(), bil)
    # floor(col + 0.5): a .5 tie takes the upper tap
    near = (cols == torch.floor(col + 0.5)[:, :, None]).float()
    valid = (src >= -0.5) & (src <= orig_n - 0.5)
    bil = torch.where(valid[:, :, None], bil, 0.0)
    near = torch.where(valid[:, :, None], near, 0.0)
    return bil, near, valid


@contextmanager
def _exact_f32(device: torch.device):
    """Full f32 products and convolutions inside: autocast off, the matmul
    precision pinned to "highest" and cuDNN's TF32 off, whatever the
    caller set; restored on exit.  The JAX pass asks for
    ``precision=HIGHEST``; the filters' convolutions
    (``photometric.py``) run in f32 in the reference."""
    before = torch.get_float32_matmul_precision()
    conv = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.autocast(device.type, enabled=False):
            yield
    finally:
        torch.set_float32_matmul_precision(before)
        torch.backends.cudnn.allow_tf32 = conv


def _scale_pass(img: Tensor, mask: Tensor, e1: Tensor, tx: Tensor,
                e2: Tensor, ty: Tensor, fill: float,
                orig_hw: Tuple[int, int], pad_in_x: int = 0,
                pad_out_y: int = 0) -> Tuple[Tensor, Tensor]:
    """Separable scale+translate as two batched f32 products with full tap
    matrices: out = Ry · x · Rxᵀ.  The input is x-padded by ``pad_in_x``,
    the output y-padded by ``pad_out_y`` (rows [−pad, H + pad) of the
    frame) and not x-padded."""
    h, w = orig_hw
    w_in = img.shape[2]
    # y reads the original frame (the x-shear never moved y): validity and
    # clamps against H.  x reads the x-sheared canvas, whose padding holds
    # content: validity spans the whole canvas.
    ry_b, ry_n, vy = _resample_matrices(e2, ty, h + 2 * pad_out_y, h, h,
                                        pad_out_y, 0)
    rx_b, rx_n, vx = _resample_matrices(e1, tx + float(pad_in_x), w, w_in,
                                        w_in, 0, 0)

    def apply(x, ry, rx):
        y = torch.einsum("bij,bjwc->biwc", ry, x)
        return torch.einsum("bij,bhjc->bhic", rx, y)

    with _exact_f32(img.device):
        img_out = apply(img.float(), ry_b, rx_b)
        mask_out = apply(mask.float(), ry_n, rx_n)
    if fill != 0.0:
        oob = ~(vy[:, :, None] & vx[:, None, :])[..., None]
        img_out = torch.where(oob, fill, img_out)
        mask_out = torch.where(oob, fill, mask_out)
    return img_out, mask_out.to(mask.dtype)


def warp_joint_multipass(images: Tensor, masks: Tensor, mats: Tensor,
                         fill: float = 0.0, pad_frac: float = 0.5,
                         fused: Optional[bool] = None,
                         disp: Optional[Tuple[Tensor, Tensor]] = None,
                         disp_k: int = 0) -> Tuple[Tensor, Tensor]:
    """images (B, H, W, C) float, masks (B, H, W, M), mats (B, 3, 3)
    inverse affines → warped (images f32, masks in their dtype).

    ``pad_frac`` sizes the canvas padding per side as a fraction of H/W;
    the shears are centred, so content moves at most |s|·size/2.  ``disp``
    = (dx, dy), each (B, H, W) with |d| ≤ ``disp_k``, adds the elastic
    resample after the affine (kernel YE on the fused path)."""
    b, h, w, _ = images.shape
    img, msk = images, masks
    if h == w:
        k, s1, e1, e2, tx, ty, s2 = _decompose(mats, h, w)
        img = rot90_select(img, k)
        msk = rot90_select(msk, k)
    else:
        s1, e1, e2, tx, ty, s2 = _decompose_nok(mats)
    # centre the shears about the image midpoint and fold the induced
    # translations into the scale pass: tx += s1·cy ; ty += e2·s2·cx
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    tx = tx + s1 * cy
    ty = ty + e2 * s2 * cx
    px, py = canvas_pads(h, w, pad_frac)
    if disp is not None:
        # kernel YE reads the y-band of its canvas: py ≥ K + 1
        py = max(py, round_pad(disp_k + 1, h))

    if _env_fused() if fused is None else fused:
        dyx = {} if disp is None else dict(dy=disp[1], dx=disp[0], k=disp_k)
        return warp_joint_fused(img, msk, s1, e1, e2, tx, ty, s2, px, py,
                                fill, **dyx)
    if disp is not None:
        # unfused: the affine passes, then the separate elastic kernel
        img, msk = warp_joint_multipass(images, masks, mats, fill=fill,
                                        pad_frac=pad_frac, fused=False)
        return warp_elastic_joint(img, msk, disp[1], disp[0], disp_k,
                                  fill=fill)

    # pass 1: x-shear (src_x = x + s1·(y − cy)) on an x-padded canvas
    img = torch.nn.functional.pad(img.float(), (0, 0, px, px), value=fill)
    msk = torch.nn.functional.pad(msk, (0, 0, px, px), value=fill)
    ys = torch.arange(h, device=img.device, dtype=torch.float32)[None] - cy
    img, msk = _shear_pass(img, msk, s1[:, None] * ys, axis=2, fill=fill,
                           src_shift=px, orig_n=w)
    # pass 2: scale + translate, x-padded in, y-padded out
    img, msk = _scale_pass(img, msk, e1, tx, e2, ty, fill, orig_hw=(h, w),
                           pad_in_x=px, pad_out_y=py)
    # pass 3: y-shear (src_y = y + s2·(x − cx)) on the y-padded canvas; the
    # whole canvas is content (the scale pass tested the original rows)
    xs = torch.arange(w, device=img.device, dtype=torch.float32)[None] - cx
    return _shear_pass(img, msk, s2[:, None] * xs, axis=1, fill=fill,
                       src_shift=0, out_slice=(py, h))
