"""Gather-free affine warp: the multipass decomposition.

Counterpart of the fused branch of
``segmentation_training_pipeline_tpu/ops/aug/fast_warp.py``
(``warp_joint_multipass``).  Each inverse affine is factored as

    A = R90^k · S1(x-shear) · D(scale+translate) · S2(y-shear)

(Catmull & Smith 1980; Paeth 1986).  The rot90 pre-pass is a per-image
select of four flips/transposes; the shears are centred on the image and
the rest runs in the two fused warp kernels (``fused_warp``) on canvases
padded by ``px``/``py``.  Images resample bilinearly, masks take the
nearest tap from the same passes.  The unfused XLA passes of the JAX module
are not ported: this is the path the TPU runs.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .fused_warp import warp_joint_fused

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


def _rot90_select(x: Tensor, k: Tensor) -> Tensor:
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


def warp_joint_multipass(images: Tensor, masks: Tensor, mats: Tensor,
                         fill: float = 0.0,
                         pad_frac: float = 0.5) -> Tuple[Tensor, Tensor]:
    """images (B, H, W, C) float, masks (B, H, W, M), mats (B, 3, 3)
    inverse affines → warped (images f32, masks in their dtype).

    ``pad_frac`` sizes the canvas padding per side as a fraction of H/W;
    the shears are centred, so content moves at most |s|·size/2."""
    b, h, w, _ = images.shape
    img, msk = images, masks
    if h == w:
        k, s1, e1, e2, tx, ty, s2 = _decompose(mats, h, w)
        img = _rot90_select(img, k)
        msk = _rot90_select(msk, k)
    else:
        s1, e1, e2, tx, ty, s2 = _decompose_nok(mats)
    # centre the shears about the image midpoint and fold the induced
    # translations into the scale pass: tx += s1·cy ; ty += e2·s2·cx
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    tx = tx + s1 * cy
    ty = ty + e2 * s2 * cx
    px, py = canvas_pads(h, w, pad_frac)
    return warp_joint_fused(img, msk, s1, e1, e2, tx, ty, s2, px, py, fill)
