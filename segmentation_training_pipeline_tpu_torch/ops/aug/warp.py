"""Inverse-affine matrix algebra, the elastic displacement field and the
exact footprint-gather warp.

Counterpart of ``segmentation_training_pipeline_tpu/ops/aug/warp.py``.
Every geometric augmenter of a run contributes a per-image 3×3 INVERSE
affine (x = column, y = row); the composed matrix and an optional
displacement field drive one warp of images (bilinear) and masks
(nearest).  ``warp_joint`` is the exact single-pass sampler: one gather of
each output pixel's 2×2 source footprint serves the image (bilinear) and
the mask (nearest) alike.  The lowering sends it what the hand-written
kernels cannot take, where the JAX lowering sends its gather: displacement
bounds K > 64, and frames and rotations the multipass warp cannot
factor.  It is a PyTorch gather, as the reference's is an XLA gather, not
a kernel.

All matrix products are f32 multiply-adds written out element by element
(the reference sets ``precision=HIGHEST``; a TF32 matmul here would move
coordinates enough to flip nearest-tap mask pixels).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def identity_mats(b: int, device=None) -> Tensor:
    return torch.eye(3, dtype=torch.float32, device=device).expand(
        b, 3, 3).clone()


def compose(m_new: Tensor, m_acc: Tensor) -> Tensor:
    """Apply ``m_new`` AFTER ``m_acc`` in forward order — for inverse
    matrices, right-multiply: inv(N·A) = inv(A)·inv(N)."""
    return (m_acc[:, :, :, None] * m_new[:, None, :, :]).sum(dim=2)


def _mats(b: int, device, **entries) -> Tensor:
    m = identity_mats(b, device)
    for key, val in entries.items():
        m[:, int(key[1]), int(key[2])] = val
    return m


def translation(tx: Tensor, ty: Tensor) -> Tensor:
    return _mats(tx.shape[0], tx.device, m02=tx, m12=ty)


def scale_about(cx: float, cy: float, sx: Tensor, sy: Tensor) -> Tensor:
    """Inverse scale about (cx, cy): src = c + (dst − c) / s."""
    inv_sx, inv_sy = 1.0 / sx, 1.0 / sy
    return _mats(sx.shape[0], sx.device, m00=inv_sx, m11=inv_sy,
                 m02=cx * (1.0 - inv_sx), m12=cy * (1.0 - inv_sy))


def rotation_about(cx: float, cy: float, theta: Tensor) -> Tensor:
    """Inverse of a rotation by ``theta`` (radians, CCW in image
    coordinates) about the centre: rotate by −theta."""
    c, s = torch.cos(theta), torch.sin(theta)
    return _mats(theta.shape[0], theta.device, m00=c, m01=s, m10=-s, m11=c,
                 m02=cx - c * cx - s * cy, m12=cy + s * cx - c * cy)


def shear_about(cx: float, cy: float, shx: Tensor, shy: Tensor) -> Tensor:
    """Inverse shear (x-shear by shx rad, y-shear by shy rad) about the
    centre."""
    tx_, ty_ = torch.tan(shx), torch.tan(shy)
    det = 1.0 - tx_ * ty_
    a00, a01, a10, a11 = 1.0 / det, -tx_ / det, -ty_ / det, 1.0 / det
    return _mats(shx.shape[0], shx.device, m00=a00, m01=a01, m10=a10,
                 m11=a11, m02=cx - a00 * cx - a01 * cy,
                 m12=cy - a10 * cx - a11 * cy)


def hflip(w: int, flip: Tensor) -> Tensor:
    """Conditional horizontal flip (x' = W−1−x); ``flip`` is (B,) bool."""
    f = flip.float()
    return _mats(f.shape[0], f.device, m00=1.0 - 2.0 * f, m02=f * (w - 1.0))


def vflip(h: int, flip: Tensor) -> Tensor:
    f = flip.float()
    return _mats(f.shape[0], f.device, m11=1.0 - 2.0 * f, m12=f * (h - 1.0))


def rot90s(h: int, w: int, k: Tensor) -> Tensor:
    """Inverse of rot90 applied k ∈ {0, 1, 2, 3} times (``np.rot90``'s
    direction).  On a non-square frame an odd k also scales so that the
    output keeps its shape (rot90 + resize, the reference's static-shape
    deviation from imgaug)."""
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    theta = -k.float() * (math.pi / 2.0)
    odd = (k % 2 == 1).float()
    sx = 1.0 + odd * ((w / h) - 1.0)
    sy = 1.0 + odd * ((h / w) - 1.0)
    return compose(scale_about(cx, cy, sx, sy), rotation_about(cx, cy, theta))


# ---------------------------------------------------------------------------
# elastic displacement field (Simard et al. 2003)
# ---------------------------------------------------------------------------

def _gaussian_kernel1d(sigma: Tensor, radius: int) -> Tensor:
    """(B, 2r+1) normalised gaussian taps for per-image sigma."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=sigma.device)
    k = torch.exp(-0.5 * (x[None, :] / torch.clamp(sigma[:, None], min=1e-3))
                  ** 2)
    return k / k.sum(dim=1, keepdim=True)


def _symmetric_index(n: int, r: int, device) -> Tensor:
    """Indices of a length-n axis padded by r on each side in numpy's
    "symmetric" mode (edge sample repeated: scipy's mode="reflect")."""
    idx = torch.arange(-r, n + r, device=device)
    idx = torch.where(idx < 0, -idx - 1, idx)
    return torch.where(idx >= n, 2 * n - 1 - idx, idx)


def smooth_field(field: Tensor, sigma: Tensor, radius: int = 8) -> Tensor:
    """Separable per-image gaussian blur of (B, H, W), symmetric padding,
    first along W then along H."""
    b, h, w = field.shape
    k = _gaussian_kernel1d(sigma, radius)                         # (B, K)
    kw = k[:, None, None, :]
    fx = field[:, :, _symmetric_index(w, radius, field.device)]
    fx = (fx.unfold(2, 2 * radius + 1, 1) * kw).sum(-1)          # along W
    fy = fx[:, _symmetric_index(h, radius, field.device), :].transpose(1, 2)
    fy = (fy.unfold(2, 2 * radius + 1, 1) * kw).sum(-1)          # along H
    return fy.transpose(1, 2)


def field_stride(h: int, w: int, radius: int, stride: int) -> int:
    """The stride ``elastic_field`` really uses: 1 when the low-res grid is
    too small for the reflect pad."""
    if stride > 1 and min(h, w) // stride <= 2 * max(2, radius // stride):
        return 1
    return stride


def noise_shape(b: int, h: int, w: int, radius: int,
                stride: int) -> Tuple[int, int, int]:
    stride = field_stride(h, w, radius, stride)
    return b, max(1, h // stride), max(1, w // stride)


def elastic_field(raw_x: Tensor, raw_y: Tensor, h: int, w: int,
                  alpha: Tensor, sigma: Tensor, radius: int = 8,
                  stride: int = 1) -> Tuple[Tensor, Tensor]:
    """→ (dx, dy) each (B, H, W): the uniform(−1, 1) noise ``raw_x``/
    ``raw_y`` (shape :func:`noise_shape`) smoothed and scaled by alpha.

    With ``stride`` > 1 the field is made at (H/stride, W/stride) and
    upsampled bilinearly (half-pixel centres, as ``jax.image.resize``); the
    amplitude is rescaled by the ratio of the two kernels' squared norms so
    the displacement statistics match the full-resolution field."""
    b = raw_x.shape[0]
    stride = field_stride(h, w, radius, stride)
    sig = sigma / float(stride)
    rad = max(2, radius // stride)
    amp = alpha
    if stride > 1:
        k_full = _gaussian_kernel1d(sigma, radius)
        k_low = _gaussian_kernel1d(sig, rad)
        amp = alpha * ((k_full ** 2).sum(dim=1) / (k_low ** 2).sum(dim=1))
    dx = smooth_field(raw_x, sig, rad) * amp[:, None, None]
    dy = smooth_field(raw_y, sig, rad) * amp[:, None, None]
    if stride > 1:
        dx = F.interpolate(dx[:, None], size=(h, w), mode="bilinear",
                           align_corners=False)[:, 0]
        dy = F.interpolate(dy[:, None], size=(h, w), mode="bilinear",
                           align_corners=False)[:, 0]
    return dx, dy


def elastic_radius(sig_max: float) -> int:
    return int(max(4, 2 * sig_max))


def displacement_bound(a_max: float, sig_min: float) -> float:
    """Static 6-sigma bound on |displacement| of one elastic op: the
    smoothed-noise std is about alpha / (2·sqrt(pi)·sigma)."""
    return 6.0 * a_max / (2.0 * math.sqrt(math.pi) * max(sig_min, 0.5)) + 1.0


# ---------------------------------------------------------------------------
# the exact sampler
# ---------------------------------------------------------------------------

def _source_coords(mats: Tensor, h: int, w: int,
                   disp: Optional[Tuple[Tensor, Tensor]]
                   ) -> Tuple[Tensor, Tensor]:
    """Output grid → source (x, y) float coordinates, (B, H, W) each."""
    gx = torch.arange(w, dtype=torch.float32, device=mats.device)[None, :]
    gy = torch.arange(h, dtype=torch.float32, device=mats.device)[:, None]
    a = mats[:, None, None, :, :]
    x_src = a[..., 0, 0] * gx + a[..., 0, 1] * gy + a[..., 0, 2]
    y_src = a[..., 1, 0] * gx + a[..., 1, 1] * gy + a[..., 1, 2]
    if disp is not None:
        x_src = x_src + disp[0]
        y_src = y_src + disp[1]
    return x_src, y_src


def _gather2d(img: Tensor, iy: Tensor, ix: Tensor) -> Tensor:
    """img (B, H, W, C), iy/ix (B, H', W') integer → (B, H', W', C)."""
    b, h, w = img.shape[:3]
    flat = img.reshape(b, h * w, -1)
    rows = torch.arange(b, device=img.device)[:, None, None]
    return flat[rows, iy * w + ix]


def _footprint(x_src: Tensor, y_src: Tensor, h: int, w: int):
    """Top-left tap (y0, x0) of each 2×2 footprint, kept inside the frame,
    and the fractional offsets (fy, fx), (B, H, W, 1) each, in [0, 1]."""
    x0 = torch.clamp(torch.floor(x_src), 0, w - 2)
    y0 = torch.clamp(torch.floor(y_src), 0, h - 2)
    fx = torch.clamp(x_src - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(y_src - y0, 0.0, 1.0)[..., None]
    return y0.long(), x0.long(), fy, fx


def _taps(joint: Tensor, y0: Tensor, x0: Tensor):
    """The four footprint taps (00, 01, 10, 11) of ``joint``."""
    return (_gather2d(joint, y0, x0), _gather2d(joint, y0, x0 + 1),
            _gather2d(joint, y0 + 1, x0), _gather2d(joint, y0 + 1, x0 + 1))


def _bilinear(p00: Tensor, p01: Tensor, p10: Tensor, p11: Tensor,
              fy: Tensor, fx: Tensor) -> Tensor:
    return ((1 - fy) * ((1 - fx) * p00 + fx * p01)
            + fy * ((1 - fx) * p10 + fx * p11))


def _outside(x_src: Tensor, y_src: Tensor, h: int, w: int) -> Tensor:
    return ((x_src < -0.5) | (x_src > w - 0.5)
            | (y_src < -0.5) | (y_src > h - 0.5))[..., None]


def warp_joint(images: Tensor, masks: Tensor, mats: Tensor,
               disp: Optional[Tuple[Tensor, Tensor]] = None,
               fill: float = 0.0, gather_u8: bool = False
               ) -> Tuple[Tensor, Tensor]:
    """One footprint gather for the image AND mask channels together:
    bilinear for the image, exact nearest for the mask (the footprint
    corner the rounded offsets select), so both see the same source
    coordinates by construction.  Outside the source frame both take
    ``fill``.  images (B, H, W, C) on 0..255, masks (B, H, W, M) →
    (images float32, masks in their dtype).

    ``gather_u8``: gather uint8 taps instead of float32, a quarter of the
    random-access traffic; lossless only for integer images and masks in
    0..255 (the first segment of the block, on decoded uint8 images)."""
    b, h, w, c = images.shape
    x_src, y_src = _source_coords(mats, h, w, disp)
    gdt = torch.uint8 if gather_u8 else torch.float32
    joint = torch.cat([images.to(gdt), masks.to(gdt)], dim=-1)
    y0, x0, fy, fx = _footprint(x_src, y_src, h, w)
    t00, t01, t10, t11 = _taps(joint, y0, x0)
    out_img = _bilinear(t00[..., :c].float(), t01[..., :c].float(),
                        t10[..., :c].float(), t11[..., :c].float(), fy, fx)
    ry, rx = fy >= 0.5, fx >= 0.5
    out_mask = torch.where(ry, torch.where(rx, t11[..., c:], t10[..., c:]),
                           torch.where(rx, t01[..., c:], t00[..., c:]))
    oob = _outside(x_src, y_src, h, w)
    out_img = torch.where(oob, torch.full_like(out_img, fill), out_img)
    out_mask = torch.where(oob, torch.full_like(out_mask, fill), out_mask)
    return out_img, out_mask.to(masks.dtype)


def warp(images: Tensor, mats: Tensor,
         disp: Optional[Tuple[Tensor, Tensor]] = None,
         method: str = "bilinear", fill: float = 0.0) -> Tensor:
    """The composed inverse transform of one tensor: images (B, H, W, C)
    → float32 (bilinear) or the input dtype (nearest)."""
    b, h, w, c = images.shape
    x_src, y_src = _source_coords(mats, h, w, disp)
    oob = _outside(x_src, y_src, h, w)
    if method == "nearest":
        ix = torch.clamp(torch.round(x_src), 0, w - 1).long()
        iy = torch.clamp(torch.round(y_src), 0, h - 1).long()
        out = _gather2d(images, iy, ix)
        return torch.where(oob, torch.full_like(out, fill), out)
    y0, x0, fy, fx = _footprint(x_src, y_src, h, w)
    out = _bilinear(*_taps(images.float(), y0, x0), fy, fx)
    return torch.where(oob, torch.full_like(out, fill), out)
