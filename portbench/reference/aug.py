"""Plain float32 reference of the config-2 augmentation block.

``Fliplr 0.5; Affine rotate/scale/translate_percent; ElasticTransformation
alpha, sigma; Multiply`` on uint8 images and {0, 1} masks, NHWC.  The
geometric run is one warp: the inverse affines of the flip and the affine
composed, the elastic displacement field (Simard et al. 2003: uniform
noise, gaussian-smoothed, scaled by alpha) added after them, images
resampled bilinearly and masks by the nearest tap.  The resampling is the
multipass factorisation A = R90^k · x-shear · scale+translate · y-shear
(Catmull & Smith 1980; Paeth 1986), each pass a 1-D blend, then a
separable bounded elastic resample: the arithmetic the program's
hand-written kernels are specified by, written here as plain gathers and
blends (a copy of the program's plain versions, frozen with the
benchmark).  Multiply scales the images per image; the block clips them to
0..255.

The draws are the benchmark's (``traffic/train.py:make_draws``): a list of
two entries, the geometric run's ``[{"flip"}, {"sx", "sy", "tx", "ty",
"rot", "shx", "shy"}, {"alpha", "sigma", "noise_x", "noise_y"}]`` and the
Multiply's ``{"mul"}``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


class BlockStatics:
    """What the block's arguments fix before any draw: the elastic blur's
    radius and field stride, the displacement bound K and the canvas pad
    fraction."""

    def __init__(self, args: dict, h: int, w: int):
        a = args["ElasticTransformation"]
        alpha_max = max(a["alpha"]) if isinstance(a["alpha"], list) else \
            float(a["alpha"])
        sig = a["sigma"]
        sig_min, sig_max = ((min(sig), max(sig)) if isinstance(sig, list)
                            else (float(sig), float(sig)))
        self.radius = int(max(4, 2 * sig_max))
        self.stride = 4 if sig_min >= 2.0 else 1
        scale = args["Affine"]["scale"]
        mag = max(max(abs(v) for v in scale), 1.0)
        bound = 6.0 * alpha_max / (2.0 * math.sqrt(math.pi)
                                   * max(sig_min, 0.5)) + 1.0
        self.k = int(math.ceil(bound * mag * 1.15)) + 2
        rot = max(abs(v) for v in args["Affine"]["rotate"])
        t = math.tan(math.radians(min(rot, 45.0 if h == w else 60.0)))
        base = 0.5 if h != w else 0.0
        self.pad_frac = min(1.0, max(base, t / 2.0 + 12.0 / max(min(h, w),
                                                                 1)))


def noise_shape(b: int, h: int, w: int, radius: int,
                stride: int) -> Tuple[int, int, int]:
    stride = field_stride(h, w, radius, stride)
    return b, max(1, h // stride), max(1, w // stride)


def field_stride(h: int, w: int, radius: int, stride: int) -> int:
    if stride > 1 and min(h, w) // stride <= 2 * max(2, radius // stride):
        return 1
    return stride


# --- inverse affines --------------------------------------------------------

def _eye(b: int, device) -> Tensor:
    return torch.eye(3, dtype=torch.float32, device=device).expand(
        b, 3, 3).clone()


def _mats(b: int, device, **entries) -> Tensor:
    m = _eye(b, device)
    for key, val in entries.items():
        m[:, int(key[1]), int(key[2])] = val
    return m


def compose(m_new: Tensor, m_acc: Tensor) -> Tensor:
    """``m_new`` after ``m_acc`` for inverse matrices: m_acc · m_new,
    element by element in float32."""
    return (m_acc[:, :, :, None] * m_new[:, None, :, :]).sum(dim=2)


def block_mats(d_flip: dict, d_aff: dict, h: int, w: int) -> Tensor:
    b, dev = d_flip["flip"].shape[0], d_flip["flip"].device
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    f = d_flip["flip"].float()
    mats = compose(_mats(b, dev, m00=1.0 - 2.0 * f, m02=f * (w - 1.0)),
                   _eye(b, dev))
    inv_sx, inv_sy = 1.0 / d_aff["sx"], 1.0 / d_aff["sy"]
    m = _mats(b, dev, m00=inv_sx, m11=inv_sy, m02=cx * (1.0 - inv_sx),
              m12=cy * (1.0 - inv_sy))
    tx, ty = d_aff["tx"] * w, d_aff["ty"] * h
    m = compose(_mats(b, dev, m02=-tx, m12=-ty), m)
    th = d_aff["rot"] * (math.pi / 180.0)
    c, s = torch.cos(th), torch.sin(th)
    m = compose(_mats(b, dev, m00=c, m01=s, m10=-s, m11=c,
                      m02=cx - c * cx - s * cy, m12=cy + s * cx - c * cy), m)
    tx_, ty_ = (torch.tan(d_aff["shx"] * (math.pi / 180.0)),
                torch.tan(d_aff["shy"] * (math.pi / 180.0)))
    det = 1.0 - tx_ * ty_
    a00, a01, a10, a11 = 1.0 / det, -tx_ / det, -ty_ / det, 1.0 / det
    m = compose(_mats(b, dev, m00=a00, m01=a01, m10=a10, m11=a11,
                      m02=cx - a00 * cx - a01 * cy,
                      m12=cy - a10 * cx - a11 * cy), m)
    return compose(m, mats)


# --- the elastic field ------------------------------------------------------

def _gauss(sigma: Tensor, radius: int) -> Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=sigma.device)
    k = torch.exp(-0.5 * (x[None, :] / torch.clamp(sigma[:, None], min=1e-3))
                  ** 2)
    return k / k.sum(dim=1, keepdim=True)


def _sym(n: int, r: int, device) -> Tensor:
    idx = torch.arange(-r, n + r, device=device)
    idx = torch.where(idx < 0, -idx - 1, idx)
    return torch.where(idx >= n, 2 * n - 1 - idx, idx)


def _smooth(field: Tensor, sigma: Tensor, radius: int) -> Tensor:
    _, h, w = field.shape
    kw = _gauss(sigma, radius)[:, None, None, :]
    fx = field[:, :, _sym(w, radius, field.device)]
    fx = (fx.unfold(2, 2 * radius + 1, 1) * kw).sum(-1)
    fy = fx[:, _sym(h, radius, field.device), :].transpose(1, 2)
    fy = (fy.unfold(2, 2 * radius + 1, 1) * kw).sum(-1)
    return fy.transpose(1, 2)


def elastic_field(d: dict, h: int, w: int, radius: int,
                  stride: int) -> Tuple[Tensor, Tensor]:
    stride = field_stride(h, w, radius, stride)
    sigma, alpha = d["sigma"], d["alpha"]
    sig, rad, amp = sigma / float(stride), max(2, radius // stride), alpha
    if stride > 1:
        amp = alpha * ((_gauss(sigma, radius) ** 2).sum(1)
                       / (_gauss(sig, rad) ** 2).sum(1))
    dx = _smooth(d["noise_x"], sig, rad) * amp[:, None, None]
    dy = _smooth(d["noise_y"], sig, rad) * amp[:, None, None]
    if stride > 1:
        dx = F.interpolate(dx[:, None], size=(h, w), mode="bilinear",
                           align_corners=False)[:, 0]
        dy = F.interpolate(dy[:, None], size=(h, w), mode="bilinear",
                           align_corners=False)[:, 0]
    return dx, dy


# --- the multipass warp -----------------------------------------------------

def _shear_scale(m00, m01, m02, m10, m11, m12):
    m11s = torch.where(torch.abs(m11) < 1e-6, torch.full_like(m11, 1e-6), m11)
    s1, s2 = m01 / m11s, m10 / m11s
    e1 = m00 - m01 * m10 / m11s
    return s1, e1, m11s, m02 - s1 * m12, m12, s2


def _decompose(mats: Tensor, h: int, w: int):
    a, b, c, d = mats[:, 0, 0], mats[:, 0, 1], mats[:, 1, 0], mats[:, 1, 1]
    tx, ty = mats[:, 0, 2], mats[:, 1, 2]
    flip = (a * d - b * c) < 0
    theta = torch.atan2(-torch.where(flip, -b, b), torch.where(flip, -a, a))
    k = torch.remainder(torch.round(theta / (math.pi / 2.0)).to(torch.int32),
                        4)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    ang = -k.float() * (math.pi / 2.0)
    ck, sk = torch.cos(ang), torch.sin(ang)
    r00, r01, r10, r11 = ck, -sk, sk, ck
    rt0, rt1 = cx - r00 * cx - r01 * cy, cy - r10 * cx - r11 * cy
    return (k, *_shear_scale(r00 * a + r01 * c, r00 * b + r01 * d,
                             r00 * tx + r01 * ty + rt0, r10 * a + r11 * c,
                             r10 * b + r11 * d, r10 * tx + r11 * ty + rt1))


def _rot90(x: Tensor, k: Tensor) -> Tensor:
    kb = k[:, None, None, None]
    t = x.transpose(1, 2)
    out = torch.where(kb == 1, t.flip(1), x)
    out = torch.where(kb == 2, x.flip((1, 2)), out)
    return torch.where(kb == 3, t.flip(2), out)


def _round_pad(p: int, dim: int) -> int:
    q = 64 if dim % 128 == 0 and dim >= 256 else 4
    return max(q, ((p + q - 1) // q) * q)


def _round_if(mask: Tensor, f: Tensor) -> Tensor:
    return torch.where(mask, torch.floor(f + 0.5), f)


def _pass_x(planes, is_mask, s1, e1, tx, px):
    b, c, h, w = planes.shape
    wp, dev = w + 2 * px, planes.device
    ii = torch.arange(h, device=dev, dtype=torch.float32)
    offs = s1[:, None] * (ii[None, :] - (h - 1) / 2.0)
    kfloor = torch.floor(offs)
    frac = _round_if(is_mask, (offs - kfloor)[:, None, :, None])
    kmod = torch.remainder(kfloor.long(), wp)
    padded = F.pad(planes, (px, px))
    q = torch.arange(wp, device=dev)
    a = torch.remainder(q[None, None, :] + kmod[:, :, None], wp)
    o = torch.gather(padded, 3, a[:, None].expand(b, c, h, wp))
    n = torch.gather(padded, 3, torch.remainder(a + 1, wp)[:, None].expand(
        b, c, h, wp))
    src = ((q.float()[None, None, :] + offs[:, :, None]) - float(px))[:, None]
    res = (1.0 - frac) * o + frac * n
    res = torch.where(src >= w - 1.0, o, res)
    res = torch.where(src < 0.0, n, res)
    canvas = torch.where((src < -0.5) | (src > w - 0.5), 0.0, res)
    jj = torch.arange(w, device=dev, dtype=torch.float32)
    col = (e1[:, None] * jj[None, :] + tx[:, None]) + float(px)
    s0 = torch.floor(col)
    f = _round_if(is_mask, (col - s0)[:, None, None, :])
    i0 = s0.clamp(0, wp - 1).long()[:, None, None, :].expand(b, c, h, w)
    i1 = (s0 + 1).clamp(0, wp - 1).long()[:, None, None, :].expand(b, c, h, w)
    out = (1.0 - f) * torch.gather(canvas, 3, i0) + f * torch.gather(
        canvas, 3, i1)
    col = col[:, None, None, :]
    out = torch.where(col >= wp - 1.0, canvas[..., wp - 1:], out)
    out = torch.where(col < 0.0, canvas[..., :1], out)
    return torch.where((col >= -0.5) & (col <= wp - 0.5), out, 0.0)


def _pass_y(planes, is_mask, e2, ty, s2, py):
    b, c, h, w = planes.shape
    hp, dev = h + 2 * py, planes.device
    rr = torch.arange(hp, device=dev, dtype=torch.float32)
    srcy = e2[:, None] * (rr[None, :] - float(py)) + ty[:, None]
    s0 = torch.floor(srcy)
    f = _round_if(is_mask, (srcy - s0)[:, None, :, None])
    i0 = s0.clamp(0, h - 1).long()[:, None, :, None].expand(b, c, hp, w)
    i1 = (s0 + 1).clamp(0, h - 1).long()[:, None, :, None].expand(b, c, hp, w)
    canvas = (1.0 - f) * torch.gather(planes, 2, i0) + f * torch.gather(
        planes, 2, i1)
    sy = srcy[:, None, :, None]
    canvas = torch.where(sy >= h - 1.0, planes[:, :, h - 1:], canvas)
    canvas = torch.where(sy < 0.0, planes[:, :, :1], canvas)
    canvas = torch.where((sy >= -0.5) & (sy <= h - 0.5), canvas, 0.0)
    jj = torch.arange(w, device=dev, dtype=torch.float32)
    offs = s2[:, None] * (jj[None, :] - (w - 1) / 2.0)
    kfloor = torch.floor(offs)
    frac = _round_if(is_mask, (offs - kfloor)[:, None, None, :])
    kmod = torch.remainder(kfloor.long(), hp)
    rows = torch.arange(py, py + h, device=dev)
    a = torch.remainder(rows[None, :, None] + kmod[:, None, :], hp)
    o = torch.gather(canvas, 2, a[:, None].expand(b, c, h, w))
    nx = torch.gather(canvas, 2, torch.remainder(a + 1, hp)[:, None].expand(
        b, c, h, w))
    src = (rows.float()[None, :, None] + offs[:, None, :])[:, None]
    res = (1.0 - frac) * o + frac * nx
    res = torch.where(src >= hp - 1.0, o, res)
    res = torch.where(src < 0.0, nx, res)
    return torch.where((src < -0.5) | (src > hp - 0.5), 0.0, res)


def _elastic(planes, near, dy, dx, k):
    source = F.pad(planes, (0, 0, 0, 1))
    b, c, _, w = source.shape
    h, dev = dy.shape[1], planes.device
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    d = torch.clamp(yy + dy, 0.0, h - 1.0) - yy
    iy = torch.floor(d)
    fy = torch.where(near, torch.floor((d - iy)[:, None] + 0.5),
                     (d - iy)[:, None])
    r0 = yy.long() + iy.long()
    g0 = torch.gather(source, 2, r0[:, None].expand(b, c, h, w))
    g1 = torch.gather(source, 2, (r0 + 1)[:, None].expand(b, c, h, w))
    row = (1.0 - fy) * g0 + fy * g1
    row = torch.where(((iy >= -k) & (iy <= k))[:, None], row, 0.0)
    d = torch.clamp(xx + dx, 0.0, w - 1.0) - xx
    ix = torch.floor(d)
    fx = torch.where(near, torch.floor((d - ix)[:, None] + 0.5),
                     (d - ix)[:, None])
    x0 = torch.remainder(xx.long() + ix.long(), w)
    x1 = torch.remainder(x0 + 1, w)
    out = ((1.0 - fx) * torch.gather(row, 3, x0[:, None].expand(b, c, h, w))
           + fx * torch.gather(row, 3, x1[:, None].expand(b, c, h, w)))
    out = torch.where(((ix >= -k) & (ix <= k))[:, None], out, 0.0)
    sy, sx = yy + dy, xx + dx
    oob = (sy < -0.5) | (sy > h - 0.5) | (sx < -0.5) | (sx > w - 0.5)
    return torch.where(oob[:, None], 0.0, out)


def apply_block(draws, images: Tensor, masks: Tensor,
                st: BlockStatics) -> Tuple[Tensor, Tensor]:
    """images (B, H, W, 3) uint8, masks (B, H, W, 1) float32 → (images
    float32 on 0..255, masks float32)."""
    geo, mul = draws
    b, h, w, ci = images.shape
    mats = block_mats(geo[0], geo[1], h, w)
    dxf, dyf = elastic_field(geo[2], h, w, st.radius, st.stride)
    k = st.k
    a00, a01 = mats[:, 0, 0, None, None], mats[:, 0, 1, None, None]
    a10, a11 = mats[:, 1, 0, None, None], mats[:, 1, 1, None, None]
    det = a00 * a11 - a01 * a10
    det = torch.where(torch.abs(det) < 1e-6, torch.full_like(det, 1e-6), det)
    dxp = ((a11 * dxf - a01 * dyf) / det).clamp(-k, k)
    dyp = ((-a10 * dxf + a00 * dyf) / det).clamp(-k, k)
    # the affine passes (square frames: the rot90 pre-pass first)
    kk, s1, e1, e2, tx, ty, s2 = _decompose(mats, h, w)
    img = _rot90(images.float(), kk)
    msk = _rot90(masks.float(), kk)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    tx = tx + s1 * cy
    ty = ty + e2 * s2 * cx
    px = _round_pad(int(math.ceil(w * st.pad_frac)), w)
    py = _round_pad(int(math.ceil(h * st.pad_frac)), h)
    planes = torch.cat([img, msk], -1).permute(0, 3, 1, 2).contiguous()
    is_mask = torch.tensor([False] * ci + [True] * msk.shape[-1],
                           device=img.device).view(1, -1, 1, 1)
    planes = _pass_x(planes, is_mask, s1, e1, tx, px)
    planes = _pass_y(planes, is_mask, e2, ty, s2, py)
    planes = _elastic(planes, is_mask, dyp, dxp, k)
    out = planes.permute(0, 2, 3, 1)
    imgs = out[..., :ci] * mul["mul"][:, None, None, None]
    return torch.clamp(imgs, 0.0, 255.0), out[..., ci:]
