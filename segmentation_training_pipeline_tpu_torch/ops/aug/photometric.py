"""Photometric (pixel-value) augmenters — image only, mask untouched.

Counterpart of ``segmentation_training_pipeline_tpu/ops/aug/photometric.py``.
Parameters are per image, (B,), or per
image and channel, (B, C) (imgaug ``per_channel=True``); values live on
the 0..255 scale and the pipeline clips at its end.

Every random value is an argument (a normal, Laplace or Poisson sample, a
uniform, a bernoulli outcome or a permutation), so each function is
deterministic: the reference draws the same values inside its functions
from a key, and the tests hand its draws to these.

The colour functions keep the reference's order of float32 operations
(the colour matrices are written out elementwise, not as a matmul that
could run in TF32 on the card).

The filters convolve in full float32: cuDNN runs float32 convolutions in
TF32 by default on the card, which rounds a blur of 0..255 values by
~0.1, so every depthwise convolution runs under
``fast_warp._exact_f32`` (TF32 off for it alone; the model keeps its own
setting).  Where a threshold,
a rounding or an order statistic follows the sum (Canny's gradient,
JPEG's 8×8 transforms, the mean shift's colour gate), the sums are
written out tap by tap in one fixed order instead, so the card and the
CPU compute the same float32 value.  The histogram names count with
``scatter_add_`` and look up with ``torch.gather``: the reference's
broadcast compare-reduces (written so because XLA:TPU serialises scatter
and gather) would build a (…, N, 256) tensor in eager PyTorch.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...models.layers import resize_to
from .fast_warp import _exact_f32

Tensor = torch.Tensor

_ON_DEVICE: dict = {}


def _const(name: str, values: np.ndarray, device: torch.device) -> Tensor:
    """The host constant ``values`` on ``device``, copied there once: a
    host-to-card copy on every call would stall the host on the card."""
    key = (name, torch.device(device))
    t = _ON_DEVICE.get(key)
    if t is None:
        t = _ON_DEVICE[key] = torch.from_numpy(
            np.ascontiguousarray(values)).to(device)
    return t


def _bcast(param: Tensor) -> Tensor:
    """(B,) → (B, 1, 1, 1) or (B, C) → (B, 1, 1, C)."""
    if param.dim() == 2:
        return param[:, None, None, :]
    return param[:, None, None, None]


def multiply(images: Tensor, factor: Tensor) -> Tensor:
    return images * _bcast(factor)


def add(images: Tensor, value: Tensor) -> Tensor:
    return images + _bcast(value)


def linear_contrast(images: Tensor, alpha: Tensor) -> Tensor:
    """imgaug LinearContrast: 127 + alpha·(v − 127)."""
    return 127.0 + _bcast(alpha) * (images - 127.0)


def gamma_contrast(images: Tensor, gamma: Tensor) -> Tensor:
    """imgaug GammaContrast: 255·(v/255)^gamma, gamma (B,) or (B, C)."""
    x = torch.clamp(images, 0.0, 255.0) / 255.0
    return torch.pow(x, _bcast(gamma)) * 255.0


def sigmoid_contrast(images: Tensor, gain: Tensor, cutoff: Tensor) -> Tensor:
    """imgaug SigmoidContrast: 255 / (1 + exp(gain·(cutoff − v/255)))."""
    x = torch.clamp(images, 0.0, 255.0) / 255.0
    return 255.0 / (1.0 + torch.exp(_bcast(gain) * (_bcast(cutoff) - x)))


def log_contrast(images: Tensor, gain: Tensor) -> Tensor:
    """imgaug LogContrast: 255·gain·log2(1 + v/255)."""
    x = torch.clamp(images, 0.0, 255.0) / 255.0
    return 255.0 * _bcast(gain) * torch.log2(1.0 + x)


def additive_noise(images: Tensor, noise: Tensor, scale: Tensor) -> Tensor:
    """imgaug AdditiveGaussianNoise / AdditiveLaplaceNoise: ``noise`` is the
    (B, H, W, C) standard normal or Laplace sample, scaled per image."""
    return images + noise * _bcast(scale)


def additive_poisson_noise(images: Tensor, counts: Tensor) -> Tensor:
    """imgaug AdditivePoissonNoise: ``counts`` the Poisson(lam) sample of
    every value (non-negative)."""
    return images + counts


def invert(images: Tensor, flip: Tensor) -> Tensor:
    """255 − v where the per-image bernoulli ``flip`` (B,) holds."""
    return torch.where(_bcast(flip), 255.0 - images, images)


def solarize(images: Tensor, threshold: Tensor) -> Tensor:
    """Invert only values at or above the per-image threshold (PIL)."""
    return torch.where(images >= _bcast(threshold), 255.0 - images, images)


def pixel_dropout(images: Tensor, u: Tensor, p: Tensor) -> Tensor:
    """imgaug Dropout: zero the pixels whose uniform ``u`` (B, H, W, 1)
    falls below p (all channels together)."""
    return images * (u >= _bcast(p)).float()


def salt_and_pepper(images: Tensor, u: Tensor, p: Tensor) -> Tensor:
    """imgaug SaltAndPepper: a share p of the pixels (``u`` (B, H, W, 1))
    become 0 or 255, half each."""
    pp = _bcast(p)
    out = torch.where(u < pp * 0.5, 0.0, images)
    return torch.where((u >= pp * 0.5) & (u < pp), 255.0, out)


def impulse_noise(images: Tensor, u: Tensor, p: Tensor) -> Tensor:
    """imgaug ImpulseNoise: SaltAndPepper per channel (``u`` (B, H, W,
    C))."""
    return salt_and_pepper(images, u, p)


def salt(images: Tensor, u: Tensor, p: Tensor) -> Tensor:
    return torch.where(u < _bcast(p), 255.0, images)


def pepper(images: Tensor, u: Tensor, p: Tensor) -> Tensor:
    return torch.where(u < _bcast(p), 0.0, images)


def coarse_grid(h: int, w: int, size_frac: float):
    """The reference's coarse grid for CoarseDropout and the coarse salt
    and pepper: (round(h·f), round(w·f)), at least 1."""
    return (max(1, int(round(h * size_frac))),
            max(1, int(round(w * size_frac))))


def nearest_nhwc(x: Tensor, h: int, w: int) -> Tensor:
    """``jax.image.resize(x, (B, h, w, C), "nearest")``: source index
    floor((i + 0.5)·n / m), computed in float32 as JAX computes it."""

    def index(n: int, m: int) -> Tensor:
        pos = (torch.arange(m, dtype=torch.float32, device=x.device)
               + 0.5) * n / m
        return torch.floor(pos).long()

    if x.shape[1] != h:
        x = x.index_select(1, index(x.shape[1], h))
    if x.shape[2] != w:
        x = x.index_select(2, index(x.shape[2], w))
    return x


def coarse_dropout(images: Tensor, u: Tensor, p: Tensor) -> Tensor:
    """imgaug CoarseDropout: the coarse uniform ``u`` (B, gh, gw, 1) keeps
    a cell at u ≥ p; the cells are nearest-upsampled over the image."""
    keep = (u >= _bcast(p)).float()
    return images * nearest_nhwc(keep, images.shape[1], images.shape[2])


def coarse_salt_and_pepper(images: Tensor, u: Tensor, p: Tensor,
                           mode: str = "both") -> Tensor:
    """imgaug CoarseSaltAndPepper / CoarseSalt / CoarsePepper: the coarse
    uniform ``u``, nearest-upsampled, filled with 255/0."""
    u = nearest_nhwc(u, images.shape[1], images.shape[2])
    pp = _bcast(p)
    if mode == "salt":
        return torch.where(u < pp, 255.0, images)
    if mode == "pepper":
        return torch.where(u < pp, 0.0, images)
    return salt_and_pepper(images, u, p)


def posterize(images: Tensor, nb_bits: Tensor) -> Tensor:
    """Keep the top n bits of every value: n (B,) rounds (half to even) to
    an integer in [1, 8]."""
    n = _bcast(torch.clamp(torch.round(nb_bits), 1.0, 8.0))
    step = torch.exp2(8.0 - n)
    return torch.floor(torch.clamp(images, 0.0, 255.0) / step) * step


def channel_shuffle(images: Tensor, perm: Tensor, sel: Tensor) -> Tensor:
    """imgaug ChannelShuffle: the channels in the order ``perm`` (B, C)
    where the per-image bernoulli ``sel`` holds."""
    idx = perm.long()[:, None, None, :].expand(images.shape)
    return torch.where(_bcast(sel), torch.gather(images, 3, idx), images)


def dropout2d(images: Tensor, u: Tensor, p: Tensor, nb_keep: int = 1
              ) -> Tensor:
    """imgaug Dropout2d: zero whole channels whose uniform ``u`` (B, C)
    falls below p, keeping at least ``nb_keep`` (those of the largest
    draws, as the reference does)."""
    c = images.shape[-1]
    keep = u >= p[:, None]
    if nb_keep > 0:
        kth = torch.sort(u, dim=1).values[:, c - nb_keep][:, None]
        keep = keep | (u >= kth)
    return images * keep[:, None, None, :].float()


def total_dropout(images: Tensor, u: Tensor, p: Tensor) -> Tensor:
    """imgaug TotalDropout: zero the whole image where ``u`` (B,) < p."""
    return images * _bcast((u >= p).float())


def grayscale(images: Tensor, alpha: Tensor) -> Tensor:
    """Blend toward ITU-R 601 luminance by per-image alpha."""
    if images.shape[-1] != 3:
        return images
    lum = (0.299 * images[..., 0] + 0.587 * images[..., 1]
           + 0.114 * images[..., 2])[..., None]
    a = alpha[:, None, None, None]
    return (1.0 - a) * images + a * lum


# ---------------------------------------------------------------------------
# HSV / HLS (OpenCV uint8 convention: H in [0, 180), the rest 0..255)
# ---------------------------------------------------------------------------

def _hue6(r: Tensor, g: Tensor, b: Tensor, mx: Tensor, c: Tensor) -> Tensor:
    """The hue sector value in [0, 6) where c > 0 (wraps as ``jnp.mod``)."""
    safe_c = torch.where(c > 0, c, 1.0)
    hr = torch.remainder((g - b) / safe_c, 6.0)
    hg = (b - r) / safe_c + 2.0
    hb = (r - g) / safe_c + 4.0
    return torch.where(mx == r, hr, torch.where(mx == g, hg, hb))


def rgb_to_hsv(images: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    r, g, b = images[..., 0], images[..., 1], images[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = mx - mn
    h = torch.where(c > 0, _hue6(r, g, b, mx, c) * 30.0, 0.0)
    s = torch.where(mx > 0, c / torch.where(mx > 0, mx, 1.0), 0.0) * 255.0
    return h, s, mx


def _select6(i: Tensor, choices, default: Tensor) -> Tensor:
    """``jnp.select([i == 0, …, i == 4], choices, default)``."""
    out = default
    for k in range(len(choices) - 1, -1, -1):
        out = torch.where(i == k, choices[k], out)
    return out


def hsv_to_rgb(h: Tensor, s: Tensor, v: Tensor) -> Tensor:
    hh = h / 30.0
    c = (s / 255.0) * v
    x = c * (1.0 - torch.abs(torch.remainder(hh, 2.0) - 1.0))
    m = v - c
    zero = torch.zeros_like(c)
    i = torch.floor(hh).to(torch.int32) % 6
    r = _select6(i, [c, x, zero, zero, x], c)
    g = _select6(i, [x, c, c, x, zero], zero)
    b = _select6(i, [zero, zero, x, c, c], x)
    return torch.stack([r + m, g + m, b + m], dim=-1)


def add_to_hue_and_saturation(images: Tensor, value_hue: Tensor,
                              value_sat: Tensor) -> Tensor:
    """imgaug AddToHueAndSaturation: hue adds at half weight with
    wrap-around (H spans 0..180), saturation adds clipped."""
    if images.shape[-1] != 3:
        return images
    h, s, v = rgb_to_hsv(images)
    h = torch.remainder(h + 0.5 * value_hue[:, None, None], 180.0)
    s = torch.clamp(s + value_sat[:, None, None], 0.0, 255.0)
    return hsv_to_rgb(h, s, v)


def multiply_hue_and_saturation(images: Tensor, mul_hue: Tensor,
                                mul_sat: Tensor) -> Tensor:
    """imgaug MultiplyHueAndSaturation: hue scales about 0 with
    wrap-around, saturation scales clipped."""
    if images.shape[-1] != 3:
        return images
    h, s, v = rgb_to_hsv(images)
    h = torch.remainder(h * mul_hue[:, None, None], 180.0)
    s = torch.clamp(s * mul_sat[:, None, None], 0.0, 255.0)
    return hsv_to_rgb(h, s, v)


def _rgb_to_hls(images: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    r, g, b = images[..., 0], images[..., 1], images[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = mx - mn
    h = torch.where(c > 0, _hue6(r, g, b, mx, c), 0.0) * 30.0
    lsum = mx + mn                                          # = 2L
    light = 0.5 * lsum
    s = torch.where(c > 0,
                    c / torch.where(light <= 127.5,
                                    torch.clamp(lsum, min=1.0),
                                    torch.clamp(510.0 - lsum, min=1.0)),
                    0.0) * 255.0
    return h, light, s


def _luminance(images: Tensor) -> Tensor:
    return (0.299 * images[..., 0] + 0.587 * images[..., 1]
            + 0.114 * images[..., 2])


def change_colorspace(images: Tensor, to_colorspace: str,
                      alpha: Tensor) -> Tensor:
    """imgaug ChangeColorspace: the image re-encoded INTO
    ``to_colorspace`` (cv2 uint8 scale), alpha-blended with the RGB
    input; GRAY tiles the luminance to 3 channels."""
    cs = to_colorspace.upper()
    if cs == "RGB":
        return images
    if cs == "BGR":
        conv = images.flip(-1)
    elif cs == "GRAY":
        conv = _luminance(images)[..., None].expand(images.shape)
    elif cs == "HSV":
        conv = torch.stack(rgb_to_hsv(images), dim=-1)
    elif cs == "HLS":
        conv = torch.stack(_rgb_to_hls(images), dim=-1)
    elif cs == "YCRCB":
        y = _luminance(images)
        cr = (images[..., 0] - y) * 0.713 + 128.0
        cb = (images[..., 2] - y) * 0.564 + 128.0
        conv = torch.stack([y, cr, cb], dim=-1)
    else:
        raise ValueError(f"ChangeColorspace: unsupported {to_colorspace!r}")
    a = alpha[:, None, None, None]
    return a * conv + (1.0 - a) * images


def change_color_temperature(images: Tensor, kelvin: Tensor) -> Tensor:
    """imgaug ChangeColorTemperature on the reference's analytic
    blackbody fit (Tanner Helland's): RGB scaled by the colour at
    ``kelvin`` (B,)."""
    if images.shape[-1] != 3:
        return images
    t = torch.clamp(kelvin, 1000.0, 40000.0) / 100.0
    hot = torch.clamp(t - 60.0, min=1e-6)
    red = torch.where(t <= 66.0, 255.0,
                      329.698727446 * torch.pow(hot, -0.1332047592))
    green = torch.where(
        t <= 66.0,
        99.4708025861 * torch.log(torch.clamp(t, min=1e-6))
        - 161.1195681661,
        288.1221695283 * torch.pow(hot, -0.0755148492))
    blue = torch.where(t >= 66.0, 255.0,
                       torch.where(t <= 19.0, 0.0,
                                   138.5177312231
                                   * torch.log(torch.clamp(t - 10.0,
                                                           min=1e-6))
                                   - 305.0447927307))
    rgb = torch.clamp(torch.stack([red, green, blue], dim=-1), 0.0,
                      255.0) / 255.0
    return images * rgb[:, None, None, :]


# ---------------------------------------------------------------------------
# histograms: Autocontrast, HistogramEqualization, CLAHE
# ---------------------------------------------------------------------------

def hist256(values: Tensor) -> Tensor:
    """(G, N) integer values in 0..255 → (G, 256) float32 counts, by one
    ``scatter_add_`` over (row, value) bins.  Every partial count is an
    integer below 2²⁴, so the float32 sums are exact in any order."""
    g = values.shape[0]
    bins = values.long() + 256 * torch.arange(g, device=values.device)[:, None]
    hist = torch.zeros(g * 256, dtype=torch.float32, device=values.device)
    hist.scatter_add_(0, bins.reshape(-1),
                      torch.ones(bins.numel(), dtype=torch.float32,
                                 device=values.device))
    return hist.reshape(g, 256)


def _channel_rows(images: Tensor) -> Tensor:
    """(B, H, W, C) → (B·C, H·W)."""
    b, h, w, c = images.shape
    return images.permute(0, 3, 1, 2).reshape(b * c, h * w)


def _from_channel_rows(rows: Tensor, shape) -> Tensor:
    b, h, w, c = shape
    return rows.reshape(b, c, h, w).permute(0, 2, 3, 1)


def autocontrast(images: Tensor, cutoff: float = 0.0) -> Tensor:
    """PIL ``ImageOps.autocontrast`` per channel: each channel's
    [cutoff, 100 − cutoff] percent range stretched to 0..255 (the cutoff
    removes ``int(cutoff·N/100)`` counts from each end of its histogram);
    a channel with no range passes through."""
    x = torch.clamp(images, 0.0, 255.0)
    flat = _channel_rows(x)
    if cutoff > 0.0:
        hist = hist256(torch.round(flat).long())
        cut = float(int(cutoff * images.shape[1] * images.shape[2] / 100.0))
        # the first bin whose running count passes the cut
        lo = torch.argmax((torch.cumsum(hist, -1) > cut).to(torch.uint8), -1)
        hi = 255 - torch.argmax(
            (torch.cumsum(hist.flip(-1), -1) > cut).to(torch.uint8), -1)
        lo = lo[:, None].float()
        hi = hi[:, None].float()
    else:
        lo = flat.amin(-1, keepdim=True)
        hi = flat.amax(-1, keepdim=True)
    # 255 / d, not ``255.0 / d`` (PyTorch's reciprocal times 255)
    scale = torch.full_like(lo, 255.0) / torch.clamp(hi - lo, min=1e-6)
    out = torch.where(hi > lo, (flat - lo) * scale, flat)
    return _from_channel_rows(torch.clamp(out, 0.0, 255.0), images.shape)


def histogram_equalization(images: Tensor) -> Tensor:
    """cv2.equalizeHist per channel: ``lut[v] = round((cdf[v] − cdf_min)
    · 255 / (N − cdf_min))``, cdf_min at the lowest occupied bin."""
    n = images.shape[1] * images.shape[2]
    flat = _channel_rows(torch.clamp(torch.round(images), 0, 255).long())
    hist = hist256(flat)
    cdf = torch.cumsum(hist, -1)
    cdf_min = torch.where(hist > 0, cdf, float(n + 1)).amin(-1, keepdim=True)
    denom = torch.clamp(n - cdf_min, min=1.0)
    lut = torch.clamp(torch.round((cdf - cdf_min) * 255.0 / denom), 0, 255)
    return _from_channel_rows(torch.gather(lut, 1, flat), images.shape)


def _true_div(x: Tensor, d: float) -> Tensor:
    """``x / d`` correctly rounded on every device: PyTorch's CUDA kernels
    divide by a host scalar as a multiply by its reciprocal, which rounds
    differently from the CPU (and the reference) where ``d`` is no power
    of two."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _clahe_weights(n: int, t: int, g: int, blocked: bool, device):
    """Per row (or column) of the padded frame: the two neighbouring tile
    indices and the weight of the second, as the reference's two
    interpolation branches compute them (``_clahe_apply_blocked`` on even
    tiles, ``_clahe_apply_gather`` otherwise: the same value up to the
    rounding of the weight)."""
    pos = torch.arange(n, device=device)
    if blocked:
        t2 = t // 2
        p, within = pos // t2, pos % t2
        w1 = (p % 2 == 0).float() * 0.5 + _true_div(within.float(), t)
        i0 = torch.clamp(torch.div(p - 1, 2, rounding_mode="floor"), 0,
                         g - 1)
        i1 = torch.clamp(torch.div(p + 1, 2, rounding_mode="floor"), 0,
                         g - 1)
        return i0, i1, w1
    tf = _true_div(pos.float(), t) - 0.5
    i0f = torch.floor(tf)
    w1 = tf - i0f
    return (torch.clamp(i0f, 0, g - 1).long(),
            torch.clamp(i0f + 1, 0, g - 1).long(), w1)


def clahe(images: Tensor, clip_limit: Tensor, tile_grid: int = 8) -> Tensor:
    """cv2 CLAHE per channel (imgaug AllChannelsCLAHE): a clipped 256-bin
    histogram per tile of a ``tile_grid``² grid → a LUT, bilinearly
    interpolated between the four neighbouring tiles' LUTs at each pixel
    (one gather per tap).  A frame that does not divide pads with
    reflect-101; counts clip at ``max(floor(clip_limit·area/256), 1)``
    (``clip_limit`` ≤ 0: no clipping) and the excess is redistributed by
    cv2's integer quotient plus strided residual."""
    b, h, w, c = images.shape
    g = int(tile_grid)
    th, tw = -(-h // g), -(-w // g)
    pad_h, pad_w = th * g - h, tw * g - w
    x = images.permute(0, 3, 1, 2)                      # (B, C, H, W)
    if pad_h or pad_w:
        x = F.pad(x, (0, pad_w, 0, pad_h), mode="reflect")
    big_h, big_w = th * g, tw * g
    area = th * tw
    v = torch.clamp(torch.round(x), 0, 255).long()
    tiles = (v.reshape(b, c, g, th, g, tw).permute(0, 1, 2, 4, 3, 5)
              .reshape(b * c * g * g, area))
    hist = hist256(tiles).reshape(b, c, g, g, 256)
    cl = torch.clamp(torch.floor(clip_limit * area / 256.0), min=1.0)
    cl = torch.where(clip_limit > 0.0, cl, float(area))
    cl = cl[:, None, None, None, None]
    excess = torch.clamp(hist - cl, min=0.0).sum(-1, keepdim=True)
    quot = torch.floor(excess / 256.0)
    res = excess - 256.0 * quot
    step = torch.clamp(torch.floor(256.0 / torch.clamp(res, min=1.0)),
                       min=1.0)
    idx = torch.arange(256, dtype=torch.float32, device=images.device)
    inc = ((torch.remainder(idx, step) == 0.0)
           & (torch.floor(idx / step) < res)).float()
    hist = torch.minimum(hist, cl) + quot + inc
    lut = torch.clamp(torch.round(torch.cumsum(hist, -1) * (255.0 / area)),
                      0.0, 255.0).reshape(b * c, g * g * 256)

    blocked = th % 2 == 0 and tw % 2 == 0
    iy0, iy1, wy = _clahe_weights(big_h, th, g, blocked, images.device)
    ix0, ix1, wx = _clahe_weights(big_w, tw, g, blocked, images.device)
    wy, wx = wy[:, None], wx[None, :]
    vf = v.reshape(b * c, big_h * big_w)

    def tap(iy: Tensor, ix: Tensor) -> Tensor:
        base = ((iy[:, None] * g + ix[None, :]) * 256).reshape(1, -1)
        return torch.gather(lut, 1, vf + base).reshape(b * c, big_h, big_w)

    out = ((1.0 - wy) * (1.0 - wx) * tap(iy0, ix0)
           + (1.0 - wy) * wx * tap(iy0, ix1)
           + wy * (1.0 - wx) * tap(iy1, ix0)
           + wy * wx * tap(iy1, ix1))
    out = torch.round(out).reshape(b, c, big_h, big_w)[:, :, :h, :w]
    return out.permute(0, 2, 3, 1)



# ---------------------------------------------------------------------------
# filters (blurs, 3×3 kernels, pooling, medians, JPEG, Canny, mean shift)
# ---------------------------------------------------------------------------

def _pad_index(n: int, r: int, mode: str, device) -> Tensor:
    """Source indices of [−r, n + r) under ``jnp.pad``'s "reflect"
    (reflect-101, any width) or "edge"."""
    i = torch.arange(-r, n + r, device=device)
    if mode == "edge" or n == 1:
        return torch.clamp(i, 0, n - 1)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i > n - 1, period - i, i)


def _pad(x: Tensor, dim: int, r: int, mode: str) -> Tensor:
    if r == 0:
        return x
    return x.index_select(dim, _pad_index(x.shape[dim], r, mode, x.device))


def _planes(images: Tensor) -> Tensor:
    """(B, H, W, C) → (1, B·C, H, W): one plane per image and channel."""
    b, h, w, c = images.shape
    return images.permute(0, 3, 1, 2).reshape(1, b * c, h, w)


def _from_planes(x: Tensor, b: int, c: int) -> Tensor:
    return x.reshape(b, c, x.shape[-2], x.shape[-1]).permute(0, 2, 3, 1)


def _depthwise(planes: Tensor, kern: Tensor, c: int) -> Tensor:
    """A VALID depthwise convolution of padded planes (1, B·C, H, W) with
    a per-image kernel ``kern`` (B, kh, kw), one grouped ``conv2d`` in
    float32 (cross-correlation, as ``lax.conv_general_dilated``)."""
    b, kh, kw = kern.shape
    weight = kern[:, None].expand(b, c, kh, kw).reshape(b * c, 1, kh, kw)
    with _exact_f32(planes.device):
        return F.conv2d(planes, weight.contiguous(), groups=b * c)


def _separable_filter(images: Tensor, kern: Tensor, radius: int) -> Tensor:
    """A per-image separable 1-D kernel (B, K) along x then y with
    reflect-101 padding (gaussian_blur / average_blur)."""
    b, _, _, c = images.shape
    x = _pad(_planes(images), 3, radius, "reflect")
    x = _depthwise(x, kern[:, None, :], c)
    x = _pad(x, 2, radius, "reflect")
    return _from_planes(_depthwise(x, kern[:, :, None], c), b, c)


def gaussian_blur(images: Tensor, sigma: Tensor, radius: int = 3) -> Tensor:
    """Separable per-image gaussian blur, sigma (B,); sigma ≈ 0 is the
    identity kernel."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=images.device)
    k = torch.exp(-0.5 * (x[None, :] / torch.clamp(sigma[:, None], min=1e-3))
                  ** 2)
    return _separable_filter(images, k / k.sum(1, keepdim=True), radius)


def average_blur(images: Tensor, k: Tensor, radius: int = 3) -> Tensor:
    """imgaug AverageBlur: a k×k box, k (B,) rounded to the nearest odd
    ≤ 2·radius + 1 (k ≤ 1 is the identity)."""
    half = torch.clamp(torch.floor((k - 1.0) / 2.0 + 0.5), 0, radius)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=images.device).abs()
    kern = (x[None, :] <= half[:, None]).float()
    return _separable_filter(images, kern / kern.sum(1, keepdim=True),
                             radius)


def _kxk(images: Tensor, kern: Tensor, radius: int) -> Tensor:
    """Reflect-101-padded depthwise (2r+1)² convolution, kern (B, K, K)."""
    b, _, _, c = images.shape
    x = _pad(_pad(_planes(images), 2, radius, "reflect"), 3, radius,
             "reflect")
    return _from_planes(_depthwise(x, kern, c), b, c)


def _blend(images: Tensor, alpha: Tensor, other: Tensor) -> Tensor:
    a = alpha[:, None, None, None]
    return (1.0 - a) * images + a * other


def sharpen(images: Tensor, alpha: Tensor, lightness: Tensor) -> Tensor:
    """imgaug Sharpen: blend with the unnormalised 3×3 kernel
    [[-1,-1,-1],[-1, 8+l,-1],[-1,-1,-1]] (it sums to l)."""
    lap = torch.full((images.shape[0], 3, 3), -1.0, device=images.device)
    lap[:, 1, 1] = 8.0 + lightness
    return _blend(images, alpha, _kxk(images, lap, 1))


def emboss(images: Tensor, alpha: Tensor, strength: Tensor) -> Tensor:
    """imgaug Emboss: blend with an embossing 3×3 response."""
    s = strength
    z, one = torch.zeros_like(s), torch.ones_like(s)
    k = torch.stack([torch.stack([-1.0 - s, -s, z], -1),
                     torch.stack([-s, one, s], -1),
                     torch.stack([z, s, 1.0 + s], -1)], 1)
    return _blend(images, alpha, _kxk(images, k, 1))


_EDGE_KERNEL = np.array([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]],
                        np.float32)


def edge_detect(images: Tensor, alpha: Tensor) -> Tensor:
    """imgaug EdgeDetect: blend toward the 3×3 response
    [[0,1,0],[1,-4,1],[0,1,0]]."""
    k = _const("edge", _EDGE_KERNEL, images.device)
    return _blend(images, alpha,
                  _kxk(images, k.expand(images.shape[0], 3, 3), 1))


_DIRECTED_CELLS = np.array([(x_, y_) for y_ in (-1, 0, 1) for x_ in (-1, 0, 1)
                            if (x_, y_) != (0, 0)], np.float32)
_DIRECTED_UNIT = _DIRECTED_CELLS / np.linalg.norm(_DIRECTED_CELLS, axis=1,
                                                  keepdims=True)


def directed_edge_detect(images: Tensor, alpha: Tensor,
                         direction: Tensor) -> Tensor:
    """imgaug DirectedEdgeDetect: a per-image 3×3 kernel whose 8 neighbour
    cells weigh in by angular similarity (1 − angle/180°)⁴ to the
    direction (``direction`` in [0, 1] ~ [0, 360) degrees, 0 up),
    normalised, negated, centre 1, blended with the identity by alpha."""
    deg = torch.remainder(torch.floor(direction * 360.0), 360.0)
    rad = deg * (math.pi / 180.0) - 0.5 * math.pi
    cu = _const("directed", _DIRECTED_UNIT, images.device)       # (8, 2)
    # the (8, 2)·(2,) products written out: no matmul on the card
    cosang = torch.clamp(cu[None, :, 0] * torch.cos(rad)[:, None]
                         + cu[None, :, 1] * torch.sin(rad)[:, None],
                         -1.0, 1.0)                               # (B, 8)
    sim = (1.0 - torch.arccos(cosang) / math.pi) ** 4
    sim = sim / sim.sum(1, keepdim=True)
    b = sim.shape[0]
    eff = torch.cat([-sim[:, :4], torch.ones((b, 1), device=sim.device),
                     -sim[:, 4:]], 1).reshape(b, 3, 3)
    ident = torch.zeros((3, 3), device=sim.device)
    ident[1, 1] = 1.0
    a = alpha[:, None, None]
    return _kxk(images, (1.0 - a) * ident[None] + a * eff, 1)


def motion_blur(images: Tensor, k: Tensor, angle: Tensor,
                radius: int = 3) -> Tensor:
    """imgaug MotionBlur: a (2·radius+1)² kernel with a 1-px anti-aliased
    line through the centre at ``angle`` degrees (0 blurs vertically),
    its taps beyond the per-image half length k//2 zero, normalised to
    sum 1; one grouped convolution for the batch."""
    coords = torch.arange(-radius, radius + 1, dtype=torch.float32,
                          device=images.device)
    gy, gx = torch.meshgrid(coords, coords, indexing="ij")
    half = torch.clamp(torch.floor((k - 1.0) / 2.0 + 0.5), 1, radius)
    a = angle * (math.pi / 180.0)
    dx, dy = torch.sin(a)[:, None, None], torch.cos(a)[:, None, None]
    proj = gx[None] * dx + gy[None] * dy
    perp = torch.abs(gx[None] * dy - gy[None] * dx)
    w = (torch.clamp(1.0 - perp, 0.0, 1.0)
         * torch.clamp(half[:, None, None] + 1.0 - proj.abs(), 0.0, 1.0))
    w = w / torch.clamp(w.sum((1, 2), keepdim=True), min=1e-8)
    return _kxk(images, w, radius)


def keep_size_pooling(images: Tensor, ksize: int, mode: str) -> Tensor:
    """imgaug {Average,Max,Min}Pooling, keep_size: a k×k window at stride
    k with XLA's SAME padding (the average over the frame's own pixels),
    nearest-resized back."""
    b, h, w, c = images.shape
    k = int(ksize)
    if k <= 1:
        return images

    def same(n):
        out = -(-n // k)
        total = max((out - 1) * k + k - n, 0)
        return out, total // 2, total - total // 2

    (ho, th, bh), (wo, lw, rw) = same(h), same(w)
    fill = {"avg": 0.0, "max": -math.inf, "min": math.inf}[mode]
    x = F.pad(images, (0, 0, lw, rw, th, bh), value=fill)
    x = x.reshape(b, ho, k, wo, k, c)
    if mode == "max":
        red = x.amax((2, 4))
    elif mode == "min":
        red = x.amin((2, 4))
    else:
        ones = F.pad(torch.ones((1, h, w, 1), device=images.device),
                     (0, 0, lw, rw, th, bh))
        counts = ones.reshape(1, ho, k, wo, k, 1).sum((2, 4))
        red = x.sum((2, 4)) / counts
    return nearest_nhwc(red, h, w)


def median_pooling(images: Tensor, ksize: int) -> Tensor:
    """imgaug MedianPooling, keep_size: the median of each k×k block at
    stride k (edge-padded at the bottom and right to a multiple of k),
    nearest-resized back; an even k² averages the middle two."""
    b, h, w, c = images.shape
    k = int(ksize)
    if k <= 1:
        return images
    x = _pad_end(_pad_end(images, 1, (-h) % k), 2, (-w) % k)
    hb, wb = x.shape[1] // k, x.shape[2] // k
    x = (x.reshape(b, hb, k, wb, k, c).permute(0, 1, 3, 5, 2, 4)
          .reshape(b, hb, wb, c, k * k))
    srt = torch.sort(x, dim=-1).values
    k2 = k * k
    med = (srt[..., k2 // 2] if k2 % 2
           else 0.5 * (srt[..., k2 // 2 - 1] + srt[..., k2 // 2]))
    return nearest_nhwc(med, h, w)


def _pad_end(x: Tensor, dim: int, n: int) -> Tensor:
    """Edge padding of ``n`` at the end of ``dim``."""
    if n == 0:
        return x
    idx = torch.clamp(torch.arange(x.shape[dim] + n, device=x.device),
                      max=x.shape[dim] - 1)
    return x.index_select(dim, idx)


# the 19-comparator median-of-9 network (Smith 1996 / Paeth), min for min
_MEDIAN9 = [(1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7),
            (1, 2), (4, 5), (7, 8), (0, 3), (5, 8), (4, 7),
            (3, 6), (1, 4), (2, 5), (4, 7), (4, 2), (6, 4), (4, 2)]
# the images a median sort takes at once: its k² stack stays near 256 MiB
_SORT_BYTES = 1 << 28


def median_blur(images: Tensor, ksize: int = 3) -> Tensor:
    """cv2/imgaug MedianBlur with a static odd ``ksize`` (edge border):
    k = 3 through the median-of-9 network; a larger k sorts the k² taps
    of a few images at a time and takes the middle one (k² is odd: the
    middle element is the median, no average of two)."""
    if ksize <= 1:
        return images
    r = ksize // 2
    b, h, w, c = images.shape
    pad = _pad(_pad(images, 1, r, "edge"), 2, r, "edge")

    def taps(x):
        return [x[:, dy:dy + h, dx:dx + w, :]
                for dy in range(ksize) for dx in range(ksize)]

    if ksize == 3:
        t = taps(pad)
        for i, j in _MEDIAN9:
            t[i], t[j] = torch.minimum(t[i], t[j]), torch.maximum(t[i], t[j])
        return t[4]
    k2 = ksize * ksize
    per = max(1, _SORT_BYTES // (k2 * h * w * c * 4))
    return torch.cat([
        torch.sort(torch.stack(taps(pad[i:i + per]), -1), dim=-1)
        .values[..., k2 // 2] for i in range(0, b, per)])


def bilateral_blur(images: Tensor, d: Tensor, sigma_color: Tensor,
                   sigma_space: Tensor, max_radius: int) -> Tensor:
    """cv2/imgaug BilateralBlur at a static ``max_radius``: each tap
    weighs in as a spatial gaussian (``sigma_space``; zero beyond the
    per-image d//2) times a range gaussian of the summed per-channel
    absolute colour difference to the centre (``sigma_color``); edge
    border.  Accumulated tap by tap."""
    b, h, w, c = images.shape
    rr = int(max_radius)
    if rr <= 0:
        return images
    radius = torch.floor(torch.floor(d) / 2.0)[:, None, None]
    sc = torch.clamp(sigma_color, min=1e-3)[:, None, None, None]
    ss = torch.clamp(sigma_space, min=1e-3)[:, None, None]
    pad = _pad(_pad(images, 1, rr, "edge"), 2, rr, "edge")
    num = torch.zeros_like(images)
    den = torch.zeros((b, h, w, 1), device=images.device)
    for dy in range(-rr, rr + 1):
        for dx in range(-rr, rr + 1):
            tap = pad[:, rr + dy:rr + dy + h, rr + dx:rr + dx + w, :]
            r2 = float(dy * dy + dx * dx)
            w_s = (torch.exp(-0.5 * r2 / (ss * ss))
                   * (math.sqrt(r2) <= radius + 1e-6))
            dcol = torch.abs(tap - images).sum(-1, keepdim=True)
            wgt = w_s[..., None] * torch.exp(-0.5 * (dcol / sc) ** 2)
            num = num + wgt * tap
            den = den + wgt
    return num / den


# --- JPEG compression (imgaug JpegCompression) ------------------------------
# Annex-K quantisation tables; quality scaling as libjpeg's
# jpeg_quality_scaling (5000/q below 50, 200 − 2q above)

_JPEG_LUMA_Q = np.array(
    [[16, 11, 10, 16, 24, 40, 51, 61],
     [12, 12, 14, 19, 26, 58, 60, 55],
     [14, 13, 16, 24, 40, 57, 69, 56],
     [14, 17, 22, 29, 51, 87, 80, 62],
     [18, 22, 37, 56, 68, 109, 103, 77],
     [24, 35, 55, 64, 81, 104, 113, 92],
     [49, 64, 78, 87, 103, 121, 120, 101],
     [72, 92, 95, 98, 112, 100, 103, 99]], np.float32)

_JPEG_CHROMA_Q = np.array(
    [[17, 18, 24, 47, 99, 99, 99, 99],
     [18, 21, 26, 66, 99, 99, 99, 99],
     [24, 26, 56, 99, 99, 99, 99, 99],
     [47, 66, 99, 99, 99, 99, 99, 99],
     [99, 99, 99, 99, 99, 99, 99, 99],
     [99, 99, 99, 99, 99, 99, 99, 99],
     [99, 99, 99, 99, 99, 99, 99, 99],
     [99, 99, 99, 99, 99, 99, 99, 99]], np.float32)


def _dct8() -> np.ndarray:
    """The orthonormal 8-point DCT-II matrix: built in float64, then cast
    to float32, as the reference builds it."""
    n = np.arange(8, dtype=np.float64)
    d = np.cos((2.0 * n[None, :] + 1.0) * n[:, None] * np.pi / 16.0)
    d[0] *= np.sqrt(0.5)
    return (d * 0.5).astype(np.float32)


_DCT8 = _dct8()


def _jpeg_qtable(name: str, base: np.ndarray, quality: Tensor) -> Tensor:
    q = torch.clamp(quality, 1.0, 100.0)
    scale = torch.where(q < 50.0, 5000.0 / q, 200.0 - 2.0 * q)
    t = torch.floor((_const(name, base, quality.device)[None]
                     * scale[:, None, None] + 50.0) / 100.0)
    return torch.clamp(t, 1.0, 255.0)                     # (B, 8, 8)


def _contract(x: Tensor, dim: int, transpose: bool) -> Tensor:
    """out[..., u, ...] = Σ_i m[u, i]·x[..., i, ...] along ``dim`` (size 8)
    with m = d (or dᵀ), summed in the order i = 0..7 by elementwise
    float32 operations: the same value on every device (a matmul's order
    is the library's, and a coefficient at a rounding tie moves a whole
    quantisation step)."""
    d = _DCT8.T if transpose else _DCT8
    m = _const("dct8T" if transpose else "dct8", d, x.device)
    shape = [1] * x.dim()
    shape[dim] = 8
    out = None
    for i in range(8):
        col = m[:, i].reshape(shape)
        term = col * x.narrow(dim, i, 1)
        out = term if out is None else out + term
    return out


def _dct_quant_plane(plane: Tensor, qt: Tensor) -> Tensor:
    """8×8 block DCT → quantise/dequantise → inverse, contracted as the
    reference's einsums are (rows i first, then columns j; the inverse
    over u, then v).  plane (B, H, W), H and W multiples of 8."""
    b, h, w = plane.shape
    blocks = plane.reshape(b, h // 8, 8, w // 8, 8)
    coef = _contract(_contract(blocks, 2, False), 4, False)
    qb = qt[:, None, :, None, :]
    coef = torch.round(coef / qb) * qb
    out = _contract(_contract(coef, 2, True), 4, True)
    return out.reshape(b, h, w)


def _upsample2x_bilinear(p: Tensor) -> Tensor:
    """``jax.image.resize`` of (B, h, w) to (B, 2h, 2w), bilinear: the
    half-pixel weights 0.75 / 0.25 with clamped edges, written out."""
    def axis(x, dim):
        n = x.shape[dim]
        idx = torch.arange(n, device=x.device)
        prev = x.index_select(dim, torch.clamp(idx - 1, min=0))
        nxt = x.index_select(dim, torch.clamp(idx + 1, max=n - 1))
        even = 0.25 * prev + 0.75 * x
        odd = 0.75 * x + 0.25 * nxt
        out = torch.stack([even, odd], dim + 1)
        shape = list(x.shape)
        shape[dim] = 2 * n
        return out.reshape(shape)

    return axis(axis(p, 1), 2)


def jpeg_compression(images: Tensor, quality: Tensor) -> Tensor:
    """imgaug JpegCompression simulated: RGB → YCbCr (BT.601 full range),
    4:2:0 chroma (2×2 mean down, half-pixel bilinear up), 8×8 block DCT
    quantisation with the Annex-K tables at per-image ``quality`` (B,);
    the lossless entropy stage skipped.  Rounded and clipped
    ``jpeg_decoded``."""
    if images.shape[-1] not in (1, 3):
        return images
    return torch.clamp(torch.round(jpeg_decoded(images, quality)), 0.0,
                       255.0)


def jpeg_decoded(images: Tensor, quality: Tensor) -> Tensor:
    """JpegCompression's decoded RGB before its final rounding (the frame
    cropped back), images with 1 or 3 channels."""
    b, h, w, c = images.shape
    pad_h, pad_w = (-h) % 16, (-w) % 16
    x = _pad_end(_pad_end(torch.clamp(images, 0.0, 255.0), 1, pad_h), 2,
                 pad_w)
    big_h, big_w = h + pad_h, w + pad_w
    q_luma = _jpeg_qtable("luma_q", _JPEG_LUMA_Q, quality)
    if c == 1:
        out = _dct_quant_plane(x[..., 0] - 128.0, q_luma)[..., None] + 128.0
    else:
        r, g, bl = x[..., 0], x[..., 1], x[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * bl
        cb = -0.168736 * r - 0.331264 * g + 0.5 * bl + 128.0
        cr = 0.5 * r - 0.418688 * g - 0.081312 * bl + 128.0
        q_chroma = _jpeg_qtable("chroma_q", _JPEG_CHROMA_Q, quality)
        yq = _dct_quant_plane(y - 128.0, q_luma) + 128.0

        def chroma(p: Tensor) -> Tensor:
            q4 = p.reshape(b, big_h // 2, 2, big_w // 2, 2)
            ds = (((q4[:, :, 0, :, 0] + q4[:, :, 0, :, 1])
                   + q4[:, :, 1, :, 0]) + q4[:, :, 1, :, 1]) / 4.0
            dq = _dct_quant_plane(ds - 128.0, q_chroma) + 128.0
            return _upsample2x_bilinear(dq)

        cbq, crq = chroma(cb), chroma(cr)
        out = torch.stack([yq + 1.402 * (crq - 128.0),
                           yq - 0.344136 * (cbq - 128.0)
                           - 0.714136 * (crq - 128.0),
                           yq + 1.772 * (cbq - 128.0)], -1)
    return out[:, :h, :w, :]


# --- Canny, mean shift, Cartoon ---------------------------------------------

_SOBEL = {3: ([-1.0, 0.0, 1.0], [1.0, 2.0, 1.0]),
          5: ([-1.0, -2.0, 0.0, 2.0, 1.0], [1.0, 4.0, 6.0, 4.0, 1.0]),
          7: ([-1.0, -4.0, -5.0, 0.0, 5.0, 4.0, 1.0],
              [1.0, 6.0, 15.0, 20.0, 15.0, 6.0, 1.0])}


def _taps(pad: Tensor, k2: np.ndarray, h: int, w: int) -> Tensor:
    """A VALID 2-D correlation of padded (B, H + 2r, W + 2r) with the
    constant ``k2``, summed tap by tap in row-major order (zero taps
    skipped: adding 0 changes no value)."""
    out = None
    for dy in range(k2.shape[0]):
        for dx in range(k2.shape[1]):
            if k2[dy, dx] == 0.0:
                continue
            term = float(k2[dy, dx]) * pad[:, dy:dy + h, dx:dx + w]
            out = term if out is None else out + term
    return out


def canny_edges(images: Tensor, lo: Tensor, hi: Tensor, sobel_k: int = 3,
                hysteresis_iters: int = 16) -> Tensor:
    """The Canny chain on ITU-R 601 luminance → (B, H, W) bool: sobel
    (reflect-101, aperture 3/5/7, float32 summed tap by tap), L1
    magnitude, 4-sector non-maximum suppression (the sector rounded from
    the gradient's angle over π/4; ties keep the pixel),
    double threshold, and ``hysteresis_iters`` rounds of 3×3 dilation
    through the weak pixels."""
    b, h, w, _ = images.shape
    lum = _luminance(images)                                    # (B, H, W)
    d1, sm = (np.array(v, np.float32) for v in _SOBEL[sobel_k])
    r = sobel_k // 2
    pad = _pad(_pad(lum, 1, r, "reflect"), 2, r, "reflect")
    gx = _taps(pad, np.outer(sm, d1), h, w)      # d/dx: smooth y, diff x
    gy = _taps(pad, np.outer(d1, sm), h, w)      # d/dy: smooth x, diff y
    mag = gx.abs() + gy.abs()
    # the sector from a float64 atan2 of the float32 gradient: the card's
    # and the CPU's float32 atan2 differ in the last place, which can move
    # a pixel across a sector boundary; the reference's float32 sector
    # differs from this one only within its rounding of a boundary
    q = torch.atan2(gy.double(), gx.double()) / (math.pi / 4.0)
    sec = torch.remainder(torch.round(q), 4.0).float()
    pm = F.pad(mag, (1, 1, 1, 1))
    nb = {0: (pm[:, 1:-1, 2:], pm[:, 1:-1, :-2]),      # E/W
          1: (pm[:, 2:, 2:], pm[:, :-2, :-2]),         # SE/NW (y down)
          2: (pm[:, 2:, 1:-1], pm[:, :-2, 1:-1]),      # S/N
          3: (pm[:, 2:, :-2], pm[:, :-2, 2:])}         # SW/NE
    keep = torch.zeros_like(mag, dtype=torch.bool)
    for s_, (n1, n2) in nb.items():
        keep = keep | ((sec == s_) & (mag >= n1) & (mag >= n2))
    nms = torch.where(keep, mag, 0.0)
    strong = nms > torch.maximum(lo, hi)[:, None, None]
    weak = nms > torch.minimum(lo, hi)[:, None, None]
    e = strong
    for _ in range(int(hysteresis_iters)):
        grown = F.max_pool2d(e[:, None].float(), 3, 1, 1)[:, 0] > 0.5
        e = (weak & grown) | e
    return e


def canny(images: Tensor, alpha: Tensor, lo: Tensor, hi: Tensor,
          col_t: Tensor, col_f: Tensor, sobel_k: int = 3,
          hysteresis_iters: int = 16) -> Tensor:
    """imgaug Canny: the edge map colourised with the per-image uniform
    draws ``col_t`` (edges) and ``col_f`` (the rest), (B, 1, 1, 3) in
    [0, 256), floored, alpha-blended over the image."""
    edges = canny_edges(images, lo, hi, sobel_k, hysteresis_iters)
    colorized = torch.where(edges[..., None], torch.floor(col_t),
                            torch.floor(col_f))
    a = alpha[:, None, None, None]
    return a * colorized + (1.0 - a) * images


def mean_shift_blur(images: Tensor, spatial_radius: Tensor,
                    color_radius: Tensor, max_radius: int,
                    iters: int = 5) -> Tensor:
    """imgaug MeanShiftBlur: ``iters`` rounds, each replacing a pixel's
    running colour with the mean of the original taps (edge border, a
    flat window of the per-image radius, capped at ``max_radius``) whose
    squared colour distance to it is ≤ sr²; a pixel no tap admits keeps
    its colour.  Accumulated tap by tap (never a stack of the taps); the
    distance sums the channels in order."""
    b, h, w, c = images.shape
    rr = int(max_radius)
    if rr <= 0:
        return images
    radius = torch.floor(spatial_radius)[:, None, None]
    sr2 = torch.square(torch.clamp(color_radius, min=1e-3))[:, None, None]
    pad = _pad(_pad(images, 1, rr, "edge"), 2, rr, "edge")
    state = images
    for _ in range(max(1, int(iters))):
        num = torch.zeros_like(images)
        den = torch.zeros((b, h, w, 1), device=images.device)
        for dy in range(-rr, rr + 1):
            for dx in range(-rr, rr + 1):
                tap = pad[:, rr + dy:rr + dy + h, rr + dx:rr + dx + w, :]
                r2 = float(dy * dy + dx * dx)
                in_win = math.sqrt(r2) <= radius + 1e-6          # (B,1,1)
                sq = torch.square(tap - state)
                d2 = sq[..., 0]
                for ch in range(1, c):
                    d2 = d2 + sq[..., ch]
                wgt = (in_win & (d2 <= sr2)).float()[..., None]
                num = num + wgt * tap
                den = den + wgt
        state = torch.where(den > 0.0, num / torch.clamp(den, min=1.0),
                            state)
    return state


def cartoon(images: Tensor, blur_ksize: int, segmentation_size: Tensor,
            saturation: Tensor, edge_prevalence: Tensor,
            max_radius: int = 4) -> Tensor:
    """imgaug Cartoon: median blur (static odd ``blur_ksize``) → mean
    shift (spatial radius 4·segmentation_size capped at ``max_radius``,
    colour radius 20·segmentation_size) → Canny edges of the flattened
    image at (60, 120) / edge_prevalence → HSV saturation × saturation
    (clipped) → edges stamped black."""
    k = int(blur_ksize)
    out = median_blur(images, ksize=k if k % 2 else k + 1) if k > 1 \
        else images
    seg_sz = torch.clamp(segmentation_size, min=1e-3)
    sp = torch.clamp(4.0 * seg_sz, max=float(max_radius))
    out = mean_shift_blur(out, sp, 20.0 * seg_sz, max_radius=max_radius)
    prev = torch.clamp(edge_prevalence, min=1e-3)
    edges = canny_edges(out, 60.0 / prev, 120.0 / prev)
    h, s, v = rgb_to_hsv(out)
    s = torch.clamp(s * saturation[:, None, None], 0.0, 255.0)
    out = hsv_to_rgb(h, s, v)
    return torch.where(edges[..., None], 0.0, out)


# ---------------------------------------------------------------------------
# weather and colour quantisation (the reference's procedural
# approximations of imgaug's weather augmenters; image only)
# ---------------------------------------------------------------------------

def value_noise(grids, h: int, w: int, persistence: float = 0.5) -> Tensor:
    """(B, H, W) multi-octave value noise in [0, 1]: the coarse uniform
    grids (B, g, g), one an octave, each upsampled bilinearly (half-pixel
    centres, as ``jax.image.resize``) and summed with weights 1, ½, ¼, …,
    over the weights' sum."""
    total, amp, norm = None, 1.0, 0.0
    for g in grids:
        up = amp * resize_to(g[:, None], h, w, "bilinear")[:, 0]
        total = up if total is None else total + up
        norm += amp
        amp *= persistence
    return total / norm


def clouds(images: Tensor, grids, coverage: Tensor) -> Tensor:
    """imgaug Clouds (approximation): white where the 3-octave noise
    (``grids`` 4², 8², 16²) exceeds 1 − coverage, soft-ramped, alpha at
    most 0.8."""
    noise = value_noise(grids, images.shape[1], images.shape[2])
    a = torch.clamp((noise - (1.0 - coverage[:, None, None])) / 0.25, 0.0,
                    1.0)
    a = (0.8 * a)[..., None]
    return images * (1.0 - a) + 255.0 * a


def fog(images: Tensor, grids, density: Tensor) -> Tensor:
    """imgaug Fog (approximation): a haze of ``density`` modulated by the
    2-octave noise (``grids`` 2², 4²), blended towards white."""
    noise = value_noise(grids, images.shape[1], images.shape[2])
    a = (density[:, None, None] * (0.55 + 0.45 * noise))[..., None]
    a = torch.clamp(a, 0.0, 0.95)
    return images * (1.0 - a) + 255.0 * a


def streak_kernels(length: Tensor, angle: Tensor, radius: int) -> Tensor:
    """(B, K, K) anti-aliased line kernels at ``angle`` degrees, ``length``
    px long, normalised to a peak of 1 (not a sum of 1, as MotionBlur's)
    so that a sparse point layer keeps its streaks bright."""
    coords = torch.arange(-radius, radius + 1, dtype=torch.float32,
                          device=length.device)
    gy, gx = torch.meshgrid(coords, coords, indexing="ij")
    half = torch.clamp((length - 1.0) / 2.0, 0.0, float(radius))
    a = angle * (math.pi / 180.0)
    dx, dy = torch.sin(a)[:, None, None], torch.cos(a)[:, None, None]
    proj = gx[None] * dx + gy[None] * dy
    perp = torch.abs(gx[None] * dy - gy[None] * dx)
    w = (torch.clamp(1.0 - perp, 0.0, 1.0)
         * torch.clamp(half[:, None, None] + 1.0 - proj.abs(), 0.0, 1.0))
    return w / torch.clamp(w.amax((1, 2), keepdim=True), min=1e-6)


def particle_layer(images: Tensor, u: Tensor, density: Tensor,
                   length: Tensor, angle: Tensor, radius: int,
                   brightness: float) -> Tensor:
    """Points where the uniform ``u`` (B, H, W, 1) falls below the
    density, smeared into streaks by one grouped convolution (full f32:
    cuDNN's TF32 would round the 0..255 sums) and screen-blended (max)
    over the image: Snowflakes and Rain."""
    pts = (u < density[:, None, None, None]).float()
    layer = _kxk(pts * brightness, streak_kernels(length, angle, radius),
                 radius)
    return torch.maximum(images, torch.clamp(layer, 0.0, brightness))


def snowflakes(images: Tensor, u: Tensor, density: Tensor, speed: Tensor,
               angle: Tensor, radius: int = 8) -> Tensor:
    """imgaug Snowflakes (approximation): ``density`` the flake share,
    ``speed`` the streak length as a share of the frame's height,
    ``angle`` (B,) the per-image streak angle in degrees."""
    length = torch.clamp(speed * images.shape[1], 1.0, 2.0 * radius + 1.0)
    return particle_layer(images, u, density, length, angle, radius,
                          brightness=255.0)


def rain(images: Tensor, u: Tensor, density: Tensor, speed: Tensor,
         angle: Tensor, radius: int = 12) -> Tensor:
    """imgaug Rain (approximation): longer, dimmer streaks over an image
    darkened by 8%."""
    length = torch.clamp(speed * images.shape[1], 3.0, 2.0 * radius + 1.0)
    return particle_layer(images * 0.92, u, density, length, angle, radius,
                          brightness=220.0)


def uniform_color_quantization(images: Tensor, n_colors: Tensor) -> Tensor:
    """imgaug UniformColorQuantization: every channel to n uniform levels
    (n (B,) rounded, at least 2), each value mapped to its bin's centre."""
    n = torch.clamp(torch.round(n_colors), min=2.0)[:, None, None, None]
    size = 256.0 / n
    v = torch.clamp(images, 0.0, 255.0)
    return torch.clamp(torch.floor(v / size) * size + size / 2.0, 0.0, 255.0)


def fast_snowy_landscape(images: Tensor, threshold: Tensor,
                         multiplier: Tensor) -> Tensor:
    """imgaug FastSnowyLandscape: in HLS (OpenCV's uint8 scale), the
    lightness of every pixel below ``threshold`` times ``multiplier``
    (clipped to 255); the RGB rebuilt from hue, the new lightness and the
    HLS saturation by the sector formula (gray stays gray)."""
    h, light, s = _rgb_to_hls(images)
    hh = h / 30.0
    thr, mul = threshold[:, None, None], multiplier[:, None, None]
    light = torch.clamp(torch.where(light < thr, light * mul, light), 0.0,
                        255.0)
    cc = (1.0 - torch.abs(2.0 * light / 255.0 - 1.0)) * s
    x = cc * (1.0 - torch.abs(torch.remainder(hh, 2.0) - 1.0))
    m0 = light - 0.5 * cc
    zero = torch.zeros_like(cc)
    i = torch.floor(hh).to(torch.int32) % 6
    rr = _select6(i, [cc, x, zero, zero, x], cc)
    gg = _select6(i, [x, cc, cc, x, zero], zero)
    bb = _select6(i, [zero, zero, x, cc, cc], x)
    return torch.stack([rr + m0, gg + m0, bb + m0], dim=-1)
