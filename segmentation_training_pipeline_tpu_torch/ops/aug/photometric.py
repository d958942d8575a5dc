"""Photometric (pixel-value) augmenters — image only, mask untouched.

Counterpart of ``segmentation_training_pipeline_tpu/ops/aug/photometric.py``
for the augmenters ported so far.  Parameters are per image, (B,), or per
image and channel, (B, C) (imgaug ``per_channel=True``); values live on
the 0..255 scale and the pipeline clips at its end.

Every random value is an argument (a normal, Laplace or Poisson sample, a
uniform, a bernoulli outcome or a permutation), so each function is
deterministic: the reference draws the same values inside its functions
from a key, and the tests hand its draws to these.

The colour functions keep the reference's order of float32 operations
(the colour matrices are written out elementwise, not as a matmul that
could run in TF32 on the card).  The histogram names count with
``scatter_add_`` and look up with ``torch.gather``: the reference's
broadcast compare-reduces (written so because XLA:TPU serialises scatter
and gather) would build a (…, N, 256) tensor in eager PyTorch.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


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
