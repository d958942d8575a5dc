"""Photometric (pixel-value) augmenters — image only, mask untouched.

Counterpart of ``segmentation_training_pipeline_tpu/ops/aug/photometric.py``
for the augmenters ported so far.  Parameters are per image, (B,), or per
image and channel, (B, C) (imgaug ``per_channel=True``); values live on
the 0..255 scale and the pipeline clips at its end.

Every random value is an argument (a normal, Laplace or Poisson sample, a
uniform, a bernoulli outcome or a permutation), so each function is
deterministic: the reference draws the same values inside its functions
from a key, and the tests hand its draws to these.
"""

from __future__ import annotations

import torch

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
