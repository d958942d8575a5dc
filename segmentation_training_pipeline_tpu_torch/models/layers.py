"""Shared building blocks of the model zoo (PyTorch).

Counterpart of ``segmentation_training_pipeline_tpu/models/layers.py``.
Modules work on NCHW tensors (PyTorch's convolution layout; the model
takes and returns NHWC at its boundary and keeps channels-last strides
inside).  Three conventions of the flax reference are kept exactly:

  * SAME padding as XLA computes it: total = max((ceil(n/s) − 1)·s + k − n,
    0), split low = total // 2, high = the rest.  At even sizes a strided
    conv pads asymmetrically (the 7×7/2 stem pads (2, 3), a 3×3/2 conv
    (0, 1)), which a symmetric ``padding=k//2`` gets wrong.
  * BatchNorm (``models/batchnorm.py``, re-exported here) with flax's
    formula and running-statistics rule: running = m·running + (1 − m)·
    batch with m = 0.9 (PyTorch's momentum 0.1; the Keras-derived graphs
    use Keras's 0.99 and eps 1e-3, MobileNetV2 0.999), and the BIASED
    batch variance.  In a process group (``parallel/distributed.py``) the
    training statistics are the global batch's, the statistics GSPMD
    gives the JAX package.
  * Initialisation as flax's defaults: conv kernels from
    variance_scaling(1, fan_in, truncated normal), biases 0, BN scale 1 and
    bias 0.

Under the ``space`` axis (``parallel/spatial.py``) the windowed ops
(``pad_same`` and so ``Conv``, ``max_pool_same``, ``avg_pool_same``; the
odd-window path of ``Conv``), the resizes, the SE mean and a bound
dropout mask work on this rank's H slab: halo rows from the neighbours,
padding only at the image's true edges, a level too short to cut run
whole.  Without it they are the one-process ops.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..parallel import spatial
from .batchnorm import BatchNorm

Tensor = torch.Tensor
Size2 = Union[int, Tuple[int, int]]


def _pair(v: Size2) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding (low, high) of one spatial axis for a window of
    ``k`` taps (a dilated kernel's EFFECTIVE size (k − 1)·r + 1, as XLA
    counts it)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def pad_same(x: Tensor, k: Size2, s: int, value: float = 0.0) -> Tensor:
    """Pad an NCHW tensor for a VALID k×k (or (kh, kw), effective sizes)
    / s window to act as SAME.  A slab of a split level takes its H halo
    from its neighbours (or is gathered first when the window's output
    level runs whole)."""
    kh, kw = _pair(k)
    l, r = same_pads(x.shape[3], kw, s)
    if spatial.is_split(x):
        if spatial.split_after(x, s):
            t = same_pads(spatial.current().global_h(x), kh, s)[0]
            x = spatial.halo(x, t, kh - s - t, value)
            return F.pad(x, (l, r), value=value) if l or r else x
        x = spatial.gather(x)
    t, b = same_pads(x.shape[2], kh, s)
    if t == b == l == r == 0:
        return x
    return F.pad(x, (l, r, t, b), value=value)


# truncated_normal(stddev=1) over [-2, 2] has std 0.8796…; flax divides it
# out so variance_scaling keeps the requested variance
_TRUNC_STD = 0.87962566103423978


class Conv(nn.Module):
    """k×k or (kh, kw) convolution, optionally dilated, with XLA SAME
    padding (flax ``nn.Conv``; ``groups`` is its ``feature_group_count``,
    ``dilation`` its ``kernel_dilation``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Size2 = 3, stride: int = 1, bias: bool = False,
                 groups: int = 1, dilation: int = 1):
        super().__init__()
        self.kernel = _pair(kernel)
        self.stride = stride
        self.groups = groups
        self.dilation = dilation
        # the window XLA pads for: (k − 1)·r + 1 taps per axis
        self.span = tuple((k - 1) * dilation + 1 for k in self.kernel)
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        # flax's fan_in of a grouped conv: in/groups · kh · kw
        fan_in = self.weight[0].numel()
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std,
                                  2.0 * std, generator=gen)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: Tensor) -> Tensor:
        (eh, ew), s, r, g = self.span, self.stride, self.dilation, self.groups
        if s == 1 and eh % 2 == 1 and ew % 2 == 1:
            # SAME pads an odd window at stride 1 by (e − 1)/2 both sides;
            # a slab takes those rows from its neighbours instead
            ph = eh // 2
            if ph and spatial.is_split(x):
                x, ph = spatial.halo(x, ph, ph), 0
            return F.conv2d(x, self.weight, self.bias, 1, (ph, ew // 2), r,
                            g)
        return F.conv2d(pad_same(x, self.span, s), self.weight, self.bias, s,
                        0, r, g)


class ConvBN(nn.Module):
    """Conv (``groups`` as flax's ``feature_group_count``) → BatchNorm
    (``momentum``, ``eps``) → ReLU (optional)."""

    def __init__(self, in_channels: int, features: int, kernel: Size2 = 3,
                 stride: int = 1, act: bool = True, groups: int = 1,
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.conv = Conv(in_channels, features, kernel, stride,
                         groups=groups)
        self.bn = BatchNorm(features, momentum, eps)
        self.act = act

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        x = self.bn(self.conv(x), train)
        return F.relu(x) if self.act else x


def max_pool_same(x: Tensor, k: int = 3, s: int = 2) -> Tensor:
    """k×k / s max-pool with SAME padding by −inf (flax ``nn.max_pool``)."""
    return F.max_pool2d(pad_same(x, k, s, value=float("-inf")), k, s)


def avg_pool_same(x: Tensor, k: int = 3, s: int = 1,
                  count_include_pad: bool = True) -> Tensor:
    """k×k / s average pool with XLA SAME padding (flax ``nn.avg_pool(…,
    padding="SAME")``): the window sum over the zero-padded input divided
    by k² (``count_include_pad=True``) or by the number of real inputs in
    the window (``False``, flax computes that count by pooling ones)."""
    sums = F.avg_pool2d(pad_same(x, k, s), k, s, divisor_override=1)
    if count_include_pad:
        return sums / (k * k)
    # the count over the whole image's map (its true edges), then the
    # rows of a slab
    sp = spatial.current()
    h = sp.global_h(x) if sp is not None else x.shape[2]
    ones = torch.ones((1, 1, h, x.shape[3]), dtype=x.dtype, device=x.device)
    (t, b), (l, r) = same_pads(h, k, s), same_pads(x.shape[3], k, s)
    counts = F.avg_pool2d(F.pad(ones, (l, r, t, b)), k, s,
                          divisor_override=1)
    return sums / spatial.slab_of(counts, sums)


def linear_resize_matrix(n: int, m: int, dtype=np.float32) -> np.ndarray:
    """(m, n) weights of ``jax.image.resize``'s "linear" method from n to m
    samples (``jax._src.image.scale.compute_weight_mat`` with translation
    0, antialiased): the triangle kernel at the half-pixel source position,
    widened by n/m when m < n, each row normalised to sum to 1.  JAX
    computes them in its default float type: float32, float64 under
    x64."""
    inv = dtype(n / m)                 # JAX: 1 / (m / n) in Python floats
    kernel_scale = max(inv, dtype(1.0))
    sample = (np.arange(m, dtype=dtype) + dtype(0.5)) * inv - dtype(0.5)
    x = np.abs(sample[:, None] - np.arange(n, dtype=dtype)[None, :]) \
        / kernel_scale
    w = np.maximum(dtype(0.0), dtype(1.0) - x)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n - 0.5)
    return np.where(inside[:, None], w, 0).astype(dtype)


def resize_to(x: Tensor, h: int, w: int, method: str = "nearest") -> Tensor:
    """Resize an NCHW batch to (h, w) in its dtype, as ``jax.image.resize``
    does.  Nearest takes source index floor((i + 0.5)·n/h) (PyTorch's
    "nearest-exact") with autocast off: CUDA autocast would run it in f32,
    which is no more exact for a copy and doubles its bytes.  Bilinear is
    the half-pixel triangle filter with clamped edges, which is
    ``align_corners=False`` when no axis shrinks; JAX antialiases a
    downsample (the triangle widened by the shrink factor), so an axis
    that shrinks takes JAX's weight matrices in ``x``'s dtype instead.
    Under the space axis the output is in its level's layout
    (``parallel/spatial.py:resize``)."""
    if tuple(x.shape[2:]) == (h, w):
        return x
    if tuple(x.shape[2:]) == (1, 1) and method in ("nearest", "bilinear"):
        # one source pixel: both methods copy it (JAX's one bilinear
        # weight normalises to exactly 1)
        return x.expand(-1, -1, h, w)
    if spatial.current() is not None:
        return spatial.resize(x, h, w, method, _resize)
    return _resize(x, h, w, method)


def _resize(x: Tensor, h: int, w: int, method: str) -> Tensor:
    if method == "nearest":
        with torch.autocast(x.device.type, enabled=False):
            return F.interpolate(x, size=(h, w), mode="nearest-exact")
    if method != "bilinear":
        raise ValueError(f"resize_to: unknown method {method!r}")
    if h >= x.shape[2] and w >= x.shape[3]:
        return F.interpolate(x, size=(h, w), mode="bilinear",
                             align_corners=False)
    wide = np.float64 if x.dtype == torch.float64 else np.float32
    mh, mw = (torch.from_numpy(linear_resize_matrix(n, m, wide)).to(
        x.device, x.dtype) for n, m in ((x.shape[2], h), (x.shape[3], w)))
    return torch.einsum("ih,jw,nchw->ncij", mh, mw, x)


def upsample2x(x: Tensor) -> Tensor:
    """Nearest 2× upsample (``jax.image.resize`` nearest: dst i ← src i//2)
    in the input's dtype."""
    return resize_to(x, x.shape[2] * 2, x.shape[3] * 2)


class SEBlock(nn.Module):
    """Squeeze-and-excitation (Hu et al. 2018): spatial mean → 1×1
    ``reduce`` (bias) → hidden activation → 1×1 ``expand`` (bias) →
    sigmoid gate on the input.  ``act``: "relu" for SE-ResNet (canonical
    SENet), "swish" for EfficientNet."""

    def __init__(self, channels: int, reduced: int, act: str = "swish"):
        super().__init__()
        self.reduce = Conv(channels, reduced, 1, bias=True)
        self.expand = Conv(reduced, channels, 1, bias=True)
        self.act = F.relu if act == "relu" else F.silu

    def forward(self, x: Tensor) -> Tensor:
        s = spatial.mean_hw(x)
        s = self.expand(self.act(self.reduce(s)))
        return x * torch.sigmoid(s)


class DropPath(nn.Module):
    """Stochastic depth: in training each example's residual branch is
    kept (scaled by 1/keep) or dropped.  The per-example keep mask is a
    draw, not sampled here: the caller sets ``keep_mask`` ((B,) bool) for
    the forward (``models.factory.apply_model``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.keep_mask: Optional[Tensor] = None

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        if self.rate == 0.0 or not train:
            return x
        if self.keep_mask is None:
            raise ValueError("DropPath in training needs its keep mask (a "
                             "draw of the step)")
        keep = 1.0 - self.rate
        m = self.keep_mask.to(x.dtype).view(-1, 1, 1, 1)
        return x * m / keep


class Dropout(nn.Module):
    """Element-wise dropout as flax's ``nn.Dropout``: in training each
    value is kept and scaled by 1/keep, or zeroed.  The keep mask (x's
    shape, bool) is ``keep_mask`` when the caller binds one (as the tests
    do with the JAX step's draw), else drawn from PyTorch's global
    generator, which ``torch.utils.checkpoint`` replays on recomputation."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.keep_mask: Optional[Tensor] = None

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        if self.rate == 0.0 or not train:
            return x
        keep = 1.0 - self.rate
        mask = self.keep_mask
        if mask is None:
            mask = torch.rand(x.shape, device=x.device) < keep
        else:
            mask = spatial.slab_of(mask, x)   # a whole image's mask
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


@contextlib.contextmanager
def bound_masks(module: nn.Module, masks: Optional[Dict[str, Tensor]],
                prefix: str):
    """Bind ``masks`` (model-level name → keep mask) to the ``DropPath``
    and ``Dropout`` layers of ``module``, whose names in the model start
    with ``prefix``, for a block."""
    bound = []
    for n, m in module.named_modules(prefix=prefix):
        if isinstance(m, (DropPath, Dropout)) and masks and n in masks:
            m.keep_mask = masks[n]
            bound.append(m)
    try:
        yield
    finally:
        for m in bound:
            m.keep_mask = None


def run_part(module: nn.Module, prefix: str, masks, remat: bool, *args,
             train: bool = False):
    """``module(*args, train)`` with the keep masks of its layers bound;
    with ``remat`` (and autograd recording) under ``torch.utils.checkpoint``
    (non-reentrant), the JAX package's ``nn.remat``: the backward pass
    recomputes the part's activations instead of keeping them.  The
    recomputation runs after the caller's ``functional_call`` has put the
    module's own tensors back, so the part's parameters and buffers as
    they are now go in as an argument and are put back in for it, and the
    masks are bound again: the recomputed forward is the same function of
    the same values, drop masks and global generator state included."""
    if not (remat and torch.is_grad_enabled()):
        with bound_masks(module, masks, prefix):
            return module(*args, train)
    tensors = {**dict(module.named_parameters()),
               **dict(module.named_buffers())}

    def call(tensors, *a):
        with bound_masks(module, masks, prefix):
            return functional_call(module, tensors, (*a, train))

    return checkpoint(call, tensors, *args, use_reentrant=False)


def round_filters(filters: float, multiplier: float, divisor: int = 8) -> int:
    """EfficientNet's width scaling to multiples of ``divisor``."""
    f = filters * multiplier
    new_f = max(divisor, int(f + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * f:
        new_f += divisor
    return int(new_f)


def round_repeats(repeats: int, multiplier: float) -> int:
    return int(math.ceil(repeats * multiplier))
