"""BatchNorm in training mode: one formula in every process, on four
hand-written kernels.

Counterpart of flax's ``nn.BatchNorm`` as the JAX package's models use it
(``segmentation_training_pipeline_tpu/models/layers.py``): the fast
variance E[x²] − mean² clipped at 0, then ``(x − mean)·(rsqrt(var +
eps)·scale) + bias``, and running = m·running + (1 − m)·batch with the
BIASED batch variance.  Every process computes it the same way, with or
without a process group (``parallel/distributed.py``):

  forward   s1 = Σx, s2 = Σx² and the count n of the float32 values per
            channel, accumulated in float64 (bf16 and f16 inputs under
            autocast too); under a group ONE all-reduce of (s1, s2, n),
            whose count slot is summed, since a level that runs whole in a
            space group (``parallel/spatial.py``) counts its whole copy on
            every rank;
            mean = s1/n and var = max(s2/n − mean², 0), each rounded to
            float32; invstd = 1/sqrt(var + eps); y = (x − mean)·(invstd·w)
            + b in float32, returned in x's dtype;
  backward  g1 = Σdy and g2 = Σdy·(x − mean) per channel in float64; the
            bias's gradient g1 and the scale's g2·invstd from these LOCAL
            sums (the train step's flat gradient all-reduce sums them
            over the group later: reduced sums would count every BatchNorm
            parameter's gradient once per rank); under a group ONE
            all-reduce of (g1, g2), then dx = invstd·w·(dy − g1/n −
            (x − mean)·invstd²·g2/n).

The sums are float64 so that the subtraction's cancellation (E[x²] far
above the variance) stays out of float32.  Each step has a kernel in
``csrc/batchnorm.cu`` (``bn_stats``, ``bn_apply``, ``bn_grad_stats``,
``bn_grad_apply``: two launches forward and two backward a layer) and a
plain PyTorch version below that takes the same float64 sums and rounds
at the same points.  A wrapper runs the plain version for a CPU tensor;
a CUDA tensor launches the kernel or raises.  The kernels take a
contiguous NCHW tensor or a channels-last one (the port's layout on the
card); another is copied to contiguous first.  ``weight`` None is flax's
``use_scale=False``.  Evaluation (``train=False``) normalises with the
running statistics through ``F.batch_norm``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import kernels as K
from ..parallel import distributed as dist

Tensor = torch.Tensor

_DIMS = (0, 2, 3)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2,
           torch.float16: 3}
# four 256-thread blocks on each of the H100's 132 SMs
_TARGET_BLOCKS = 4 * 132
_THREADS = 256
# (device index, stream) → the reductions' scratch (``_scratch``)
_SCRATCH: Dict[tuple, tuple] = {}
# (dtype, shape, strides, aligned) → the launch geometry (``_geometry``)
_GEOMETRY: Dict[tuple, tuple] = {}


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The type a value computes in: float64 for float64, else float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _channel(t: Tensor) -> Tensor:
    return t.view(1, -1, 1, 1)


# ---------------------------------------------------------------- plain


def bn_stats_plain(x: Tensor) -> Tensor:
    """(s1, s2, n) of (B, C, H, W) ``x`` in float64: (2C + 1,)."""
    xd = x.to(torch.float64)
    n = xd.new_full((1,), x.numel() // x.shape[1])
    return torch.cat([xd.sum(_DIMS), (xd * xd).sum(_DIMS), n])


def bn_apply_plain(x: Tensor, sums: Tensor, weight: Optional[Tensor],
                   bias: Tensor, running_mean: Tensor, running_var: Tensor,
                   momentum: float, eps: float):
    """y in x's dtype, the saved mean and invstd, and the blended running
    mean and variance, from the (reduced) sums."""
    c, acc = x.shape[1], _acc(x.dtype)
    n = sums[2 * c]
    m = sums[:c] / n
    v = torch.clamp(sums[c:2 * c] / n - m * m, min=0.0)
    mean, var = m.to(acc), v.to(acc)
    invstd = (1.0 / torch.sqrt((var + eps).double())).to(acc)
    scale = invstd if weight is None else invstd * weight
    y = (x.to(acc) - _channel(mean)) * _channel(scale) + _channel(bias)
    return (y.to(x.dtype), mean, invstd,
            running_mean * momentum + mean * (1.0 - momentum),
            running_var * momentum + var * (1.0 - momentum))


def bn_grad_stats_plain(dy: Tensor, x: Tensor, mean: Tensor,
                        invstd: Tensor, weight: Optional[Tensor]):
    """(g1, g2) in float64, (2C,), and the scale's (None without one) and
    bias's gradients from them."""
    acc = _acc(x.dtype)
    dyd = dy.to(torch.float64)
    d = (x.to(acc) - _channel(mean)).to(torch.float64)
    g1, g2 = dyd.sum(_DIMS), (dyd * d).sum(_DIMS)
    dw = None if weight is None else (g2 * invstd.double()).to(acc)
    return torch.cat([g1, g2]), dw, g1.to(acc)


def bn_grad_apply_plain(dy: Tensor, x: Tensor, gsums: Tensor, sums: Tensor,
                        mean: Tensor, invstd: Tensor,
                        weight: Optional[Tensor]) -> Tensor:
    """dx in x's dtype from the (reduced) gradient and forward sums."""
    c, acc = x.shape[1], _acc(x.dtype)
    n = sums[2 * c]
    isd = invstd.double()
    c1 = (gsums[:c] / n).to(acc)
    c2 = ((gsums[c:] / n) * (isd * isd)).to(acc)
    scale = invstd if weight is None else invstd * weight
    t = dy.to(acc) - _channel(c1)
    t = t - (x.to(acc) - _channel(mean)) * _channel(c2)
    return (_channel(scale) * t).to(x.dtype)


# ---------------------------------------------------------------- kernels


def _rows(x: Tensor) -> bool:
    """Whether the kernels see ``x`` as an (N·H·W, C) matrix (channels-
    last, or H·W = 1) rather than as NCHW planes; ``x`` is one or the
    other."""
    return x.shape[2] * x.shape[3] == 1 or not x.is_contiguous()


def _dense(x: Tensor) -> Tensor:
    """``x`` as the kernels take it: contiguous NCHW or channels-last; any
    other layout is copied to contiguous NCHW."""
    if x.is_contiguous() or x.is_contiguous(
            memory_format=torch.channels_last):
        return x
    return x.contiguous()


def _like(t: Tensor, x: Tensor) -> Tensor:
    """``t`` in ``x``'s layout (a copy only where it differs)."""
    if _rows(x):
        return t if t.is_contiguous(
            memory_format=torch.channels_last) else t.contiguous(
                memory_format=torch.channels_last)
    return t.contiguous()


def _plan(rows: bool, outer: int, c: int, inner: int, v: int):
    """(span, slices, tile width) of a launch over ``outer`` × C ×
    ``inner`` values, ``v`` a vector.  Rows: a tile of ``tw`` vector
    columns and 256 // tw rows at a time, each block ``span`` rows, each
    thread eight rows or more.  Planes: ``span`` values (a multiple of v)
    of one channel a block, each thread four vectors or more.  The grid
    aims at ``_TARGET_BLOCKS``."""
    if rows:
        tw = min(c // v, 32)
        tiles = -(-(c // v) // tw)
        ry = _THREADS // tw
        slices = max(1, min(-(-_TARGET_BLOCKS // tiles),
                            -(-outer // (8 * ry))))
        span = -(-outer // slices)
        return span, -(-outer // span), tw
    m = outer * inner
    slices = max(1, min(-(-_TARGET_BLOCKS // c), -(-m // (4 * _THREADS * v))))
    span = -(-(-(-m // slices)) // v) * v
    return span, -(-m // span), 0


def _geometry(x: Tensor, *others: Tensor):
    """The kernels' dtype code, geometry arguments and slice count for
    ``x`` (already dense) and the tensors of its shape beside it; cached
    by type, shape, strides and whether every pointer is 16-byte
    aligned."""
    ptrs = x.data_ptr()
    for t in others:
        ptrs |= t.data_ptr()
    key = (x.dtype, x.shape, x.stride(), not ptrs & 15)
    geo = _GEOMETRY.get(key)
    if geo is None:
        geo = _GEOMETRY[key] = _new_geometry(x, key[3])
    return geo


def _new_geometry(x: Tensor, aligned: bool):
    if x.dtype not in _DTYPES:
        raise ValueError(f"batch norm kernels: float32, bfloat16, float16 "
                         f"or float64 values, got {x.dtype}")
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"batch norm kernels: a non-empty (B, C, H, W) "
                         f"tensor, got {tuple(x.shape)}")
    b, c, h, w = x.shape
    rows = _rows(x)
    outer, inner = (b * h * w, 1) if rows else (b, h * w)
    v = 16 // x.element_size()
    vec = aligned and (c if rows else inner) % v == 0
    span, slices, tw = _plan(rows, outer, c, inner, v if vec else 1)
    return (_DTYPES[x.dtype], int(rows), outer, inner, span, c, slices, tw,
            int(vec)), slices


def _check(x: Tensor, *tensors: Optional[Tensor]) -> None:
    """Every tensor on ``x``'s CUDA device; per-channel ones in the type
    x computes in."""
    if x.device.type != "cuda":
        raise ValueError(f"batch norm kernels need CUDA tensors, got "
                         f"{x.device}")
    acc = _acc(x.dtype)
    for t in tensors:
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"batch norm kernels: tensors on {t.device} "
                             f"and {x.device}")
        if t.dim() == 1 and (t.dtype != acc or t.shape[0] != x.shape[1]
                             or not t.is_contiguous()):
            raise ValueError(f"batch norm kernels: per-channel tensors "
                             f"must be contiguous ({x.shape[1]},) {acc}, "
                             f"got {tuple(t.shape)} {t.dtype}")


def _scratch(x: Tensor, stream: int, c: int, slices: int):
    """Pointers to the reductions' slice tickets (at least ``c``) and
    partial sums (at least 2·c·slices float64) of ``x``'s device and
    ``stream``.  Launches on one stream run in order, so they share its
    scratch; the tickets are zeroed once and every launch leaves them
    zeroed."""
    key = (x.device.index, stream)
    s = _SCRATCH.get(key)
    if s is None or s[0].numel() < c or s[1].numel() < 2 * c * slices:
        n_t = max(c, 1024 if s is None else s[0].numel())
        n_p = max(2 * c * slices, 1 << 16 if s is None else s[1].numel())
        t = torch.zeros(n_t, dtype=torch.int32, device=x.device)
        p = torch.empty(n_p, dtype=torch.float64, device=x.device)
        s = _SCRATCH[key] = (t, p, t.data_ptr(), p.data_ptr())
    return s[2], s[3]


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


# The launches.  Each takes checked, dense tensors of one layout, the
# geometry of ``_geometry`` and the stream, and allocates its outputs.


def _stats(x: Tensor, geo: tuple, slices: int, stream: int) -> Tensor:
    c = x.shape[1]
    tickets, partials = _scratch(x, stream, c, slices)
    out = torch.empty(2 * c + 1, dtype=torch.float64, device=x.device)
    K.KERNELS["bn_stats"].launch(x.data_ptr(), *geo, partials, tickets,
                                 out.data_ptr(), stream)
    return out


def _apply(x: Tensor, y: Tensor, geo: tuple, stream: int, sums: Tensor,
           weight: Optional[Tensor], bias: Tensor, running_mean: Tensor,
           running_var: Tensor, momentum: float, eps: float):
    st = torch.empty((4, x.shape[1]), dtype=_acc(x.dtype), device=x.device)
    p, step = st.data_ptr(), st.stride(0) * st.element_size()
    K.KERNELS["bn_apply"].launch(
        x.data_ptr(), y.data_ptr(), *geo, sums.data_ptr(), _ptr(weight),
        bias.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(),
        float(momentum), float(eps), p, p + step, p + 2 * step,
        p + 3 * step, stream)
    return st.unbind(0)             # mean, invstd, running mean and var


def _grad_stats(dy: Tensor, x: Tensor, geo: tuple, slices: int,
                stream: int, mean: Tensor, invstd: Tensor,
                weight: Optional[Tensor]):
    c = x.shape[1]
    tickets, partials = _scratch(x, stream, c, slices)
    out = torch.empty(2 * c, dtype=torch.float64, device=x.device)
    grads = torch.empty((2, c), dtype=_acc(x.dtype), device=x.device)
    p, step = grads.data_ptr(), grads.stride(0) * grads.element_size()
    K.KERNELS["bn_grad_stats"].launch(
        dy.data_ptr(), x.data_ptr(), *geo, mean.data_ptr(),
        invstd.data_ptr(), partials, tickets, out.data_ptr(),
        None if weight is None else p, p + step, stream)
    dw, db = grads.unbind(0)
    return out, None if weight is None else dw, db


def _grad_apply(dy: Tensor, x: Tensor, dx: Tensor, geo: tuple,
                stream: int, gsums: Tensor, sums: Tensor, mean: Tensor,
                invstd: Tensor, weight: Optional[Tensor]) -> None:
    K.KERNELS["bn_grad_apply"].launch(
        dy.data_ptr(), x.data_ptr(), dx.data_ptr(), *geo, gsums.data_ptr(),
        sums.data_ptr(), mean.data_ptr(), invstd.data_ptr(), _ptr(weight),
        stream)


# The wrappers: the plain version for a CPU tensor, else the checked
# kernel.  ``BatchNormTrain`` checks once a layer and calls the launches.


def bn_stats(x: Tensor) -> Tensor:
    """(s1, s2, n) in float64: the ``bn_stats`` kernel on a dense CUDA
    tensor, the plain version on a CPU one."""
    if x.device.type == "cpu":
        return bn_stats_plain(x)
    _check(x)
    geo, slices = _geometry(x)
    return _stats(x, geo, slices, K.stream_of(x))


def bn_apply(x: Tensor, sums: Tensor, weight: Optional[Tensor],
             bias: Tensor, running_mean: Tensor, running_var: Tensor,
             momentum: float, eps: float):
    """``bn_apply_plain``'s outputs: the ``bn_apply`` kernel on a dense
    CUDA tensor, the plain version on a CPU one."""
    if x.device.type == "cpu":
        return bn_apply_plain(x, sums, weight, bias, running_mean,
                              running_var, momentum, eps)
    _check(x, weight, bias, running_mean, running_var)
    y = torch.empty_like(x)
    geo, _ = _geometry(x, y)
    return (y, *_apply(x, y, geo, K.stream_of(x), sums, weight, bias,
                       running_mean, running_var, momentum, eps))


def bn_grad_stats(dy: Tensor, x: Tensor, mean: Tensor, invstd: Tensor,
                  weight: Optional[Tensor]):
    """``bn_grad_stats_plain``'s outputs: the ``bn_grad_stats`` kernel on
    dense CUDA tensors of one layout, the plain version on CPU ones."""
    if x.device.type == "cpu":
        return bn_grad_stats_plain(dy, x, mean, invstd, weight)
    _check(x, dy, mean, invstd, weight)
    geo, slices = _geometry(x, dy)
    return _grad_stats(dy, x, geo, slices, K.stream_of(x), mean, invstd,
                       weight)


def bn_grad_apply(dy: Tensor, x: Tensor, gsums: Tensor, sums: Tensor,
                  mean: Tensor, invstd: Tensor,
                  weight: Optional[Tensor]) -> Tensor:
    """dx: the ``bn_grad_apply`` kernel on dense CUDA tensors of one
    layout, the plain version on CPU ones."""
    if x.device.type == "cpu":
        return bn_grad_apply_plain(dy, x, gsums, sums, mean, invstd, weight)
    _check(x, dy, mean, invstd, weight)
    dx = torch.empty_like(x)
    geo, _ = _geometry(x, dy, dx)
    _grad_apply(dy, x, dx, geo, K.stream_of(x), gsums, sums, mean, invstd,
                weight)
    return dx


# ---------------------------------------------------------------- layer


class BatchNormTrain(torch.autograd.Function):
    """Train-mode batch norm over the process group's global batch (this
    process's batch without one) by flax's rule (see the module's notes):
    (x, weight, bias, running_mean, running_var, momentum, eps) → (y, new
    running mean, new running variance).  On the card, one check, one
    geometry and one stream query a pass serve both of its launches."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps):
        x = _dense(x)
        group = dist.active()
        if x.device.type == "cpu":
            sums = bn_stats_plain(x)
            if group:
                dist.all_reduce_(sums)
            y, mean, invstd, rm, rv = bn_apply_plain(
                x, sums, weight, bias, running_mean, running_var, momentum,
                eps)
        else:
            _check(x, weight, bias, running_mean, running_var)
            y = torch.empty_like(x)
            geo, slices = _geometry(x, y)
            stream = K.stream_of(x)
            sums = _stats(x, geo, slices, stream)
            if group:
                dist.all_reduce_(sums)
            mean, invstd, rm, rv = _apply(x, y, geo, stream, sums, weight,
                                          bias, running_mean, running_var,
                                          momentum, eps)
        ctx.save_for_backward(x, weight, mean, invstd, sums)
        ctx.mark_non_differentiable(rm, rv)
        return y, rm, rv

    @staticmethod
    def backward(ctx, dy, _rm, _rv):
        x, weight, mean, invstd, sums = ctx.saved_tensors
        dy = _like(dy, x)
        need_dx = ctx.needs_input_grad[0]
        if x.device.type == "cpu":
            gsums, dw, db = bn_grad_stats_plain(dy, x, mean, invstd, weight)
        else:
            # dy: autograd's gradient of y, on y's device in y's type
            dx = torch.empty_like(x) if need_dx else None
            geo, slices = _geometry(x, dy, *(() if dx is None else (dx,)))
            stream = K.stream_of(x)
            gsums, dw, db = _grad_stats(dy, x, geo, slices, stream, mean,
                                        invstd, weight)
        if need_dx:
            if dist.active():
                dist.all_reduce_(gsums)
            if x.device.type == "cpu":
                dx = bn_grad_apply_plain(dy, x, gsums, sums, mean, invstd,
                                         weight)
            else:
                _grad_apply(dy, x, dx, geo, stream, gsums, sums, mean,
                            invstd, weight)
        else:
            dx = None
        return (dx, dw if ctx.needs_input_grad[1] else None,
                db if ctx.needs_input_grad[2] else None, None, None, None,
                None)


class BatchNorm(nn.Module):
    """BatchNorm over NCHW channels with flax's statistics rule.
    ``scale=False`` is flax's ``use_scale=False`` (no ``weight``).  In
    training mode the layer leaves its updated statistics in ``updated``;
    the caller collects them (``models.factory.apply_model``)."""

    def __init__(self, channels: int, momentum: float = 0.9,
                 eps: float = 1e-5, scale: bool = True):
        super().__init__()
        self.momentum = momentum       # flax convention (decay of running)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels)) if scale else None
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.updated: Optional[Tuple[Tensor, Tensor]] = None

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        y, rm, rv = BatchNormTrain.apply(x, self.weight, self.bias,
                                         self.running_mean, self.running_var,
                                         self.momentum, self.eps)
        self.updated = (rm, rv)
        return y
