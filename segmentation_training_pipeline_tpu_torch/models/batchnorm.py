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

import ctypes
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import kernels as K
from ..parallel import distributed as dist

Tensor = torch.Tensor

_DIMS = (0, 2, 3)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2,
           torch.float16: 3}
_THREADS = 256
# blocks of a reduction's cluster (the portable size)
_CLUSTER = 8
# the least bytes a block of bn_stats, bn_apply or bn_grad_stats moves
_SLICE_BYTES = 32 * 1024
# the most rounds of loads a plan leaves the last cluster's partial sums
_TAIL_ROUNDS = 2
# bn_grad_apply's blocks an SM aimed at (its first design)
_BLOCKS_PER_SM = 4
# the kernels' codes in ``stp_bn_occupancy`` and the tensors each streams
_KERNEL_CODES = {"bn_stats": 0, "bn_apply": 1, "bn_grad_stats": 2}
_TENSORS = {"bn_stats": 1, "bn_apply": 2, "bn_grad_stats": 2}
# the geometry's mode: one value at a time, 16-byte vectors through the
# ring of bulk copies, 16-byte loads straight from device memory
_PER_VALUE, _RING, _DIRECT = 0, 1, 2
# channels-last maps of at most these bytes (a tensor) take the direct
# mode: their blocks' few stages would not pay for the ring
_DIRECT_BYTES = {"bn_stats": 8 << 20, "bn_apply": 16 << 20,
                 "bn_grad_stats": 8 << 20}
# the direct mode's tile (channels) and rows a thread
_DIRECT_TILE, _DIRECT_ROWS = 64, 8
# the partition's card, so that a sum's order depends on the shape alone:
# the clusters of 1, 2, 4 and 8 blocks an H100 80GB HBM3 holds at once of
# each kernel's ring instantiations (``stp_bn_occupancy``: 4 resident
# blocks an SM of 132)
_H100 = {"bn_stats": (528, 264, 124, 62), "bn_apply": (528,),
         "bn_grad_stats": (528, 264, 124, 62)}
# (device index, stream) → the reductions' scratch (``_scratch``)
_SCRATCH: Dict[tuple, tuple] = {}
# (dtype, shape, strides, aligned) → the launch geometry (``_geometry``)
_GEOMETRY: Dict[tuple, tuple] = {}
# (device, kernel, dtype code, rows, vec) → its ``Card`` (``_card``)
_CARDS: Dict[tuple, "Card"] = {}


class Card(NamedTuple):
    """What a launch plan needs of the card for one kernel instantiation:
    its SM count, the instantiation's resident blocks an SM, the largest
    cluster it may take (a power of 2) and, for clusters of 1, 2, 4, …
    that many blocks, how many the card holds at once (of 1: SMs × resident
    blocks)."""
    sms: int
    blocks_per_sm: int
    cluster: int
    clusters: Tuple[int, ...]


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


def _mode(kernel: str, rows: bool, outer: int, c: int, inner: int,
          esize: int, vec: bool) -> int:
    """How ``kernel`` reads its map: one value at a time where 16-byte
    accesses do not fit (``vec`` False); else the direct mode on a small
    channels-last map (``_DIRECT_BYTES``) and on planes of at least four
    vectors a thread (``bn_apply``, ``bn_grad_stats``), the ring
    elsewhere."""
    if not vec:
        return _PER_VALUE
    if rows:
        small = outer * c * esize <= _DIRECT_BYTES[kernel]
        return _DIRECT if small else _RING
    wide = inner >= 4 * _THREADS * (16 // esize)
    return _DIRECT if wide and kernel != "bn_stats" else _RING


def _plan(kernel: str, rows: bool, outer: int, c: int, inner: int,
          esize: int, mode: int, card: Card):
    """(span, slices, tile width, cluster, items) of a ``kernel`` launch
    (``bn_stats``, ``bn_apply`` or ``bn_grad_stats``) in ``mode``
    (``_mode``) over ``outer`` × C × ``inner`` values of ``esize`` bytes,
    on ``card``.

    The partition, and with it each sum's order, comes from the shape
    alone (``_partition``); the card sets only ``items``, the tiles on
    the grid at once (grid y; where the tiles outnumber a wave each block
    walks on by ``items``): as many as one wave of the instantiation's
    resident blocks (of its clusters) holds."""
    span, slices, tw, cluster = _partition(kernel, rows, outer, c, inner,
                                           esize, mode)
    tiles = -(-c // tw) if rows else c
    wave = card.clusters[cluster.bit_length() - 1] * cluster
    items = min(tiles, max(1, wave // slices), 65535)
    return span, slices, tw, cluster, items


def _partition(kernel: str, rows: bool, outer: int, c: int, inner: int,
               esize: int, mode: int):
    """(span, slices, tile width, cluster): a tile's slices and their
    clusters, from the shape alone.

    Rows: tiles of ``tw`` channels; planes: one channel a tile.  Direct
    mode: tiles of ``_DIRECT_TILE`` channels, ``_DIRECT_ROWS`` rows a
    thread, no clusters (rows); a channel in 8 slices (planes).  Ring and
    per-value modes: tiles of the whole row up to 512 channels (256 in
    float64 or one value at a time); each of a tile's ``slices`` blocks
    moves ``_SLICE_BYTES`` or more: ``span`` rows (rows) or values
    (planes, a multiple of the 16-byte vector; through the ring a
    channel's planes are dealt out to its blocks a ring stage at a time,
    ``stages_of`` in the source).  The blocks of all tiles fill at most one
    wave of an H100 80GB HBM3 (``_H100``, the clusters of each size it
    holds at once), in whole clusters along the slices: ``slices`` is a
    multiple of ``cluster`` (trailing blocks may hold nothing).  Of the
    cluster sizes that give every tile a cluster, the plan takes the one
    with the most blocks whose last cluster adds the partials in at most
    ``_TAIL_ROUNDS`` rounds of loads, the larger of equals (four resident
    blocks an SM make 528 blocks, clusters of 8 only 480: the tail
    decides which is faster); a tile takes one cluster where its map is
    small enough."""
    v = 16 // esize if mode != _PER_VALUE else 1
    if mode == _DIRECT:
        if rows:
            tw = min(c, _DIRECT_TILE)
            span = _DIRECT_ROWS * (_THREADS // (tw // v))
            return span, -(-outer // span), tw, 1
        span = -(-(-(-(outer * inner) // 8)) // v) * v
        return span, -(-(outer * inner) // span), 0, 1
    if rows:
        tw = min(c, _THREADS * (2 if mode == _RING and esize <= 4 else 1))
        tiles, length, unit = -(-c // tw), outer, tw * esize
    else:
        tw, tiles, length, unit = 0, c, outer * inner, esize
    want = -(-length * unit * _TENSORS[kernel] // _SLICE_BYTES)
    counts = _H100[kernel]
    options = []
    for i, count in enumerate(counts):
        cluster = 1 << i
        per_tile = count // tiles * cluster
        if cluster > 1 and cluster > min(want, per_tile):
            continue
        slices = max(1, min(want, per_tile))
        rounds = _tail_rounds(-(-slices // cluster), -(-max(tw, 1) //
                                                        cluster))
        options.append((rounds <= _TAIL_ROUNDS, slices, cluster))
    _, slices, cluster = max(options)
    span = -(-length // slices)
    if not rows:
        span = -(-span // v) * v
    slices = -(-length // span)           # every slice holds values
    slices = -(-slices // cluster) * cluster
    return span, slices, tw, cluster


def _tail_rounds(clusters: int, channels: int) -> int:
    """Rounds of loads (``run_sum``'s 8 in flight) in which a block of a
    tile's last cluster sums ``clusters`` partials of each of its
    ``channels`` (0 with one cluster)."""
    if clusters == 1:
        return 0
    parts = max(1, min(_THREADS // channels, clusters))
    return -(-(-(-clusters // parts)) // 8)


def _plan_grad_apply(rows: bool, outer: int, c: int, inner: int, v: int,
                     sms: int):
    """(span, slices, tile width in channels) of a ``bn_grad_apply``
    launch (its first design): rows, a tile of ``tw // v`` vector columns
    and 256 // (tw // v) rows at a time, each thread eight rows or more;
    planes, ``span`` values (a multiple of v) of one channel a block, each
    thread four vectors or more; ``_BLOCKS_PER_SM`` blocks on each SM
    aimed at."""
    target = _BLOCKS_PER_SM * sms
    if rows:
        tw = min(c // v, 32)
        tiles = -(-(c // v) // tw)
        ry = _THREADS // tw
        slices = max(1, min(-(-target // tiles), -(-outer // (8 * ry))))
        span = -(-outer // slices)
        return span, -(-outer // span), tw * v
    m = outer * inner
    slices = max(1, min(-(-target // c), -(-m // (4 * _THREADS * v))))
    span = -(-(-(-m // slices)) // v) * v
    return span, -(-m // span), 0


def _occupancy():
    return K.function("batchnorm.cu", "stp_bn_occupancy",
                      [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)


def _card(device: torch.device, kernel: str, code: int, rows: bool,
          mode: int) -> Card:
    """The card's ``Card`` for one instantiation, from the occupancy API
    (``stp_bn_occupancy``) and the device's SM count, asked once."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    key = (index, kernel, code, rows, mode)
    card = _CARDS.get(key)
    if card is None:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        cluster = 1 if kernel == "bn_apply" else _CLUSTER
        counts = []
        blocks, clusters = ctypes.c_int(), ctypes.c_int()
        size = 1
        while size <= cluster:
            with torch.cuda.device(index):
                err = _occupancy()(_KERNEL_CODES[kernel], code, int(rows),
                                   mode, size, ctypes.addressof(blocks),
                                   ctypes.addressof(clusters))
            if err != 0 or blocks.value < 1:
                raise RuntimeError(f"batch norm kernels: occupancy of "
                                   f"{kernel} failed (cudaError {err})")
            counts.append(sms * blocks.value if size == 1
                          else clusters.value)
            size *= 2
        card = _CARDS[key] = Card(sms, blocks.value, cluster, tuple(counts))
    return card


def _geometry(x: Tensor, *others: Tensor):
    """``_new_geometry`` for ``x`` (already dense) and the tensors of its
    shape beside it, on its card; cached by type, shape, strides and
    whether every pointer is 16-byte aligned.  The device stays out of the
    key (it costs every call a device object): the first card's tiles at
    once serve another card too, as they would any card."""
    ptrs = x.data_ptr()
    for t in others:
        ptrs |= t.data_ptr()
    key = (x.dtype, x.shape, x.stride(), not ptrs & 15)
    geo = _GEOMETRY.get(key)
    if geo is None:
        geo = _GEOMETRY[key] = _new_geometry(
            x, key[3], lambda *a: _card(x.device, *a))
    return geo


def _new_geometry(x: Tensor, aligned: bool,
                  card_of: Callable[[str, int, bool, int], Card]):
    """The four kernels' geometry arguments (dtype code first; in the
    order ``bn_stats``, ``bn_apply``, ``bn_grad_stats``, ``bn_grad_apply``)
    and the most clusters a tile of the two reductions has (their partial
    sums' count), from ``card_of(kernel, dtype code, rows, mode)``."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"batch norm kernels: float32, bfloat16, float16 "
                         f"or float64 values, got {x.dtype}")
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"batch norm kernels: a non-empty (B, C, H, W) "
                         f"tensor, got {tuple(x.shape)}")
    b, c, h, w = x.shape
    code, esize, rows = _DTYPES[x.dtype], x.element_size(), _rows(x)
    outer, inner = (b * h * w, 1) if rows else (b, h * w)
    v = 16 // esize
    vec = aligned and (c if rows else inner) % v == 0
    head = (code, int(rows), outer, inner)
    geos, parts = [], 1
    for kernel in ("bn_stats", "bn_apply", "bn_grad_stats"):
        mode = _mode(kernel, rows, outer, c, inner, esize, vec)
        span, slices, tw, cluster, items = _plan(
            kernel, rows, outer, c, inner, esize, mode,
            card_of(kernel, code, rows, mode))
        geos.append(head + (span, c, slices, tw, mode, cluster, items))
        if kernel != "bn_apply":
            parts = max(parts, slices // cluster)
    sms = card_of("bn_stats", code, rows, geos[0][8]).sms
    span, slices, tw = _plan_grad_apply(rows, outer, c, inner,
                                        v if vec else 1, sms)
    tiles = -(-(c // (v if vec else 1)) // (tw // (v if vec else 1))) \
        if rows else c
    geos.append(head + (span, c, slices, tw, int(vec), 1, tiles))
    return (*geos, parts)


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


def _scratch(x: Tensor, stream: int, c: int, parts: int):
    """Pointers to the reductions' tile tickets (at least ``c``) and
    partial sums (at least 2·c·parts float64, ``parts`` clusters a tile)
    of ``x``'s device and ``stream``.  Launches on one stream run in
    order, so they share its scratch; the tickets are zeroed once and
    every launch leaves them zeroed."""
    key = (x.device.index, stream)
    s = _SCRATCH.get(key)
    if s is None or s[0].numel() < c or s[1].numel() < 2 * c * parts:
        n_t = max(c, 1024 if s is None else s[0].numel())
        n_p = max(2 * c * parts, 1 << 16 if s is None else s[1].numel())
        t = torch.zeros(n_t, dtype=torch.int32, device=x.device)
        p = torch.empty(n_p, dtype=torch.float64, device=x.device)
        s = _SCRATCH[key] = (t, p, t.data_ptr(), p.data_ptr())
    return s[2], s[3]


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


# The launches.  Each takes checked, dense tensors of one layout, the
# geometries of ``_geometry`` and the stream, and allocates its outputs.


def _stats(x: Tensor, geo: tuple, stream: int) -> Tensor:
    c = x.shape[1]
    tickets, partials = _scratch(x, stream, c, geo[4])
    out = torch.empty(2 * c + 1, dtype=torch.float64, device=x.device)
    K.KERNELS["bn_stats"].launch(x.data_ptr(), *geo[0], partials, tickets,
                                 out.data_ptr(), stream)
    return out


def _apply(x: Tensor, y: Tensor, geo: tuple, stream: int, sums: Tensor,
           weight: Optional[Tensor], bias: Tensor, running_mean: Tensor,
           running_var: Tensor, momentum: float, eps: float):
    st = torch.empty((4, x.shape[1]), dtype=_acc(x.dtype), device=x.device)
    p, step = st.data_ptr(), st.stride(0) * st.element_size()
    K.KERNELS["bn_apply"].launch(
        x.data_ptr(), y.data_ptr(), *geo[1], sums.data_ptr(), _ptr(weight),
        bias.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(),
        float(momentum), float(eps), p, p + step, p + 2 * step,
        p + 3 * step, stream)
    return st.unbind(0)             # mean, invstd, running mean and var


def _grad_stats(dy: Tensor, x: Tensor, geo: tuple, stream: int,
                mean: Tensor, invstd: Tensor, weight: Optional[Tensor]):
    c = x.shape[1]
    tickets, partials = _scratch(x, stream, c, geo[4])
    out = torch.empty(2 * c, dtype=torch.float64, device=x.device)
    grads = torch.empty((2, c), dtype=_acc(x.dtype), device=x.device)
    p, step = grads.data_ptr(), grads.stride(0) * grads.element_size()
    K.KERNELS["bn_grad_stats"].launch(
        dy.data_ptr(), x.data_ptr(), *geo[2], mean.data_ptr(),
        invstd.data_ptr(), partials, tickets, out.data_ptr(),
        None if weight is None else p, p + step, stream)
    dw, db = grads.unbind(0)
    return out, None if weight is None else dw, db


def _grad_apply(dy: Tensor, x: Tensor, dx: Tensor, geo: tuple,
                stream: int, gsums: Tensor, sums: Tensor, mean: Tensor,
                invstd: Tensor, weight: Optional[Tensor]) -> None:
    K.KERNELS["bn_grad_apply"].launch(
        dy.data_ptr(), x.data_ptr(), dx.data_ptr(), *geo[3], gsums.data_ptr(),
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
    return _stats(x, _geometry(x), K.stream_of(x))


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
    geo = _geometry(x, y)
    return (y, *_apply(x, y, geo, K.stream_of(x), sums, weight, bias,
                       running_mean, running_var, momentum, eps))


def bn_grad_stats(dy: Tensor, x: Tensor, mean: Tensor, invstd: Tensor,
                  weight: Optional[Tensor]):
    """``bn_grad_stats_plain``'s outputs: the ``bn_grad_stats`` kernel on
    dense CUDA tensors of one layout, the plain version on CPU ones."""
    if x.device.type == "cpu":
        return bn_grad_stats_plain(dy, x, mean, invstd, weight)
    _check(x, dy, mean, invstd, weight)
    return _grad_stats(dy, x, _geometry(x, dy), K.stream_of(x), mean,
                       invstd, weight)


def bn_grad_apply(dy: Tensor, x: Tensor, gsums: Tensor, sums: Tensor,
                  mean: Tensor, invstd: Tensor,
                  weight: Optional[Tensor]) -> Tensor:
    """dx: the ``bn_grad_apply`` kernel on dense CUDA tensors of one
    layout, the plain version on CPU ones."""
    if x.device.type == "cpu":
        return bn_grad_apply_plain(dy, x, gsums, sums, mean, invstd, weight)
    _check(x, dy, mean, invstd, weight)
    dx = torch.empty_like(x)
    _grad_apply(dy, x, dx, _geometry(x, dy, dx), K.stream_of(x), gsums,
                sums, mean, invstd, weight)
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
            geo = _geometry(x, y)
            stream = K.stream_of(x)
            sums = _stats(x, geo, stream)
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
            geo = _geometry(x, dy, *(() if dx is None else (dx,)))
            stream = K.stream_of(x)
            gsums, dw, db = _grad_stats(dy, x, geo, stream, mean, invstd,
                                        weight)
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
