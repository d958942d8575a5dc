"""Spatial partitioning of H over the ``space`` axis, written by hand.

The JAX package shards each batch ``P('data', 'space')`` on (N, H) and
GSPMD partitions every op of the model for it.  Here the model's layers
ask this module what to do with the tensor they were given.  The train
and eval steps open ``partitioned(mesh, hg, wg)`` around the model (and
its backward pass, which a remat recomputation runs forward again in):

  * the group: S ranks (``Mesh.space``), this one the ``s``-th, each
    holding rows ``s·H/S … (s+1)·H/S`` of the input images of its data
    rows; the global image is ``hg`` × ``wg``.  W is never cut.
  * **The level rule.**  A feature map's stride ``f`` is read from its
    width: the smallest power of two with ``ceil(wg / f) == W``.  The
    level is *split* when every slab holds a whole number of rows at
    that stride, ``hg % (S·f) == 0``; it then holds ``hg / (S·f)`` rows.
    Otherwise the level runs *whole* on every rank of the group.  A map
    whose width is no level's (PSPNet's bins, a pooled 1×1) is whole.
    At Unet-resnet18 32² with S = 2 the stride-16 level holds one row a
    rank and the stride-32 level runs whole.
  * **Windows** (``layers.pad_same``, ``Conv``'s odd-window path): on a
    split map whose output level is split too, a SAME window of
    effective size k at stride s reads ``t = same_pads(H, k, s)[0]`` rows
    above the slab and ``k − s − t`` below (negative: rows dropped), from
    the neighbours (``halo``); the fill (0, −inf, or the edge row for a
    bilinear resize) sits only at the image's true edges.  When the
    output level runs whole the input is gathered first.
  * **Means** over H and W are group sums over the global pixel count
    (``mean_hw``).  **Resizes** by a whole factor of a split map stay on
    the slab (bilinear with a one-row halo); any other resize runs whole
    and is cut to the output level (``resize``).
  * Gradients: what runs whole is each rank's own copy, which reaches the
    loss only through that rank's slab, so the world's gradient sum
    counts every path once (``parallel/distributed.py``).

Without ``partitioned`` (one process, or ``space: 1``) every function here
leaves its layer's one-process path as it was.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from . import distributed as dist

Tensor = torch.Tensor

# the deepest stride a level is looked for at (2^12)
_MAX_LOG2_STRIDE = 12


@dataclass(frozen=True)
class Space:
    size: int     # S, the ranks of the group
    index: int    # s, this rank's slab
    hg: int       # the global image's height
    wg: int       # and width
    group: Any    # the space subgroup

    def stride(self, w: int) -> Optional[int]:
        """The stride of a map ``w`` wide, or None for no level's width."""
        for i in range(_MAX_LOG2_STRIDE + 1):
            if -(-self.wg // (1 << i)) == w:
                return 1 << i
        return None

    def level_split(self, f: int) -> bool:
        return self.hg % (self.size * f) == 0

    def is_split(self, x: Tensor) -> bool:
        """True for an NCHW map that holds this rank's slab of a split
        level."""
        f = self.stride(x.shape[3])
        return (f is not None and self.level_split(f)
                and x.shape[2] * self.size * f == self.hg)

    def global_h(self, x: Tensor) -> int:
        """The height of ``x``'s level over the whole image."""
        return x.shape[2] * self.size if self.is_split(x) else x.shape[2]


_CURRENT: Optional[Space] = None


def current() -> Optional[Space]:
    """The open partitioning, or None."""
    return _CURRENT


@contextlib.contextmanager
def partitioned(mesh, hg: int, wg: int):
    """Run a block with the model's maps split over ``mesh``'s space axis
    for a global image of ``hg`` × ``wg`` (a no-op for ``space: 1``)."""
    global _CURRENT
    if mesh is None or mesh.space == 1:
        yield
        return
    mesh.slab(hg)          # JAX's error for an H the axis does not divide
    prev = _CURRENT
    _CURRENT = Space(mesh.space, mesh.s, hg, wg,
                     dist.space_group(mesh.data, mesh.space, mesh.d))
    try:
        yield
    finally:
        _CURRENT = prev


def is_split(x: Tensor) -> bool:
    return _CURRENT is not None and _CURRENT.is_split(x)


def split_after(x: Tensor, stride: int) -> bool:
    """True when a window of ``stride`` on the split ``x`` lands on a split
    level."""
    sp = _CURRENT
    return sp.level_split(sp.stride(x.shape[3]) * stride)


def gather(x: Tensor, dim: int = 2) -> Tensor:
    """The whole tensor from this rank's slab along ``dim``: H of an NCHW
    map, or ``dim=1`` for the step's NHWC logits."""
    sp = _CURRENT
    return dist.gather_h(x, dim, sp.size, sp.index, sp.group)


def slab_of(whole: Tensor, like: Tensor) -> Tensor:
    """This rank's rows (dim 2) of ``whole`` when ``like`` holds fewer
    rows (a slab), else ``whole``: a cut needs no collective, its backward
    zero-pads."""
    n = like.shape[2]
    if _CURRENT is None or whole.shape[2] == n:
        return whole
    if whole.shape[2] != n * _CURRENT.size:
        raise ValueError(f"a slab of {n} rows does not cut "
                         f"{whole.shape[2]} rows into {_CURRENT.size}")
    return whole.narrow(2, _CURRENT.index * n, n)


def to_level(y: Tensor) -> Tensor:
    """A whole map cut to its level's layout (unchanged when the level
    runs whole or ``y`` is a slab already)."""
    sp = _CURRENT
    if sp is None:
        return y
    f = sp.stride(y.shape[3])
    if f is None or not sp.level_split(f) or y.shape[2] * f != sp.hg:
        return y
    n = y.shape[2] // sp.size
    return y.narrow(2, sp.index * n, n)


def halo(x: Tensor, top: int, bottom: int,
         fill: Optional[float] = 0.0) -> Tensor:
    """The split NCHW ``x`` with ``top`` rows above and ``bottom`` below
    from its neighbours (a negative ``bottom`` drops rows instead).  At
    the image's true edges the rows are ``fill``, or copies of the edge
    row when ``fill`` is None.  A halo taller than the slab reads the
    gathered map."""
    sp = _CURRENT
    n = x.shape[2]
    down = max(bottom, 0)
    if top > n or down > n:
        whole = gather(x)
        if fill is None:
            whole = F.pad(whole, (0, 0, top, down), mode="replicate")
        else:
            whole = F.pad(whole, (0, 0, top, down), value=fill)
        return whole.narrow(2, sp.index * n, top + n + bottom)
    body = x if bottom >= 0 else x.narrow(2, 0, n + bottom)
    if top == 0 and down == 0:
        return body
    got = dist.halo_exchange(x, top, down, sp.size, sp.index, sp.group)
    up, low = got[:, :, :top], got[:, :, top:]

    def edge(rows: Tensor, k: int) -> Tensor:
        if fill is None:
            return rows.expand(-1, -1, k, -1)
        return x.new_full((x.shape[0], x.shape[1], k, x.shape[3]), fill)

    if sp.index == 0 and top:
        up = edge(x[:, :, :1], top)
    if sp.index == sp.size - 1 and down:
        low = edge(x[:, :, n - 1:], down)
    return torch.cat([up, body, low], dim=2)


def mean_hw(x: Tensor) -> Tensor:
    """The spatial mean (N, C, 1, 1) of the global map: on a slab, the
    float32 sum over the group divided by the global pixel count."""
    if not is_split(x):
        return x.mean(dim=(2, 3), keepdim=True)
    sp = _CURRENT
    s = dist.space_sum(x.float().sum(dim=(2, 3), keepdim=True), sp.group)
    return (s / (x.shape[2] * sp.size * x.shape[3])).to(x.dtype)


def space_sum(t: Tensor) -> Tensor:
    """Differentiable sum of ``t`` over the group."""
    return dist.space_sum(t, _CURRENT.group)


def valid_pool(x: Tensor, k: int, fn: Callable) -> Tensor:
    """``fn(x, k, k)``, a k×k / k VALID pool: on the slab when the output
    level is split too, else on the gathered map."""
    if is_split(x) and not split_after(x, k):
        x = gather(x)
    return fn(x, k, k)


def resize(x: Tensor, h: int, w: int, method: str,
           fn: Callable[[Tensor, int, int, str], Tensor]) -> Tensor:
    """``fn(x, h, w, method)`` (the one-process resize) for the split or
    whole ``x``, in the output level's layout; ``h`` is that level's
    height on this rank or on the whole image.  An upsample of a split map
    by a whole factor in H stays on the slab: nearest reads only its own
    rows, bilinear one edge row from each neighbour (the edge row itself
    at the image's edges, as the clamp), then drops the factor's rows at
    both ends.  Anything else runs on the whole map and is cut."""
    sp = _CURRENT
    fo = sp.stride(w)
    out_split = fo is not None and sp.level_split(fo)
    hl = -(-sp.hg // fo) if fo is not None else h
    if sp.is_split(x):
        n = x.shape[2]
        k = hl // (n * sp.size)
        if out_split and k >= 1 and k * n * sp.size == hl:
            if method == "nearest":
                return fn(x, k * n, w, method)
            if method == "bilinear" and w >= x.shape[3]:
                y = fn(halo(x, 1, 1, None), k * (n + 2), w, method)
                return y.narrow(2, k, k * n)
        x = gather(x)
    y = fn(x, hl, w, method)
    return to_level(y) if out_split else y
