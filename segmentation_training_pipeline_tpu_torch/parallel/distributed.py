"""Multi-process bootstrap on ``torch.distributed``: one process per card.

Counterpart of ``segmentation_training_pipeline_tpu/parallel/distributed.py``.
PyTorch's idiom is one process per card, launched by ``torchrun``
(``python -m torch.distributed.run --nproc-per-node N …``), where the JAX
package drives every local chip from one process.  ``maybe_initialize``
joins the processes into one process group:

  * it runs when ``STP_DISTRIBUTED`` is set (the JAX package's switch,
    the same values: anything but ``0``, ``false`` or empty) or when
    torchrun's environment is there (``WORLD_SIZE``, ``RANK`` and
    ``MASTER_ADDR``);
  * the JAX-only variables map to torchrun's, which are the ones read
    here: ``JAX_COORDINATOR_ADDRESS`` → ``MASTER_ADDR``/``MASTER_PORT``,
    ``JAX_NUM_PROCESSES`` → ``WORLD_SIZE``, ``JAX_PROCESS_ID`` → ``RANK``;
    torchrun also sets ``LOCAL_RANK`` (the card) and ``LOCAL_WORLD_SIZE``
    (processes per node, ``mesh.py``'s ``hosts``);
  * the card's backend is NCCL.  A failed NCCL init raises; nothing falls
    back to another backend.  Gloo runs only where a caller names it
    (``backend="gloo"``: the CPU tests, and two ranks rehearsed on one
    card, which NCCL refuses).

A process without a group is the default and takes the one-process path
of every module, unchanged.  A process with a group runs its collectives
whatever the group's size, so a world-size-1 NCCL run really calls NCCL.
The collectives are ``all_reduce`` and ``barrier`` only (gloo carries
CUDA tensors for both, not for ``all_gather``), on both backends.

The ``space`` axis (``parallel/spatial.py``) adds one subgroup per space
group (``space_group``, created in the same order on every rank) and
three differentiable collectives on it, each an ``all_reduce`` of a
zero-padded buffer:

  * ``halo_exchange``: each rank's edge rows to its neighbours (forward),
    the halo rows' gradients back to their owners (backward);
  * ``gather_h``: a tensor split in H becomes whole on every rank of the
    group; backward sums the group's gradients and keeps the rank's slab;
  * ``space_sum``: a sum over the group, forward and backward.

A level cut back from whole (``x.narrow``) needs no collective: its
backward zero-pads.  These follow one convention: a value that every rank
of a group computes whole is each rank's own variable, and reaches the
loss only through that rank's slab, so the gradients summed over the world
count every path once.  Each kind keeps its own count of calls and bytes
(``space_counts``), apart from the world's ``all_reduce`` count.
"""

from __future__ import annotations

import os
import zlib
from datetime import timedelta
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

Tensor = torch.Tensor

# how long a collective waits for the other ranks before it raises
TIMEOUT_S = 600.0

# all-reduce calls and bytes since the last ``reset_counts``
_COUNTS = {"all_reduce": 0, "bytes": 0}
# the space subgroups' collectives: calls and bytes of each kind
_SPACE_COUNTS = {k: 0 for k in ("halo", "halo_bytes", "gather",
                                "gather_bytes", "space_sum",
                                "space_sum_bytes")}
# (data, space) → this rank's space group
_SPACE_GROUPS: Dict[Tuple[int, int], Any] = {}


def _requested() -> bool:
    if os.environ.get("STP_DISTRIBUTED", "0") not in ("0", "false", ""):
        return True
    return all(os.environ.get(k) for k in ("WORLD_SIZE", "RANK",
                                           "MASTER_ADDR"))


def active() -> bool:
    """True in a process that belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def maybe_initialize(force: Optional[bool] = None,
                     backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout_s: float = TIMEOUT_S) -> bool:
    """Join the process group when multi-process execution is requested
    (``force``, or the environment: see the module's notes).  Returns True
    iff more than one process runs afterwards.  Idempotent.

    ``backend``: ``nccl`` (the default), whose card ``cuda:LOCAL_RANK``
    becomes the current device before any other CUDA use, or ``gloo``,
    which leaves the current device as it is (ranks rehearsed on one card
    share card 0).  ``init_method``, ``world_size`` and ``rank`` default
    to torchrun's environment (``env://``)."""
    want = force if force is not None else _requested()
    if want and not active():
        backend = backend or "nccl"
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        kw = {}
        if world_size is not None:
            kw["world_size"] = world_size
        if rank is not None:
            kw["rank"] = rank
        dist.init_process_group(backend, init_method=init_method,
                                timeout=timedelta(seconds=timeout_s), **kw)
    return process_count() > 1


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    _SPACE_GROUPS.clear()
    if active():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if active() else 1


def process_index() -> int:
    return dist.get_rank() if active() else 0


def is_primary() -> bool:
    """True on the process that owns host-side side effects (checkpoint
    writes, metrics CSV, event files).  Always True in one process."""
    return process_index() == 0


def local_world_size() -> int:
    """Processes on this node (torchrun's ``LOCAL_WORLD_SIZE``; all of
    them when it is not set)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", process_count()))


def _count(t: Tensor) -> None:
    _COUNTS["all_reduce"] += 1
    _COUNTS["bytes"] += t.numel() * t.element_size()


def reset_counts() -> None:
    for d in (_COUNTS, _SPACE_COUNTS):
        for k in d:
            d[k] = 0


def counts() -> Dict[str, int]:
    """All-reduce calls over the world and their bytes since
    ``reset_counts``."""
    return dict(_COUNTS)


def space_counts() -> Dict[str, int]:
    """Halo exchanges, gathers and group sums on the space subgroups
    (forward and backward calls) and their bytes since ``reset_counts``."""
    return dict(_SPACE_COUNTS)


def all_reduce_(t: Tensor) -> Tensor:
    """In-place sum of ``t`` over the group (no autograd)."""
    _count(t)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_reduce_flat(tensors: List[Tensor]) -> None:
    """Sum ``tensors`` over the group in place, through one flat bucket
    and one ``all_reduce``."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view(t.shape))
        offset += n


def barrier(name: str) -> None:
    """Wait for every rank at the barrier ``name`` (no-op without a
    group).  One all-reduce of the name's hash, as its maximum and its
    negated minimum, so ranks that wait at different barriers raise
    instead of passing each other."""
    if not active():
        return
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    h = float(zlib.crc32(name.encode()) & 0xFFFFFF)
    t = torch.tensor([h, -h], dtype=torch.float64, device=dev)
    _count(t)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    if t[0].item() != h or -t[1].item() != h:
        raise RuntimeError(f"barrier {name!r}: the ranks are at different "
                           "barriers")


def space_group(data: int, space: int, d: int):
    """The subgroup of data block ``d``'s space group (ranks ``d·space …
    d·space + space − 1``).  ``new_group`` is collective over the world:
    every rank creates all ``data`` groups, in the same order, once."""
    key = (data, space)
    if key not in _SPACE_GROUPS:
        groups = [dist.new_group(list(range(i * space, (i + 1) * space)))
                  for i in range(data)]
        _SPACE_GROUPS[key] = groups
    return _SPACE_GROUPS[key][d]


def _group_sum_(t: Tensor, group, kind: str) -> Tensor:
    """In-place sum of the contiguous ``t`` over ``group``, counted as
    ``kind``."""
    _SPACE_COUNTS[kind] += 1
    _SPACE_COUNTS[kind + "_bytes"] += t.numel() * t.element_size()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _SpaceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: Tensor, group) -> Tensor:
        ctx.group = group
        return _group_sum_(t.contiguous().clone(), group, "space_sum")

    @staticmethod
    def backward(ctx, g: Tensor):
        return _group_sum_(g.contiguous().clone(), ctx.group,
                           "space_sum"), None


def space_sum(t: Tensor, group) -> Tensor:
    """Differentiable sum of ``t`` over the space ``group``."""
    return _SpaceSum.apply(t, group)


class _GatherH(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, dim: int, size: int, index: int,
                group) -> Tensor:
        ctx.dim, ctx.size, ctx.index, ctx.group = dim, size, index, group
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * size
        buf = x.new_zeros(shape)
        buf.narrow(dim, index * n, n).copy_(x)
        return _group_sum_(buf, group, "gather")

    @staticmethod
    def backward(ctx, g: Tensor):
        g = _group_sum_(g.contiguous().clone(), ctx.group, "gather")
        n = g.shape[ctx.dim] // ctx.size
        return g.narrow(ctx.dim, ctx.index * n, n), None, None, None, None


def gather_h(x: Tensor, dim: int, size: int, index: int, group) -> Tensor:
    """The whole tensor on every rank of the space ``group`` from each
    rank's slab along ``dim`` (rank ``index`` of ``size`` holds rows
    ``index·n … (index+1)·n``): one sum of zero-padded slabs.  Backward:
    the group's gradients summed, then the rank's slab."""
    return _GatherH.apply(x, dim, size, index, group)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, top: int, bottom: int, size: int,
                index: int, group) -> Tensor:
        ctx.top, ctx.bottom, ctx.size, ctx.index, ctx.group = (
            top, bottom, size, index, group)
        n = x.shape[2]
        # slot r: rank r's last ``top`` rows (its lower neighbour's top
        # halo), then its first ``bottom`` rows (its upper neighbour's
        # bottom halo)
        buf = x.new_zeros((size, x.shape[0], x.shape[1], top + bottom,
                           x.shape[3]))
        buf[index, :, :, :top] = x[:, :, n - top:]
        buf[index, :, :, top:] = x[:, :, :bottom]
        _group_sum_(buf, group, "halo")
        out = x.new_zeros((x.shape[0], x.shape[1], top + bottom,
                           x.shape[3]))
        if index > 0:
            out[:, :, :top] = buf[index - 1, :, :, :top]
        if index < size - 1:
            out[:, :, top:] = buf[index + 1, :, :, top:]
        ctx.n = n
        return out

    @staticmethod
    def backward(ctx, g: Tensor):
        top, bottom, size, index, n = (ctx.top, ctx.bottom, ctx.size,
                                       ctx.index, ctx.n)
        # the top halo's gradient belongs to the rank above, the bottom
        # halo's to the rank below: the same slots, read the other way
        buf = g.new_zeros((size, g.shape[0], g.shape[1], top + bottom,
                           g.shape[3]))
        if index > 0:
            buf[index, :, :, :top] = g[:, :, :top]
        if index < size - 1:
            buf[index, :, :, top:] = g[:, :, top:]
        _group_sum_(buf, ctx.group, "halo")
        gx = g.new_zeros((g.shape[0], g.shape[1], n, g.shape[3]))
        if index < size - 1 and top:
            gx[:, :, n - top:] += buf[index + 1, :, :, :top]
        if index > 0 and bottom:
            gx[:, :, :bottom] += buf[index - 1, :, :, top:]
        return gx, None, None, None, None, None


def halo_exchange(x: Tensor, top: int, bottom: int, size: int, index: int,
                  group) -> Tensor:
    """The ``top`` rows above and the ``bottom`` rows below rank
    ``index``'s NCHW slab ``x`` (each at most the slab's height), from
    its neighbours in the space ``group``, as one (N, C, top + bottom, W)
    tensor; zeros where the slab touches the image's edge (the caller
    fills them).  Backward: each halo row's gradient is added to the row
    it came from."""
    return _HaloExchange.apply(x, top, bottom, size, index, group)
