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
CUDA tensors for both, not for ``all_gather``).
"""

from __future__ import annotations

import os
import zlib
from datetime import timedelta
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

Tensor = torch.Tensor

# how long a collective waits for the other ranks before it raises
TIMEOUT_S = 600.0

# all-reduce calls and bytes since the last ``reset_counts``
_COUNTS = {"all_reduce": 0, "bytes": 0}


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
    for k in _COUNTS:
        _COUNTS[k] = 0


def counts() -> Dict[str, int]:
    """All-reduce calls and their bytes since ``reset_counts``."""
    return dict(_COUNTS)


def all_reduce_(t: Tensor) -> Tensor:
    """In-place sum of ``t`` over the group (no autograd)."""
    _count(t)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group in the forward pass, and the same sum of the
    incoming gradient in the backward pass: each rank's loss depends on
    every rank's input through the sum."""

    @staticmethod
    def forward(ctx, t: Tensor) -> Tensor:
        return all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, g: Tensor) -> Tensor:
        return all_reduce_(g.clone())


def all_reduce_sum(t: Tensor) -> Tensor:
    """Differentiable sum of ``t`` over the group."""
    return _AllReduceSum.apply(t)


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
