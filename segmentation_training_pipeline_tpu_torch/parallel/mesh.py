"""The data-parallel layout over the process group.

Counterpart of ``segmentation_training_pipeline_tpu/parallel/mesh.py``.
One process drives one card, so the mesh is the process group itself:

  * axes ``data`` (batch rows) × ``space`` (H, for large images), laid
    out as the JAX package's ``np.asarray(devices).reshape(data,
    space)``: rank ``r = d·S + s`` holds data block ``d = r // S`` and H
    slab ``s = r % S``.
  * Parameters and optimizer state are replicated.  Rank ``r`` takes rows
    ``d·B/D … (d+1)·B/D`` of each global batch of ``B``, whole: every
    rank of a space group augments the same images, then keeps rows
    ``s·H/S … (s+1)·H/S`` of them (``Mesh.slab``; ``parallel/spatial.py``
    runs the model on the slabs).  BatchNorm's statistics are summed over
    the group (``models/layers.py``) and the gradients summed in one flat
    bucket (``train/step.py``), so a W-rank step computes what the
    one-process step computes at the same global batch, up to reduction
    order.
  * ``hosts`` is the outer blocking of ``data``, as in the JAX package:
    torchrun numbers ranks node-major, so rank ``r`` sits on node
    ``r // LOCAL_WORLD_SIZE``.  NCCL forms its own hierarchy across
    nodes; nothing hybrid is written here.
  * A process without a group is a mesh of one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from . import distributed as dist


@dataclass(frozen=True)
class MeshSpec:
    data: int = -1   # -1 = all remaining processes
    space: int = 1
    hosts: int = 0   # outer factor of the data axis; 0 = the node count

    @staticmethod
    def from_config(mesh_cfg: Dict[str, int]) -> "MeshSpec":
        return MeshSpec(
            data=int(mesh_cfg.get("data", -1)),
            space=int(mesh_cfg.get("space", 1)),
            hosts=int(mesh_cfg.get("hosts", 0)),
        )


@dataclass(frozen=True)
class Mesh:
    """This process's place in the layout."""

    data: int
    space: int
    hosts: int
    rank: int
    world: int

    @property
    def d(self) -> int:
        """This rank's index on the data axis."""
        return self.rank // self.space

    @property
    def s(self) -> int:
        """This rank's index on the space axis (its H slab)."""
        return self.rank % self.space

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` (its data block's,
        the same on every rank of a space group)."""
        if n % self.data:
            raise ValueError(f"batch {n} is not divisible by the mesh data "
                             f"axis ({self.data})")
        per = n // self.data
        return slice(self.d * per, (self.d + 1) * per)

    def slab(self, h: int) -> slice:
        """This rank's rows of an image of height ``h``, with the error
        JAX's ``device_put`` raises for an H the space axis does not
        divide."""
        if h % self.space:
            raise ValueError(
                f"the sharding P('data', 'space') implies that the global "
                f"size of its dimension 1 should be divisible by "
                f"{self.space}, but it is equal to {h}")
        per = h // self.space
        return slice(self.s * per, (self.s + 1) * per)


def build_mesh(spec: Optional[MeshSpec] = None,
               world: Optional[int] = None, rank: Optional[int] = None,
               local_world: Optional[int] = None) -> Mesh:
    """The mesh over ``world`` processes (the group's size; 1 without a
    group), with the JAX package's rules and ``ValueError`` texts.
    ``rank`` and ``local_world`` (processes per node) default to the
    group's and torchrun's."""
    spec = spec or MeshSpec()
    n = dist.process_count() if world is None else world
    rank = dist.process_index() if rank is None else rank
    local = dist.local_world_size() if local_world is None else local_world
    space = max(1, spec.space)
    hosts = spec.hosts if spec.hosts and spec.hosts > 0 else max(
        1, n // max(1, local))
    data = spec.data if spec.data and spec.data > 0 else n // space
    if data * space != n:
        hint = ""
        if n == 1:
            want = data * space if data > 0 else space
            hint = (" (torch drives one card per process: launch "
                    f"{want} processes with `torchrun "
                    f"--nproc-per-node {want}`)")
        raise ValueError(
            f"mesh {data}x{space} (data x space) does not cover {n} "
            f"devices{hint}")
    if data % hosts:
        raise ValueError(
            f"mesh data axis ({data}) is not divisible by the DCN/hosts "
            f"factor ({hosts})")
    return Mesh(data=data, space=space, hosts=hosts, rank=rank, world=n)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of every array (numpy or tensor) with 2 or more
    dims, whole in H (the step cuts the slab after the augmentation, which
    reads source rows from anywhere); 1-D arrays (the per-example
    ``weight``) stay whole, as the JAX package replicates them."""
    return {k: v[mesh.rows(v.shape[0])] if v.ndim >= 2 else v
            for k, v in batch.items()}
