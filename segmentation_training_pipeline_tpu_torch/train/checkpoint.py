"""Checkpoint save/load in the JAX package's format and directory contract.

Counterpart of ``segmentation_training_pipeline_tpu/train/checkpoint.py``:
``weights/best-{fold}.{stage}.weights`` holds the flax variables tree
``{"batch_stats", "params"}`` as flax's msgpack (``utils.msgpack_tree``),
beside a JSON sidecar ``<path>.json`` with the model identity and the best
metric.  Both are written to ``.tmp`` and moved into place with
``os.replace``, so a crash never leaves a torn file.  The state dict ⇄
flax tree mapping is ``models.bridge``'s, so files move between the two
packages both ways.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn as nn

from ..models.bridge import (flatten, flax_path, jax_from_state_dict,
                             state_dict_from_jax)
from ..utils import msgpack_tree

Tensor = torch.Tensor


def _sorted_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Keys sorted at every level: the order ``jax.device_get`` rebuilds
    dicts in before the JAX package serialises them, so that both packages
    write the same bytes for the same variables."""
    return {k: _sorted_tree(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


def save_checkpoint(path: str, state_dict: Mapping[str, Tensor],
                    meta: Optional[Dict[str, Any]] = None) -> None:
    """Write a model's state dict (parameters and BN buffers) as the flax
    variables tree, and the sidecar when ``meta`` is given."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = msgpack_tree.packb(_sorted_tree(jax_from_state_dict(state_dict)))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)
    if meta is not None:
        tmp_meta = path + ".json.tmp"
        with open(tmp_meta, "w") as f:
            json.dump(meta, f, indent=2, default=float)
        os.replace(tmp_meta, path + ".json")


def load_checkpoint(path: str, model: nn.Module) -> Dict[str, Tensor]:
    """Load a checkpoint into ``model`` (strictly) and return its state
    dict (CPU tensors).  A file whose leaves are not the model's raises a
    ``ValueError`` naming the first flax path that differs; a leaf of the
    wrong shape raises in ``load_state_dict``."""
    with open(path, "rb") as f:
        tree = msgpack_tree.unpackb(f.read())
    have = sorted(flatten(tree))
    want = sorted(flax_path(n, t.ndim) for n, t in model.state_dict().items())
    if have != want:
        first = next((a, b) for a, b in zip(have + [None], want + [None])
                     if a != b)
        raise ValueError(
            f"checkpoint {path} does not fit the {type(model).__name__}: "
            f"first differing leaf is {first[0]!r} in the file, "
            f"{first[1]!r} in the model")
    sd = state_dict_from_jax(tree)
    model.load_state_dict(sd, strict=True)
    return sd


def checkpoint_meta(path: str) -> Optional[Dict[str, Any]]:
    side = path + ".json"
    if os.path.exists(side):
        with open(side) as f:
            return json.load(f)
    return None
