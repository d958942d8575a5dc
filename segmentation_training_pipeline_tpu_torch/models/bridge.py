"""flax variables ⇄ PyTorch state dict, by name.

The flax tree ``{"params": …, "batch_stats": …}`` (numpy leaves, nested
dicts) maps onto this package's module names one to one:

  params/<path>/kernel  (kh, kw, in, out)  ↔  <path>.weight (out, in, kh, kw)
  params/<path>/bias                        ↔  <path>.bias
  params/<path>/scale   (BatchNorm)         ↔  <path>.weight
  batch_stats/<path>/mean, var              ↔  <path>.running_mean, .running_var

with ``/`` ↔ ``.``.  Conv kernels go HWIO ↔ OIHW (the transpose the JAX
package's ``models/pretrained.py`` applies to torchvision weights, in the
other direction); a depthwise kernel (k, k, 1, C) becomes PyTorch's grouped
layout (C, 1, k, k) by the same transpose.  Both directions copy values bit
for bit.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

Tensor = torch.Tensor


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(dict(v.items()), path))
        else:
            out[path] = v
    return out


def state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, Tensor]:
    """flax variables (numpy or array-like leaves) → PyTorch state dict."""
    sd: Dict[str, Tensor] = {}
    for path, v in _flatten(dict(variables.get("params", {}))).items():
        mod, leaf = path.rsplit("/", 1)
        arr = np.asarray(v)
        if leaf == "kernel":
            arr, leaf = arr.transpose(3, 2, 0, 1), "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf != "bias":
            raise KeyError(f"unexpected flax parameter {path!r}")
        sd[f"{mod.replace('/', '.')}.{leaf}"] = torch.from_numpy(
            np.array(arr, order="C"))
    names = {"mean": "running_mean", "var": "running_var"}
    for path, v in _flatten(dict(variables.get("batch_stats", {}))).items():
        mod, leaf = path.rsplit("/", 1)
        sd[f"{mod.replace('/', '.')}.{names[leaf]}"] = torch.from_numpy(
            np.array(v))
    return sd


def jax_from_state_dict(state_dict: Dict[str, Tensor]) -> Dict[str, Any]:
    """PyTorch state dict → flax variables with numpy leaves."""
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for name, t in state_dict.items():
        mod, leaf = name.rsplit(".", 1)
        arr = t.detach().cpu().numpy()
        if leaf in ("running_mean", "running_var"):
            coll, leaf = "batch_stats", leaf[len("running_"):]
        elif leaf == "weight":
            coll = "params"
            if arr.ndim == 4:
                arr, leaf = arr.transpose(2, 3, 1, 0), "kernel"
            else:
                leaf = "scale"
        elif leaf == "bias":
            coll = "params"
        else:
            raise KeyError(f"unexpected state-dict entry {name!r}")
        node = out[coll]
        for part in mod.split("."):
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr)
    return out
