"""flax variables ⇄ PyTorch state dict, by name.

The flax tree ``{"params": …, "batch_stats": …}`` (numpy leaves, nested
dicts) maps onto this package's module names one to one:

  params/<path>/kernel  (kh, kw, in, out)  ↔  <path>.weight (out, in, kh, kw)
  params/<path>/bias                        ↔  <path>.bias
  params/<path>/scale   (BatchNorm)         ↔  <path>.weight
  batch_stats/<path>/mean, var              ↔  <path>.running_mean, .running_var

with ``/`` ↔ ``.``.  Conv kernels go HWIO ↔ OIHW (the transpose the JAX
package's ``models/pretrained.py`` applies to torchvision weights, in the
other direction); a grouped kernel (k, k, in/groups, out), depthwise
(k, k, 1, C) included, becomes PyTorch's grouped layout (out, in/groups,
k, k) by the same transpose.  Both directions copy values bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

Tensor = torch.Tensor


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dicts → ``{"a/b/leaf": leaf}``."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flatten(dict(v.items()), path))
        else:
            out[path] = v
    return out


def _tensor(v) -> Tensor:
    """A leaf as a CPU tensor (tensor leaves, as the checkpoint reader
    gives them, keep bfloat16, which numpy lacks)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.from_numpy(np.array(v))


def state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, Tensor]:
    """flax variables (tensor, numpy or array-like leaves) → PyTorch state
    dict."""
    sd: Dict[str, Tensor] = {}
    for path, v in flatten(dict(variables.get("params", {}))).items():
        mod, leaf = path.rsplit("/", 1)
        t = _tensor(v)
        if leaf == "kernel":
            t, leaf = t.permute(3, 2, 0, 1).contiguous(), "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf != "bias":
            raise KeyError(f"unexpected flax parameter {path!r}")
        sd[f"{mod.replace('/', '.')}.{leaf}"] = t
    names = {"mean": "running_mean", "var": "running_var"}
    for path, v in flatten(dict(variables.get("batch_stats", {}))).items():
        mod, leaf = path.rsplit("/", 1)
        if leaf not in names:
            raise KeyError(f"unexpected flax batch statistic {path!r}")
        sd[f"{mod.replace('/', '.')}.{names[leaf]}"] = _tensor(v)
    return sd


def flax_path(name: str, ndim: int) -> str:
    """The flax leaf path (``collection/module/…/leaf``) of state-dict
    entry ``name`` holding a tensor of ``ndim`` dimensions."""
    mod, leaf = name.rsplit(".", 1)
    if leaf in ("running_mean", "running_var"):
        coll, leaf = "batch_stats", leaf[len("running_"):]
    elif leaf == "weight":
        coll, leaf = "params", "kernel" if ndim == 4 else "scale"
    elif leaf == "bias":
        coll = "params"
    else:
        raise KeyError(f"unexpected state-dict entry {name!r}")
    return "/".join([coll, *mod.split("."), leaf])


def jax_from_state_dict(state_dict: Dict[str, Tensor]) -> Dict[str, Any]:
    """PyTorch state dict → flax variables with numpy leaves."""
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for name, t in state_dict.items():
        arr = t.detach().cpu().numpy()
        *parts, leaf = flax_path(name, arr.ndim).split("/")
        if leaf == "kernel":
            arr = arr.transpose(2, 3, 1, 0)
        node = out
        for part in parts:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr)
    return out
