"""What every part of the benchmark shares: finding files by name, the
import guard, seeds, and the inputs made from a seed on the card."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import re
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded where the program runs
FORBIDDEN = ("jax", "jaxlib", "flax", "segmentation_training_pipeline_tpu")
# H100 SXM, dense, NVIDIA's data sheet: bf16 FLOP/s and HBM bytes/s
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def load_json(kind: str, name: str) -> dict:
    """``portbench/<kind>/<name>.json``."""
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module of its own."""
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} named {name!r}: {path}")
    key = f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


def subseed(seed: int, tag: str) -> int:
    """A generator seed under 2**62 for one use of the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 2


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, tag))


def p90(values: List[float]) -> float:
    """The 90th percentile (``statistics.quantiles``, exclusive method)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=10)[8]


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


# --- weights ----------------------------------------------------------------

def weight_shapes(arch: str) -> Dict[str, torch.Size]:
    """Every parameter and buffer of the reference model, by name."""
    from portbench.reference.models import Segmenter

    with torch.device("meta"):
        model = Segmenter(arch)
    return {k: v.shape for k, v in model.state_dict().items()}


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights of a configuration's reference model in three
    draws on ``device``: convolution kernels normal with std 1/sqrt(fan_in)
    (flax's fan-in scaling), BatchNorm scales 1 + 0.1·N and shifts 0.1·N,
    convolution biases 0, running means 0 and variances 1.  The scale of
    the last BatchNorm of every residual branch (the names that the
    configuration's ``init.residual_bn`` pattern matches) is multiplied by
    ``init.residual_gamma``, as a trained residual network's branches add
    small corrections to their stream (Goyal et al. 2017 start them at 0);
    a random deep network with unit branch gains amplifies rounding into
    its output."""
    arch = config["reference"]
    init = config.get("init", {})
    shapes = weight_shapes(arch)
    gen = generator(seed, f"weights:{arch}", device)
    kernels = [k for k, s in shapes.items() if len(s) == 4]
    norms = [k for k, s in shapes.items()
             if k.endswith(".weight") and len(s) == 1]
    total = sum(math.prod(shapes[k]) for k in kernels)
    flat = torch.randn(total, generator=gen, device=device)
    affine = torch.randn(2 * sum(shapes[k][0] for k in norms), generator=gen,
                         device=device) * 0.1
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for k in kernels:
        n = math.prod(shapes[k])
        out[k] = (flat[at:at + n].view(shapes[k])
                  / math.sqrt(math.prod(shapes[k][1:])))
        at += n
    at = 0
    for k in norms:
        c = shapes[k][0]
        out[k] = 1.0 + affine[at:at + c]
        out[k[:-len("weight")] + "bias"] = affine[at + c:at + 2 * c]
        at += 2 * c
    if init.get("residual_bn"):
        branch = re.compile(init["residual_bn"])
        for k in norms:
            if branch.search(k):
                out[k] = out[k] * init["residual_gamma"]
    for k, s in shapes.items():
        if k in out:
            continue
        out[k] = (torch.ones(s, device=device) if k.endswith("running_var")
                  else torch.zeros(s, device=device))
    return {k: out[k] for k in shapes}


# --- images -----------------------------------------------------------------

def synthetic_batch(gen: torch.Generator, b: int, h: int, w: int):
    """uint8 images (B, H, W, 3) whose bright ellipses are the mask, over
    a grey level gradient with noise, and float32 masks (B, H, W, 1) in
    {0, 1}, on the generator's device."""
    dev = gen.device
    u = torch.rand((b, 8), generator=gen, device=dev)
    yy = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :]
    cy = (0.25 + 0.5 * u[:, 0])[:, None, None] * h
    cx = (0.25 + 0.5 * u[:, 1])[:, None, None] * w
    ry = (0.1 + 0.2 * u[:, 2])[:, None, None] * h
    rx = (0.1 + 0.2 * u[:, 3])[:, None, None] * w
    masks = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0).float()
    base = (40.0 + 60.0 * u[:, 4])[:, None, None] + (
        30.0 * (u[:, 5] - 0.5))[:, None, None] * yy / h
    fg = (60.0 + 80.0 * u[:, 6])[:, None, None]
    imgs = (base + fg * masks)[..., None] + 20.0 * torch.randn(
        (b, h, w, 3), generator=gen, device=dev)
    imgs = imgs + (10.0 * (u[:, 7] - 0.5))[:, None, None, None]
    return imgs.clamp(0, 255).to(torch.uint8), masks[..., None]
