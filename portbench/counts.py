"""Work counts of a model at an image size, from the reference model's
layer shapes: each convolution's FLOPs and the elements it reads and
writes, each BatchNorm's elements.  The benchmark freezes them into the
configuration files (``python portbench/counts.py CONFIG [--write]``), so
that no change to the program moves the yardstick.

Conventions: a convolution's FLOPs are 2 · out elements · (in channels /
groups) · kh · kw per image (the logits head, a 1x1 convolution, counts
too); training is 3× the forward (forward, input gradient, weight
gradient; no recompute).  Bytes count each input read once and each output
written once, at the activation type's width (2 bytes: bfloat16), but the
logits head's 4 (the program runs it in float32).

    conv row: [flops, in_elems, out_elems, weight_elems, depthwise,
               input_gradient, bytes_per_elem]   (per image; weights once)
    bn:       [elems]                            (per image)
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.reference.models import RBN, RConv, Segmenter  # noqa: E402

ACT_BYTES = 2


def count(arch: str, h: int, w: int) -> Dict[str, object]:
    """The per-image counts of the reference ``arch`` at ``h`` × ``w``."""
    with torch.device("meta"):
        model = Segmenter(arch)
    return count_model(model, model.logits_conv, h, w)


def count_model(model: torch.nn.Module, head: Optional[RConv], h: int,
                w: int) -> Dict[str, object]:
    """The per-image counts of a model built of ``RConv`` and ``RBN``
    layers (``model(x, train=True)`` on NHWC input), by a training-mode
    forward on the meta device; ``head`` runs in float32.  The first
    convolution reads the image, whose gradient no step computes."""
    convs: List[list] = []
    bns: List[int] = []

    def on_conv(m, inputs, out):
        x = inputs[0]
        cin, k = m.weight.shape[1], m.weight.shape[2] * m.weight.shape[3]
        flops = 2 * out[0].numel() * cin * k
        convs.append([flops, x[0].numel(), out[0].numel(), m.weight.numel(),
                      int(m.groups > 1 and m.groups == x.shape[1]),
                      int(bool(convs)), 4 if m is head else ACT_BYTES])

    def on_bn(m, inputs, out):
        bns.append(inputs[0][0].numel())

    hooks = []
    for m in model.modules():
        if isinstance(m, RConv):
            hooks.append(m.register_forward_hook(on_conv))
        elif isinstance(m, RBN):
            hooks.append(m.register_forward_hook(on_bn))
    try:
        with torch.no_grad():
            model(torch.empty((1, h, w, 3), device="meta"), train=True)
    finally:
        for hk in hooks:
            hk.remove()
    fwd = sum(c[0] for c in convs)
    return {"conv": convs, "bn": bns, "forward_flops": fwd,
            "train_flops": 3 * fwd}


def size_key(h: int, w: int) -> str:
    return f"{h}x{w}"


def counts_for(config: dict, h: int, w: int) -> Dict[str, object]:
    """The frozen counts of a configuration file at ``h`` × ``w``; a size
    the file has not frozen is refused (``main`` freezes it)."""
    frozen = config.get("counts", {}).get(size_key(h, w))
    if frozen is None:
        raise KeyError(f"{config['name']}: no counts frozen at "
                       f"{size_key(h, w)}; run portbench/counts.py "
                       f"{config['name']} --sizes {size_key(h, w)} --write")
    return frozen


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config")
    p.add_argument("--sizes", default="", help="HxW,… (default: the sizes "
                   "of the configuration's cells)")
    p.add_argument("--write", action="store_true",
                   help="freeze the counts into the configuration file")
    a = p.parse_args()
    here = Path(__file__).resolve().parent
    path = here / "configs" / f"{a.config}.json"
    cfg = json.loads(path.read_text())
    sizes = [tuple(int(v) for v in s.split("x")) for s in
             (a.sizes.split(",") if a.sizes else cfg.get("counts", {}))]
    counts = {size_key(h, w): count(cfg["reference"], h, w)
              for h, w in sizes}
    for k, c in counts.items():
        print(k, "forward GFLOP/img", c["forward_flops"] / 1e9,
              "convs", len(c["conv"]), "bn", len(c["bn"]))
    if a.write:
        cfg["counts"] = {**cfg.get("counts", {}), **counts}
        text = json.dumps(cfg, indent=1)
        # one row of numbers a line
        path.write_text(text + "\n")


if __name__ == "__main__":
    main()
