"""imgaug Jigsaw: grid cells of the image and the mask shuffled by a chain
of adjacent-cell swaps.

Counterpart of ``segmentation_training_pipeline_tpu/ops/aug/jigsaw.py``.
``nb_rows``/``nb_cols`` are static; the chain runs the spec's static
maximum of steps, a step past the image's own count a no-op.  Each step
swaps a cell (a uniform draw) with its neighbour in one of four
directions (a uniform draw); a step that walks off the grid is a no-op.
The frame pads bottom/right to a cell multiple (images repeat their edge,
masks take 0), the cells move, the frame is cropped back: pure block
moves, so the masks stay exact.  The draws are arguments: ``cells`` and
``dirs`` (B, max_steps) integers.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# direction d moves (row, col) by (_DR[d], _DC[d]): up, down, left, right
_DR = (-1, 1, 0, 0)
_DC = (0, 0, -1, 1)


def swap_chain(cells: Tensor, dirs: Tensor, steps: Tensor, rows: int,
               cols: int) -> Tensor:
    """(B, rows·cols) cell permutation from the chain of swaps; step s is
    live where ``s < steps`` (B,)."""
    b, max_steps = cells.shape
    dev = cells.device
    cells, dirs = cells.long(), dirs.long()
    perm = torch.arange(rows * cols, device=dev).expand(b, -1).clone()
    dr = torch.tensor(_DR, device=dev)
    dc = torch.tensor(_DC, device=dev)
    for s in range(max_steps):
        cell, d = cells[:, s:s + 1], dirs[:, s:s + 1]
        r = torch.div(cell, cols, rounding_mode="floor")
        nr, nc = r + dr[d], cell % cols + dc[d]
        ok = ((nr >= 0) & (nr < rows) & (nc >= 0) & (nc < cols)
              & (s < steps[:, None]))
        nb = nr.clamp(0, rows - 1) * cols + nc.clamp(0, cols - 1)
        vc, vn = perm.gather(1, cell), perm.gather(1, nb)
        perm = perm.scatter(1, cell, torch.where(ok, vn, vc))
        perm = perm.scatter(1, nb, torch.where(ok, vc, vn))
    return perm


def permute_cells(x: Tensor, perm: Tensor, rows: int, cols: int,
                  edge: bool) -> Tensor:
    """Cell ``i`` of the output is cell ``perm[:, i]`` of ``x`` (B, H, W,
    C), the frame padded bottom/right to a cell multiple (the edge
    repeated, or 0) and cropped back."""
    b, h, w, c = x.shape
    hp = int(math.ceil(h / rows)) * rows
    wp = int(math.ceil(w / cols)) * cols
    if (hp, wp) != (h, w):
        if edge:
            x = x.index_select(1, torch.arange(hp, device=x.device).clamp(
                max=h - 1))
            x = x.index_select(2, torch.arange(wp, device=x.device).clamp(
                max=w - 1))
        else:
            x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
    ch, cw = hp // rows, wp // cols
    cells = (x.reshape(b, rows, ch, cols, cw, c).permute(0, 1, 3, 2, 4, 5)
             .reshape(b, rows * cols, ch, cw, c))
    cells = cells[torch.arange(b, device=x.device)[:, None], perm]
    out = (cells.reshape(b, rows, cols, ch, cw, c).permute(0, 1, 3, 2, 4, 5)
           .reshape(b, hp, wp, c))
    return out[:, :h, :w]


def jigsaw(images: Tensor, masks: Tensor, rows: int, cols: int,
           steps: Tensor, cells: Tensor, dirs: Tensor
           ) -> Tuple[Tensor, Tensor]:
    """The image and mask shuffled by one permutation."""
    perm = swap_chain(cells, dirs, steps, rows, cols)
    return (permute_cells(images, perm, rows, cols, edge=True),
            permute_cells(masks, perm, rows, cols, edge=False))
