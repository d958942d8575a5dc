"""Segment colour augmenters: Superpixels, the Voronoi family and
KMeansColorQuantization.

Counterpart of ``segmentation_training_pipeline_tpu/ops/aug/segment.py``,
with the reference's shape discipline: every sampler has a static seed
capacity P from its spec's maximum, and the per-image counts mask the
surplus slots invalid, so a step's shapes and launches do not depend on
the draws.  Pixels go to their nearest valid seed by an argmin over
``|p|² − 2 p·sᵀ + |s|²`` (the cross term a batched matmul) in chunks of
128 seeds, and segment means are one-hot matmuls.  Both products run in
full float32 (``fast_warp._exact_f32``): squared distances reach ~65k, and
a product rounded to TF32 would flip near-tie argmins and recolour whole
cells; a one-hot product in TF32 would round the pixel values it sums.
(cuBLAS's float32 matmuls are full precision by default; the caller's
setting is pinned here all the same.)

The segment maps are computed at the ``max_size`` downscale (imgaug's
default 128, an antialiased bilinear shrink), nearest-upsampled, and
composited at full resolution: unreplaced pixels keep their values.

Every random value is an argument (seed positions, the drop and replace
uniforms, k-means' first index and its Gumbel fields), batch first.
Masks are untouched; images are float32 on 0..255.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ...models.layers import resize_to
from .fast_warp import _exact_f32
from .photometric import nearest_nhwc

Tensor = torch.Tensor

_SEED_CHUNK = 128   # seed-block size of the chunked argmin and the means
_PIXEL_CHUNK = 65536  # pixel-block size of k-means' full-resolution map


def downscaled_size(h: int, w: int, max_size: Optional[int]
                    ) -> Tuple[int, int]:
    """The (hs, ws) that ``max_size`` shrinks an H×W frame to (unchanged
    when it fits, or for ``None``)."""
    if max_size is None or max(h, w) <= int(max_size):
        return h, w
    f = float(max_size) / float(max(h, w))
    return max(2, int(round(h * f))), max(2, int(round(w * f)))


def _downscale(images: Tensor, max_size: Optional[int]) -> Tensor:
    """imgaug's ``max_size`` downscale: an antialiased bilinear shrink
    (``jax.image.resize`` "linear"), its weight products in full f32."""
    hs, ws = downscaled_size(images.shape[1], images.shape[2], max_size)
    if (hs, ws) == tuple(images.shape[1:3]):
        return images
    with _exact_f32(images.device):
        return resize_to(images.permute(0, 3, 1, 2), hs, ws,
                         "bilinear").permute(0, 2, 3, 1)


def _coords(hs: int, ws: int, device) -> Tensor:
    """(hs·ws, 2) pixel (y, x) coordinates, float32."""
    yy, xx = torch.meshgrid(torch.arange(hs, dtype=torch.float32,
                                         device=device),
                            torch.arange(ws, dtype=torch.float32,
                                         device=device), indexing="ij")
    return torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)


def chunked_argmin(feats: Tensor, seeds: Tensor, valid: Tensor) -> Tensor:
    """Nearest valid seed of each pixel: feats (B, N, F), seeds (B, P, F),
    valid (B, P) → (B, N) int64.  Seeds in chunks of 128, so that one
    (B, N, 128) distance block is live at a time; a later chunk wins only
    a strictly smaller distance, and within a chunk the first minimum
    wins (the reference's order)."""
    b, n, _ = feats.shape
    fn2 = torch.sum(feats * feats, dim=-1)
    best_d = torch.full((b, n), float("inf"), device=feats.device)
    best_i = torch.zeros((b, n), dtype=torch.long, device=feats.device)
    for s in range(0, seeds.shape[1], _SEED_CHUNK):
        sc = seeds[:, s:s + _SEED_CHUNK]
        vc = valid[:, s:s + _SEED_CHUNK]
        with _exact_f32(feats.device):
            cross = torch.bmm(feats, sc.transpose(1, 2))
        d = (fn2[..., None] - 2.0 * cross
             + torch.sum(sc * sc, dim=-1)[:, None, :])
        d = torch.where(vc[:, None, :], d, float("inf"))
        dm, i = torch.min(d, dim=-1)
        upd = dm < best_d
        best_d = torch.where(upd, dm, best_d)
        best_i = torch.where(upd, i + s, best_i)
    return best_i


def segment_means(assign: Tensor, values: Tensor,
                  p: int) -> Tuple[Tensor, Tensor]:
    """Per-segment means by one-hot matmuls: assign (B, N) in [0, p),
    values (B, N, C) → (means (B, p, C), counts (B, p)); an empty segment
    has mean 0 and count 0."""
    sums, counts = [], []
    for s in range(0, p, _SEED_CHUNK):
        pc = min(_SEED_CHUNK, p - s)
        oh = (assign[..., None] == torch.arange(
            s, s + pc, device=assign.device)).float()        # (B, N, pc)
        with _exact_f32(values.device):
            sums.append(torch.bmm(oh.transpose(1, 2), values))
        counts.append(oh.sum(dim=1))
    sums, counts = torch.cat(sums, dim=1), torch.cat(counts, dim=1)
    return sums / torch.clamp(counts, min=1.0)[..., None], counts


def _composite_full_res(images: Tensor, cell_color: Tensor,
                        replace: Tensor) -> Tensor:
    """Nearest-upsample the downscaled (cell colour, replace) maps and
    composite at full resolution."""
    h, w = images.shape[1], images.shape[2]
    cell_up = nearest_nhwc(cell_color, h, w)
    rep_up = nearest_nhwc(replace.float(), h, w)
    return torch.where(rep_up > 0.5, cell_up, images)


def _gather_cells(table: Tensor, assign: Tensor) -> Tensor:
    """table (B, P, C) at assign (B, N) → (B, N, C)."""
    return torch.gather(table, 1, assign[..., None].expand(
        -1, -1, table.shape[-1]))


def _replace_cells(images: Tensor, small: Tensor, assign: Tensor,
                   means: Tensor, rep_cell: Tensor) -> Tensor:
    """Each pixel of a replaced cell takes its cell's mean colour."""
    b, hs, ws, c = small.shape
    cell_color = _gather_cells(means, assign).reshape(b, hs, ws, c)
    rep_px = torch.gather(rep_cell, 1, assign).reshape(b, hs, ws, 1)
    return _composite_full_res(images, cell_color, rep_px)


def _voronoi_apply(images: Tensor, seeds_yx: Tensor, valid: Tensor,
                   u_rep: Tensor, p_replace: Tensor,
                   max_size: Optional[int]) -> Tensor:
    """The Voronoi tail: pixels of the downscaled image to their nearest
    valid seed (``seeds_yx`` (B, P, 2) in downscaled pixels), each cell
    whose uniform ``u_rep`` (B, P) falls below ``p_replace`` (B,) replaced
    by its mean colour, composited at full resolution."""
    b, c = images.shape[0], images.shape[-1]
    small = _downscale(images, max_size)
    hs, ws = small.shape[1], small.shape[2]
    feats = _coords(hs, ws, images.device)[None].expand(b, hs * ws, 2)
    assign = chunked_argmin(feats, seeds_yx, valid)
    means, _ = segment_means(assign, small.reshape(b, hs * ws, c),
                             seeds_yx.shape[1])
    rep_cell = (u_rep < p_replace[:, None]) & valid
    return _replace_cells(images, small, assign, means, rep_cell)


def _ensure_one_valid(valid: Tensor) -> Tensor:
    """At least one valid seed an image (slot 0 when none is)."""
    none = ~valid.any(dim=1, keepdim=True)
    first = torch.arange(valid.shape[1], device=valid.device) == 0
    return valid | (none & first[None, :])


def regular_grid_voronoi(images: Tensor, rows: Tensor, cols: Tensor,
                         max_rows: int, max_cols: int, u_drop: Tensor,
                         u_rep: Tensor, p_drop: Tensor, p_replace: Tensor,
                         max_size: Optional[int]) -> Tensor:
    """imgaug RegularGridVoronoi: seeds on a per-image rows × cols grid
    over the downscaled image (slot p is cell (p // max_cols, p %
    max_cols); slots past the image's grid invalid), each dropped where
    its uniform ``u_drop`` (B, P) falls below ``p_drop`` (at least one
    kept)."""
    hs, ws = downscaled_size(images.shape[1], images.shape[2], max_size)
    idx = torch.arange(max_rows * max_cols, device=images.device)
    r = torch.div(idx, max_cols, rounding_mode="floor")[None].float()
    c = (idx % max_cols)[None].float()
    rows_f = torch.clamp(rows, min=1).float()[:, None]
    cols_f = torch.clamp(cols, min=1).float()[:, None]
    y = r * (hs - 1) / torch.clamp(rows_f - 1.0, min=1.0)
    x = c * (ws - 1) / torch.clamp(cols_f - 1.0, min=1.0)
    valid = (r < rows_f) & (c < cols_f) & (u_drop >= p_drop[:, None])
    return _voronoi_apply(images, torch.stack([y, x], dim=-1),
                          _ensure_one_valid(valid), u_rep, p_replace,
                          max_size)


def uniform_voronoi(images: Tensor, n_points: Tensor, pos: Tensor,
                    u_rep: Tensor, p_replace: Tensor,
                    max_size: Optional[int]) -> Tensor:
    """imgaug UniformVoronoi: ``n_points`` seeds at the uniform positions
    ``pos`` (B, P, 2) over the downscaled image; slots past the image's
    count invalid."""
    hs, ws = downscaled_size(images.shape[1], images.shape[2], max_size)
    seeds = pos * torch.tensor([hs - 1, ws - 1], dtype=torch.float32,
                               device=pos.device)
    valid = (torch.arange(pos.shape[1], device=pos.device)[None, :]
             < torch.clamp(n_points, min=1)[:, None])
    return _voronoi_apply(images, seeds, valid, u_rep, p_replace, max_size)


def superpixels(images: Tensor, n_segments: Tensor, max_segments: int,
                u_rep: Tensor, p_replace: Tensor, max_size: Optional[int],
                compactness: float = 10.0, iters: int = 5) -> Tensor:
    """imgaug Superpixels by fixed-round SLIC: ``iters`` Lloyd rounds of a
    global nearest-seed assignment in (RGB, compactness-scaled yx) space,
    ``d² = d_colour² + (m/S)²·d_yx²`` with S = sqrt(N/n), the seeds
    starting on a rows × cols ≈ n grid with the colour under them; then
    the segments whose uniform ``u_rep`` (B, P) falls below ``p_replace``
    take their mean colour (the reference's deviations from skimage:
    RGB, not Lab; no 2S window; fixed rounds)."""
    b, _, _, c = images.shape
    small = _downscale(images, max_size)
    hs, ws = small.shape[1], small.shape[2]
    n = hs * ws
    flat = small.reshape(b, n, c)
    dev = images.device
    nseg = torch.clamp(n_segments, 1, max_segments).float()
    cols = torch.clamp(torch.round(torch.sqrt(nseg * (ws / hs))), min=1.0)
    rows = torch.clamp(torch.floor(nseg / cols), min=1.0)
    p = max_segments
    idx = torch.arange(p, dtype=torch.float32, device=dev)[None, :]
    r = torch.floor(idx / cols[:, None])
    cgrid = idx - r * cols[:, None]
    y = torch.clamp((r + 0.5) * hs / rows[:, None], 0.0, hs - 1.0)
    x = torch.clamp((cgrid + 0.5) * ws / cols[:, None], 0.0, ws - 1.0)
    valid = idx < (rows * cols)[:, None]
    scale = (compactness
             / torch.sqrt(float(n) / torch.clamp(rows * cols, min=1.0)))
    scale = scale[:, None]
    flat_idx = (torch.round(y) * ws + torch.round(x)).long()
    seeds = torch.cat([_gather_cells(flat, flat_idx),
                       torch.stack([y, x], -1) * scale[..., None]], dim=-1)
    feats = torch.cat([flat, _coords(hs, ws, dev)[None].expand(b, n, 2)
                       * scale[:, :, None]], dim=-1)
    for _ in range(max(1, int(iters))):
        assign = chunked_argmin(feats, seeds, valid)
        means, counts = segment_means(assign, feats, p)
        seeds = torch.where((counts > 0.0)[..., None], means, seeds)
    assign = chunked_argmin(feats, seeds, valid)
    color_means, _ = segment_means(assign, flat, p)
    rep_cell = (u_rep < p_replace[:, None]) & valid
    return _replace_cells(images, small, assign, color_means, rep_cell)


def kmeans_color_quantization(images: Tensor, n_colors: Tensor,
                              max_colors: int, idx0: Tensor,
                              gumbels: Tensor, max_size: Optional[int],
                              iters: int = 8) -> Tensor:
    """imgaug KMeansColorQuantization: k-means of the downscaled image's
    colours, every full-resolution pixel snapped to its nearest centre.
    k-means++ seeding from the first index ``idx0`` (B, 1) and the Gumbel
    fields ``gumbels`` (B, K − 1, N), centre j at the argmax of
    log(d² + 1e-6) + g_j; then ``iters`` Lloyd rounds, an empty cluster
    keeping its centre.  Slots past the image's ``n_colors`` are
    invalid."""
    b, h, w, c = images.shape
    small = _downscale(images, max_size)
    n = small.shape[1] * small.shape[2]
    flat = small.reshape(b, n, c)
    kk = max_colors
    center = _gather_cells(flat, idx0.long())                    # (B, 1, C)
    centers: List[Tensor] = [center[:, 0]]
    best_d2 = torch.sum((flat - center) ** 2, dim=-1)
    for j in range(1, kk):
        pick = torch.argmax(torch.log(best_d2 + 1e-6) + gumbels[:, j - 1],
                            dim=-1)
        cj = _gather_cells(flat, pick[:, None])
        centers.append(cj[:, 0])
        best_d2 = torch.minimum(best_d2, torch.sum((flat - cj) ** 2, dim=-1))
    centers = torch.stack(centers, dim=1)                        # (B, K, C)
    valid = (torch.arange(kk, device=images.device)[None, :]
             < torch.clamp(n_colors, 2, kk)[:, None])
    for _ in range(max(1, int(iters))):
        assign = chunked_argmin(flat, centers, valid)
        means, counts = segment_means(assign, flat, kk)
        centers = torch.where(((counts > 0.0) & valid)[..., None], means,
                              centers)
    full = images.reshape(b, h * w, c)
    out = [_gather_cells(centers, chunked_argmin(
        full[:, s:s + _PIXEL_CHUNK], centers, valid))
        for s in range(0, h * w, _PIXEL_CHUNK)]
    return torch.cat(out, dim=1).reshape(b, h, w, c)
