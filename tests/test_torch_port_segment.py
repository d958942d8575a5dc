"""The segment colour augmenters (Superpixels, UniformVoronoi,
RegularGridVoronoi, RelativeRegularGridVoronoi, KMeansColorQuantization,
UniformColorQuantization) and Jigsaw of the port against the JAX
lowering on the same draws (the seed positions, the drop and replace
uniforms, k-means' first index and Gumbel fields, Jigsaw's cells and
directions: tests/torch_port_util.py:_jax_photo_draw).

Each name runs in its default and argument forms (a ``max_size`` that
downscales, ``max_size: null``) on uint8 noise images at 40×56 B3 and at
128² B2 (the default ``max_size`` 128 leaves it whole; 64 halves it),
every case of a shape in one jitted JAX function.

Tolerances:
  * Jigsaw: images and masks exactly equal (block moves);
  * one round of ``chunked_argmin`` and ``segment_means`` from the same
    state (random points; a pixel grid against a seed grid; Superpixels'
    first state on flat colour regions): the assignment equal to JAX's
    wherever JAX's two best distances differ by more than 1e-4 relative
    (the cross term sums in another order than XLA's CPU dot, and exact
    ties fall either way), the means within 1e-3;
  * the whole functions: one flipped tie recolours a pixel, moves its
    cells' means and, through later rounds, other cells' (on flat colour
    regions Superpixels' first round flips two pixels at a relative gap
    of 5e-7 and 6% of the values end off), so the share of image values
    off by more than 1e-3 is held at or under 1%: 0.0 measured on every
    case but RelativeRegularGridVoronoi's 29×40 seed grid, whose exact
    ties leave 3.3% (held at 5%, ``TIE_SHARE``);
    UniformColorQuantization within 1e-3; masks exactly equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from segmentation_training_pipeline_tpu import config as JC
from segmentation_training_pipeline_tpu.ops.aug import lowering as JL
from segmentation_training_pipeline_tpu.ops.aug import segment as JS
from segmentation_training_pipeline_tpu_torch import config as TC
from segmentation_training_pipeline_tpu_torch.ops.aug import lowering as TL
from segmentation_training_pipeline_tpu_torch.ops.aug import segment as TS

from torch_port_util import (blob_batch, few_torch_threads,  # noqa: F401
                             jax_draws)

ATOL = 1e-3
SHARE = 1e-2
# a seed grid on the downscaled pixel grid (29×40 here) puts whole rows
# and columns of pixels midway between two seeds: exact ties, which XLA
# and PyTorch break by their last float32 rounding (test_one_round's
# "grid" state); each flipped pixel also moves its two cells' means
TIE_SHARE = {"RelativeRegularGridVoronoi-dict-40x56": 0.05}
SEED = 9

FORMS = {
    "Superpixels": [("bare", None), ("scalar", 0.7),
                    ("dict", {"p_replace": [0.5, 1.0], "n_segments": [8, 40],
                              "max_size": 32})],
    "UniformVoronoi": [("list", [10, 60]),
                       ("dict", {"n_points": [20, 200], "p_replace": 1.0,
                                 "max_size": 32})],
    "RegularGridVoronoi": [("scalar", 6),
                           ("dict", {"n_rows": [3, 8], "n_cols": [2, 10],
                                     "p_drop_points": [0.0, 0.5],
                                     "p_replace": 0.9, "max_size": None})],
    "RelativeRegularGridVoronoi": [("bare", None),
                                   ("dict", {"n_rows_frac": [0.1, 0.3],
                                             "n_cols_frac": 0.2,
                                             "max_size": 40})],
    "KMeansColorQuantization": [("bare", None), ("scalar", 5),
                                ("dict", {"n_colors": [2, 12],
                                          "max_size": 24})],
    "UniformColorQuantization": [("list", [2, 16])],
    "Jigsaw": [("bare", None),
               ("dict", {"nb_rows": 3, "nb_cols": 7, "max_steps": [2, 9]})],
}
CASES = [(f"{n}-{f}", {n: a}) for n, forms in FORMS.items() for f, a in forms]
BIG = [("Superpixels-big", {"Superpixels": {"n_segments": [60, 120],
                                            "p_replace": [0.0, 0.3]}}),
       ("Superpixels-big-64", {"Superpixels": {"max_size": 64}}),
       ("UniformVoronoi-big-64", {"UniformVoronoi": {"max_size": 64}}),
       ("KMeansColorQuantization-big", {"KMeansColorQuantization": None}),
       ("Jigsaw-big", {"Jigsaw": {"nb_rows": 6, "nb_cols": 5}})]
RUNS = [(c, s, (40, 56), 3) for c, s in CASES] + [
    (c, s, (128, 128), 2) for c, s in BIG]


def region_batch(b, h, w, seed):
    """uint8 images of a few flat colour regions with noise (integer
    colours: distance ties), disc masks."""
    r = np.random.RandomState(seed)
    imgs, masks = blob_batch(b, h, w, seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.empty((b, h, w, 3))
    for i in range(b):
        region = ((yy * 3 // h) * 3 + (xx * 3 // w)) % 5
        out[i] = r.uniform(20, 235, (5, 3))[region] + r.normal(0, 8, (h, w, 3))
    return np.clip(out, 0, 255).astype(np.uint8), masks


@pytest.fixture(scope="module")
def jax_outputs():
    cache = {}

    def get(hw, b):
        if hw not in cache:
            cases = [(c, s) for c, s, at, _ in RUNS if at == hw]
            fns = [JL.build_augmentation(JL._coerce_block(s))
                   for _, s in cases]
            imgs, masks = blob_batch(b, *hw, SEED)
            outs = jax.jit(lambda k, i, m: [f(k, i, m) for f in fns])(
                jax.random.PRNGKey(SEED), jnp.asarray(imgs),
                jnp.asarray(masks))
            cache[hw] = {c: (np.asarray(i), np.asarray(m))
                         for (c, _), (i, m) in zip(cases, outs)}
        return cache[hw]

    return get


@pytest.mark.parametrize("case,spec,hw,b", RUNS,
                         ids=[f"{c}-{h}x{w}" for c, _, (h, w), _ in RUNS])
def test_each_segment_name_matches_jax(case, spec, hw, b, jax_outputs):
    ji, jm = jax_outputs(hw, b)[case]
    case = f"{case}-{hw[0]}x{hw[1]}"
    imgs, masks = blob_batch(b, *hw, SEED)
    aug = TL.build_augmentation(spec)
    draws = jax_draws(aug, jax.random.PRNGKey(SEED), b, *hw)
    ti, tm = aug.apply(draws, torch.from_numpy(imgs), torch.from_numpy(masks))
    ti, tm = ti.numpy(), tm.numpy()
    assert ti.dtype == np.float32 and ti.shape == ji.shape == imgs.shape
    if case.startswith("Jigsaw"):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tm, jm)
    elif case.startswith("UniformColor"):
        np.testing.assert_allclose(ti, ji, atol=ATOL, rtol=0)
    else:
        off = np.abs(ti - ji) > ATOL
        assert off.mean() <= TIE_SHARE.get(case, SHARE), off.mean()
        np.testing.assert_array_equal(tm, masks)
    np.testing.assert_array_equal(tm, jm)
    assert not np.array_equal(ti, imgs.astype(np.float32)), case


def _round_state(kind):
    """(feats (B, N, F), seeds (B, P, F), valid (B, P)) float32/bool:
    random points against 300 seeds (three chunks, a third invalid); the
    pixel grid of a 29×41 frame against a 3×5 seed grid (rows of pixels
    midway between two seed rows: exact ties); or Superpixels' first
    state on flat colour regions (integer colours: ties)."""
    r = np.random.RandomState(2)
    if kind == "random":
        feats = (r.rand(2, 900, 5) * 255).astype(np.float32)
        seeds = (r.rand(2, 300, 5) * 255).astype(np.float32)
        return feats, seeds, r.rand(2, 300) < 0.66
    if kind == "grid":
        hs, ws, rows, cols = 29, 41, 3, 5
        yy, xx = np.mgrid[0:hs, 0:ws].astype(np.float32)
        feats = np.stack([yy.ravel(), xx.ravel()], -1)[None]
        ry, cx = np.mgrid[0:rows, 0:cols].astype(np.float32)
        seeds = np.stack([(ry * (hs - 1) / (rows - 1)).ravel(),
                          (cx * (ws - 1) / (cols - 1)).ravel()], -1)[None]
        return feats, seeds, np.ones((1, rows * cols), bool)
    imgs, _ = region_batch(2, 40, 56, SEED)
    flat = imgs.reshape(2, -1, 3).astype(np.float32)
    idx = r.choice(flat.shape[1], 96, replace=False)
    yx = np.stack(np.unravel_index(idx, (40, 56)), -1).astype(np.float32)
    yy, xx = np.mgrid[0:40, 0:56].astype(np.float32)
    coords = np.stack([yy.ravel(), xx.ravel()], -1)
    feats = np.concatenate([flat, np.broadcast_to(coords * 2.0, (2,) +
                                                  coords.shape)], -1)
    seeds = np.concatenate([flat[:, idx], np.broadcast_to(yx * 2.0, (2, 96,
                                                                     2))], -1)
    return feats, seeds.astype(np.float32), np.ones((2, 96), bool)


@pytest.mark.parametrize("kind", ["random", "grid", "regions"])
def test_one_round_matches_jax(kind):
    """``chunked_argmin`` and ``segment_means`` from one state on both
    sides: the assignment equal wherever JAX's two best distances differ
    by more than 1e-4 relative; the means of JAX's assignment within
    1e-3, the counts equal."""
    feats, seeds, valid = _round_state(kind)
    p = seeds.shape[1]
    ja = np.asarray(JS._chunked_argmin(jnp.asarray(feats), jnp.asarray(seeds),
                                       jnp.asarray(valid)))
    ta = TS.chunked_argmin(torch.from_numpy(feats), torch.from_numpy(seeds),
                           torch.from_numpy(valid)).numpy()
    d = ((feats[:, :, None].astype(np.float64)
          - seeds[:, None].astype(np.float64)) ** 2).sum(-1)
    d[~np.broadcast_to(valid[:, None], d.shape)] = np.inf
    best2 = np.sort(d, axis=-1)[..., :2]
    clear = (best2[..., 1] - best2[..., 0]) > 1e-4 * best2[..., 1]
    np.testing.assert_array_equal(ta[clear], ja[clear])
    if kind == "grid":
        assert (~clear).mean() > 0.05      # rows and columns of exact ties
    jm, jc = JS._segment_means(jnp.asarray(ja), jnp.asarray(feats), p)
    tm, tc = TS.segment_means(torch.from_numpy(np.array(ja)).long(),
                              torch.from_numpy(feats), p)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("case,spec", CASES, ids=[c for c, _ in CASES])
def test_segment_names_parse_as_jax(case, spec):
    d = {"augmentation": spec}
    assert TC.parse_dict(d).to_dict() == JC.parse_dict(d).to_dict()


LOWERING_REFUSALS = {
    "jigsaw-max-steps-65": ({"Jigsaw": {"max_steps": [1, 65]}},
                            "max_steps caps at 64"),
    "superpixels-max-size-list": ({"Superpixels": {"max_size": [64, 128]}},
                                  "max_size must be a static integer"),
    "jigsaw-rows-list": ({"Jigsaw": {"nb_rows": [2, 4]}},
                         "nb_rows must be a static integer"),
}


@pytest.mark.parametrize("case", sorted(LOWERING_REFUSALS))
def test_lowering_refusals_match_jax(case):
    """What the reference's lowering refuses (past its parse, in
    ``build_augmentation``'s call), the port refuses when the block is
    built, with the same statement."""
    spec, match = LOWERING_REFUSALS[case]
    imgs, masks = blob_batch(1, 16, 16, 0)
    with pytest.raises(ValueError, match=match) as j:
        JL.build_augmentation(JL._coerce_block(spec))(
            jax.random.PRNGKey(0), jnp.asarray(imgs), jnp.asarray(masks))
    with pytest.raises(ValueError, match=match) as t:
        TL.build_augmentation(spec)
    assert str(t.value).split(" (")[0] == str(j.value).split(" (")[0]


def test_jigsaw_moves_masks_with_the_image():
    """A mask equal to the image's first channel stays equal to it after
    the swaps (the padding aside: the frame is a cell multiple here)."""
    imgs, _ = blob_batch(2, 30, 42, 1)
    masks = torch.from_numpy(imgs[..., :1].astype(np.float32))
    aug = TL.build_augmentation({"Jigsaw": {"nb_rows": 3, "nb_cols": 6,
                                            "max_steps": 8}})
    ti, tm = aug(torch.Generator().manual_seed(3), torch.from_numpy(imgs),
                 masks)
    assert torch.equal(ti[..., :1], tm)
    assert not torch.equal(tm, masks)
