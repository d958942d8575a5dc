"""The filter augmenters of the port (blurs, the 3×3 kernels, MotionBlur,
the poolings, the medians, BilateralBlur, JpegCompression, Canny,
MeanShiftBlur and Cartoon) against the JAX lowering on the same draws
(made with jax.random along the reference's key splits:
tests/torch_port_util.py:_jax_photo_draw), and their parsing and
refusals against the JAX config's and lowering's.

Each name runs in its scalar, list and dict forms (the poolings and
MedianBlur take no list: the reference refuses one) at 40×48, B3, on
uint8 images with discs, a gradient and noise; JpegCompression, Canny,
MeanShiftBlur (its default radius 5: 121 taps) and Cartoon also at 128².
The JAX side runs every case of a shape in one jitted function
(``jax_outputs``, module-scoped).

Tolerances:
  * images within 1e-3 on the 0..255 scale (the convolutions sum their
    taps in another order than XLA), masks exactly equal and untouched;
  * JpegCompression: exactly equal, except a value whose decoded value
    (before the final rounding) sits within 1e-3 of a .5 rounding tie,
    which may differ by one gray level (one such value at 128²: the port
    decodes 105.5 exactly and rounds it to even, the reference's 105.4999…
    rounds down); at most 1e-4 of the values;
  * Canny: the edge map is binary and a flipped pixel moves the output by
    up to 255·alpha, so pixels off by more than 1e-3 are held as a share
    (at most 1e-3 of the pixels), each within ``hysteresis_iters`` pixels
    of a witnessed tie (a float64 recompute of the gradient puts the
    magnitude within 1e-4 of a threshold or of an NMS neighbour, or the
    angle within 1e-4 of a sector boundary); every other value within
    1e-3.  No pixel differs on these inputs today.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from segmentation_training_pipeline_tpu import config as JC
from segmentation_training_pipeline_tpu.ops.aug import lowering as JL
from segmentation_training_pipeline_tpu_torch import config as TC
from segmentation_training_pipeline_tpu_torch.ops.aug import lowering as TL
from segmentation_training_pipeline_tpu_torch.ops.aug import (
    photometric as TP)

from torch_port_util import few_torch_threads, jax_draws  # noqa: F401

ATOL = 1e-3
B = 3
SEED = 3

# name → its forms: (id, args)
FORMS = {
    "AverageBlur": [("scalar", 3), ("list", [1, 7]), ("dict", {"k": [3, 5]})],
    "GaussianBlur": [("scalar", 1.0), ("list", [0, 3]),
                     ("dict", {"sigma": [0.5, 2.0]})],
    "Sharpen": [("scalar", 0.5), ("list", [0, 1]),
                ("dict", {"alpha": [0.2, 0.8], "lightness": [0.8, 1.2]})],
    "Emboss": [("scalar", 0.5), ("list", [0, 1]),
               ("dict", {"alpha": [0.2, 0.8], "strength": [0.8, 1.2]})],
    "EdgeDetect": [("scalar", 0.5), ("list", [0, 1]),
                   ("dict", {"alpha": [0.2, 0.6]})],
    "DirectedEdgeDetect": [("scalar", 0.7), ("list", [0, 1]),
                           ("dict", {"alpha": [0.3, 1.0],
                                     "direction": [0.1, 0.6]})],
    "MotionBlur": [("scalar", 5), ("list", [3, 9]),
                   ("dict", {"k": [3, 7], "angle": [-45, 45]})],
    "AveragePooling": [("scalar", 2), ("dict", {"k": 3, "keep_size": True})],
    "MaxPooling": [("scalar", 3), ("dict", {"k": 2})],
    "MinPooling": [("scalar", 2), ("dict", {"k": 4})],
    "MedianPooling": [("scalar", 2), ("dict", {"k": 3})],
    # a bare MedianBlur is k 3 (the 19-comparator network); 5 sorts
    "MedianBlur": [("bare", None), ("scalar", 5), ("dict", {"k": 3})],
    "BilateralBlur": [("scalar", 3), ("list", [3, 7]),
                      ("dict", {"d": 5, "sigma_color": [10, 100],
                                "sigma_space": [10, 100]})],
    "JpegCompression": [("scalar", 50), ("list", [0, 100]),
                        ("dict", {"compression": [70, 99]})],
    "Canny": [("scalar", 0.8), ("list", [0.2, 0.9]),
              ("dict", {"alpha": 1.0,
                        "hysteresis_thresholds": [[40, 80], [100, 160]],
                        "sobel_kernel_size": 5, "hysteresis_iters": 4})],
    "MeanShiftBlur": [("scalar", 2), ("list", [1, 3]),
                      ("dict", {"spatial_radius": 2,
                                "color_radius": [10, 30]})],
    # a scalar or list is all defaults; the dict's even median widens to 5
    "Cartoon": [("scalar", 1.0),
                ("dict", {"blur_ksize": 4, "segmentation_size": [0.5, 1.0],
                          "saturation": [1.0, 2.0],
                          "edge_prevalence": [0.8, 1.2]})],
}
BIG = [("JpegCompression-big", {"JpegCompression": {"compression": [70, 99]}}),
       ("Canny-big", {"Canny": None}),
       ("MeanShiftBlur-big", {"MeanShiftBlur": None}),
       ("Cartoon-big", {"Cartoon": {"blur_ksize": 3}})]

CASES = [(f"{n}-{f}", {n: a}) for n, forms in FORMS.items() for f, a in forms]
RUNS = [(c, s, (40, 48)) for c, s in CASES] + [
    (c, s, (128, 128)) for c, s in BIG]


def filter_batch(b, h, w, seed=0):
    """uint8 images: a gradient, two discs of another colour (edges for
    Canny, regions for the mean shift) and noise; one-channel disc
    masks."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    imgs = np.empty((b, h, w, 3), np.float64)
    masks = np.zeros((b, h, w, 1), np.float32)
    for i in range(b):
        base = r.uniform(30, 120, 3)
        imgs[i] = base + 80.0 * (0.6 * yy + 0.4 * xx)[..., None]
        for _ in range(2):
            cy, cx, rad = r.uniform(0.2, 0.8), r.uniform(0.2, 0.8), \
                r.uniform(0.1, 0.25)
            disc = (yy - cy) ** 2 + (xx - cx) ** 2 < rad ** 2
            imgs[i][disc] = r.uniform(60, 250, 3)
            masks[i][disc] = 1.0
        imgs[i] += r.normal(0, 6, (h, w, 3))
    return np.clip(imgs, 0, 255).astype(np.uint8), masks


@pytest.fixture(scope="module")
def jax_outputs():
    """The JAX lowering's images and masks of every case at one shape,
    from one jitted function per shape, shared by the module."""
    cache = {}

    def get(hw):
        if hw not in cache:
            cases = [(c, s) for c, s, at in RUNS if at == hw]
            fns = [JL.build_augmentation(JL._coerce_block(spec))
                   for _, spec in cases]

            def run_all(key, imgs, masks):
                return [fn(key, imgs, masks) for fn in fns]

            imgs, masks = filter_batch(B, *hw, SEED)
            outs = jax.jit(run_all)(jax.random.PRNGKey(SEED),
                                    jnp.asarray(imgs), jnp.asarray(masks))
            cache[hw] = {case: (np.asarray(i), np.asarray(m))
                         for (case, _), (i, m) in zip(cases, outs)}
        return cache[hw]

    return get


def _reflect(x, r):
    return np.pad(x, ((0, 0), (r, r), (r, r)), mode="reflect")


def _canny_ties(imgs, d, sobel_k, iters):
    """(B, H, W) bool: pixels within ``iters`` px of a witnessed tie of the
    Canny chain, recomputed in float64 from the input."""
    x = imgs.astype(np.float64)
    lum = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    d1, sm = (np.array(v) for v in TP._SOBEL[sobel_k])
    r = sobel_k // 2
    pad = _reflect(lum, r)
    h, w = lum.shape[1:]

    def corr(k2):
        return sum(k2[i, j] * pad[:, i:i + h, j:j + w]
                   for i in range(sobel_k) for j in range(sobel_k))

    gx, gy = corr(np.outer(sm, d1)), corr(np.outer(d1, sm))
    mag = np.abs(gx) + np.abs(gy)
    q = np.arctan2(gy, gx) / (math.pi / 4.0)
    tie = np.abs(q - np.floor(q) - 0.5) < 1e-4
    lo = np.minimum(d["lo"], d["hi"]).numpy().astype(np.float64)
    hi = np.maximum(d["lo"], d["hi"]).numpy().astype(np.float64)
    for t in (lo, hi):
        tie |= np.abs(mag - t[:, None, None]) < 1e-4 * (1.0 + mag)
    pm = np.pad(mag, ((0, 0), (1, 1), (1, 1)))
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                nb = pm[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                tie |= np.abs(mag - nb) < 1e-4 * (1.0 + mag)
    for _ in range(iters):
        p = np.pad(tie, ((0, 0), (1, 1), (1, 1)))
        tie = np.any([p[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                      for dy in (-1, 0, 1) for dx in (-1, 0, 1)], axis=0)
    return tie


def _hold_canny(aug, draws, imgs, ti, ji):
    seg = aug.segments[0]
    off = np.abs(ti - ji).max(-1) > ATOL                       # (B, H, W)
    assert off.mean() <= 1e-3, off.mean()
    if off.any():
        sobel_k, iters = seg.static
        assert not (off & ~_canny_ties(imgs, draws[0], sobel_k,
                                       iters)).any()
    np.testing.assert_allclose(ti[~off], ji[~off], atol=ATOL, rtol=0)


def _hold_jpeg(draws, imgs, ti, ji):
    off = ti != ji
    assert off.mean() <= 1e-4, off.mean()
    if off.any():
        dec = TP.jpeg_decoded(torch.from_numpy(imgs).float(),
                              100.0 - draws[0]["compression"]).numpy()
        assert np.all(np.abs(ti - ji)[off] == 1.0)
        frac = dec[off] - np.floor(dec[off])
        assert np.all(np.abs(frac - 0.5) < 1e-3), dec[off]


@pytest.mark.parametrize("case,spec,hw", RUNS,
                         ids=[f"{c}-{h}x{w}" for c, _, (h, w) in RUNS])
def test_each_filter_matches_jax(case, spec, hw, jax_outputs):
    ji, jm = jax_outputs(hw)[case]
    imgs, masks = filter_batch(B, *hw, SEED)
    aug = TL.build_augmentation(spec)
    draws = jax_draws(aug, jax.random.PRNGKey(SEED), B, *hw)
    ti, tm = aug.apply(draws, torch.from_numpy(imgs),
                       torch.from_numpy(masks))
    ti, tm = ti.numpy(), tm.numpy()
    assert ti.dtype == np.float32 and ti.shape == ji.shape == imgs.shape
    name = next(iter(spec)).lower()
    if name == "jpegcompression":
        _hold_jpeg(draws, imgs, ti, ji)
    elif name == "canny":
        _hold_canny(aug, draws, imgs, ti, ji)
    else:
        np.testing.assert_allclose(ti, ji, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tm, masks)
    assert not np.array_equal(ti, imgs.astype(np.float32)), case


def test_ports_draws_have_the_reference_entries():
    """The port's own sampler (a torch.Generator, as the train step
    draws) gives every name the entries, shapes and kinds of the
    reference's draws."""
    for case, spec in CASES + BIG:
        aug = TL.build_augmentation(spec)
        port = aug.sample(torch.Generator().manual_seed(1), B, 8, 8, 3)
        ref = jax_draws(aug, jax.random.PRNGKey(1), B, 8, 8)
        assert len(port) == len(ref) == 1, case
        assert set(port[0]) == set(ref[0]), case
        for k, v in ref[0].items():
            assert tuple(port[0][k].shape) == tuple(v.shape), (case, k)


STATICS = {
    "averageblur-range": ({"AverageBlur": {"k": [1, 7]}}, 3),
    "averageblur-cap": ({"AverageBlur": 200}, 64),
    "averageblur-unreadable": ({"AverageBlur": {"k": "x"}}, 3),
    "gaussianblur-bare": ({"GaussianBlur": None}, 8),
    "gaussianblur-floor": ({"GaussianBlur": 0.5}, 3),
    "motionblur-bare": ({"MotionBlur": None}, 2),
    "motionblur-range": ({"MotionBlur": {"k": [3, 15]}}, 7),
    "bilateralblur-9": ({"BilateralBlur": 9}, 4),
    "bilateralblur-cap": ({"BilateralBlur": {"d": [3, 30]}}, 5),
    "bilateralblur-1": ({"BilateralBlur": 1}, 0),
    "meanshiftblur-range": ({"MeanShiftBlur": {"spatial_radius": [1, 3]}},
                            3),
    "meanshiftblur-cap": ({"MeanShiftBlur": None}, 5),
    "medianblur-bare": ({"MedianBlur": None}, 3),
    "medianpooling-float": ({"MedianPooling": {"k": 4.0}}, 4),
    "canny": ({"Canny": {"sobel_kernel_size": 7, "hysteresis_iters": 2}},
              (7, 2)),
    "cartoon": ({"Cartoon": {"blur_ksize": 4}}, 4),
}


@pytest.mark.parametrize("spec,statics", list(STATICS.values()),
                         ids=list(STATICS))
def test_static_windows_follow_the_reference(spec, statics):
    """The windows fixed when the block is built, from the spec's largest
    value as the reference's lowering takes them (capped: a blur radius at
    64, the bilateral and mean-shift windows at 5; an unreadable spec
    falls back to the reference's default)."""
    assert TL.build_augmentation(spec).segments[0].static == statics


# the reference lowering's ValueErrors for static windows (its config lets
# a bare scalar or list through; the lowering refuses it when traced)
LOWERING_REFUSALS = {
    "averagepooling-list": {"AveragePooling": [2, 3]},
    "maxpooling-bare": {"MaxPooling": None},
    "minpooling-float": {"MinPooling": 2.5},
    "averagepooling-bool": {"AveragePooling": True},
    "medianpooling-list": {"MedianPooling": [2, 4]},
    "medianpooling-zero": {"MedianPooling": {"k": 0}},
    "medianblur-even": {"MedianBlur": 4},
    "medianblur-list": {"MedianBlur": [3, 5]},
    "medianblur-inf": {"MedianBlur": float("inf")},
    "medianblur-bool": {"MedianBlur": {"k": True}},
}


@pytest.mark.parametrize("spec", list(LOWERING_REFUSALS.values()),
                         ids=list(LOWERING_REFUSALS))
def test_lowering_refusals_match_jax(spec):
    """The reference raises when its block is traced, the port when it is
    built: the same ValueError text."""
    imgs, masks = filter_batch(1, 16, 16)
    with pytest.raises(ValueError) as j:
        JL.build_augmentation(JL._coerce_block(spec))(
            jax.random.PRNGKey(0), jnp.asarray(imgs), jnp.asarray(masks))
    with pytest.raises(ValueError) as t:
        TL.build_augmentation(spec)
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("spec", [
    {"Canny": {"sobel_kernel_size": 4}},
    {"Canny": {"hysteresis_iters": 0}},
    {"Cartoon": {"blur_ksize": 2.5}},
], ids=["canny-sobel", "canny-iters", "cartoon-blur"])
def test_static_argument_refusals_match_the_jax_lowering(spec):
    """Canny's and Cartoon's static arguments, refused by the reference's
    lowering when a block skips its config (its config refuses them
    first: tests/test_torch_port_guards.py VALUE_CHECKS)."""
    imgs, masks = filter_batch(1, 16, 16)
    with pytest.raises(ValueError) as j:
        JL.build_augmentation(JL._coerce_block(spec))(
            jax.random.PRNGKey(0), jnp.asarray(imgs), jnp.asarray(masks))
    with pytest.raises(ValueError) as t:
        TL.build_augmentation(spec)
    assert str(t.value) == str(j.value)


SCHEMA_REFUSALS = {
    "motionblur-direction": {"MotionBlur": {"k": 5, "direction": 0.5}},
    "motionblur-order": {"MotionBlur": {"order": 1}},
    "canny-colorizer": {"Canny": {"colorizer": "x"}},
    "cartoon-from": {"Cartoon": {"from_colorspace": "RGB"}},
    "meanshift-old-name": {"MeanShiftBlur": {"spatial_window_radius": 5}},
    "gaussianblur-typo": {"GaussianBlur": {"sigm": 1.0}},
    "bilateral-typo": {"BilateralBlur": {"sigma_colour": 50}},
    "jpeg-quality": {"JpegCompression": {"quality": 50}},
    "emboss-typo": {"Emboss": {"alpha": 0.5, "strenght": 1.0}},
    "child-sharpen-typo": {"SomeOf": {"n": 1, "children": [
        {"Sharpen": {"lightnes": 1.0}}]}},
}


@pytest.mark.parametrize("block", list(SCHEMA_REFUSALS.values()),
                         ids=list(SCHEMA_REFUSALS))
def test_schema_refusals_match_jax(block):
    with pytest.raises(JC.ConfigError) as j:
        JC.parse_dict({"augmentation": block})
    with pytest.raises(TC.ConfigError) as t:
        TC.parse_dict({"augmentation": block})
    assert str(t.value) == str(j.value)


def test_filter_blocks_normalise_as_jax():
    block = [{"GaussianBlur": [0, 2]}, {"MedianBlur": None},
             {"OneOf": [{"MotionBlur": {"k": [3, 7]}}, {"Sharpen": 0.3},
                        {"JpegCompression": [50, 90]}]},
             {"Sometimes": {"p": 0.3, "then": [{"Canny": {"alpha": 0.2}},
                                                {"MaxPooling": 2}]}},
             {"WithChannels": {"channels": [0], "children": [
                 {"AverageBlur": 3}]}}]
    d = {"augmentation": block}
    assert TC.parse_dict(d).to_dict() == JC.parse_dict(d).to_dict()


def test_tap_loops_never_stack_the_taps():
    """MeanShiftBlur and BilateralBlur at radius 5 (121 taps) and a 7×7
    MedianBlur hold no tensor larger than a few images' worth: no stack
    of 121 (or 49 per image) copies of the frame, seen by every PyTorch
    operation's output at 32² B2."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Biggest(TorchDispatchMode):
        most = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else [out]):
                if isinstance(t, torch.Tensor):
                    Biggest.most = max(Biggest.most, t.numel())
            return out

    x = torch.from_numpy(filter_batch(2, 32, 32)[0]).float()
    two = torch.tensor([5.0, 5.0])
    with Biggest():
        TP.mean_shift_blur(x, two, torch.tensor([20.0, 40.0]), 5)
        TP.bilateral_blur(x, torch.tensor([11.0, 11.0]), two * 10, two * 10,
                          5)
    assert 0 < Biggest.most <= 2 * x.numel()
    old, TP._SORT_BYTES = TP._SORT_BYTES, 32 * 32 * 3 * 4 * 49
    try:
        Biggest.most = 0
        with Biggest():
            out = TP.median_blur(x, 7)
        assert Biggest.most <= 49 * x[:1].numel()     # one image at a time
        want = torch.sort(torch.stack([
            TP._pad(TP._pad(x, 1, 3, "edge"), 2, 3, "edge")[
                :, dy:dy + 32, dx:dx + 32] for dy in range(7)
            for dx in range(7)], -1), -1).values[..., 24]
        assert torch.equal(out, want)
    finally:
        TP._SORT_BYTES = old
