"""The pixelwise photometric augmenters, Resize and the Affine sugar names of
the port against the JAX lowering, on the same draws (made with jax.random
along the reference's key schedule, including the values its photometric
functions draw inside: tests/torch_port_util.py:_jax_photo_draw).

Each name runs alone in its forms (bare ``Name:``, a scalar, a [lo, hi]
range, a list of choices, ``per_channel`` where its schema takes it), at
48×64 (the coarse grids then have non-integer cell sizes: 5×6 cells at
``size_percent`` 0.1) and B4, on uint8 images; the JAX side runs one
jitted function per case.

Tolerances: images within 1e-3 on the 0..255 scale (f32 ``pow``, ``exp``
and ``log2`` differ by ulps between the two libraries; everything else is
equal), masks exactly equal (and untouched, except by Resize).  The sugar
names go through the warp (kernels X and Y in interpret mode on the JAX
side): images within 1e-2 (the reference's warp dots), masks exact, the
route recorded on the JAX side and held.
"""

import copy
import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from segmentation_training_pipeline_tpu.ops.aug import lowering as JL
from segmentation_training_pipeline_tpu_torch import kernels as K
from segmentation_training_pipeline_tpu_torch.ops.aug import lowering as TL

from torch_port_util import (blob_batch, few_torch_threads,  # noqa: F401
                             interpret_kernels, jax_draws, port_warps,
                             record_jax_warps)

ATOL = 1e-3
WARP_ATOL = 1e-2
B, H, W = 4, 48, 64

# name → its forms: (id, args)
FORMS = {
    "Add": [("bare", None), ("scalar", 10), ("range", [-20, 20]),
            ("list", [-30, 0, 30]),
            ("pc", {"value": [-20, 20], "per_channel": True})],
    "AddElementwise": [("bare", None), ("scalar", 7), ("range", [-10, 10]),
                       ("list", [-5, 0, 5]),
                       ("pc", {"value": [-10, 10], "per_channel": True})],
    "MultiplyElementwise": [("bare", None), ("scalar", 1.1),
                            ("range", [0.8, 1.2]), ("list", [0.5, 1, 1.5]),
                            ("pc", {"mul": [0.8, 1.2], "per_channel": True})],
    "LinearContrast": [("bare", None), ("scalar", 1.3), ("range", [0.6, 1.4]),
                       ("list", [0.5, 1.0, 1.5]),
                       ("pc", {"alpha": [0.6, 1.4], "per_channel": True})],
    "ContrastNormalization": [("range", [0.5, 1.5])],
    "GammaContrast": [("bare", None), ("scalar", 1.5), ("range", [0.5, 2.0]),
                      ("list", [0.5, 1.0, 2.0]),
                      ("pc", {"gamma": [0.5, 2.0], "per_channel": True})],
    "SigmoidContrast": [("bare", None), ("scalar", 8),
                        ("range", {"gain": [5, 10], "cutoff": [0.3, 0.6]}),
                        ("list", {"gain": [4, 8, 12],
                                  "cutoff": [0.4, 0.5, 0.6]}),
                        ("pc", {"gain": [5, 10], "per_channel": True})],
    "LogContrast": [("bare", None), ("scalar", 0.8), ("range", [0.4, 1.6]),
                    ("list", [0.5, 1.0, 1.5]),
                    ("pc", {"gain": [0.4, 1.6], "per_channel": True})],
    "Invert": [("bare", None), ("scalar", 0.5), ("range", [0.2, 0.8]),
               ("list", [0.0, 1.0, 1.0]),
               ("pc", {"p": 0.5, "per_channel": True})],
    # a bare scalar is the probability; a list p is compared with a uniform
    "Solarize": [("bare", None), ("scalar", 0.75), ("range", [0.2, 0.8]),
                 ("threshold", {"p": 1.0, "threshold": [64, 192]}),
                 ("list", {"p": 0.9, "threshold": [32, 96, 160]})],
    # bare: the lowering's 4 bits; a dict without nb_bits: [1, 8]
    "Posterize": [("bare", None), ("scalar", 3), ("range", [2, 6]),
                  ("list", [1, 4, 8]), ("dict", {})],
    "AdditiveGaussianNoise": [("bare", None), ("scalar", 10),
                              ("range", [0, 15]), ("list", [5, 10, 20]),
                              ("pc", {"scale": [0, 15],
                                      "per_channel": True})],
    "AdditiveLaplaceNoise": [("bare", None), ("scalar", 10),
                             ("range", [0, 15]), ("list", [5, 10, 20]),
                             ("pc", {"scale": [0, 15], "per_channel": True})],
    "AdditivePoissonNoise": [("bare", None), ("scalar", 5), ("range", [0, 10]),
                             ("list", [2, 5, 8]),
                             ("pc", {"lam": [0, 10], "per_channel": True})],
    "ImpulseNoise": [("bare", None), ("scalar", 0.1), ("range", [0, 0.2]),
                     ("list", [0.05, 0.1, 0.2])],
    "Salt": [("bare", None), ("scalar", 0.1), ("range", [0, 0.2]),
             ("list", [0.05, 0.1, 0.2]),
             ("pc", {"p": 0.1, "per_channel": True})],
    "Pepper": [("bare", None), ("scalar", 0.1), ("range", [0, 0.2]),
               ("list", [0.05, 0.1, 0.2]),
               ("pc", {"p": 0.1, "per_channel": True})],
    "SaltAndPepper": [("bare", None), ("scalar", 0.1), ("range", [0, 0.2]),
                      ("list", [0.05, 0.1, 0.2]),
                      ("pc", {"p": 0.1, "per_channel": True})],
    "SaltPepper": [("scalar", 0.2)],
    "CoarseSaltAndPepper": [("bare", None), ("scalar", 0.2),
                            ("range", [0.1, 0.3]), ("list", [0.1, 0.2, 0.3]),
                            ("pc", {"p": 0.2, "size_percent": 0.1,
                                    "per_channel": True})],
    "CoarseSalt": [("bare", None), ("scalar", 0.2), ("range", [0.1, 0.3]),
                   ("list", [0.1, 0.2, 0.3]),
                   ("size", {"p": 0.3, "size_percent": 0.2})],
    "CoarsePepper": [("bare", None), ("scalar", 0.2), ("range", [0.1, 0.3]),
                     ("list", [0.1, 0.2, 0.3]),
                     ("size", {"p": 0.3, "size_percent": 0.05})],
    "Dropout": [("bare", None), ("scalar", 0.1), ("range", [0, 0.2]),
                ("list", [0.05, 0.1, 0.2]),
                ("pc", {"p": 0.1, "per_channel": True})],
    "Dropout2d": [("bare", None), ("scalar", 0.5), ("range", [0.2, 0.8]),
                  ("list", [0.3, 0.6, 0.9]),
                  ("keep", {"p": 0.9, "nb_keep_channels": 2})],
    "ChannelDropout": [("scalar", 0.7)],
    "TotalDropout": [("bare", None), ("scalar", 0.5), ("range", [0.2, 0.8]),
                     ("list", [0.3, 0.6, 0.9])],
    "CoarseDropout": [("bare", None), ("scalar", 0.3), ("range", [0.1, 0.5]),
                      ("list", [0.1, 0.3, 0.5]),
                      ("pc", {"p": 0.3, "size_percent": 0.1,
                              "per_channel": True})],
    "Cutout": [("bare", None), ("scalar", 2), ("range", [1, 3]),
               ("list", [1, 2, 4]),
               ("dict", {"nb_iterations": [1, 3], "size": 0.15,
                         "cval": [0, 255], "squared": True})],
    "ReplaceElementwise": [("bare", None), ("scalar", 0.1),
                           ("range", {"mask": [0, 0.2],
                                      "replacement": [0, 255]}),
                           ("list", {"mask": [0.05, 0.1, 0.2],
                                     "replacement": [0, 128, 255]}),
                           ("pc", {"mask": 0.1, "per_channel": True})],
    "ChannelShuffle": [("bare", None), ("scalar", 0.5), ("range", [0.2, 0.8]),
                       ("list", [0.0, 1.0, 1.0])],
    "Noop": [("bare", None)],
    "Identity": [("bare", None)],
    # a float is a factor, an int absolute pixels
    "Resize": [("float", 0.75), ("int", 20), ("size", {"size": 0.5}),
               ("percent", {"percent": 1.5})],
    "Scale": [("float", 0.6)],
}
CASES = [(name, form, args) for name, forms in FORMS.items()
         for form, args in forms]
# cases whose draws may leave every image of the batch as it was
MAY_KEEP = {("Noop", "bare"), ("Identity", "bare")}


def _run_both(spec, b, h, w, seed):
    imgs, masks = blob_batch(b, h, w, seed)
    key = jax.random.PRNGKey(seed)
    fn = jax.jit(JL.build_augmentation(JL._coerce_block(spec)))
    ji, jm = fn(key, jnp.asarray(imgs), jnp.asarray(masks))
    aug = TL.build_augmentation(spec)
    ti, tm = aug.apply(jax_draws(aug, key, b, h, w), torch.from_numpy(imgs),
                       torch.from_numpy(masks))
    return imgs, masks, np.asarray(ji), np.asarray(jm), ti.numpy(), tm.numpy()


@pytest.mark.parametrize("name,form,args", CASES,
                         ids=[f"{n}-{f}" for n, f, _ in CASES])
def test_each_name_matches_jax(name, form, args):
    imgs, masks, ji, jm, ti, tm = _run_both({name: args}, B, H, W, 3)
    assert ti.dtype == np.float32 and ti.shape == ji.shape == imgs.shape
    np.testing.assert_allclose(ti, ji, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tm, jm)
    if name not in ("Resize", "Scale"):
        np.testing.assert_array_equal(tm, masks)
    if (name, form) not in MAY_KEEP:
        assert not np.array_equal(ti, imgs.astype(np.float32)), (name, form)


@pytest.mark.parametrize("spec", [{"Resize": 0.75}, {"Resize": 20},
                                  {"Scale": {"size": 0.3}}],
                         ids=["float", "int", "scale-alias"])
def test_resize_moves_masks_as_jax(spec):
    """Resize's masks go down and back with nearest (half-pixel centres,
    ``jax.image.resize``): at 48×64 a 0.75 factor gives 36×48, 20 px
    20×20, 0.3 14×19; the disc edges move, equal on both sides."""
    imgs, masks, ji, jm, ti, tm = _run_both(spec, B, H, W, 5)
    np.testing.assert_array_equal(tm, jm)
    assert not np.array_equal(tm, masks)
    np.testing.assert_allclose(ti, ji, atol=ATOL, rtol=0)


@pytest.mark.parametrize("args,match", [
    ([0.5, 1.0], "static scalar"),
    (True, "static scalar"),
    (0, "absolute pixels"),
    (-0.5, "must be > 0"),
    ({"percent": [0.5, 0.9]}, "static scalar"),
], ids=["range", "bool", "zero-px", "negative", "percent-range"])
def test_resize_refusals_match_jax(args, match):
    """The reference raises when its block is traced, the port when it is
    built: the same ValueError."""
    imgs, masks = blob_batch(1, 16, 16)
    with pytest.raises(ValueError, match=match):
        JL.build_augmentation(JL._coerce_block({"Resize": args}))(
            jax.random.PRNGKey(0), jnp.asarray(imgs), jnp.asarray(masks))
    with pytest.raises(ValueError, match=match):
        TL.build_augmentation({"Resize": args})


SUGAR = [
    ("Rotate", None), ("Rotate", 20), ("Rotate", [-15, 15]),
    ("Rotate", {"rotate": [-10, 10], "cval": 128}),
    ("Rotate", {"value": [-5, 5]}),
    ("TranslateX", None), ("TranslateX", [-0.1, 0.1]),
    ("TranslateX", {"px": [-5, 5]}), ("TranslateY", {"percent": 0.1}),
    ("TranslateY", [-0.2, 0.2]),
    ("ScaleX", None), ("ScaleX", [0.8, 1.2]),
    ("ScaleY", {"scale": [1.05, 1.15]}),
    ("ScaleY", {"value": [0.9, 1.1]}),
    ("ShearX", None), ("ShearX", [-10, 10]), ("ShearY", {"shear": 5}),
    ("ShearY", {"value": [-8, 8]}),
]


@pytest.mark.parametrize("name,args", SUGAR,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(SUGAR)])
def test_sugar_names_are_the_jax_affine(name, args, monkeypatch):
    """Each sugar name becomes the Affine the reference rewrites it into,
    fuses into the geometric run (with a flip beside it) and takes the
    reference's warp."""
    entry = [{"name": name, "args": copy.deepcopy(args)}]
    want = JL._coerce_block(copy.deepcopy(entry))
    assert TL._coerce_block(entry) == want
    assert want[0]["name"] == "Affine"
    assert entry == [{"name": name, "args": args}]     # left as it was
    spec = [{"Fliplr": 0.5}, {name: args}]
    interpret_kernels(monkeypatch)
    ran = record_jax_warps(monkeypatch)
    imgs, masks = blob_batch(B, 64, 64, 2)
    key = jax.random.PRNGKey(2)
    ji, jm = JL.build_augmentation(JL._coerce_block(spec))(
        key, jnp.asarray(imgs), jnp.asarray(masks))
    aug = TL.build_augmentation(spec)
    assert len(aug.segments) == 1 and aug.segments[0].names == [
        "fliplr", "affine"]
    assert port_warps(aug, 64, 64) == ran
    K.reset_launches()
    ti, tm = aug.apply(jax_draws(aug, key, B, 64, 64),
                       torch.from_numpy(imgs), torch.from_numpy(masks))
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}   # on the CPU
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=WARP_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("spec", [{"ScaleY": {"scale": 1.1}},
                                  {"Affine": {"scale": 1.1}}],
                         ids=["scaley", "affine"])
def test_constant_scale_ties_follow_the_reference_xla_warp(spec,
                                                           monkeypatch):
    """A constant zoom of 1.1 at 64² puts mask rows on exact half-pixel
    ties (row 48 reads source row 46.5).  The reference's jitted CPU code
    contracts e2·(i − py) + ty into one fused multiply-add, the port (and
    its CUDA kernels, built with -fmad=false) rounds the product and the
    sum apart, so a tie can fall either way: against the reference's
    interpret-mode kernels 7 of 16384 mask values flip at this seed, and
    the reference's own two warps (its Pallas kernels and its XLA passes)
    disagree on the same 7.  The port's fused warp equals the reference's
    XLA warp (``STP_PALLAS_WARP=0``) exactly here, images within 1e-2."""
    monkeypatch.setenv("STP_PALLAS_WARP", "0")
    imgs, masks = blob_batch(B, 64, 64, 2)
    key = jax.random.PRNGKey(2)
    ji, jm = JL.build_augmentation(JL._coerce_block(spec))(
        key, jnp.asarray(imgs), jnp.asarray(masks))
    monkeypatch.setenv("STP_PALLAS_WARP", "1")
    aug = TL.build_augmentation(spec)
    ti, tm = aug.apply(jax_draws(aug, key, B, 64, 64),
                       torch.from_numpy(imgs), torch.from_numpy(masks))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=WARP_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_sample_draws_every_photometric_name():
    """The port's own draws: shapes, ranges and dtypes of each name's
    entry, from a torch.Generator, on the generator's device."""
    spec = [{name: args} for name, form, args in CASES
            if form in ("range", "pc", "bare")]
    aug = TL.build_augmentation(spec)
    gen = torch.Generator().manual_seed(0)
    draws = aug.sample(gen, B, H, W, 3)
    d = {s.name + str(i): dr for i, (s, dr) in enumerate(
        zip(aug.segments, draws))}
    for key, v in d.items():
        for t in v.values():
            assert isinstance(t, torch.Tensor) and t.shape[0] == B, key
    noise = [v["noise"] for k, v in d.items() if "laplace" in k]
    assert all(bool(torch.isfinite(n).all()) for n in noise)
    counts = [v["counts"] for k, v in d.items() if "poisson" in k]
    assert all(bool((c >= 0).all() and (c == c.round()).all())
               for c in counts)
    imgs, masks = blob_batch(B, H, W)
    ti, tm = aug.apply(draws, torch.from_numpy(imgs), torch.from_numpy(masks))
    assert ti.shape == imgs.shape and bool(torch.isfinite(ti).all())
    np.testing.assert_array_equal(tm.numpy(), masks)


def _ks(a, b) -> float:
    """The two-sample Kolmogorov-Smirnov distance of two samples."""
    a, b = np.sort(a), np.sort(b)
    v = np.concatenate([a, b])
    return float(np.abs(np.searchsorted(a, v, "right") / a.size
                        - np.searchsorted(b, v, "right") / b.size).max())


DB, DHW, DN = 4096, 6, 100_000


def _values(key, v) -> tuple:
    """One draw entry as two float64 samples: each image's mean (a
    permutation of the channels as its index among the 3! orders), and
    up to DN of its values.  Poisson counts give no pooled sample: their
    values share their image's rate, so they are not independent across
    the batch (the law given the rate is held by
    ``test_port_draws_keep_each_default_and_law``)."""
    v = np.asarray(v)
    if key == "perm":
        v = v[:, 0] * 9 + v[:, 1] * 3 + v[:, 2]
    v = v.astype(np.float64)
    pooled = None if key == "counts" else v.ravel()[:DN]
    return v.reshape(v.shape[0], -1).mean(axis=1), pooled


@pytest.mark.parametrize("name,form,args", CASES,
                         ids=[f"{n}-{f}" for n, f, _ in CASES])
def test_port_draws_follow_the_reference_laws(name, form, args):
    """Each name's own sampler (``aug.sample`` from a torch.Generator, as
    the train step draws) against the reference's draws (``jax_draws``,
    which ``test_each_name_matches_jax`` holds to the JAX lowering's
    draws) at B4096 6×6: the same entries, shapes and kinds; a constant
    entry equal; every other entry of the same law by the two-sample
    Kolmogorov-Smirnov distance of its per-image means and of its values,
    each below 2.23·sqrt(2/n): the 0.01% level, as the file makes some 400
    such comparisons."""
    aug = TL.build_augmentation({name: args})
    port = aug.sample(torch.Generator().manual_seed(7), DB, DHW, DHW, 3)[0]
    ref = jax_draws(aug, jax.random.PRNGKey(7), DB, DHW, DHW)[0]
    assert set(port) == set(ref)
    for key, t in port.items():
        p, r = t.numpy(), ref[key].numpy()
        assert p.shape == r.shape, key
        assert (p.dtype == np.bool_) == (r.dtype == np.bool_), key
        if r.min() == r.max():
            np.testing.assert_array_equal(p, np.full_like(p, r.flat[0]), key)
            continue
        for ps, rs in zip(_values(key, p), _values(key, r)):
            if rs is not None:
                assert _ks(ps, rs) < 2.23 * np.sqrt(2.0 / rs.size), key


# (spec, entry, law): "const" v, "rate" p (a share of True), "uniform"
# (lo, hi) of the values, "moments" (mean, variance) of the values,
# "orders": each of the 3! channel orders in a share of 1/6
LAWS = [
    ({"AdditiveLaplaceNoise": None}, "noise", "moments", (0.0, 2.0)),
    ({"AdditiveGaussianNoise": None}, "noise", "moments", (0.0, 1.0)),
    ({"AdditiveGaussianNoise": None}, "scale", "uniform", (0.0, 15.0)),
    ({"AdditivePoissonNoise": 4}, "counts", "moments", (4.0, 4.0)),
    ({"AdditivePoissonNoise": 0.5}, "counts", "moments", (0.5, 0.5)),
    ({"AdditivePoissonNoise": 30}, "counts", "moments", (30.0, 30.0)),
    ({"Add": None}, "value", "uniform", (-20.0, 20.0)),
    ({"Multiply": None}, "mul", "uniform", (0.8, 1.2)),
    ({"LinearContrast": None}, "alpha", "uniform", (0.6, 1.4)),
    ({"GammaContrast": None}, "gamma", "uniform", (0.7, 1.7)),
    ({"SigmoidContrast": None}, "gain", "const", 10.0),
    ({"SigmoidContrast": None}, "cutoff", "const", 0.5),
    ({"LogContrast": None}, "gain", "uniform", (0.4, 1.6)),
    ({"AddElementwise": None}, "value", "uniform", (-20.0, 20.0)),
    ({"MultiplyElementwise": None}, "mul", "uniform", (0.8, 1.2)),
    ({"Posterize": None}, "nb_bits", "const", 4.0),
    ({"Posterize": {}}, "nb_bits", "uniform", (1.0, 8.0)),
    ({"Invert": None}, "flip", "rate", 1.0),
    ({"Invert": 0.25}, "flip", "rate", 0.25),
    ({"Invert": [0.2, 0.6]}, "flip", "rate", 0.4),
    ({"Solarize": None}, "apply", "rate", 1.0),
    ({"Solarize": None}, "threshold", "const", 128.0),
    ({"Solarize": 0.3}, "apply", "rate", 0.3),
    ({"Solarize": {"p": [0.2, 0.6]}}, "apply", "rate", 0.4),
    ({"ChannelShuffle": None}, "sel", "rate", 1.0),
    ({"ChannelShuffle": 0.35}, "sel", "rate", 0.35),
    ({"ChannelShuffle": None}, "perm", "orders", None),
    ({"Dropout": None}, "p", "const", 0.05),
    ({"SaltAndPepper": None}, "p", "const", 0.05),
    ({"ImpulseNoise": None}, "p", "const", 0.05),
    ({"CoarseDropout": None}, "p", "const", 0.05),
    ({"Dropout2d": None}, "p", "const", 0.1),
    ({"TotalDropout": None}, "p", "const", 1.0),
    ({"Cutout": None}, "nb", "const", 1.0),
    ({"Cutout": None}, "cval", "const", 128.0),
    ({"ReplaceElementwise": None}, "p", "const", 0.05),
    ({"ReplaceElementwise": None}, "replacement", "uniform", (0.0, 255.0)),
]


@pytest.mark.parametrize("spec,key,law,value", LAWS,
                         ids=[f"{next(iter(s))}-{k}-{i}"
                              for i, (s, k, _, _) in enumerate(LAWS)])
def test_port_draws_keep_each_default_and_law(spec, key, law, value):
    """The port's sampler against the law the reference's lowering and
    imgaug give each entry (its bare default, Laplace's variance 2,
    Poisson's mean and variance lam, the selection rate p), at B4096
    6×6, within 4 standard errors."""
    aug = TL.build_augmentation(spec)
    v = aug.sample(torch.Generator().manual_seed(11), DB, DHW, DHW,
                   3)[0][key].numpy()
    x = v.astype(np.float64).ravel()
    if law == "const":
        np.testing.assert_array_equal(v, np.full_like(v, value))
    elif law == "rate":
        assert v.dtype == np.bool_ and v.shape == (DB,)
        assert abs(x.mean() - value) <= 4 * np.sqrt(value * (1 - value)
                                                    / x.size)
    elif law == "uniform":
        lo, hi = value
        assert lo <= x.min() and x.max() <= hi
        assert x.min() - lo < 0.01 * (hi - lo) > hi - x.max()
        assert abs(x.mean() - (lo + hi) / 2) <= 4 * (hi - lo) / np.sqrt(
            12 * x.size)
    elif law == "orders":
        assert sorted(map(tuple, np.unique(v, axis=0))) == sorted(
            itertools.permutations(range(3)))
        share = (v[:, None, :] == np.unique(v, axis=0)[None]).all(-1).mean(0)
        assert np.abs(share - 1 / 6).max() <= 4 * np.sqrt(5 / 36 / DB)
    else:
        mean, var = value
        assert abs(x.mean() - mean) <= 4 * np.sqrt(var / x.size)
        assert abs(x.var() / var - 1.0) < 0.02
