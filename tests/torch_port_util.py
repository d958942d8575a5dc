"""Shared helpers of the torch-port parity tests (tests/test_torch_port_*).

The port's augmentation takes its random draws as an argument; JAX's
threefry bits cannot be reproduced in torch, so these helpers make the
draws with ``jax.random`` along the reference lowering's key schedule and
hand the same values to the port:

  * ``aug_fn``: one key per segment (lowering.py:313);
  * geo run: one key per op plus one (lowering.py:649); the flips and
    square-rot90 fast path splits the last one per op
    (``_apply_cheap_geo``); otherwise the last one draws the run's
    ``cval``;
  * Affine: 4 keys — scale, translate, rotate, shear (lowering.py:687);
  * Crop/CropAndPad/Pad: 4 keys, one per side; the fixed-size crops and
    pads: 2 keys, the x and y offsets; PiecewiseAffine and
    PerspectiveTransform: 2 keys, the scale and the normal draws of the
    control points or corners;
  * ElasticTransformation: 3 keys — alpha, sigma, field (lowering.py:812),
    the field key split into the x and y noise (warp.py:191-196);
  * a photometric segment: its ``_apply_photo`` branch's split
    (lowering.py:1480-2030), the values its photometric function draws
    inside drawn from the same key (``_jax_photo_draw``);
  * Sometimes / OneOf / SomeOf: ``_make_meta``'s split (lowering.py:
    1353, 1371, 1404), each child block drawn as a block of its own;
  * a BlendAlpha: ``_make_blend``'s three keys (lowering.py:1196), the
    foreground and background blocks and the alpha map
    (``_blend_alpha_map``'s splits, ``_jax_blend_alpha``).

It also runs the reference's Pallas kernels in interpret mode inside the
full lowering (the pattern of tests/test_pallas_elastic.py:132-141), and
perturbs the BatchNorm statistics of a flax variables tree
(``perturbed_batch_stats``) so that a swapped mean and variance would show.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from segmentation_training_pipeline_tpu.ops.aug import fast_warp as JFW
from segmentation_training_pipeline_tpu.ops.aug import lowering as JL
from segmentation_training_pipeline_tpu.ops.aug import pallas_elastic as JPE
from segmentation_training_pipeline_tpu_torch.ops.aug import lowering as TL
from segmentation_training_pipeline_tpu_torch.ops.aug import segment as TS
from segmentation_training_pipeline_tpu_torch.ops.aug import warp as TW

CONFIG2_BLOCK = {
    "Fliplr": 0.5,
    "Affine": {"rotate": [-15, 15], "scale": [0.85, 1.15],
               "translate_percent": {"x": [-0.1, 0.1], "y": [-0.1, 0.1]}},
    "ElasticTransformation": {"alpha": [0, 40], "sigma": 6},
    "Multiply": [0.9, 1.1],
}


def interpret_kernels(monkeypatch):
    """Route the JAX lowering through its Pallas kernels, run in interpret
    mode on the CPU."""
    monkeypatch.setenv("STP_PALLAS_WARP", "1")
    monkeypatch.setenv("STP_PALLAS_ELASTIC", "1")
    warp, elastic = JFW.warp_joint_multipass, JPE.warp_elastic_joint
    monkeypatch.setattr(JFW, "warp_joint_multipass",
                        lambda *a, **kw: warp(*a, **{**kw,
                                                     "interpret": True}))
    monkeypatch.setattr(JPE, "warp_elastic_joint",
                        lambda *a, **kw: elastic(*a, **{**kw,
                                                        "interpret": True}))


def _t(v):
    return torch.from_numpy(np.array(v))


def _jax_rot90_k(k, args, b):
    """JAX's Rot90 k per image (``_apply_cheap_geo`` and the warp path
    draw alike)."""
    spec = args if args is not None else [0, 3]
    spec = spec.get("k") if isinstance(spec, dict) else spec
    if isinstance(spec, (list, tuple)) and len(spec) == 2:
        return jax.random.randint(k, (b,), int(spec[0]), int(spec[1]) + 1)
    if isinstance(spec, (list, tuple)):
        arr = jnp.asarray([int(v) for v in spec], jnp.int32)
        return arr[jax.random.randint(k, (b,), 0, len(spec))]
    return jnp.full((b,), int(spec), jnp.int32)


def _jax_geo_draw(seg, i, name, a, k, b, h, w):
    """One geometric op's draws from its key ``k``, as the reference's
    ``_make_geo_run`` splits and samples it."""
    if name in TL._FLIPS:
        return {"flip": jax.random.bernoulli(k, TL._flip_p(a), (b,))}
    if name == "rot90":
        return {"k": _jax_rot90_k(k, a, b)}
    if name == "affine":
        a = a or {}
        k1, k2, k3, k4 = jax.random.split(k, 4)
        sx, sy = JL._sample_xy(k1, a.get("scale"), b, 1.0)
        tkey = ("translate_percent" if "translate_percent" in a
                else "translate_px")
        tx, ty = JL._sample_xy(k2, a.get(tkey), b, 0.0)
        rot = JL._sample(k3, a.get("rotate"), b, 0.0)
        shear = a.get("shear")
        shx, shy = JL._sample_xy(k4, shear, b, 0.0)
        if not isinstance(shear, dict):
            shy = jnp.zeros_like(shy)
        return dict(sx=sx, sy=sy, tx=tx, ty=ty, rot=rot, shx=shx, shy=shy)
    if name in TL._CROPS:
        spec = (a["px"] if isinstance(a, dict) and "px" in a
                else JL._percent_arg(a, [0, 0.1]))
        return {side: JL._sample(kk, spec, b, 0.0) for side, kk in
                zip(("left", "right", "top", "bottom"),
                    jax.random.split(k, 4))}
    if name in TL._FIXED_SIZE:
        k1, k2 = jax.random.split(k)
        return {"ux": jax.random.uniform(k1, (b,)),
                "uy": jax.random.uniform(k2, (b,))}
    if name in ("piecewiseaffine", "perspectivetransform"):
        a = JL._bare(a, "scale")
        k1, k2 = jax.random.split(k)
        if name == "piecewiseaffine":
            shape = (b, 2, int(a.get("nb_rows", 4)), int(a.get("nb_cols", 4)))
            return {"scale": JL._sample(k1, a.get("scale", [0.01, 0.05]), b),
                    "coarse": jax.random.normal(k2, shape)}
        return {"scale": JL._sample(k1, a.get("scale", [0.0, 0.06]), b),
                "offsets": jax.random.normal(k2, (b, 4, 2))}
    a = a or {}
    k1, k2, k3 = jax.random.split(k, 3)
    radius, stride = seg.elastic[i]
    shape = TW.noise_shape(b, h, w, radius, stride)
    kx, ky = jax.random.split(k3)
    return dict(
        alpha=JL._sample(k1, a.get("alpha", 20.0), b),
        sigma=JL._sample(k2, a.get("sigma", 5.0), b),
        noise_x=jax.random.uniform(kx, shape, minval=-1.0, maxval=1.0),
        noise_y=jax.random.uniform(ky, shape, minval=-1.0, maxval=1.0))


def _jax_photo_draw(seg, k, b, h, w, c):
    """One photometric segment's draws from its key ``k``, as the
    reference's ``_apply_photo`` branch splits the key and as its
    photometric functions draw inside (``photometric.py``)."""
    name, a, pc = seg.name, seg.args, seg.per_channel
    split = jax.random.split
    uniform = jax.random.uniform
    if name in ("multiply", "add", "gammacontrast", "logcontrast"):
        key, spec, default = {
            "multiply": ("mul", [0.8, 1.2], 1.0),
            "add": ("value", [-20, 20], 0.0),
            "gammacontrast": ("gamma", [0.7, 1.7], 1.0),
            "logcontrast": ("gain", [0.4, 1.6], 1.0)}[name]
        return {key: JL._sample_maybe_per_channel(
            k, JL._bare(a, key).get(key, spec), b, c, pc, default)}
    if name in ("linearcontrast", "contrastnormalization"):
        return {"alpha": JL._sample(k, JL._bare(a, "alpha").get(
            "alpha", [0.6, 1.4]), b, 1.0)}
    if name == "sigmoidcontrast":
        aa = JL._bare(a, "gain")
        k1, k2 = split(k)
        return {"gain": JL._sample(k1, aa.get("gain", 10.0), b, 10.0),
                "cutoff": JL._sample(k2, aa.get("cutoff", 0.5), b, 0.5)}
    if name in ("additivegaussiannoise", "additivelaplacenoise"):
        k1, k2 = split(k)
        draw = (jax.random.normal if name == "additivegaussiannoise"
                else jax.random.laplace)
        return {"scale": JL._sample(k1, JL._bare(a, "scale").get(
                    "scale", [0, 15]), b, 0.0),
                "noise": draw(k2, (b, h, w, c), jnp.float32)}
    if name == "additivepoissonnoise":
        k1, k2 = split(k)
        lam = JL._sample(k1, JL._bare(a, "lam").get("lam", [0, 15]), b, 1.0)
        return {"counts": jax.random.poisson(
            k2, jnp.maximum(lam, 0.0)[:, None, None, None],
            shape=(b, h, w, c)).astype(jnp.float32)}
    if name == "invert":
        k1, k2 = split(k)
        p = JL._sample(k1, JL._bare(a, "p").get("p", 1.0), b, 1.0)
        return {"flip": jax.random.bernoulli(k2, p, (b,))}
    if name == "solarize":
        aa = JL._bare(a, "p")
        k1, k2, k3 = split(k, 3)
        th = JL._sample(k2, aa.get("threshold", 128), b, 128.0)
        if isinstance(aa.get("p"), (list, tuple)):
            apply = uniform(k3, (b,)) < JL._sample(k1, aa.get("p"), b, 1.0)
        elif float(aa.get("p", 1.0)) >= 1.0:
            apply = jnp.ones((b,), bool)
        else:
            apply = jax.random.bernoulli(k1, float(aa.get("p", 1.0)), (b,))
        return {"threshold": th, "apply": apply}
    if name == "posterize":
        return {"nb_bits": JL._sample(k, TL._single(a, "nb_bits", [1, 8]), b,
                                      4.0)}
    if name == "channelshuffle":
        k1, k2 = split(k)
        p = JL._sample(k1, TL._single(a, "p", 1.0), b, 1.0)
        kk1, kk2 = split(k2)
        return {"perm": jnp.argsort(uniform(kk1, (b, c)), axis=1),
                "sel": jax.random.bernoulli(kk2, p, (b,))}
    if name in ("addelementwise", "multiplyelementwise"):
        key, default = (("value", [-20, 20]) if name == "addelementwise"
                        else ("mul", [0.8, 1.2]))
        return {key: JL._sample_elementwise(k, TL._single(a, key, None),
                                            (b, h, w, c), pc, default)}
    if name in ("dropout", "saltandpepper", "saltpepper", "salt", "pepper",
                "impulsenoise"):
        k1, k2 = split(k)
        return {"p": JL._sample(k1, TL._single(a, "p", 0.05), b, 0.05),
                "u": uniform(k2, (b, h, w, c if name == "impulsenoise"
                                  else 1))}
    if name in ("coarsedropout", "coarsesaltandpepper", "coarsesalt",
                "coarsepepper"):
        p_spec, size = TL._coarse_args(a)
        k1, k2 = split(k)
        gh = max(1, int(round(h * size)))
        gw = max(1, int(round(w * size)))
        return {"p": JL._sample(k1, p_spec, b),
                "u": uniform(k2, (b, gh, gw, 1))}
    if name in ("dropout2d", "channeldropout"):
        k1, k2 = split(k)
        return {"p": JL._sample(k1, TL._dropout2d_args(a)[0], b, 0.1),
                "u": uniform(k2, (b, c))}
    if name == "totaldropout":
        k1, k2 = split(k)
        return {"p": JL._sample(k1, TL._single(a, "p", 1.0), b, 1.0),
                "u": uniform(k2, (b,))}
    if name == "cutout":
        aa, g = TL._cutout_args(a)
        k1, k2, k3 = split(k, 3)
        return {"nb": JL._sample(k1, aa.get("nb_iterations", 1), b, 1.0),
                "u": uniform(k2, (b, g, g, 1)),
                "cval": JL._sample(k3, aa.get("cval", 128), b, 128.0)}
    if name == "replaceelementwise":
        aa = JL._bare(a, "mask")
        k1, k2, k3 = split(k, 3)
        shape = (b, h, w, c if pc else 1)
        return {"p": JL._sample(k1, aa.get("mask", 0.05), b),
                "u": uniform(k2, shape),
                "replacement": JL._sample_shape(
                    k3, aa.get("replacement", [0.0, 255.0]), shape)}
    if name == "grayscale":
        return {"alpha": JL._sample(k, TL._single(a, "alpha", 1.0), b, 1.0)}
    if name in ("addtohueandsaturation", "multiplyhueandsaturation"):
        key, spec = (("value", [-30, 30]) if name.startswith("add")
                     else ("mul", [0.8, 1.2]))
        aa = JL._bare(a, key)
        k1, k2 = split(k)
        return {"hue": JL._sample(k1, aa.get(f"{key}_hue",
                                            aa.get(key, spec)), b),
                "sat": JL._sample(k2, aa.get(f"{key}_saturation",
                                            aa.get(key, spec)), b)}
    if name in ("addtohue", "addtosaturation", "multiplyhue",
                "multiplysaturation"):
        key, spec, rest = {
            "addtohue": ("value", [-255, 255], 0.0),
            "addtosaturation": ("value", [-75, 75], 0.0),
            "multiplyhue": ("mul", [-3.0, 3.0], 1.0),
            "multiplysaturation": ("mul", [0.0, 3.0], 1.0)}[name]
        v = JL._sample(k, JL._bare(a, key).get(key, spec), b)
        fixed = jnp.full((b,), rest, jnp.float32)
        return ({"hue": v, "sat": fixed} if name.endswith("hue")
                else {"hue": fixed, "sat": v})
    if name == "removesaturation":
        return {"hue": jnp.ones((b,), jnp.float32),
                "sat": 1.0 - JL._sample(k, TL._single(a, "mul", 1.0), b,
                                        1.0)}
    if name == "changecolortemperature":
        kv = TL._single(a, "kelvin", None)
        return {"kelvin": JL._sample(k, [1000, 11000] if kv is None else kv,
                                     b, 6600.0)}
    if name == "changecolorspace":
        return {"alpha": JL._sample(k, JL._bare(a, "to_colorspace").get(
            "alpha", 1.0), b, 1.0)}
    if name in ("clahe", "allchannelsclahe"):
        return {"clip_limit": JL._sample(k, JL._bare(a, "clip_limit").get(
            "clip_limit", [1, 10]), b, 40.0)}
    if name == "averageblur":
        return {"k": JL._sample(k, JL._bare(a, "k").get("k", [1, 7]), b,
                                3.0)}
    if name == "gaussianblur":
        return {"sigma": JL._sample(k, JL._bare(a, "sigma").get(
            "sigma", [0.0, 3.0]), b, 0.0)}
    if name in ("sharpen", "emboss"):
        key, spec = (("lightness", [0.75, 1.5]) if name == "sharpen"
                     else ("strength", [0.5, 1.5]))
        aa = a or {}
        k1, k2 = split(k)
        return {"alpha": JL._sample(k1, aa.get("alpha", [0.0, 1.0])
                                    if isinstance(aa, dict) else aa, b),
                key: JL._sample(k2, aa.get(key, spec)
                                if isinstance(aa, dict) else spec, b)}
    if name == "edgedetect":
        return {"alpha": JL._sample(k, JL._bare(a, "alpha").get(
            "alpha", [0.0, 0.75]), b)}
    if name == "directededgedetect":
        aa = JL._bare(a, "alpha")
        k1, k2 = split(k)
        return {"alpha": JL._sample(k1, aa.get("alpha", [0.0, 0.75]), b),
                "direction": JL._sample(k2, aa.get("direction", [0.0, 1.0]),
                                        b)}
    if name == "motionblur":
        aa = JL._bare(a, "k")
        k1, k2 = split(k)
        return {"k": JL._sample(k1, aa.get("k", 5), b, 5.0),
                "angle": JL._sample(k2, aa.get("angle", [0, 360]), b)}
    if name == "bilateralblur":
        aa = JL._bare(a, "d")
        k1, k2, k3 = split(k, 3)
        return {"d": JL._sample(k1, aa.get("d", 3), b, 3.0),
                "sigma_color": JL._sample(k2, aa.get("sigma_color",
                                                     [10, 250]), b, 75.0),
                "sigma_space": JL._sample(k3, aa.get("sigma_space",
                                                     [10, 250]), b, 75.0)}
    if name == "jpegcompression":
        return {"compression": JL._sample(k, JL._bare(a, "compression").get(
            "compression", [0, 100]), b, 50.0)}
    if name == "canny":
        # the branch splits k four ways; canny splits k4 for the colours
        aa = JL._bare(a, "alpha")
        ht = aa.get("hysteresis_thresholds")
        if ht is None:
            lo_spec, hi_spec = [60, 140], [160, 240]
        elif (isinstance(ht, (list, tuple)) and len(ht) == 2
              and all(isinstance(e, (list, tuple)) for e in ht)):
            lo_spec, hi_spec = ht
        else:
            lo_spec = hi_spec = ht
        k1, k2, k3, k4 = split(k, 4)
        kt, kf = split(k4)
        return {"alpha": JL._sample(k1, aa.get("alpha", [0.0, 1.0]), b),
                "lo": JL._sample(k2, lo_spec, b),
                "hi": JL._sample(k3, hi_spec, b),
                "col_t": uniform(kt, (b, 1, 1, 3), minval=0.0, maxval=256.0),
                "col_f": uniform(kf, (b, 1, 1, 3), minval=0.0,
                                 maxval=256.0)}
    if name == "cartoon":
        aa = a if isinstance(a, dict) else {}
        k1, k2, k3 = split(k, 3)
        return {"segmentation_size": JL._sample(
                    k1, aa.get("segmentation_size", [0.8, 1.2]), b, 1.0),
                "saturation": JL._sample(k2, aa.get("saturation",
                                                    [1.5, 2.5]), b, 2.0),
                "edge_prevalence": JL._sample(
                    k3, aa.get("edge_prevalence", [0.9, 1.1]), b, 1.0)}
    if name == "meanshiftblur":
        aa = JL._bare(a, "spatial_radius")
        k1, k2 = split(k)
        return {"spatial_radius": JL._sample(
                    k1, aa.get("spatial_radius", [5.0, 40.0]), b, 5.0),
                "color_radius": JL._sample(
                    k2, aa.get("color_radius", [5.0, 40.0]), b, 10.0)}
    if name in ("clouds", "fog"):
        key, spec, sizes = (("coverage", [0.2, 0.5], (4, 8, 16))
                            if name == "clouds"
                            else ("density", [0.1, 0.4], (2, 4)))
        k1, k2 = split(k)
        return {key: JL._sample(k1, JL._bare(a, key).get(key, spec), b),
                "grids": [uniform(jax.random.fold_in(k2, i), (b, g, g))
                          for i, g in enumerate(sizes)]}
    if name in ("snowflakes", "rain"):
        aa = a if isinstance(a, dict) else {}
        dens, speed, turn = (([0.005, 0.05], [0.007, 0.03], 30.0)
                             if name == "snowflakes"
                             else ([0.01, 0.06], [0.04, 0.1], 20.0))
        k1, k2, k3 = split(k, 3)
        ka, ku = split(k3)
        return {"density": JL._sample(k1, aa.get("density", dens), b),
                "speed": JL._sample(k2, aa.get("speed", speed), b),
                "angle": uniform(ka, (b,), minval=-turn, maxval=turn),
                "u": uniform(ku, (b, h, w, 1))}
    if name == "fastsnowylandscape":
        aa = a if isinstance(a, dict) else {}
        k1, k2 = split(k)
        return {"threshold": JL._sample(k1, aa.get("lightness_threshold",
                                                   [100, 255]), b, 140.0),
                "multiplier": JL._sample(k2, aa.get("lightness_multiplier",
                                                    [1.0, 4.0]), b, 2.5)}
    if name == "uniformcolorquantization":
        return {"n_colors": JL._sample(k, TL._single_or(a, "n_colors",
                                                        [2, 16]), b, 8.0)}
    if name in ("superpixels", "uniformvoronoi"):
        key, spec = (("n_segments", 100) if name == "superpixels"
                     else ("n_points", [50, 500]))
        aa = JL._bare(a, "p_replace" if name == "superpixels" else key)
        k1, k2, k3 = split(k, 3)
        p = seg.static[1]
        out = {key: JL._sample_int(k1, aa.get(key, spec), b, 100)[0],
               "p_replace": JL._sample(k2, aa.get("p_replace", [0.5, 1.0]),
                                       b, 1.0)}
        if name == "superpixels":
            return {**out, "u_rep": uniform(k3, (b, p))}
        kp, kr = split(k3)
        return {**out, "pos": uniform(kp, (b, p, 2)),
                "u_rep": uniform(kr, (b, p))}
    if name in ("regulargridvoronoi", "relativeregulargridvoronoi"):
        aa = TL._grid_args(a)
        k1, k2, k3, k4, k5 = split(k, 5)
        if name == "regulargridvoronoi":
            rows, rmax = JL._sample_int(k1, aa.get("n_rows", [10, 30]), b, 20)
            cols, cmax = JL._sample_int(k2, aa.get("n_cols", [10, 30]), b, 20)
            out = {"rows": rows, "cols": cols}
            p = max(1, rmax) * max(1, cmax)
        else:
            rf, cf, rmax, cmax = TL._relative_grid(seg, h, w)
            out = {"rows_frac": JL._sample(k1, rf, b, 0.1),
                   "cols_frac": JL._sample(k2, cf, b, 0.1)}
            p = rmax * cmax
        kd, kr = split(k5)
        return {**out,
                "p_drop": JL._sample(k3, aa.get("p_drop_points", 0.4), b,
                                     0.4),
                "p_replace": JL._sample(k4, aa.get("p_replace", [0.5, 1.0]),
                                        b, 1.0),
                "u_drop": uniform(kd, (b, p)), "u_rep": uniform(kr, (b, p))}
    if name == "kmeanscolorquantization":
        ms, kk = seg.static
        hs, ws = TS.downscaled_size(h, w, ms)
        k1, k2 = split(k)
        keys = split(k2, kk + 1)
        return {"n_colors": JL._sample_int(k1, JL._bare(a, "n_colors").get(
                    "n_colors", [2, 16]), b, 8)[0],
                "idx0": jax.random.randint(keys[0], (b, 1), 0, hs * ws),
                "gumbels": jnp.stack([jax.random.gumbel(kj, (b, hs * ws))
                                      for kj in keys[1:kk]], axis=1)}
    if name == "jigsaw":
        rows, cols, smax = seg.static
        k1, rng = split(k)
        cells, dirs = [], []
        for _ in range(smax):
            kc, kd, rng = split(rng, 3)
            cells.append(jax.random.randint(kc, (b,), 0, rows * cols))
            dirs.append(jax.random.randint(kd, (b,), 0, 4))
        return {"steps": JL._sample_int(k1, (a if isinstance(a, dict)
                                             else {}).get("max_steps",
                                                          [1, 5]), b, 2)[0],
                "cells": jnp.stack(cells, axis=1),
                "dirs": jnp.stack(dirs, axis=1)}
    assert name in ("noop", "identity", "resize", "scale", "autocontrast",
                    "auto_contrast", "histogramequalization",
                    "allchannelshistogramequalization", "averagepooling",
                    "maxpooling", "minpooling", "medianpooling",
                    "medianblur"), name
    return {}


def _jax_scope_draw(seg, k, b, h, w, c):
    """A scope's draws as the reference's ``_make_meta`` makes them:
    WithChannels hands its key to its child block; the colourspace scopes
    split it, one key per child, each child seeing the scoped
    channels."""
    if seg.name == "withchannels":
        return {"children": jax_draws(seg.child, k, b, h, w, c)}
    keys = jax.random.split(k, len(seg.children))
    return {"children": [
        {n: _t(v) for n, v in _jax_photo_draw(ch, kk, b, h, w,
                                              seg.n_ch).items()}
        for ch, kk in zip(seg.children, keys)]}


def _jax_meta_draw(seg, k, b, h, w, c):
    """A combinator's draws as the reference's ``_make_meta`` splits its
    key: k1, k2, k3 (selector, then, else) for Sometimes; kc and one key
    per child for OneOf; kn, ks and one key per child for SomeOf."""
    n = len(seg.children)
    if seg.name == "sometimes":
        k1, *kids = jax.random.split(k, 3)
        sel = {"sel": _t(jax.random.bernoulli(k1, seg.p, (b,)))}
    elif seg.name == "oneof":
        kc, *kids = jax.random.split(k, n + 1)
        sel = {"choice": _t(jax.random.randint(kc, (b,), 0, n))}
    else:
        kn, ks, *kids = jax.random.split(k, n + 2)
        ns = (jnp.full((b,), seg.n_lo, jnp.int32) if seg.n_lo == seg.n_hi
              else jax.random.randint(kn, (b,), seg.n_lo, seg.n_hi + 1))
        sel = {"n": _t(ns), "scores": _t(jax.random.uniform(ks, (b, n)))}
    return {**sel, "children": [jax_draws(ch, kk, b, h, w, c)
                                for ch, kk in zip(seg.children, kids)]}


def _jax_blend_alpha(seg, k, b, h, w, c):
    """A blend's alpha-map draws from its key, as the reference's
    ``_blend_alpha_map`` splits and samples it."""
    name, a, split = seg.name, seg.args, jax.random.split
    if name in ("blendalpha", "blendalphaelementwise"):
        spec = seg._factor_spec()
        if name == "blendalpha":
            shape = (b, 1, 1, c) if seg.per_channel else (b,)
        else:
            shape = (b, h, w, c if seg.per_channel else 1)
        return {"factor": JL._sample_shape(k, spec, shape)}
    if "lineargradient" in name:
        k1, k2 = split(k)
        return {"start": JL._sample(k1, a.get("start_at", [0.0, 1.0]), b),
                "end": JL._sample(k2, a.get("end_at", [0.0, 1.0]), b)}
    if name in ("blendalpharegulargrid", "blendalphacheckerboard"):
        kr, kc, kg = split(k, 3)
        out = {"rows": JL._sample_int(kr, a.get("nb_rows"), b, 4)[0],
               "cols": JL._sample_int(kc, a.get("nb_cols"), b, 4)[0]}
        if name == "blendalpharegulargrid":
            shape = (b, seg.rmax, seg.cmax)
            out["grid"] = (jax.random.bernoulli(kg, 0.5, shape).astype(
                jnp.float32) if a.get("alpha") is None
                else JL._sample_shape(kg, a["alpha"], shape))
        return out
    if name == "blendalphasomecolors":
        kr, kn, ka, ks = split(k, 4)
        shape = (b, seg.nbmax)
        return {"rotation": JL._sample(kr, a.get("rotation_deg", [0, 360]),
                                       b),
                "nb_bins": JL._sample_int(kn, a.get("nb_bins", [5, 15]), b,
                                          10)[0],
                "table": (jax.random.bernoulli(ka, 0.5, shape).astype(
                    jnp.float32) if a.get("alpha") is None
                    else JL._sample_shape(ka, a["alpha"], shape)),
                "smoothness": JL._sample(ks, a.get("smoothness", [0.1, 0.3]),
                                         b)}
    if name == "blendalphasegmapclassids":
        return {}
    if name == "blendalphasimplexnoise":
        ks = split(k, 5)
        out, kt = {"grids": [jax.random.uniform(kk, (b, g, g)) for kk, g in
                             zip(ks[:4], (2, 4, 8, 16))]}, ks[4]
    else:
        ke, kn, kt = split(k, 3)
        out = {"exponent": JL._sample(ke, a.get("exponent", [-4.0, 4.0]), b),
               "white": jax.random.normal(kn, (b, h, w))}
    if a.get("sigmoid", True):
        out["thresh"] = JL._sample(kt, a.get("sigmoid_thresh", [0.4, 0.6]),
                                   b)
    return out


def _tree_t(v):
    if isinstance(v, dict):
        return {n: _tree_t(x) for n, x in v.items()}
    if isinstance(v, list):
        return [_tree_t(x) for x in v]
    return _t(v)


def _jax_blend_draw(seg, k, b, h, w, c):
    """A blend's draws as the reference's ``_make_blend`` splits its key:
    kf for the foreground block, kb for the background block, ka for the
    alpha map."""
    kf, kb, ka = jax.random.split(k, 3)
    kids = [jax_draws(ch, kk, b, h, w, c)
            for ch, kk in ((seg.fg, kf), (seg.bg, kb)) if ch is not None]
    return {"children": kids,
            "alpha": _tree_t(_jax_blend_alpha(seg, ka, b, h, w, c))}


def jax_draws(aug, key, b, h, w, c=3):
    """Draws for the port's ``aug`` (a ``lowering.Augmentation``) made with
    jax.random exactly as the reference lowering draws them from ``key``."""
    keys = jax.random.split(key, max(len(aug.segments), 1))
    out = []
    for seg, k in zip(aug.segments, keys):
        if isinstance(seg, TL._Meta):
            out.append(_jax_meta_draw(seg, k, b, h, w, c))
            continue
        if isinstance(seg, TL._Scope):
            out.append(_jax_scope_draw(seg, k, b, h, w, c))
            continue
        if isinstance(seg, TL._Blend):
            out.append(_jax_blend_draw(seg, k, b, h, w, c))
            continue
        if isinstance(seg, TL._Photo):
            out.append(_tree_t(_jax_photo_draw(seg, k, b, h, w, c)))
            continue
        gk = jax.random.split(k, len(seg.geo) + 1)
        if seg.is_cheap(h, w):
            gk = jax.random.split(gk[-1], len(seg.geo))
        draws = [_jax_geo_draw(seg, i, name, s.get("args"), gk[i], b, h, w)
                 for i, (s, name) in enumerate(zip(seg.geo, seg.names))]
        if seg.cval_spec is not None:
            draws.append({"cval": JL._sample(gk[-1], seg.cval_spec, b, 0.0)})
        out.append([{n: _t(v) for n, v in d.items()} for d in draws])
    return out


def record_jax_warps(monkeypatch):
    """Wrap the reference's three warps to record, in order, which ran:
    "multipass" (" ye" with a field), "elastic", "gather" (" u8" with the
    uint8 taps)."""
    from segmentation_training_pipeline_tpu.ops.aug import warp as JW

    ran = []

    def wrap(mod, name, tag):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            extra = ((" ye" if kw.get("disp") is not None else "")
                     + (" u8" if kw.get("gather_u8") else ""))
            ran.append(tag + extra)
            return fn(*a, **kw)

        monkeypatch.setattr(mod, name, wrapped)

    wrap(JFW, "warp_joint_multipass", "multipass")
    wrap(JPE, "warp_elastic_joint", "elastic")
    wrap(JW, "warp_joint", "gather")
    return ran


def port_warps(aug, h, w):
    """The warps the port's ``aug`` runs at H×W, in order, named as
    ``record_jax_warps`` names the reference's."""
    out = []
    for run in aug.geo_runs():
        route = run.route(h, w)
        if route == "gather":
            u8 = run.integer_input and run.cval_spec is None
            out.append("gather u8" if u8 else "gather")
        elif route == "multipass+elastic":
            out += ["multipass", "elastic"]
        elif route != "flips":
            out.append(route)
    return out


def blob_batch(b, h, w, seed=0):
    """uint8 noise images and one-channel float disc masks (few mask
    boundaries, as real masks)."""
    r = np.random.RandomState(seed)
    imgs = (r.rand(b, h, w, 3) * 255).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    masks = np.stack([
        (yy - h * (0.4 + 0.05 * i)) ** 2 + (xx - w * 0.35) ** 2
        < (min(h, w) / 4.0) ** 2 for i in range(b)])
    return imgs, masks[..., None].astype(np.float32)


def capture_drop_masks(store):
    """A ``flax.linen.intercept_methods`` context under which every
    training-mode ``DropPath`` of the JAX models draws its keep mask as
    the module itself does (one ``make_rng("dropout")``, a bernoulli) and
    records it in ``store`` under the port's module name, as a (B,) bool
    array; and every training-mode ``nn.Dropout`` too, under its flax path
    with "/" → ".", as a bool array of the input's shape (NHWC).  Works
    inside ``jit`` (the mask leaves through ``jax.debug.callback``); call
    ``jax.effects_barrier()`` before reading."""
    import flax.linen as fnn
    from segmentation_training_pipeline_tpu.models import layers as JLY

    def put(name, m):
        store[name] = np.asarray(m).reshape(-1).astype(bool)

    def put_full(name, m):
        store[name] = np.asarray(m).astype(bool)

    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, fnn.Dropout) and context.method_name == "__call__":
            return dropout(mod, next_fun, args, kwargs)
        if (not isinstance(mod, JLY.DropPath)
                or context.method_name != "__call__"):
            return next_fun(*args, **kwargs)
        x = args[0]
        det = kwargs.get("deterministic", args[1] if len(args) > 1 else True)
        if mod.rate == 0.0 or det:
            return next_fun(*args, **kwargs)
        keep = 1.0 - mod.rate
        mask = jax.random.bernoulli(mod.make_rng("dropout"), keep,
                                    (x.shape[0], 1, 1, 1))
        jax.debug.callback(lambda m, n=".".join(mod.path): put(n, m), mask)
        return x * mask.astype(x.dtype) / keep

    def dropout(mod, next_fun, args, kwargs):
        # flax's own Dropout.__call__, its draw recorded
        x = args[0]
        det = kwargs.get("deterministic")
        det = mod.deterministic if det is None else det
        if mod.rate == 0.0 or det or mod.broadcast_dims:
            return next_fun(*args, **kwargs)
        keep = 1.0 - mod.rate
        mask = jax.random.bernoulli(mod.make_rng(mod.rng_collection), keep,
                                    x.shape)
        jax.debug.callback(lambda m, n=".".join(mod.path): put_full(n, m),
                           mask)
        return jax.lax.select(mask, x / keep, jnp.zeros_like(x))

    return fnn.intercept_methods(intercept)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """At most 2 PyTorch intra-op threads while a port test module runs,
    restored after it.  The tier-1 command runs 6 pytest workers on one
    host; with PyTorch's default of a thread per core in each, their
    spin-waiting OpenMP threads oversubscribe the cores: six of the port's
    files took 557 s side by side at the default and 260 s with this
    fixture (6 workers, 8-core CPU host).  A module that imports this
    fixture uses it."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def private_native_library(tmp_path_factory):
    """The JAX package's native loader, built into a directory of this
    module's own and loaded in this process, whatever other processes do.

    ``native/build.py`` compiles ``libstploader.so`` next to its source
    when the file is absent (it is git-ignored), writing one shared
    ``libstploader.so.tmp``; several pytest workers building at once on a
    fresh tree race on that file, and a worker whose build failed keeps
    ``_TRIED`` set and no library for the rest of its run.  The fixture
    points the build at a private path, clears the module's cache and the
    JAX batcher's cached loader, builds, and restores all of it after the
    module.  It fails, and never skips, when the library does not load."""
    from segmentation_training_pipeline_tpu.data import batcher as JB
    from segmentation_training_pipeline_tpu.native import build as NB

    saved = NB._SO, NB._LIB, NB._TRIED, JB._NATIVE_LOADER
    NB._SO = str(tmp_path_factory.mktemp("native") / "libstploader.so")
    NB._LIB, NB._TRIED, JB._NATIVE_LOADER = None, False, None
    try:
        lib = NB.load_native_library()
        assert lib is not None, "the native loader did not build or load"
        yield lib
    finally:
        NB._SO, NB._LIB, NB._TRIED, JB._NATIVE_LOADER = saved


def random_weights(module, seed):
    """Fill every parameter of a port module from ``seed``, much faster
    than ``models.factory.init_model``'s truncated normals at ResNet-50
    size: conv kernels N(0, 1/fan_in), BatchNorm scales 1 + N(0, 0.1²),
    every bias N(0, 0.1²); running statistics 0 and 1 (see
    ``perturbed_batch_stats``).  Returns the module."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            r = torch.randn(p.shape, generator=gen)
            if p.dim() == 4:
                p.copy_(r / float(np.sqrt(p[0].numel())))
            elif name.endswith("weight"):
                p.copy_(1.0 + 0.1 * r)
            else:
                p.copy_(0.1 * r)
        for name, b in module.named_buffers():
            b.fill_(1.0 if name.endswith("running_var") else 0.0)
    return module


def perturbed_batch_stats(var, seed=1):
    """Seeded noise on the means and a positive factor on the variances."""
    r = np.random.RandomState(seed)

    def f(path, a):
        noise = r.randn(*a.shape).astype(np.float32)
        if path[-1].key == "var":
            return (a * np.exp(0.3 * noise)).astype(np.float32)
        return (a + 0.2 * noise).astype(np.float32)

    return {**var, "batch_stats": jax.tree_util.tree_map_with_path(
        f, var["batch_stats"])}
