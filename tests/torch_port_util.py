"""Shared helpers of the torch-port parity tests (tests/test_torch_port_*).

The port's augmentation takes its random draws as an argument; JAX's
threefry bits cannot be reproduced in torch, so these helpers make the
draws with ``jax.random`` along the reference lowering's key schedule and
hand the same values to the port:

  * ``aug_fn``: one key per segment (lowering.py:313);
  * geo run: one key per op plus one (lowering.py:649); the flips-only fast
    path splits the last one per op (``_apply_cheap_geo``);
  * Affine: 4 keys — scale, translate, rotate, shear (lowering.py:687);
  * ElasticTransformation: 3 keys — alpha, sigma, field (lowering.py:812),
    the field key split into the x and y noise (warp.py:191-196);
  * Multiply: the segment key (lowering.py:1491-1494).

It also runs the reference's Pallas kernels in interpret mode inside the
full lowering (the pattern of tests/test_pallas_elastic.py:132-141).
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from segmentation_training_pipeline_tpu.ops.aug import fast_warp as JFW
from segmentation_training_pipeline_tpu.ops.aug import lowering as JL
from segmentation_training_pipeline_tpu.ops.aug import pallas_elastic as JPE
from segmentation_training_pipeline_tpu_torch.ops.aug import lowering as TL
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


def jax_draws(aug, key, b, h, w, c=3):
    """Draws for the port's ``aug`` (a ``lowering.Augmentation``) made with
    jax.random exactly as the reference lowering draws them from ``key``."""
    keys = jax.random.split(key, max(len(aug.segments), 1))
    out = []
    for seg, k in zip(aug.segments, keys):
        if not isinstance(seg, TL._GeoRun):
            mul = JL._sample_maybe_per_channel(k, seg.mul, b, c,
                                               seg.per_channel, 1.0)
            out.append({"mul": _t(mul)})
            continue
        gk = jax.random.split(k, len(seg.geo) + 1)
        if seg.cheap:
            gk = jax.random.split(gk[-1], len(seg.geo))
        draws = []
        for i, (s, name) in enumerate(zip(seg.geo, seg.names)):
            a = s.get("args")
            if name in TL._FLIPS:
                draws.append({"flip": jax.random.bernoulli(
                    gk[i], TL._flip_p(a), (b,))})
            elif name == "affine":
                a = a or {}
                k1, k2, k3, k4 = jax.random.split(gk[i], 4)
                sx, sy = JL._sample_xy(k1, a.get("scale"), b, 1.0)
                tkey = ("translate_percent" if "translate_percent" in a
                        else "translate_px")
                tx, ty = JL._sample_xy(k2, a.get(tkey), b, 0.0)
                rot = JL._sample(k3, a.get("rotate"), b, 0.0)
                shear = a.get("shear")
                shx, shy = JL._sample_xy(k4, shear, b, 0.0)
                if not isinstance(shear, dict):
                    shy = jnp.zeros_like(shy)
                draws.append(dict(sx=sx, sy=sy, tx=tx, ty=ty, rot=rot,
                                  shx=shx, shy=shy))
            else:
                a = a or {}
                k1, k2, k3 = jax.random.split(gk[i], 3)
                radius, stride = seg.elastic[i]
                shape = TW.noise_shape(b, h, w, radius, stride)
                kx, ky = jax.random.split(k3)
                draws.append(dict(
                    alpha=JL._sample(k1, a.get("alpha", 20.0), b),
                    sigma=JL._sample(k2, a.get("sigma", 5.0), b),
                    noise_x=jax.random.uniform(kx, shape, minval=-1.0,
                                               maxval=1.0),
                    noise_y=jax.random.uniform(ky, shape, minval=-1.0,
                                               maxval=1.0)))
        out.append([{n: _t(v) for n, v in d.items()} for d in draws])
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
