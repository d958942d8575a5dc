"""The weather augmenters (Clouds, Fog, Snowflakes, Rain,
FastSnowyLandscape) and UniformColorQuantization of the port against the
JAX lowering on the same draws (made with jax.random along the
reference's key splits, including the value noise's ``fold_in`` grids:
tests/torch_port_util.py:_jax_photo_draw).

Each name runs in its bare, scalar or list, and dict forms at 40×56, B3,
and once at 128² (the streak kernels' reflect padding then stays inside
the frame), all cases of a shape in one jitted JAX function
(``jax_outputs``, module-scoped).  Tolerances: images within 1e-3 on the
0..255 scale (the bilinear upsampling, sin/cos and the streak
convolution round in another order than XLA's; 1.2e-4 measured), masks
exactly equal and untouched.
"""

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

from torch_port_util import (blob_batch, few_torch_threads,  # noqa: F401
                             jax_draws)

ATOL = 1e-3
B = 3
SEED = 11

FORMS = {
    "Clouds": [("bare", None), ("list", [0.3, 0.7]),
               ("dict", {"coverage": 0.6})],
    "Fog": [("bare", None), ("scalar", 0.5), ("dict", {"density": [0.2, 0.6]})],
    "Snowflakes": [("bare", None),
                   ("dict", {"density": [0.02, 0.08], "speed": [0.05, 0.2]})],
    "Rain": [("bare", None), ("dict", {"density": 0.05, "speed": [0.1, 0.3]})],
    "FastSnowyLandscape": [("bare", None),
                           ("dict", {"lightness_threshold": [60, 160],
                                     "lightness_multiplier": [1.5, 3.0]})],
    "UniformColorQuantization": [("bare", None), ("scalar", 4),
                                 ("list", [2, 8]),
                                 ("dict", {"n_colors": [3, 16]})],
}
CASES = [(f"{n}-{f}", {n: a}) for n, forms in FORMS.items() for f, a in forms]
BIG = [(f"{n}-big", {n: None}) for n in FORMS]
RUNS = [(c, s, (40, 56)) for c, s in CASES] + [(c, s, (128, 128))
                                               for c, s in BIG]


@pytest.fixture(scope="module")
def jax_outputs():
    """Every case's JAX images and masks at one shape, from one jitted
    function per shape."""
    cache = {}

    def get(hw):
        if hw not in cache:
            cases = [(c, s) for c, s, at in RUNS if at == hw]
            fns = [JL.build_augmentation(JL._coerce_block(s))
                   for _, s in cases]
            imgs, masks = blob_batch(B, *hw, SEED)
            outs = jax.jit(lambda k, i, m: [f(k, i, m) for f in fns])(
                jax.random.PRNGKey(SEED), jnp.asarray(imgs),
                jnp.asarray(masks))
            cache[hw] = {c: (np.asarray(i), np.asarray(m))
                         for (c, _), (i, m) in zip(cases, outs)}
        return cache[hw]

    return get


@pytest.mark.parametrize("case,spec,hw", RUNS,
                         ids=[f"{c}-{h}x{w}" for c, _, (h, w) in RUNS])
def test_each_weather_name_matches_jax(case, spec, hw, jax_outputs):
    ji, jm = jax_outputs(hw)[case]
    imgs, masks = blob_batch(B, *hw, SEED)
    aug = TL.build_augmentation(spec)
    draws = jax_draws(aug, jax.random.PRNGKey(SEED), B, *hw)
    ti, tm = aug.apply(draws, torch.from_numpy(imgs), torch.from_numpy(masks))
    ti, tm = ti.numpy(), tm.numpy()
    assert ti.dtype == np.float32 and ti.shape == ji.shape == imgs.shape
    np.testing.assert_allclose(ti, ji, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tm, masks)
    assert not np.array_equal(ti, imgs.astype(np.float32)), case


@pytest.mark.parametrize("case,spec", CASES, ids=[c for c, _ in CASES])
def test_weather_parses_as_jax(case, spec):
    d = {"augmentation": spec}
    assert TC.parse_dict(d).to_dict() == JC.parse_dict(d).to_dict()


def test_streak_kernels_peak_at_one():
    """The streak kernels' peak is 1 (a point keeps its brightness); a
    length-1 streak is one tap; angle 0 streaks vertically."""
    k = TP.streak_kernels(torch.tensor([1.0, 9.0, 9.0]),
                          torch.tensor([0.0, 0.0, 90.0]), 4)
    assert torch.allclose(k.amax((1, 2)), torch.ones(3))
    assert int((k[0] > 0).sum()) == 1
    assert torch.allclose(k[1], k[2].T, atol=1e-6)   # cos 90° ≈ −4e-8
    assert float(k[1][:, 4].sum()) == 9.0 and float(k[1][4].sum()) == 1.0


def test_uniform_color_quantization_takes_bin_centres():
    x = torch.tensor([0.0, 63.9, 64.0, 255.0]).reshape(1, 1, 4, 1)
    out = TP.uniform_color_quantization(x, torch.tensor([4.0]))
    assert out.flatten().tolist() == [32.0, 32.0, 96.0, 224.0]
