"""The port's augmentation lowering against the JAX lowering on the same
random draws (made with jax.random along the reference's key schedule,
tests/torch_port_util.py).  The JAX side runs its Pallas kernels in
interpret mode; the port runs its kernels' plain versions on the CPU.

Tolerances: images within 1e-2 on the 0..255 scale (the reference's warp
dots leave ~2^-16 relative error), masks exactly equal; the elastic field
within 1e-5 (pins ``jax.image.resize`` bilinear against
``F.interpolate(align_corners=False)`` and the symmetric-pad blur).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from segmentation_training_pipeline_tpu.ops.aug import lowering as JL
from segmentation_training_pipeline_tpu.ops.aug import warp as JW
from segmentation_training_pipeline_tpu_torch import kernels as K
from segmentation_training_pipeline_tpu_torch.ops.aug import lowering as TL
from segmentation_training_pipeline_tpu_torch.ops.aug import warp as TW

from torch_port_util import (CONFIG2_BLOCK, blob_batch, few_torch_threads,
                             interpret_kernels, jax_draws)


def _run_both(spec, b, h, w, seed, monkeypatch, imgs=None, masks=None):
    interpret_kernels(monkeypatch)
    if imgs is None:
        imgs, masks = blob_batch(b, h, w, seed)
    key = jax.random.PRNGKey(seed)
    ji, jm = JL.build_augmentation(JL._coerce_block(spec))(
        key, jnp.asarray(imgs), jnp.asarray(masks))
    aug = TL.build_augmentation(spec)
    ti, tm = aug.apply(jax_draws(aug, key, b, h, w), torch.from_numpy(imgs),
                       torch.from_numpy(masks))
    return np.asarray(ji), np.asarray(jm), ti.numpy(), tm.numpy()


@pytest.mark.parametrize("h,seed", [(64, 0), (64, 3), (128, 1)])
def test_config2_block_matches_jax(h, seed, monkeypatch):
    """Fliplr + Affine + ElasticTransformation + Multiply: kernels X, Y and
    the elastic resample, end to end through the lowering."""
    K.reset_launches()
    ji, jm, ti, tm = _run_both(CONFIG2_BLOCK, 3, h, h, seed, monkeypatch)
    np.testing.assert_allclose(ti, ji, atol=1e-2, rtol=0)
    np.testing.assert_array_equal(tm, jm)
    assert ti.min() >= 0.0 and ti.max() <= 255.0
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


@pytest.mark.parametrize("spec", [
    {"Affine": {"rotate": [-30, 30], "shear": [-10, 10],
                "scale": {"x": [0.8, 1.2], "y": [0.9, 1.1]},
                "translate_px": {"x": [-5, 5], "y": [-3, 3]}}},
    {"Flipud": {"p": 0.5}, "Affine": {"rotate": [80, 100]}},
    {"Elastic": {"alpha": [10, 30], "sigma": [4, 6]}},
    {"Fliplr": 0.5, "Flipud": 0.5, "Multiply": {"mul": [0.5, 1.5],
                                                "per_channel": True}},
], ids=["affine", "rot90-extraction", "elastic-only", "flips-multiply"])
def test_other_blocks_match_jax(spec, monkeypatch):
    ji, jm, ti, tm = _run_both(spec, 3, 64, 64, 5, monkeypatch)
    np.testing.assert_allclose(ti, ji, atol=1e-2, rtol=0)
    np.testing.assert_array_equal(tm, jm)


def test_non_square_affine_matches_jax(monkeypatch):
    ji, jm, ti, tm = _run_both(
        {"Affine": {"rotate": [-20, 20], "scale": [0.9, 1.1]}}, 2, 64, 96, 2,
        monkeypatch)
    np.testing.assert_allclose(ti, ji, atol=1e-2, rtol=0)
    np.testing.assert_array_equal(tm, jm)


def test_flips_only_is_reverse_select():
    aug = TL.build_augmentation({"Fliplr": 1.0})
    assert aug.segments[0].route(16, 16) == "flips"
    imgs, masks = blob_batch(2, 16, 16)
    gen = torch.Generator().manual_seed(0)
    ti, tm = aug(gen, torch.from_numpy(imgs), torch.from_numpy(masks))
    np.testing.assert_array_equal(ti.numpy(), imgs[:, :, ::-1].astype(
        np.float32))
    np.testing.assert_array_equal(tm.numpy(), masks[:, :, ::-1])


@pytest.mark.parametrize("h,sigma", [(64, 6.0), (16, 5.0)])
def test_elastic_field_matches_jax(h, sigma):
    """stride 4 at 64² (blur at quarter resolution, bilinear upsample),
    stride 1 at 16² (grid too small for the low-res path)."""
    b = 2
    radius = TW.elastic_radius(sigma)
    key = jax.random.PRNGKey(4)
    alpha = jnp.asarray([13.0, 37.0])
    sig = jnp.full((b,), sigma)
    jdx, jdy = JW.elastic_field(key, b, h, h, alpha, sig, radius, stride=4)
    shape = TW.noise_shape(b, h, h, radius, 4)
    kx, ky = jax.random.split(key)
    nx = torch.from_numpy(np.array(jax.random.uniform(kx, shape, minval=-1.0,
                                                      maxval=1.0)))
    ny = torch.from_numpy(np.array(jax.random.uniform(ky, shape, minval=-1.0,
                                                      maxval=1.0)))
    tdx, tdy = TW.elastic_field(nx, ny, h, h, torch.tensor([13.0, 37.0]),
                                torch.full((b,), sigma), radius, stride=4)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), atol=1e-5)
    np.testing.assert_allclose(tdy.numpy(), np.asarray(jdy), atol=1e-5)
    assert (shape[1] == h // 4) == (h == 64)


def test_matrix_helpers_match_jax():
    r = np.random.RandomState(0)
    th, sx, sy, tx, ty = (r.uniform(-1, 1, 3).astype(np.float32)
                          for _ in range(5))
    f = np.array([True, False, True])
    cx, cy = 31.5, 20.5
    jm = JW.compose(JW.rotation_about(cx, cy, jnp.asarray(th)),
                    JW.scale_about(cx, cy, jnp.asarray(sx + 2),
                                   jnp.asarray(sy + 2)))
    jm = JW.compose(JW.shear_about(cx, cy, jnp.asarray(tx), jnp.asarray(ty)),
                    jm)
    jm = JW.compose(JW.translation(jnp.asarray(tx), jnp.asarray(ty)), jm)
    jm = JW.compose(JW.vflip(41, jnp.asarray(f)),
                    JW.compose(JW.hflip(64, jnp.asarray(f)), jm))
    t = torch.from_numpy
    tm = TW.compose(TW.rotation_about(cx, cy, t(th)),
                    TW.scale_about(cx, cy, t(sx + 2), t(sy + 2)))
    tm = TW.compose(TW.shear_about(cx, cy, t(tx), t(ty)), tm)
    tm = TW.compose(TW.translation(t(tx), t(ty)), tm)
    tm = TW.compose(TW.vflip(41, t(f)), TW.compose(TW.hflip(64, t(f)), tm))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5,
                               rtol=1e-6)


def test_sample_draws_distributions():
    aug = TL.build_augmentation(CONFIG2_BLOCK)
    gen = torch.Generator().manual_seed(3)
    draws = aug.sample(gen, 64, 64, 64)
    flip, affine, elastic = draws[0]
    assert flip["flip"].dtype == torch.bool and 0 < flip["flip"].sum() < 64
    assert float(affine["rot"].abs().max()) <= 15.0
    assert 0.85 <= float(affine["sx"].min()) and float(affine["sx"].max()) <= 1.15
    assert torch.equal(affine["sx"], affine["sy"])        # scalar range
    assert not torch.equal(affine["tx"], affine["ty"])    # per-axis dict
    assert float(affine["tx"].abs().max()) <= 0.1
    assert torch.equal(affine["shy"], torch.zeros(64))
    assert tuple(elastic["noise_x"].shape) == (64, 16, 16)  # stride 4
    assert float(elastic["alpha"].max()) <= 40.0
    assert torch.equal(elastic["sigma"], torch.full((64,), 6.0))
    assert 0.9 <= float(draws[1]["mul"].min()) <= float(draws[1]["mul"].max()) <= 1.1
    again = aug.sample(torch.Generator().manual_seed(3), 64, 64, 64)
    assert torch.equal(again[0][2]["noise_y"], elastic["noise_y"])


@pytest.mark.parametrize("spec,match", [
    ({"Sharpen": {"alpha": 0.5}}, "Sharpen"),
    ({"Add": 10}, "Add"),
    ({"Sometimes": {"p": 0.5, "then": [{"Affine": {"cval": 128}}]}},
     "Sometimes"),
])
def test_unported_configs_raise_at_build(spec, match):
    with pytest.raises(NotImplementedError, match=match):
        TL.build_augmentation(spec)


@pytest.mark.parametrize("spec", [
    {"ElasticTransformation": {"alpha": 400, "sigma": 4}},  # K > 64
    # anisotropic scale doubles the shear factors: beyond the canvas
    {"Affine": {"rotate": [-45, 45], "scale": {"x": [0.5, 1.0], "y": 1.0}}},
])
def test_footprint_gather_configs_raise(spec, monkeypatch):
    """The configurations the JAX package sends to its exact footprint
    gather (they raised before the gather was ported) take the port's
    gather, no kernel, and equal the reference on its draws."""
    interpret_kernels(monkeypatch)
    imgs, masks = blob_batch(2, 32, 32)
    aug = TL.build_augmentation(spec)
    assert aug.segments[0].route(32, 32) == "gather"
    key = jax.random.PRNGKey(4)
    ji, jm = JL.build_augmentation(JL._coerce_block(spec))(
        key, jnp.asarray(imgs), jnp.asarray(masks))
    K.reset_launches()
    ti, tm = aug.apply(jax_draws(aug, key, 2, 32, 32),
                       torch.from_numpy(imgs), torch.from_numpy(masks))
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-2, rtol=0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
