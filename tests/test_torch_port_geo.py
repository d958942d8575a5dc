"""The geometric augmenters (Rot90, the crop and pad family, PiecewiseAffine,
PerspectiveTransform, a ``cval`` fill) and the exact footprint-gather warp
of the port against the JAX lowering, on the same draws (made with
jax.random along the reference's key schedule, tests/torch_port_util.py).

The JAX side runs its Pallas kernels in interpret mode (with
``STP_PALLAS_ELASTIC=1``, so it chooses its paths as on the TPU); the port
runs its kernels' plain versions on the CPU.  Each case also records which
of the reference's warps ran (its multipass warp, its elastic kernel, its
exact gather) and holds the port's ``route`` to it.

Tolerances: images within 1e-2 on the 0..255 scale (the reference's warp
dots leave ~2^-16 relative error, the gather's bilinear blend is f32 on
both sides), masks exactly equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from segmentation_training_pipeline_tpu.ops.aug import fast_warp as JFW
from segmentation_training_pipeline_tpu.ops.aug import lowering as JL
from segmentation_training_pipeline_tpu.ops.aug import pallas_elastic as JPE
from segmentation_training_pipeline_tpu.ops.aug import warp as JW
from segmentation_training_pipeline_tpu_torch import kernels as K
from segmentation_training_pipeline_tpu_torch.ops.aug import lowering as TL
from segmentation_training_pipeline_tpu_torch.ops.aug import warp as TW

from torch_port_util import (blob_batch, few_torch_threads,  # noqa: F401
                             interpret_kernels, jax_draws)

ATOL = 1e-2

SINGLE = {
    "rot90": {"Rot90": [0, 3]},
    "crop": {"Crop": {"percent": [0, 0.1]}},
    "cropandpad": {"CropAndPad": {"percent": [-0.08, 0.08]}},
    "pad-px": {"Pad": {"px": [0, 6]}},
    "croptofixedsize": {"CropToFixedSize": {"width": 40, "height": 36}},
    "randomcrop-center": {"RandomCrop": {"width": 44, "height": 40,
                                         "position": "center"}},
    "padtofixedsize": {"PadToFixedSize": {"width": 80, "height": 72}},
    "centercroptofixedsize": {"CenterCropToFixedSize": {"width": 40,
                                                        "height": 44}},
    "piecewiseaffine": {"PiecewiseAffine": {"scale": [0.01, 0.03]}},
    "perspectivetransform": {"PerspectiveTransform": {"scale": [0, 0.06]}},
}


def kitchen_sink_geo(side):
    """The geometric entries of examples/kitchen_sink.yaml, its
    PadToFixedSize and CenterCropToFixedSize scaled from the 384² frame to
    ``side``."""
    pad, crop = round(420 * side / 384), round(352 * side / 384)
    return {
        "Fliplr": 0.5,
        "Rot90": [0, 3],
        "Affine": {"rotate": [-25, 25],
                   "scale": {"x": [0.85, 1.2], "y": [0.85, 1.2]},
                   "translate_percent": [-0.05, 0.05], "shear": [-8, 8],
                   "cval": [0, 255]},
        "CropAndPad": {"percent": [-0.08, 0.08]},
        "PadToFixedSize": {"width": pad, "height": pad, "pad_cval": 16},
        "CenterCropToFixedSize": {"width": crop, "height": crop},
        "ElasticTransformation": {"alpha": [0, 30], "sigma": [4, 7]},
        "PiecewiseAffine": {"scale": [0.01, 0.03]},
    }


def _record_jax_paths(monkeypatch):
    """Wrap the reference's three warps to record which ran."""
    ran = []
    for mod, name, tag in ((JFW, "warp_joint_multipass", "multipass"),
                           (JPE, "warp_elastic_joint", "elastic"),
                           (JW, "warp_joint", "gather")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _tag=tag, **kw):
            ran.append(_tag + (" ye" if kw.get("disp") is not None else ""))
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, wrapped)
    return ran


def _jax_route(ran):
    """The reference's calls → the port's route name."""
    if not ran:
        return "flips"
    return {("multipass",): "multipass", ("elastic",): "elastic",
            ("gather",): "gather", ("multipass ye",): "multipass ye",
            ("multipass", "elastic"): "multipass+elastic"}[tuple(ran)]


def run_both(spec, b, h, w, seed, monkeypatch):
    interpret_kernels(monkeypatch)
    ran = _record_jax_paths(monkeypatch)
    imgs, masks = blob_batch(b, h, w, seed)
    key = jax.random.PRNGKey(seed)
    ji, jm = JL.build_augmentation(JL._coerce_block(spec))(
        key, jnp.asarray(imgs), jnp.asarray(masks))
    aug = TL.build_augmentation(spec)
    ti, tm = aug.apply(jax_draws(aug, key, b, h, w), torch.from_numpy(imgs),
                       torch.from_numpy(masks))
    routes = [s.route(h, w) for s in aug.segments
              if isinstance(s, TL._GeoRun)]
    assert routes == [_jax_route(ran)], (routes, ran)
    return np.asarray(ji), np.asarray(jm), ti.numpy(), tm.numpy(), routes[0]


def _close(ji, jm, ti, tm):
    assert ti.shape == ji.shape and tm.shape == jm.shape
    np.testing.assert_allclose(ti, ji, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tm, jm)


@pytest.mark.parametrize("hw", [(64, 64), (48, 64)], ids=["64x64", "48x64"])
@pytest.mark.parametrize("name", sorted(SINGLE))
def test_each_name_alone_matches_jax(name, hw, monkeypatch):
    ji, jm, ti, tm, route = run_both(SINGLE[name], 4, *hw, 7, monkeypatch)
    _close(ji, jm, ti, tm)
    if name != "rot90":
        assert not np.array_equal(ti, blob_batch(4, *hw, 7)[0]), route


@pytest.mark.parametrize("hw,want", [((64, 64), "gather"),
                                     ((48, 64), "gather")],
                         ids=["64x64", "48x64"])
def test_kitchen_sink_geometric_block_matches_jax(hw, want, monkeypatch):
    """Fliplr, Rot90, the Affine with cval, CropAndPad, PadToFixedSize with
    pad_cval, CenterCropToFixedSize, ElasticTransformation and
    PiecewiseAffine in one run: its displacement bound K is far above 64
    (the fixed-size crop alone counts a zoom of 4), so both packages take
    the exact gather."""
    ji, jm, ti, tm, route = run_both(kitchen_sink_geo(hw[0]), 4, *hw, 3,
                                     monkeypatch)
    assert route == want
    _close(ji, jm, ti, tm)


@pytest.mark.parametrize("spec,want", [
    ({"Affine": {"rotate": [-20, 20], "cval": [0, 255]}}, "multipass"),
    ({"Crop": {"px": [0, 5], "cval": 77}}, "multipass"),
    ({"ElasticTransformation": {"alpha": 400, "sigma": 4}}, "gather"),
    ({"Affine": {"rotate": [-10, 10]},
      "PiecewiseAffine": {"scale": [0.005, 0.02]}}, "multipass+elastic"),
    ({"Rot90": [1, 3], "Affine": {"scale": [0.9, 1.1]}}, "multipass"),
    ({"PerspectiveTransform": {"scale": [0.1, 0.2]}}, "gather"),
], ids=["cval-affine", "cval-crop-px", "k-over-64", "affine-piecewise",
        "rot90-in-the-warp", "perspective-k-over-64"])
def test_paths_and_fills_match_jax(spec, want, monkeypatch):
    ji, jm, ti, tm, route = run_both(spec, 4, 64, 64, 11, monkeypatch)
    assert route == want
    _close(ji, jm, ti, tm)


def test_ye_route_matches_jax(monkeypatch):
    monkeypatch.setenv("STP_FUSE_ELASTIC", "1")
    spec = {"Fliplr": 0.5, "Affine": {"rotate": [-10, 10]},
            "PiecewiseAffine": {"scale": [0.005, 0.02]}}
    ji, jm, ti, tm, route = run_both(spec, 2, 64, 64, 5, monkeypatch)
    assert route == "multipass ye"
    _close(ji, jm, ti, tm)


@pytest.mark.parametrize("gather_u8", [False, True])
@pytest.mark.parametrize("with_disp", [False, True])
def test_warp_joint_matches_jax(gather_u8, with_disp):
    """The exact gather alone: rotations past 90°, zooms that sample
    outside the frame, a displacement field; f32 and uint8 taps."""
    b, h, w = 3, 40, 56
    imgs, masks = blob_batch(b, h, w, 4)
    r = np.random.RandomState(0)
    mats = np.stack([np.array([[np.cos(t) / s, np.sin(t) / s, r.randn() * 5],
                               [-np.sin(t) / s, np.cos(t) / s, r.randn() * 5],
                               [0, 0, 1]], np.float32)
                     for t, s in zip([0.3, 2.0, -2.9], [0.8, 1.0, 1.3])])
    disp = None
    if with_disp:
        disp = tuple((3.0 * r.randn(b, h, w)).astype(np.float32)
                     for _ in range(2))
    ji, jm = JW.warp_joint(jnp.asarray(imgs, jnp.float32), jnp.asarray(masks),
                           jnp.asarray(mats),
                           None if disp is None else tuple(map(jnp.asarray,
                                                               disp)),
                           gather_u8=gather_u8)
    ti, tm = TW.warp_joint(torch.from_numpy(imgs).float(),
                           torch.from_numpy(masks), torch.from_numpy(mats),
                           None if disp is None else tuple(
                               map(torch.from_numpy, disp)),
                           gather_u8=gather_u8)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-3, rtol=0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert (tm.numpy() == 0).any() and (ti.numpy() == 0).any()   # the fill


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_warp_matches_jax(method):
    imgs, _ = blob_batch(2, 32, 48, 2)
    mats = np.stack([np.array([[0.9, 0.2, 3], [-0.2, 0.9, -4], [0, 0, 1]],
                              np.float32)] * 2)
    want = JW.warp(jnp.asarray(imgs), jnp.asarray(mats), method=method)
    got = TW.warp(torch.from_numpy(imgs), torch.from_numpy(mats),
                  method=method)
    assert got.dtype == (torch.uint8 if method == "nearest"
                         else torch.float32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=1e-3)


def test_rot90s_and_fields_match_jax():
    k = np.array([0, 1, 2, 3], np.int32)
    np.testing.assert_allclose(TW.rot90s(48, 64, torch.from_numpy(k)).numpy(),
                               np.asarray(JW.rot90s(48, 64, jnp.asarray(k))),
                               atol=1e-5)
    r = np.random.RandomState(1)
    coarse = r.randn(2, 2, 4, 5).astype(np.float32)
    offs = r.randn(2, 4, 2).astype(np.float32)
    scale = np.array([0.02, 0.05], np.float32)
    # the reference draws inside its field functions: hand it the draws
    jdx, jdy = _jax_piecewise(coarse, scale, 40, 56)
    tdx, tdy = TL.piecewise_field(torch.from_numpy(coarse),
                                  torch.from_numpy(scale), 40, 56)
    np.testing.assert_allclose(tdx.numpy(), jdx, atol=1e-5)
    np.testing.assert_allclose(tdy.numpy(), jdy, atol=1e-5)
    jdx, jdy = _jax_perspective(offs, scale, 40, 56)
    tdx, tdy = TL.perspective_field(torch.from_numpy(offs),
                                    torch.from_numpy(scale), 40, 56)
    np.testing.assert_allclose(tdx.numpy(), jdx, atol=1e-3)
    np.testing.assert_allclose(tdy.numpy(), jdy, atol=1e-3)


def _jax_piecewise(coarse, scale, h, w):
    b, _, rows, cols = coarse.shape
    with _normal_returns(coarse):
        dx, dy = JL._piecewise_field(jax.random.PRNGKey(0), b, h, w,
                                     jnp.asarray(scale), rows, cols)
    return np.asarray(dx), np.asarray(dy)


def _jax_perspective(offs, scale, h, w):
    with _normal_returns(offs):
        dx, dy = JL._perspective_field(jax.random.PRNGKey(0), offs.shape[0],
                                       h, w, jnp.asarray(scale))
    return np.asarray(dx), np.asarray(dy)


class _normal_returns:
    """``jax.random.normal`` returns ``value`` inside the block."""

    def __init__(self, value):
        self.value = value

    def __enter__(self):
        self.saved = jax.random.normal
        jax.random.normal = lambda k, shape, *a, **kw: jnp.asarray(self.value)

    def __exit__(self, *exc):
        jax.random.normal = self.saved


def test_sample_draws_every_new_name():
    spec = {**kitchen_sink_geo(64),
            "PerspectiveTransform": {"scale": [0.01, 0.02]}}
    aug = TL.build_augmentation(spec)
    draws = aug.sample(torch.Generator().manual_seed(0), 8, 64, 64)
    run = draws[0]
    assert len(run) == len(spec) + 1                 # + the run's cval
    names = aug.segments[0].names
    d = dict(zip(names, run))
    assert set(d["rot90"]["k"].tolist()) <= {0, 1, 2, 3}
    assert float(d["cropandpad"]["left"].abs().max()) <= 0.08
    assert tuple(d["piecewiseaffine"]["coarse"].shape) == (8, 2, 4, 4)
    assert tuple(d["perspectivetransform"]["offsets"].shape) == (8, 4, 2)
    assert 0.0 <= float(run[-1]["cval"].min()) <= 255.0
    imgs, masks = blob_batch(8, 64, 64)
    K.reset_launches()
    ti, tm = aug.apply(draws, torch.from_numpy(imgs), torch.from_numpy(masks))
    assert ti.shape == (8, 64, 64, 3) and tm.shape == (8, 64, 64, 1)
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


@pytest.mark.parametrize("spec,exc,match", [
    ({"CropToFixedSize": {"position": "center"}}, ValueError,
     "width: ..., height: ..."),
    ({"Pad": {"percent": [0.1, 0, 0.1, 0]}}, ValueError, "4-tuple"),
    ({"CropAndPad": {"percent": 0.1, "pad_mode": "edge"}}, ValueError,
     "pad_mode='constant'"),
], ids=["fixed-size-without-size", "four-tuple", "pad-mode"])
def test_refusals_match_jax(spec, exc, match):
    with pytest.raises(exc, match=match):
        JL.build_augmentation(JL._coerce_block(spec))
    with pytest.raises(exc, match=match):
        TL.build_augmentation(spec)
