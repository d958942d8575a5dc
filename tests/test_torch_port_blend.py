"""The BlendAlpha family of the port (the ten blends and the four
pre-0.4 aliases) against the JAX lowering on the same draws: the
foreground and background child blocks drawn from ``_make_blend``'s kf
and kb, the alpha map from ka along ``_blend_alpha_map``'s splits
(tests/torch_port_util.py:_jax_blend_draw).

Each blend runs with a geometric foreground child (Fliplr or Flipud:
the masks then differ between the branches, so their routing shows),
in its default and argument forms, ``per_channel`` on and off where the
reference reads it (BlendAlpha, BlendAlphaElementwise), and one case
with both children; at 40×56 B3 (FrequencyNoise also at 33×47, odd),
every case of a shape in one jitted JAX function.

Tolerances: images within 1e-3 on 0..255 (1.4e-4 measured), FrequencyNoise
too: XLA's and PyTorch's CPU FFTs round differently and the per-image
min-max normalisation and sigmoid(10·x) enlarge that, to 1.4e-4 at 40×56
and 1.3e-4 at 33×47 measured; masks equal at every pixel whose JAX alpha
(its channel mean) is farther than 1e-5 from 0.5, and such near-tie
pixels under 0.1% (1.5e-4 measured, per-channel BlendAlphaElementwise).
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

from torch_port_util import (blob_batch, few_torch_threads,  # noqa: F401
                             jax_draws)

ATOL = 1e-3
TIE = 1e-5
B = 3
SEED = 5
FLIP = {"Fliplr": 1.0}

CASES = {
    "blendalpha": {"BlendAlpha": {"foreground": FLIP}},
    "blendalpha-scalar": {"BlendAlpha": {"factor": 0.75,
                                         "foreground": {"Add": 40}}},
    "blendalpha-per-channel": {"BlendAlpha": {
        "factor": [0.0, 1.0], "per_channel": True, "foreground": FLIP}},
    "blendalpha-both": {"BlendAlpha": {
        "factor": [0.2, 0.9], "foreground": FLIP,
        "background": [{"Flipud": 1.0}, {"Add": [-30, 30]}]}},
    "alpha": {"Alpha": {"factor": [0.3, 0.8], "first": FLIP}},
    "blendalphaelementwise": {"BlendAlphaElementwise": {"foreground": FLIP}},
    "blendalphaelementwise-per-channel": {"BlendAlphaElementwise": {
        "alpha": [0.1, 0.9], "per_channel": True,
        "foreground": {"Flipud": 1.0}}},
    "alphaelementwise": {"AlphaElementwise": {"foreground": FLIP,
                                              "factor": [0.0, 0.6, 1.0]}},
    "vertical": {"BlendAlphaVerticalLinearGradient": {"foreground": FLIP}},
    "vertical-args": {"BlendAlphaVerticalLinearGradient": {
        "foreground": FLIP, "min_value": 0.2, "max_value": 0.9,
        "start_at": [0.0, 0.3], "end_at": [0.7, 1.0]}},
    "horizontal": {"BlendAlphaHorizontalLinearGradient": {
        "foreground": {"Flipud": 1.0}, "start_at": 0.8, "end_at": 0.2}},
    "regulargrid": {"BlendAlphaRegularGrid": {"foreground": FLIP}},
    "regulargrid-args": {"BlendAlphaRegularGrid": {
        "foreground": FLIP, "nb_rows": [2, 7], "nb_cols": [1, 4, 6],
        "alpha": [0.2, 0.8]}},
    "checkerboard": {"BlendAlphaCheckerboard": {
        "foreground": FLIP, "nb_rows": [2, 6], "nb_cols": 3}},
    "simplexnoise": {"BlendAlphaSimplexNoise": {"foreground": FLIP}},
    "simplexnoise-args": {"BlendAlphaSimplexNoise": {
        "foreground": FLIP, "sigmoid": False}},
    "simplexnoisealpha": {"SimplexNoiseAlpha": {
        "foreground": FLIP, "sigmoid_thresh": 0.5}},
    "frequencynoise": {"BlendAlphaFrequencyNoise": {"foreground": FLIP}},
    "frequencynoise-args": {"BlendAlphaFrequencyNoise": {
        "foreground": FLIP, "exponent": [-2.0, 2.0], "sigmoid": False}},
    "frequencynoisealpha": {"FrequencyNoiseAlpha": {
        "foreground": FLIP, "exponent": -4.0}},
    "somecolors": {"BlendAlphaSomeColors": {"foreground": FLIP}},
    "somecolors-args": {"BlendAlphaSomeColors": {
        "foreground": FLIP, "nb_bins": [2, 6], "smoothness": [0.0, 0.5],
        "alpha": [0.0, 1.0], "rotation_deg": 90}},
    "segmapclassids": {"BlendAlphaSegMapClassIds": {
        "foreground": FLIP, "class_ids": 1}},
    "segmapclassids-background": {"BlendAlphaSegMapClassIds": {
        "foreground": FLIP, "class_ids": [0, 2]}},
}
RUNS = [(c, s, (40, 56)) for c, s in CASES.items()] + [
    (c, CASES[c], (33, 47)) for c in ("frequencynoise", "frequencynoisealpha")]


def blend_batch(b, h, w, seed):
    """uint8 noise images under two-channel masks: a disc (channel 0)
    and a bar (channel 1)."""
    imgs, disc = blob_batch(b, h, w, seed)
    bar = np.zeros_like(disc)
    bar[:, h // 3:h // 2] = 1.0
    return imgs, np.concatenate([disc, bar * (1.0 - disc)], axis=-1)


@pytest.fixture(scope="module")
def jax_outputs():
    """Every case's JAX images, masks and alpha map at one shape, from one
    jitted function per shape (the alpha map from ``_blend_alpha_map`` on
    the key the block hands it)."""
    cache = {}

    def get(hw):
        if hw not in cache:
            cases = [(c, s) for c, s, at in RUNS if at == hw]
            specs = [JL._coerce_block(s) for _, s in cases]
            fns = [JL.build_augmentation(s) for s in specs]

            def alpha(s, key, imgs, masks):
                b, h, w, c = imgs.shape
                a = dict(s["args"])
                ka = jax.random.split(jax.random.split(key, 1)[0], 3)[2]
                name = JL._BLEND_CANON.get(s["name"].lower(),
                                           s["name"].lower())
                base = jnp.clip(imgs.astype(jnp.float32), 0.0, 255.0)
                al = JL._blend_alpha_map(name, a, ka, b, h, w, c,
                                         bool(a.get("per_channel", False)),
                                         base_img=base, masks=masks)
                al = jnp.broadcast_to(al, (b, h, w, al.shape[-1]))
                return al.mean(axis=-1)

            def run_all(key, imgs, masks):
                return [(f(key, imgs, masks), alpha(s[0], key, imgs, masks))
                        for f, s in zip(fns, specs)]

            imgs, masks = blend_batch(B, *hw, SEED)
            outs = jax.jit(run_all)(jax.random.PRNGKey(SEED),
                                    jnp.asarray(imgs), jnp.asarray(masks))
            cache[hw] = {c: (np.asarray(i), np.asarray(m), np.asarray(al))
                         for (c, _), ((i, m), al) in zip(cases, outs)}
        return cache[hw]

    return get


@pytest.mark.parametrize("case,spec,hw", RUNS,
                         ids=[f"{c}-{h}x{w}" for c, _, (h, w) in RUNS])
def test_each_blend_matches_jax(case, spec, hw, jax_outputs):
    ji, jm, jal = jax_outputs(hw)[case]
    imgs, masks = blend_batch(B, *hw, SEED)
    aug = TL.build_augmentation(spec)
    assert isinstance(aug.segments[0], TL._Blend)
    draws = jax_draws(aug, jax.random.PRNGKey(SEED), B, *hw)
    ti, tm = aug.apply(draws, torch.from_numpy(imgs), torch.from_numpy(masks))
    ti, tm = ti.numpy(), tm.numpy()
    np.testing.assert_allclose(ti, ji, atol=ATOL, rtol=0)
    far = np.abs(jal - 0.5) > TIE                                 # (B, H, W)
    assert (~far).mean() < 1e-3, (~far).mean()
    np.testing.assert_array_equal(tm[far], jm[far])
    assert not np.array_equal(ti, imgs.astype(np.float32)), case
    if "Flip" in str(spec) and (jal[far] >= 0.5).any():
        assert not np.array_equal(tm, masks), case      # routed to the flip


@pytest.mark.parametrize("case", sorted(CASES))
def test_blends_parse_as_jax(case):
    d = {"augmentation": CASES[case]}
    assert TC.parse_dict(d).to_dict() == JC.parse_dict(d).to_dict()


def test_alpha_maps_cover_their_ranges():
    """The port's own draws: the checkerboard alternates from 1 at the
    top-left, a regular grid's default cells are 0 or 1, a gradient runs
    from min_value to max_value."""
    gen = torch.Generator().manual_seed(0)
    x = torch.zeros(2, 16, 16, 3)
    m = torch.zeros(2, 16, 16, 1)
    for spec, check in (
            ({"BlendAlphaCheckerboard": {"nb_rows": 4, "nb_cols": 4,
                                         "foreground": {"Add": 1}}},
             lambda al: al[:, 0, 0].eq(1).all() and al[:, 0, 4].eq(0).all()),
            ({"BlendAlphaRegularGrid": {"foreground": {"Add": 1}}},
             lambda al: set(al.unique().tolist()) <= {0.0, 1.0}),
            ({"BlendAlphaHorizontalLinearGradient": {
                "start_at": 0.0, "end_at": 1.0, "min_value": 0.25,
                "max_value": 0.75, "foreground": {"Add": 1}}},
             lambda al: torch.allclose(al[:, 0, [0, 15], 0], torch.tensor(
                 [[0.25, 0.75]] * 2)))):
        seg = TL.build_augmentation(spec).segments[0]
        d = seg.sample(gen, 2, 16, 16, 3)
        assert check(seg.alpha(d["alpha"], x, m)), spec


REFUSALS = {
    "no-child": ({"BlendAlpha": {"factor": 0.5}},
                 "needs a foreground"),
    "scalar-args": ({"BlendAlphaSimplexNoise": 0.5}, "expects"),
    "class-ids-negative": ({"BlendAlphaSegMapClassIds": {
        "class_ids": [1, -1], "foreground": FLIP}}, "non-negative"),
    "class-ids-float": ({"BlendAlphaSegMapClassIds": {
        "class_ids": 1.5, "foreground": FLIP}}, "non-negative"),
    "unknown-key": ({"BlendAlpha": {"factr": 0.5, "foreground": FLIP}},
                    "Did you mean 'factor'"),
    "iterations": ({"BlendAlphaSimplexNoise": {
        "iterations": 2, "foreground": FLIP}}, "octave count is fixed"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_blend_refusals_match_jax(case):
    spec, match = REFUSALS[case]
    with pytest.raises(JC.ConfigError, match=match) as j:
        JC.parse_dict({"augmentation": spec})
    with pytest.raises(TC.ConfigError, match=match) as t:
        TC.parse_dict({"augmentation": spec})
    assert str(t.value).split(" (")[0] == str(j.value).split(" (")[0]


def test_class_ids_out_of_range_raises_as_jax():
    """An id past the mask's channels: the reference's ValueError, when
    the block meets the masks."""
    spec = {"BlendAlphaSegMapClassIds": {"class_ids": [3],
                                         "foreground": FLIP}}
    imgs, masks = blend_batch(1, 8, 8, 0)
    with pytest.raises(ValueError, match="out of range") as j:
        JL.build_augmentation(JL._coerce_block(spec))(
            jax.random.PRNGKey(0), jnp.asarray(imgs), jnp.asarray(masks))
    aug = TL.build_augmentation(spec)
    with pytest.raises(ValueError, match="out of range") as t:
        aug(torch.Generator().manual_seed(0), torch.from_numpy(imgs),
            torch.from_numpy(masks))
    assert str(t.value) == str(j.value)
    with pytest.raises(ValueError, match="needs {class_ids"):
        TL.build_augmentation({"BlendAlphaSegMapClassIds": {
            "foreground": FLIP}})
