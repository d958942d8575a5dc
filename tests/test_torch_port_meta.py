"""The choice combinators Sometimes, OneOf and SomeOf of the port against the
JAX lowering's ``_make_meta``, on the same draws (the selectors' and every
child's, made with jax.random along the reference's key splits:
tests/torch_port_util.py:_jax_meta_draw), and their parsing against the
JAX config's.

Children run on the whole batch in order and a per-image ``where``
selects, as in the reference.  The JAX side runs its Pallas kernels in
interpret mode and records which of its warps ran, in order, with the
uint8 taps marked; the port's warps (``port_warps``) are held to that.

Tolerances: images within 1e-2 on the 0..255 scale where a warp is inside
(the reference's warp dots), 1e-3 otherwise; masks exactly equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from segmentation_training_pipeline_tpu import config as JC
from segmentation_training_pipeline_tpu.ops.aug import lowering as JL
from segmentation_training_pipeline_tpu_torch import config as TC
from segmentation_training_pipeline_tpu_torch import kernels as K
from segmentation_training_pipeline_tpu_torch.ops.aug import lowering as TL

from torch_port_util import (blob_batch, few_torch_threads,  # noqa: F401
                             interpret_kernels, jax_draws, port_warps,
                             record_jax_warps)

WARP_ATOL = 1e-2
B = 4

# the chip_smoke.py ``train_photo`` block
TRAIN_PHOTO_BLOCK = [
    {"Fliplr": 0.5},
    {"Rotate": [-15, 15]},
    {"Sometimes": {"p": 0.5, "then": [{"ElasticTransformation": {
        "alpha": [0, 40], "sigma": 6}}]}},
    {"OneOf": [{"GammaContrast": [0.7, 1.4]}, {"LinearContrast": [0.9, 1.1]},
               {"SigmoidContrast": {"gain": [6, 10]}}]},
    {"SomeOf": {"n": [0, 2], "children": [
        {"AdditiveGaussianNoise": {"scale": [0, 10]}}, {"SaltAndPepper": 0.02},
        {"CoarseDropout": {"p": 0.05}},
        {"Cutout": {"nb_iterations": [1, 3], "size": 0.15, "cval": 128}}]}},
    {"Resize": 0.75},
]

CASES = {
    "sometimes-then": (
        [{"Sometimes": {"p": 0.5, "then": [{"Affine": {"rotate": [-20, 20]}},
                                           {"Add": 20}]}}],
        ["multipass"]),
    "sometimes-then-else": (
        [{"Sometimes": {"p": 0.5, "then": [{"Flipud": 1.0}],
                        "else": [{"GammaContrast": [0.5, 2.0]}]}}],
        []),
    "sometimes-else-only": (
        [{"Add": 10},
         {"Sometimes": {"p": 0.5, "else_list": [{"Rotate": [-10, 10]}]}}],
        ["multipass"]),
    "sometimes-cval": (
        [{"Sometimes": {"p": 0.5, "then": [
            {"Affine": {"rotate": [-20, 20], "cval": 128}}]}}],
        ["multipass"]),
    "oneof-list-children": (
        [{"OneOf": [[{"Flipud": 1.0}, {"Add": 30}], {"Invert": 1.0},
                    {"Rotate": [-20, 20]}]}],
        ["multipass"]),
    "someof-n-fixed": (
        [{"SomeOf": {"n": 2, "children": [
            {"Fliplr": 1.0}, {"Multiply": 0.5}, {"Dropout": 0.2},
            {"TranslateX": [-0.1, 0.1]}]}}],
        ["multipass"]),
    "someof-n-range": (
        [{"SomeOf": {"n": [0, 3], "children": [
            {"Flipud": 1.0}, {"LogContrast": [0.5, 1.5]}, {"Salt": 0.1},
            {"ScaleX": [0.8, 1.2]}]}}],
        ["multipass"]),
    "nested": (
        [{"Sometimes": {"p": 0.7, "then": [{"OneOf": [
            {"Salt": 0.1},
            {"SomeOf": {"n": 1, "children": [
                {"Pepper": 0.1},
                {"ElasticTransformation": {"alpha": [0, 30],
                                           "sigma": 5}}]}}]}]}}],
        ["elastic"]),
    # a warp child after a photometric sees non-integers: float taps
    "geo-after-photo": (
        [{"Multiply": 0.55},
         {"Sometimes": {"p": 0.6, "then": [{"ElasticTransformation": {
             "alpha": 400, "sigma": 4}}]}}],
        ["gather"]),
    "geo-first": (
        [{"Sometimes": {"p": 0.6, "then": [{"ElasticTransformation": {
            "alpha": 400, "sigma": 4}}]}}, {"Multiply": 0.55}],
        ["gather u8"]),
    "train-photo-block": (TRAIN_PHOTO_BLOCK, ["multipass", "elastic"]),
}


def run_both(spec, b, h, w, seed, monkeypatch):
    interpret_kernels(monkeypatch)
    ran = record_jax_warps(monkeypatch)
    imgs, masks = blob_batch(b, h, w, seed)
    key = jax.random.PRNGKey(seed)
    ji, jm = JL.build_augmentation(JL._coerce_block(spec))(
        key, jnp.asarray(imgs), jnp.asarray(masks))
    aug = TL.build_augmentation(spec)
    assert port_warps(aug, h, w) == ran
    draws = jax_draws(aug, key, b, h, w)
    K.reset_launches()
    ti, tm = aug.apply(draws, torch.from_numpy(imgs), torch.from_numpy(masks))
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}    # on the CPU
    return (imgs, masks, np.asarray(ji), np.asarray(jm), ti.numpy(),
            tm.numpy(), ran, draws)


@pytest.mark.parametrize("hw", [(64, 64), (48, 64)], ids=["64x64", "48x64"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_combinators_match_jax(case, hw, monkeypatch):
    spec, warps = CASES[case]
    imgs, masks, ji, jm, ti, tm, ran, draws = run_both(spec, B, *hw, 7,
                                                       monkeypatch)
    assert ran == warps, ran
    assert ti.shape == ji.shape and tm.shape == jm.shape
    np.testing.assert_allclose(ti, ji, atol=WARP_ATOL, rtol=0)
    np.testing.assert_array_equal(tm, jm)
    assert not np.array_equal(ti, imgs.astype(np.float32))


@pytest.mark.parametrize("name", ["sometimes", "oneof", "someof"])
def test_selectors_split_the_batch(name, monkeypatch):
    """Each selector, on the reference's draws, keeps its child's output
    on some images and the input on the others (photometric children, so
    the images tell which ran)."""
    spec = {"sometimes": {"Sometimes": {"p": 0.5, "then": [{"Add": 50}]}},
            "oneof": {"OneOf": [{"Add": 50}, {"Noop": None}]},
            "someof": {"SomeOf": {"n": 1, "children": [{"Add": 50},
                                                       {"Noop": None}]}}}
    imgs, masks, ji, jm, ti, tm, _, draws = run_both(
        [spec[name]], 8, 16, 16, 1, monkeypatch)
    np.testing.assert_allclose(ti, ji, atol=1e-3, rtol=0)
    moved = (ti != imgs).reshape(8, -1).any(1)
    assert 0 < moved.sum() < 8, moved
    want = {"sometimes": lambda d: d["sel"],
            "oneof": lambda d: d["choice"] == 0,
            "someof": lambda d: TL.build_augmentation([spec[name]])
            .segments[0].include(d)[:, 0]}[name](draws[0])
    np.testing.assert_array_equal(moved, want.numpy())


def test_someof_keeps_exactly_n(monkeypatch):
    """SomeOf's ranks of uniform scores keep exactly n children an image
    (n drawn per image in [lo, min(hi, children)])."""
    aug = TL.build_augmentation({"SomeOf": {"n": [1, 9], "children": [
        {"Add": 1}, {"Add": 2}, {"Add": 4}, {"Add": 8}]}})
    seg = aug.segments[0]
    assert (seg.n_lo, seg.n_hi) == (1, 4)
    draws = aug.sample(torch.Generator().manual_seed(0), 64, 8, 8)
    keep = seg.include(draws[0])
    np.testing.assert_array_equal(keep.sum(1).numpy(),
                                  draws[0]["n"].numpy())
    imgs = torch.zeros((64, 8, 8, 3), dtype=torch.uint8)
    out, _ = aug.apply(draws, imgs, torch.zeros((64, 8, 8, 1)))
    bits = (keep.float() * torch.tensor([1.0, 2.0, 4.0, 8.0])).sum(1)
    np.testing.assert_array_equal(out[:, 0, 0, 0].numpy(), bits.numpy())


def test_train_photo_block_parses_as_jax(monkeypatch):
    """The block through both configs: the same normalised entries (the
    combinators' children validated and normalised recursively), and the
    port's augmentation from its config equals the JAX one's on the same
    draws (the reference's kernels in interpret mode)."""
    interpret_kernels(monkeypatch)
    d = {"augmentation": TRAIN_PHOTO_BLOCK, "shape": [64, 64, 3]}
    jcfg, tcfg = JC.parse_dict(d), TC.parse_dict(d)
    assert tcfg.augmentation == jcfg.augmentation
    assert tcfg.to_dict() == jcfg.to_dict()
    assert [a["name"] for a in tcfg.augmentation] == [
        "Fliplr", "Rotate", "Sometimes", "OneOf", "SomeOf", "Resize"]
    imgs, masks = blob_batch(B, 64, 64, 9)
    key = jax.random.PRNGKey(9)
    ji, jm = JL.build_augmentation(jcfg.augmentation)(
        key, jnp.asarray(imgs), jnp.asarray(masks))
    aug = TL.build_augmentation(tcfg.augmentation)
    ti, tm = aug.apply(jax_draws(aug, key, B, 64, 64), torch.from_numpy(imgs),
                       torch.from_numpy(masks))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=WARP_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("block", [
    [{"Sometimes": {"p": 0.3, "then_list": [{"Add": 5}],
                    "otherwise": [{"Rotate": 5}]}}],
    [{"Sometimes": {"children": {"Fliplr": 1.0}}}],
    [{"OneOf": ["Noop", {"Add": 3}, [{"Flipud": 0.5}, {"Cutout": 2}]]}],
    [{"SomeOf": {"n": [1, 2], "children": [{"Dropout": 0.1}, "Invert",
                                           [{"ShearX": 5}]]}}],
    [{"SomeOf": {"n": 1, "children": [{"OneOf": [{"Salt": 0.1},
                                                 {"Pepper": 0.1}]}]}}],
], ids=["aliases", "children-key", "oneof-forms", "someof-forms", "nested"])
def test_combinator_blocks_normalise_as_jax(block):
    d = {"augmentation": block}
    assert TC.parse_dict(d).to_dict() == JC.parse_dict(d).to_dict()


@pytest.mark.parametrize("block,exc,match", [
    ([{"Sometimes": {"p": 0.5, "then": [{"Fliplrr": 0.5}]}}], "config",
     "Did you mean 'Fliplr'"),
    ([{"OneOf": [{"Add": 5}, {"Voronoi": {}}]}], "config",
     "intentionally does not lower"),
    ([{"SomeOf": {"n": 1, "children": [{"pillike.Equalize": None}]}}],
     "config", "intentionally does not lower"),
    ([{"Sometimes": {"p": 0.5, "then": [{"Affine": {"mode": "edge"}}]}}],
     "config", "mode='constant'"),
    ([{"Sometimes": {"p": 0.5}}], "config", "neither a then"),
    ([{"Sometimes": 0.5}], "config", "Sometimes expects"),
    ([{"OneOf": {"Add": 5}}], "config", "unknown argument 'Add'"),
    ([{"OneOf": []}], "config", "OneOf expects"),
    ([{"SomeOf": [{"Add": 5}]}], "config", "SomeOf expects"),
    ([{"SomeOf": {"n": 1, "then": [{"Add": 5}]}}], "config",
     "SomeOf expects"),
    ([{"SomeOf": {"n": 1, "random_order": True, "children": []}}], "config",
     "random_order"),
], ids=["child-typo", "child-known-unsupported", "child-prefix",
        "child-value-check", "no-child", "sometimes-scalar", "oneof-dict",
        "oneof-empty", "someof-list", "someof-then-only", "random-order"])
def test_combinator_refusals_match_jax(block, exc, match):
    with pytest.raises(JC.ConfigError, match=match):
        JC.parse_dict({"augmentation": block})
    with pytest.raises(TC.ConfigError, match=match):
        TC.parse_dict({"augmentation": block})


@pytest.mark.parametrize("block", [
    [{"Sometimes": {"p": 0.5, "then": [{"Fog": None}]}}],
    [{"OneOf": [{"Add": 5}, {"Clouds": None}]}],
    [{"SomeOf": {"n": 1, "children": [{"WithChannels": {
        "channels": [0], "children": [{"Fog": None}]}}]}}],
], ids=["sometimes", "oneof", "someof"])
def test_unported_children_fail_at_parse(block):
    """Child names the port refused at parse before they were ported
    (Fog, Clouds) parse as in the JAX package, and the block builds."""
    d = {"augmentation": block}
    cfg = TC.parse_dict(d)
    assert cfg.to_dict() == JC.parse_dict(d).to_dict()
    TL.build_augmentation(cfg.augmentation)


def test_sample_nests_the_children_draws():
    aug = TL.build_augmentation(TRAIN_PHOTO_BLOCK)
    draws = aug.sample(torch.Generator().manual_seed(4), 16, 64, 64)
    assert len(draws) == len(aug.segments) == 5
    geo, some, one, many, resize = draws
    assert set(some) == {"sel", "children"} and len(some["children"]) == 1
    assert some["sel"].dtype == torch.bool
    assert set(one) == {"choice", "children"} and len(one["children"]) == 3
    assert int(one["choice"].max()) <= 2
    assert set(many) == {"n", "scores", "children"}
    assert int(many["n"].min()) >= 0 and int(many["n"].max()) <= 2
    assert tuple(many["scores"].shape) == (16, 4) and resize == {}
    imgs, masks = blob_batch(16, 64, 64)
    ti, tm = aug.apply(draws, torch.from_numpy(imgs), torch.from_numpy(masks))
    assert ti.shape == (16, 64, 64, 3) and tm.shape == (16, 64, 64, 1)
    assert float(ti.min()) >= 0.0 and float(ti.max()) <= 255.0
