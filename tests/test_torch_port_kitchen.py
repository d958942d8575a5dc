"""``examples/kitchen_sink.yaml`` in the port: its parse against the JAX
config's, and its whole augmentation block (the geometric run, Sometimes,
the four blends, WithChannels, ReplaceElementwise, OneOf, the SomeOf of
13 names among them Fog, Superpixels, Canny, Cartoon and MeanShiftBlur)
at 128², B2, held to the JAX lowering on the same draws, its
PadToFixedSize and CenterCropToFixedSize scaled from the 384² frame as
``tests/test_torch_port_geo.py:kitchen_sink_geo`` scales them.

One jitted JAX function returns the block's output (JAX's
``build_augmentation``) and every segment's output along the way (the
reference's segment functions, keyed as its ``aug_fn`` keys them).  Each
port segment then runs on the JAX chain's input to it, so that a
difference in one segment does not reach the next:
  * the geometric run (the exact gather): images within 1e-2 (the geo
    tests' bound; 2.2e-3 measured), mask values off at most 1e-4 (a
    nearest-sample tie of the float32 geometry, where sin, cos and the
    matrix products round apart, would flip one; none here);
  * every other segment: images within 1e-3 (1.4e-4 measured), masks
    equal, except the SomeOf, whose Superpixels, Canny and JPEG can flip
    at ties: a share of values off by more than 1e-3 at most 1% (0
    measured).
The port's whole chain against JAX's block on its own: values within
1e-2 but for at most 1e-3 of them (2.1e-3 at most measured: the gather's
float32 differences pass through the chain; a JPEG rounding or a
SomeColors hue bin they move would land beyond), masks off at most 1e-4
(none measured).
"""

import copy
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from segmentation_training_pipeline_tpu import config as JC
from segmentation_training_pipeline_tpu.ops.aug import lowering as JL
from segmentation_training_pipeline_tpu_torch import config as TC
from segmentation_training_pipeline_tpu_torch.ops.aug import lowering as TL

from torch_port_util import few_torch_threads, jax_draws  # noqa: F401

YAML = os.path.join(os.path.dirname(__file__), "..", "examples",
                    "kitchen_sink.yaml")
SIDE = 128
B = 2
SEED = 7


def kitchen_block(side):
    """The YAML's augmentation block, the fixed sizes scaled to ``side``."""
    with open(YAML) as f:
        block = yaml.safe_load(f)["augmentation"]
    block = copy.deepcopy(block)
    pad, crop = round(420 * side / 384), round(352 * side / 384)
    block["PadToFixedSize"].update(width=pad, height=pad)
    block["CenterCropToFixedSize"].update(width=crop, height=crop)
    return block


def kitchen_batch(b, side, seed):
    """uint8 images (a gradient, discs of other colours, noise) and 4-class
    one-hot masks (the YAML's classes; BlendAlphaSegMapClassIds reads
    classes 1 and 2)."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:side, 0:side] / side
    imgs = np.empty((b, side, side, 3))
    cls = np.zeros((b, side, side), int)
    for i in range(b):
        imgs[i] = r.uniform(30, 120, 3) + 90.0 * (0.5 * yy + 0.5 * xx)[
            ..., None]
        for k in (1, 2, 3):
            cy, cx, rad = r.uniform(0.2, 0.8, 2).tolist() + [r.uniform(
                0.1, 0.2)]
            disc = (yy - cy) ** 2 + (xx - cx) ** 2 < rad ** 2
            imgs[i][disc] = r.uniform(40, 250, 3)
            cls[i][disc] = k
        imgs[i] += r.normal(0, 5, (side, side, 3))
    return (np.clip(imgs, 0, 255).astype(np.uint8),
            np.eye(4, dtype=np.float32)[cls])


def test_kitchen_sink_parses_as_jax():
    """The port's parse of the unchanged file: every key as JAX's, the
    augmentation entries (children normalised) equal, and the block and
    the ``transforms:`` build."""
    t, j = TC.parse(YAML), JC.parse(YAML)
    assert t.augmentation == j.augmentation
    assert t.to_dict() == j.to_dict()
    aug, transform = TL.build_transform_fn(t.transforms, t.augmentation)
    assert [type(s).__name__ for s in aug.segments] == [
        "_GeoRun", "_Meta", "_Blend", "_Blend", "_Scope", "_Photo", "_Meta",
        "_Meta", "_Blend", "_Blend"]
    assert aug.segments[0].route(384, 384) == "gather"
    imgs, masks = kitchen_batch(1, 32, 0)
    gi, gm = transform(torch.from_numpy(imgs), torch.from_numpy(masks))
    assert torch.equal(gi[..., 0], gi[..., 2]) and torch.equal(
        gm, torch.from_numpy(masks))                 # Grayscale: 1.0


def _jax_segments(aug, specs):
    """The reference's segment functions of the block, built as its
    ``build_augmentation`` builds them, in the port's grouping."""
    fns, j = [], 0
    for i, seg in enumerate(aug.segments):
        if isinstance(seg, TL._GeoRun):
            fns.append(JL._make_geo_run(specs[j:j + len(seg.geo)],
                                        integer_input=i == 0))
            j += len(seg.geo)
        elif isinstance(seg, TL._Photo):
            fns.append(functools.partial(JL._apply_photo, specs[j]))
            j += 1
        else:
            fns.append(JL._make_meta(specs[j], integer_input=i == 0))
            j += 1
    assert j == len(specs)
    return fns


@pytest.fixture(scope="module")
def kitchen():
    """The port's block, its draws, the batch, and JAX's block output and
    chain of segment outputs from one jitted function."""
    block = kitchen_block(SIDE)
    cfg = TC.parse_dict({"augmentation": block})
    assert cfg.augmentation == JC.parse_dict(
        {"augmentation": block}).augmentation
    aug = TL.build_augmentation(cfg.augmentation)
    specs = JL._coerce_block(cfg.augmentation)
    fns = _jax_segments(aug, specs)
    block_fn = JL.build_augmentation(specs)

    def run(key, imgs, masks):
        chain, x, m = [], imgs, masks
        for fn, k in zip(fns, jax.random.split(key, len(fns))):
            x, m = fn(k, x, m)
            chain.append((x.astype(jnp.float32), m))
        return block_fn(key, imgs, masks), chain

    imgs, masks = kitchen_batch(B, SIDE, SEED)
    key = jax.random.PRNGKey(SEED)
    (ji, jm), chain = jax.jit(run)(key, jnp.asarray(imgs),
                                   jnp.asarray(masks))
    chain = [(np.asarray(x), np.asarray(m)) for x, m in chain]
    return dict(aug=aug, imgs=imgs, masks=masks,
                draws=jax_draws(aug, key, B, SIDE, SIDE),
                block=(np.asarray(ji), np.asarray(jm)), chain=chain)


def test_jax_chain_is_jax_block(kitchen):
    """The reference's segments chained as its ``aug_fn`` chains them end
    at its block's output (so the per-segment inputs below are the
    block's own)."""
    ji, jm = kitchen["block"]
    x, m = kitchen["chain"][-1]
    np.testing.assert_array_equal(np.clip(x, 0.0, 255.0), ji)
    np.testing.assert_array_equal(m, jm)


@pytest.mark.parametrize("i", range(10))
def test_each_kitchen_segment_matches_jax(i, kitchen):
    aug, chain = kitchen["aug"], kitchen["chain"]
    seg = aug.segments[i]
    x, m = ((kitchen["imgs"], kitchen["masks"]) if i == 0
            else chain[i - 1])
    ti, tm = seg.apply(kitchen["draws"][i], torch.from_numpy(np.array(x)),
                       torch.from_numpy(np.array(m)))
    ti, tm = ti.float().numpy(), tm.numpy()
    ji, jm = chain[i]
    assert ti.shape == ji.shape and tm.shape == jm.shape
    if isinstance(seg, TL._GeoRun):
        assert seg.route(SIDE, SIDE) == "gather"
        np.testing.assert_allclose(ti, ji, atol=1e-2, rtol=0)
        assert (tm != jm).mean() <= 1e-4
        return
    off = np.abs(ti - ji) > 1e-3
    if getattr(seg, "name", "") == "someof":
        assert off.mean() <= 1e-2, off.mean()
    else:
        assert not off.any(), np.abs(ti - ji).max()
    np.testing.assert_array_equal(tm, jm)


def test_kitchen_block_matches_jax(kitchen):
    """The port's whole block on its own chain against JAX's block."""
    ti, tm = kitchen["aug"].apply(kitchen["draws"],
                                  torch.from_numpy(kitchen["imgs"]),
                                  torch.from_numpy(kitchen["masks"]))
    ji, jm = kitchen["block"]
    ti, tm = ti.numpy(), tm.numpy()
    assert ti.shape == ji.shape and tm.shape == jm.shape
    assert (np.abs(ti - ji) > 1e-2).mean() <= 1e-3
    assert (tm != jm).mean() <= 1e-4
    assert ti.min() >= 0.0 and ti.max() <= 255.0
    assert not np.array_equal(ti, kitchen["imgs"].astype(np.float32))
