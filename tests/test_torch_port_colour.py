"""The colour augmenters and the channel / colourspace scopes of the port
against the JAX lowering, on the same draws (made with jax.random along
the reference's key splits: tests/torch_port_util.py:_jax_photo_draw and
_jax_scope_draw), and their parsing and refusals against the JAX config's
and lowering's.

Each name runs alone in its forms (bare ``Name:``, a scalar, a [lo, hi]
range, a dict) at 48×64, B4, on uint8 images of a reduced and uneven
range (so Autocontrast and the equalisations move every channel); at 128²
the histogram names and the scopes in every form, the others in one.
The JAX side runs every case of a shape in one jitted function
(``jax_outputs``, module-scoped).

Tolerances:
  * images within 1e-3 on the 0..255 scale (f32 ``pow`` and ``log`` of
    the colour temperature and the HSV division differ by ulps between
    the two libraries); masks exactly equal and untouched;
  * HistogramEqualization and Autocontrast (integer-valued inputs, the
    same float32 operations on integer counts, a rounded LUT or the
    same stretch): exactly equal;
  * CLAHE: exactly equal to the reference's ``clahe`` run op by op (on
    the lowering's draws), in both of its interpolation branches
    (``_clahe_apply_blocked`` when both half-tiles are whole,
    ``_clahe_apply_gather`` otherwise: the port computes each pixel's
    tile weight as the branch for the frame does).  The reference's
    jitted lowering contracts products and sums of the four-tap blend
    into fused multiply-adds, so where the blend lands on .5 its
    rounding flips: its jitted and op-by-op runs differ by one gray
    level on a fraction of a percent of values where the tile weights
    are not binary fractions (48×64, and any padded frame).  Against
    the jitted lowering the port is held within 1 gray level, with every
    value that differs one where the reference's two runs differ too; at
    128² and 8×8 (16-px tiles, every blend weight a multiple of 1/32) the
    jitted lowering itself is exact and the port equals it.  Both
    branches are covered: 48×64 and 128² at the default 8×8 grid (even
    tiles, blocked), 120×136 at 8×8 (reflect-101 padding, odd tiles,
    gather).
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

from torch_port_util import few_torch_threads, jax_draws  # noqa: F401

ATOL = 1e-3
B = 4
SEED = 3

# name → its forms: (id, args)
FORMS = {
    "Grayscale": [("bare", None), ("scalar", 0.7), ("range", [0.2, 1.0]),
                  ("dict", {"alpha": [0.0, 1.0]})],
    "AddToHueAndSaturation": [
        ("bare", None), ("scalar", 20), ("range", [-40, 40]),
        ("dict", {"value_hue": [-50, 50], "value_saturation": [-20, 20]})],
    # -100 moves H by -50: H = 20 wraps to 150
    "AddToHue": [("bare", None), ("scalar", -100), ("range", [-100, 100]),
                 ("dict", {"value": [-255, 255]})],
    "AddToSaturation": [("bare", None), ("scalar", 30), ("range", [-75, 75]),
                        ("dict", {"value": [-50, 10]})],
    "MultiplyHueAndSaturation": [
        ("bare", None), ("scalar", 1.2), ("range", [0.5, 1.5]),
        ("dict", {"mul_hue": [0.5, 1.5], "mul_saturation": [0.0, 2.0]})],
    "MultiplyHue": [("bare", None), ("scalar", -2.0), ("range", [-3, 3]),
                    ("dict", {"mul": [0.5, 2.0]})],
    "MultiplySaturation": [("bare", None), ("scalar", 2.0),
                           ("range", [0.0, 3.0]), ("dict", {"mul": [0.5, 1.5]})],
    "RemoveSaturation": [("bare", None), ("scalar", 0.5), ("range", [0.2, 1.0]),
                         ("dict", {"mul": 0.8})],
    "ChangeColorTemperature": [("bare", None), ("scalar", 4000),
                               ("range", [1000, 11000]),
                               ("dict", {"kelvin": [2000, 20000]})],
    # the bare form is the colourspace's name
    "ChangeColorspace": [
        ("scalar", "HSV"), ("range", {"to_colorspace": "HLS",
                                      "alpha": [0.2, 1.0]}),
        ("dict-rgb", {"to_colorspace": "RGB"}),
        ("dict-bgr", {"to_colorspace": "BGR", "alpha": 0.5}),
        ("dict-gray", {"to_colorspace": "GRAY"}),
        ("dict-ycrcb", {"to_colorspace": "YCrCb", "alpha": [0.5, 1.0]})],
    "Autocontrast": [("bare", None), ("scalar", 2), ("dict", {"cutoff": 5}),
                     ("dict-zero", {"cutoff": 0, "per_channel": True})],
    "auto_contrast": [("scalar", 3)],
    "HistogramEqualization": [("bare", None), ("dict", {})],
    "AllChannelsHistogramEqualization": [("bare", None)],
    # other grids: test_clahe_takes_both_reference_branches
    "CLAHE": [("bare", None), ("scalar", 4), ("range", [1, 10]),
              ("dict", {"clip_limit": [2, 6], "tile_grid_size": 8}),
              ("dict-noclip", {"clip_limit": 0})],
    "AllChannelsCLAHE": [("dict", {"clip_limit": 3,
                                   "tile_grid_size_px": 8})],
}
EXACT = {"histogramequalization", "allchannelshistogramequalization",
         "autocontrast", "auto_contrast"}
CLAHE = {"clahe", "allchannelsclahe"}

# cases that leave every image as it was
MAY_KEEP = {"ChangeColorspace-dict-rgb"}

SCOPES = {
    "withchannels": [{"WithChannels": {"channels": [0, 2], "children": [
        {"Add": 30}, {"Multiply": [0.8, 1.2]}]}}],
    "withchannels-then-colour": [{"WithChannels": {"channels": 1, "then": {
        "Grayscale": [0.5, 1.0]}}}],
    "withhueandsaturation": [{"WithHueAndSaturation": {"children": [
        {"Add": {"value": [-40, 40], "per_channel": True}}]}}],
    "withhueandsaturation-histeq": [{"WithHueAndSaturation": {"then": {
        "HistogramEqualization": None}}}],
    "withbrightnesschannels": [{"WithBrightnessChannels": {"children": [
        {"Add": [-60, 60]}, {"LinearContrast": [0.5, 1.5]}]}}],
    "withcolorspace": [{"WithColorspace": {"to_colorspace": "HSV",
                                           "children": [
        {"Add": {"value": [-30, 30], "per_channel": True}},
        {"Multiply": [0.7, 1.3]}]}}],
    "scopes-in-a-block": [
        {"Add": 5},
        {"WithColorspace": {"to_colorspace": "hsv", "children": {
            "Multiply": {"mul": [0.5, 1.5], "per_channel": True}}}},
        {"WithChannels": {"channels": [0], "children": {"Invert": 1.0}}},
        {"Sometimes": {"p": 0.5, "then": [{"WithHueAndSaturation": {
            "children": {"Add": [-90, 90]}}}]}}],
}

CASES = ([(f"{n}-{f}", {n: a}) for n, forms in FORMS.items()
          for f, a in forms] + list(SCOPES.items()))
# every case at 48×64; at 128² the histogram names' and the scopes' cases
# and each other name's first form (the elementwise names do not care
# about the frame)
_SIZED = {"histogramequalization", "allchannelshistogramequalization",
          "autocontrast", "auto_contrast", "clahe", "allchannelsclahe"}
RUNS = [(c, s, (48, 64)) for c, s in CASES] + [
    (c, s, (128, 128)) for c, s in CASES
    if c in SCOPES or c.split("-")[0].lower() in _SIZED
    or c == f"{c.split('-')[0]}-{FORMS[c.split('-')[0]][0][0]}"]


def colour_batch(b, h, w, seed=0):
    """uint8 images on an uneven range per channel (a gradient plus noise,
    one channel of some images constant) and one-channel disc masks."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    imgs = np.empty((b, h, w, 3), np.float64)
    for i in range(b):
        for c in range(3):
            lo, span = r.uniform(20, 90), r.uniform(60, 140)
            imgs[i, ..., c] = (lo + span * (0.5 * (yy + xx) * r.uniform(0.5, 1)
                                            + 0.5 * r.rand(h, w)))
    imgs[0, ..., 2] = 77.0
    masks = ((yy - 0.4) ** 2 + (xx - 0.35) ** 2 < 0.06)
    masks = np.broadcast_to(masks[None, ..., None], (b, h, w, 1))
    return np.clip(imgs, 0, 255).astype(np.uint8), masks.astype(np.float32)


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

            imgs, masks = colour_batch(B, *hw, SEED)
            outs = jax.jit(run_all)(jax.random.PRNGKey(SEED),
                                    jnp.asarray(imgs), jnp.asarray(masks))
            cache[hw] = {case: (np.asarray(i), np.asarray(m))
                         for (case, _), (i, m) in zip(cases, outs)}
        return cache[hw]

    return get


def _run_port(spec, b, h, w, seed):
    imgs, masks = colour_batch(b, h, w, seed)
    aug = TL.build_augmentation(spec)
    ti, tm = aug.apply(jax_draws(aug, jax.random.PRNGKey(seed), b, h, w),
                       torch.from_numpy(imgs), torch.from_numpy(masks))
    return imgs, masks, ti.numpy(), tm.numpy()


def _op_by_op(spec, b, h, w, seed):
    """The reference's ``clahe`` on the lowering's draws, op by op (each
    jnp operation compiled alone: no fusion across them)."""
    from segmentation_training_pipeline_tpu.ops.aug import photometric as JP

    imgs, _ = colour_batch(b, h, w, seed)
    aug = TL.build_augmentation(spec)
    d = jax_draws(aug, jax.random.PRNGKey(seed), b, h, w)[0]
    out = JP.clahe(jnp.asarray(imgs, jnp.float32),
                   jnp.asarray(d["clip_limit"].numpy()),
                   TL._clahe_grid(aug.segments[0].args))
    return np.clip(np.asarray(out), 0.0, 255.0)


def _hold(name, ti, ji, spec=None, shape=None):
    if name in EXACT:
        np.testing.assert_array_equal(ti, ji)
    elif name in CLAHE and shape[1:3] == (128, 128):
        # 16-px tiles: every blend weight is a multiple of 1/32, exact
        np.testing.assert_array_equal(ti, ji)
    elif name in CLAHE:
        je = _op_by_op(spec, *shape)
        np.testing.assert_array_equal(ti, je)
        np.testing.assert_allclose(ti, ji, atol=1.0, rtol=0)
        assert np.array_equal(ti != ji, je != ji)
    else:
        np.testing.assert_allclose(ti, ji, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case,spec,hw", RUNS,
                         ids=[f"{c}-{h}x{w}" for c, _, (h, w) in RUNS])
def test_each_name_and_scope_matches_jax(case, spec, hw, jax_outputs):
    ji, jm = jax_outputs(hw)[case]
    imgs, masks, ti, tm = _run_port(spec, B, *hw, SEED)
    assert ti.dtype == np.float32 and ti.shape == ji.shape == imgs.shape
    name = next(iter(spec[0] if isinstance(spec, list) else spec)).lower()
    _hold(name, ti, ji, spec, (B, *hw, SEED))
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tm, masks)
    if case not in MAY_KEEP:
        assert not np.array_equal(ti, imgs.astype(np.float32)), case


@pytest.mark.parametrize("spec,hw,branch", [
    ({"CLAHE": {"clip_limit": [1, 10]}}, (120, 136), "gather"),
    ({"AllChannelsCLAHE": 2}, (48, 64), "blocked"),
], ids=["120x136-grid8", "48x64-grid8"])
def test_clahe_takes_both_reference_branches(spec, hw, branch, monkeypatch):
    """120×136 at 8×8 pads to 15×17 tiles (odd: the reference's gather
    branch), 48×64 at 8×8 gives 6×8 tiles (even: its blocked branch).
    The branch the reference takes
    is recorded on its side (its ``clahe`` run op by op); the port
    equals each exactly."""
    from segmentation_training_pipeline_tpu.ops.aug import photometric as JP

    ran = []
    for nm in ("blocked", "gather"):
        real = getattr(JP, f"_clahe_apply_{nm}")
        monkeypatch.setattr(JP, f"_clahe_apply_{nm}",
                            lambda *a, _r=real, _n=nm: ran.append(_n)
                            or _r(*a))
    want = _op_by_op(spec, B, *hw, 9)
    assert ran == [branch]
    imgs, masks, ti, tm = _run_port(spec, B, *hw, 9)
    np.testing.assert_array_equal(ti, want)
    np.testing.assert_array_equal(tm, masks)
    assert not np.array_equal(ti, imgs.astype(np.float32))


def test_hue_wraps_on_negatives():
    """H − 50 at H = 20 is 150, not −30 (``torch.remainder``, as
    ``jnp.mod``): a pure hue-20 pixel under AddToHue −100."""
    from segmentation_training_pipeline_tpu_torch.ops.aug import (
        photometric as TP)

    px = TP.hsv_to_rgb(torch.tensor([[[20.0]]]), torch.tensor([[[255.0]]]),
                       torch.tensor([[[200.0]]]))                # (1,1,1,3)
    out = TP.add_to_hue_and_saturation(px, torch.tensor([-100.0]),
                                       torch.tensor([0.0]))
    h, s, v = TP.rgb_to_hsv(out)
    assert abs(float(h) - 150.0) < 1e-3 and float(s) == 255.0


def test_no_histogram_builds_a_bin_axis_per_pixel():
    """The counts are one ``scatter_add_`` and the lookups gathers: no
    tensor that the histogram names make holds more than twice the
    image's elements (the reference's compare-reduce form holds 256×),
    seen by every PyTorch operation's output at 64² B2 (CLAHE at 4×4)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from segmentation_training_pipeline_tpu_torch.ops.aug import (
        photometric as TP)

    class Biggest(TorchDispatchMode):
        most = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else [out]):
                if isinstance(t, torch.Tensor):
                    Biggest.most = max(Biggest.most, t.numel())
            return out

    x = torch.from_numpy(colour_batch(2, 64, 64)[0]).float()
    with Biggest():
        outs = [TP.histogram_equalization(x), TP.autocontrast(x, 2.0),
                TP.clahe(x, torch.tensor([2.0, 4.0]), 4)]
    assert all(o.shape == x.shape for o in outs)
    assert 0 < Biggest.most <= 2 * x.numel()


def test_ports_draws_have_the_reference_entries():
    """The port's own sampler (from a torch.Generator, as the train step
    draws) gives every new name and scope the entries, shapes and
    kinds the reference's draws have."""
    for case, spec in CASES:
        aug = TL.build_augmentation(spec)
        port = aug.sample(torch.Generator().manual_seed(1), B, 8, 8, 3)
        ref = jax_draws(aug, jax.random.PRNGKey(1), B, 8, 8)
        _same_tree(port, ref, case)


def _same_tree(p, r, where):
    if isinstance(r, dict):
        assert set(p) == set(r), where
        for k in r:
            _same_tree(p[k], r[k], f"{where}.{k}")
    elif isinstance(r, list):
        assert len(p) == len(r), where
        for i, (a, b) in enumerate(zip(p, r)):
            _same_tree(a, b, f"{where}[{i}]")
    else:
        assert tuple(p.shape) == tuple(r.shape), where
        assert (p.dtype == torch.bool) == (r.dtype == torch.bool), where


PARSE_BLOCKS = [spec for _, spec in SCOPES.items()] + [
    [{"Grayscale": [0.0, 1.0]}, {"AllChannelsCLAHE": {"clip_limit": 2}},
     {"AutoContrast": {"cutoff": 1}}, {"ChangeColorspace": "YCrCb"}],
]


@pytest.mark.parametrize("block", PARSE_BLOCKS,
                         ids=[f"block{i}" for i in range(len(PARSE_BLOCKS))])
def test_blocks_normalise_as_jax(block):
    d = {"augmentation": block}
    assert TC.parse_dict(d).to_dict() == JC.parse_dict(d).to_dict()


# the reference lowering's ValueErrors under the scopes
LOWERING_REFUSALS = {
    "withchannels-no-channels": (
        {"WithChannels": {"children": {"Add": 5}}}, "WithChannels needs"),
    "withchannels-geometric": (
        {"WithChannels": {"channels": [0], "children": {"Fliplr": 1.0}}},
        "only photometric children"),
    "withchannels-sugar": (
        {"WithChannels": {"channels": [0], "children": [{"Rotate": 10}]}},
        "child 'Affine': only photometric"),
    "withchannels-meta": (
        {"WithChannels": {"channels": [0], "children": [
            {"Sometimes": {"p": 0.5, "then": {"Add": 5}}}]}},
        "only photometric children"),
    "withchannels-joint": (
        {"WithChannels": {"channels": [1], "children": {"Jigsaw": None}}},
        "child 'Jigsaw': only photometric"),
    "withhueandsaturation-rgb-only": (
        {"WithHueAndSaturation": {"children": {"Grayscale": 1.0}}},
        "assumes an RGB image, but WithHueAndSaturation children see 2"),
    "withbrightnesschannels-rgb-only-unported": (
        {"WithBrightnessChannels": {"children": {
            "FastSnowyLandscape": None}}},
        "assumes an RGB image, but WithBrightnessChannels children see 1"),
    "withcolorspace-lab": (
        {"WithColorspace": {"to_colorspace": "Lab", "children": {"Add": 5}}},
        r"lowers only \{to_colorspace: HSV\}"),
    "withcolorspace-blend": (
        {"WithColorspace": {"to_colorspace": "HSV", "children": {
            "BlendAlpha": {"factor": 0.5, "foreground": {"Add": 5}}}}},
        "child 'BlendAlpha': only photometric"),
    "withhueandsaturation-empty": (
        {"WithHueAndSaturation": {}}, "needs a"),
    "changecolorspace-bare": (
        {"ChangeColorspace": None}, "to_colorspace must be one static"),
}


@pytest.mark.parametrize("spec,match", list(LOWERING_REFUSALS.values()),
                         ids=list(LOWERING_REFUSALS))
def test_lowering_refusals_match_jax(spec, match):
    """The reference raises when its block is built or traced, the port
    when it is built: the same ValueError (FastSnowyLandscape, Jigsaw
    and BlendAlpha among the children refused)."""
    imgs, masks = colour_batch(1, 16, 16)
    with pytest.raises(ValueError, match=match) as j:
        JL.build_augmentation(JL._coerce_block(spec))(
            jax.random.PRNGKey(0), jnp.asarray(imgs), jnp.asarray(masks))
    with pytest.raises(ValueError, match=match) as t:
        TL.build_augmentation(spec)
    assert str(t.value) == str(j.value)


# what the reference's lowering refuses, the port's parse refuses with its
# text (the reference parses these and raises when the block is built)
PARSE_REFUSALS = ["withchannels-geometric", "withchannels-sugar",
                  "withchannels-meta", "withchannels-joint",
                  "withhueandsaturation-rgb-only",
                  "withbrightnesschannels-rgb-only-unported",
                  "withcolorspace-blend"]


@pytest.mark.parametrize("case", PARSE_REFUSALS)
def test_parse_refuses_scoped_children_as_jax_lowering(case):
    spec, match = LOWERING_REFUSALS[case]
    cfg = JC.parse_dict({"augmentation": spec})
    imgs, masks = colour_batch(1, 16, 16)
    with pytest.raises(ValueError) as j:
        JL.build_augmentation(JL._coerce_block(cfg.augmentation))(
            jax.random.PRNGKey(0), jnp.asarray(imgs), jnp.asarray(masks))
    with pytest.raises(ValueError) as t:
        TC.parse_dict({"augmentation": spec})
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("spec,match", [
    ({"WithChannels": {"children": {"Add": 5}}}, "WithChannels expects"),
    ({"WithColorspace": {"to_colorspace": "Lab", "children": {"Add": 5}}},
     r"lowers only \{to_colorspace: HSV\}"),
    ({"WithBrightnessChannels": {"to_colorspace": "HSV"}}, "to_colorspaces"),
    ({"WithHueAndSaturation": {}}, "needs a children"),
    ({"WithHueAndSaturation": 0.5}, "expects"),
    ({"ChangeColorspace": {"to_colorspace": "Lab"}}, "one static name"),
    ({"WithChannels": {"channels": [0], "children": {"Addd": 5}}},
     "Did you mean 'Add'"),
], ids=["withchannels-no-channels", "withcolorspace-lab", "key-typo",
        "no-children", "scalar", "changecolorspace-lab", "child-typo"])
def test_config_refusals_match_jax(spec, match):
    with pytest.raises(JC.ConfigError, match=match) as j:
        JC.parse_dict({"augmentation": spec})
    with pytest.raises(TC.ConfigError, match=match) as t:
        TC.parse_dict({"augmentation": spec})
    assert str(t.value) == str(j.value)


def test_unported_scoped_child_is_refused_after_the_reference_checks():
    """A photometric child the port refused before it was ported (Fog
    under WithChannels) parses and builds in both packages, and the
    scope splices the child's channel 0 back as the reference does."""
    block = {"WithChannels": {"channels": [0], "children": {
        "Fog": None}}}
    d = {"augmentation": block}
    assert TC.parse_dict(d).to_dict() == JC.parse_dict(d).to_dict()
    imgs, masks = colour_batch(2, 16, 16)
    key = jax.random.PRNGKey(0)
    ji, _ = JL.build_augmentation(JL._coerce_block(block))(
        key, jnp.asarray(imgs), jnp.asarray(masks))
    aug = TL.build_augmentation(block)
    ti, tm = aug.apply(jax_draws(aug, key, 2, 16, 16), torch.from_numpy(imgs),
                       torch.from_numpy(masks))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-3, rtol=0)
    assert np.array_equal(ti.numpy()[..., 1:], imgs[..., 1:].astype(
        np.float32))
