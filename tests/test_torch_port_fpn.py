"""The port's FPN + efficientnetb0 against the flax model on the same
weights, and its new layers one by one.

The weights are the flax model's ``init_model`` variables, carried over by
``models.bridge``.  Both sides compute in float32 at 2×64².  Tolerances:
logits within 1e-4 of the largest |logit| and the encoder taps within 1e-4
of each tap's largest value (summation order of the convolutions only);
updated BatchNorm statistics within 1e-5.  In train mode the DropPath keep
masks are the ones the flax model drew (``capture_drop_masks``).  The
small tests pin the hazards: depthwise 5×5/2 convs with XLA's asymmetric
SAME pad, BatchNorm momentum 0.99 and eps 1e-3, swish squeeze-excitation
with biases, nearest and bilinear ``jax.image.resize``, the width and depth
rounding of B0–B7.
"""

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import pytest
import torch

from segmentation_training_pipeline_tpu.models import factory as JF
from segmentation_training_pipeline_tpu.models import layers as JLY
from segmentation_training_pipeline_tpu.models.encoders import (
    build_encoder as j_build_encoder)
from segmentation_training_pipeline_tpu_torch.models import bridge as BR
from segmentation_training_pipeline_tpu_torch.models import factory as TF
from segmentation_training_pipeline_tpu_torch.models import layers as TLY
from segmentation_training_pipeline_tpu_torch.models.encoders import (
    ENCODERS, build_encoder)

from torch_port_util import capture_drop_masks, few_torch_threads

H = 64


@pytest.fixture(scope="module")
def models():
    jm = JF.create_model("FPN", "efficientnetb0", 1, dtype="float32")
    var = jax.tree.map(np.asarray, JF.init_model(jm, (H, H, 3), seed=0))
    tm = TF.create_model("FPN", "efficientnetb0", 1, dtype="float32")
    tm.load_state_dict(BR.state_dict_from_jax(var))
    return jm, var, tm


def test_bridge_round_trips_bit_exact(models):
    jm, var, tm = models
    sd = BR.state_dict_from_jax(var)
    assert set(sd) == set(tm.state_dict())
    back = BR.jax_from_state_dict(tm.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(var)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(var)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    n_jax = sum(x.size for x in jax.tree.leaves(var["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_jax
    # depthwise (k, k, 1, C) ↔ (C, 1, k, k); SE and lateral biases; names
    dw = var["params"]["encoder"]["stage2_block0"]["depthwise"]["kernel"]
    assert dw.shape == (5, 5, 1, 144)
    assert sd["encoder.stage2_block0.depthwise.weight"].shape == (144, 1, 5, 5)
    for name in ("encoder.stage1_block0.se.reduce.bias",
                 "encoder.stage1_block0.se.expand.bias",
                 "decoder.lat5.bias", "decoder.seg2_conv2.bn.running_var",
                 "decoder.merge_conv.conv.weight", "encoder.head_bn.weight",
                 "logits_conv.bias"):
        assert name in sd, name


def _drawn(b, seed=5):
    return jax.random.PRNGKey(seed)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_encoder_taps_match_flax(models, train):
    _, var, tm = models
    x = np.random.RandomState(1).randn(2, H, H, 3).astype(np.float32)
    je = j_build_encoder("efficientnetb0", dtype=jnp.float32)
    ev = {"params": var["params"]["encoder"],
          "batch_stats": var["batch_stats"]["encoder"]}
    masks = {}
    with capture_drop_masks(masks):
        if train:
            jt, _ = je.apply(ev, jnp.asarray(x), train=True,
                             mutable=["batch_stats"],
                             rngs={"dropout": _drawn(2)})
        else:
            jt = je.apply(ev, jnp.asarray(x), train=False)
    jax.effects_barrier()
    assert (len(masks) == 9) == train
    enc = tm.encoder
    names = dict(enc.named_modules())
    for n, m in masks.items():
        names[n].keep_mask = torch.from_numpy(m)
    try:
        with torch.no_grad():
            tt = enc(torch.from_numpy(x).permute(0, 3, 1, 2), train)
    finally:
        for n in masks:
            names[n].keep_mask = None
    assert enc.out_channels == [16, 24, 40, 112, 1280]
    assert len(tt) == len(jt) == 5
    for i, (a, b) in enumerate(zip(tt, jt)):
        b = np.asarray(b)
        a = a.permute(0, 2, 3, 1).numpy()
        assert a.shape == b.shape == (2, H >> (i + 1), H >> (i + 1),
                                      enc.out_channels[i])
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), i


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_flax(models, train):
    jm, var, tm = models
    x = np.random.RandomState(0).randn(2, H, H, 3).astype(np.float32)
    params, stats = TF.model_variables(tm)
    if train:
        masks = {}
        with capture_drop_masks(masks):
            jl, upd = jm.apply(var, jnp.asarray(x), train=True,
                               mutable=["batch_stats"],
                               rngs={"dropout": _drawn(2, 9)})
        jax.effects_barrier()
        drop = {n: torch.from_numpy(m) for n, m in masks.items()}
        assert set(drop) == set(tm.drop_paths())
        assert any(not m.all() for m in drop.values())  # something dropped
        tl, new_stats = TF.apply_model(tm, params, stats, torch.from_numpy(x),
                                       train=True, drop_masks=drop)
        want = BR.state_dict_from_jax(
            {"batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])})
        assert set(want) == set(new_stats)
        for k, v in want.items():
            np.testing.assert_allclose(new_stats[k].numpy(), v.numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=k)
    else:
        jl = jm.apply(var, jnp.asarray(x), train=False)
        tl = TF.apply_model(tm, params, stats, torch.from_numpy(x))
    jl = np.asarray(jl)
    assert tl.dtype == torch.float32 and tl.shape == jl.shape == (2, H, H, 1)
    err = np.abs(tl.detach().numpy() - jl).max() / np.abs(jl).max()
    assert err < 1e-4


def test_train_mode_needs_drop_masks(models):
    _, _, tm = models
    params, stats = TF.model_variables(tm)
    with pytest.raises(ValueError, match="drop-path"):
        TF.apply_model(tm, params, stats, torch.zeros(1, 32, 32, 3),
                       train=True)
    gen = torch.Generator().manual_seed(0)
    drop = tm.sample_drop_masks(gen, 64)
    rates = tm.drop_paths()
    assert list(drop) == list(rates) and len(drop) == 9
    for n, m in drop.items():
        assert m.dtype == torch.bool and m.shape == (64,)
    # the deepest identity block drops 0.2·15/16 of the examples on average
    assert 0.5 < float(drop["encoder.stage5_block3.drop_path"].float().mean()
                       ) < 0.95
    assert all(m.keep_mask is None for m in tm.modules()
               if isinstance(m, TLY.DropPath))


@pytest.mark.parametrize("n,k,s", [(64, 5, 2), (32, 3, 2), (33, 5, 2),
                                   (16, 5, 1)])
def test_depthwise_conv_matches_flax(n, k, s):
    """A 5×5/2 depthwise conv at an even size pads (1, 2), as XLA does."""
    r = np.random.RandomState(n + k)
    x = r.randn(2, n, n, 6).astype(np.float32)
    w = r.randn(k, k, 1, 6).astype(np.float32)
    conv = fnn.Conv(6, (k, k), (s, s), padding="SAME", use_bias=False,
                    feature_group_count=6)
    want = conv.apply({"params": {"kernel": jnp.asarray(w)}}, jnp.asarray(x))
    tc = TLY.Conv(6, 6, k, s, groups=6)
    with torch.no_grad():
        tc.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        got = tc(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert TLY.same_pads(64, 5, 2) == (1, 2)


def test_grouped_conv_init_fan_in():
    """flax's fan_in of a grouped conv is in/groups·k·k."""
    tc = TLY.Conv(96, 96, 5, groups=96)
    tc.reset_parameters(torch.Generator().manual_seed(0))
    assert tc.weight.shape == (96, 1, 5, 5)
    assert abs(float(tc.weight.detach().std()) * 5.0 - 1.0) < 0.1


def test_batchnorm_momentum_099():
    """EfficientNet's BatchNorm: running = 0.99·running + 0.01·batch with
    the biased variance, eps 1e-3."""
    r = np.random.RandomState(1)
    x = (r.randn(4, 5, 5, 3) * 3 + 2).astype(np.float32)
    mean0 = r.randn(3).astype(np.float32)
    var0 = (r.rand(3) + 0.5).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=1e-3)
    v = {"params": {"scale": jnp.ones(3), "bias": jnp.zeros(3)},
         "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    want, upd = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    tb = TLY.BatchNorm(3, momentum=0.99, eps=1e-3)
    with torch.no_grad():
        tb.running_mean.copy_(torch.from_numpy(mean0))
        tb.running_var.copy_(torch.from_numpy(var0))
    got = tb(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-5)
    for i, key in enumerate(("mean", "var")):
        np.testing.assert_allclose(tb.updated[i].numpy(),
                                   np.asarray(upd["batch_stats"][key]),
                                   rtol=1e-6, atol=1e-6)


def test_se_block_matches_flax():
    r = np.random.RandomState(3)
    x = r.randn(2, 6, 6, 8).astype(np.float32)
    se = JLY.SEBlock(2, dtype=jnp.float32)
    v = se.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree.map(lambda a: jnp.asarray(r.randn(*a.shape), jnp.float32), v)
    want = se.apply(v, jnp.asarray(x))
    ts = TLY.SEBlock(8, 2)
    ts.load_state_dict(BR.state_dict_from_jax(jax.tree.map(np.asarray, v)))
    got = ts(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)


@pytest.mark.parametrize("size,method", [((40, 56), "nearest"),
                                         ((15, 9), "nearest"),
                                         ((20, 28), "bilinear"),
                                         ((5, 7), "nearest")])
def test_resize_to_matches_jax(size, method):
    x = np.random.RandomState(2).randn(2, 5, 7, 3).astype(np.float32)
    want = JLY.resize_to(jnp.asarray(x), *size, method=method)
    got = TLY.resize_to(torch.from_numpy(x).permute(0, 3, 1, 2), *size,
                        method=method).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_width_and_depth_rounding_matches_jax():
    for i in range(8):
        _, kw = ENCODERS[f"efficientnetb{i}"]
        w, d = kw["width_mult"], kw["depth_mult"]
        for f in (16, 24, 32, 40, 80, 112, 192, 320, 1280):
            assert TLY.round_filters(f, w) == JLY.round_filters(f, w)
        for n in (1, 2, 3, 4):
            assert TLY.round_repeats(n, d) == JLY.round_repeats(n, d)


def test_drop_path_scales_kept_examples():
    dp = TLY.DropPath(0.25)
    x = torch.ones(4, 2, 3, 3)
    assert dp(x) is x            # eval: identity
    dp.keep_mask = torch.tensor([True, False, True, False])
    y = dp(x, train=True)
    assert torch.equal(y[:, 0, 0, 0], torch.tensor([4 / 3, 0, 4 / 3, 0]))


@pytest.mark.parametrize("backbone", ["efficientnetb0", "efficientnetb3"])
def test_unet_on_efficientnet_matches_flax(backbone):
    """The encoder table serves every ported decoder."""
    jm = JF.create_model("Unet", backbone, 2, dtype="float32")
    var = jax.tree.map(np.asarray, JF.init_model(jm, (32, 32, 3), seed=1))
    tm = TF.create_model("Unet", backbone, 2, dtype="float32")
    tm.load_state_dict(BR.state_dict_from_jax(var))
    x = np.random.RandomState(4).randn(1, 32, 32, 3).astype(np.float32)
    jl = np.asarray(jm.apply(var, jnp.asarray(x), train=False))
    params, stats = TF.model_variables(tm)
    tl = TF.apply_model(tm, params, stats, torch.from_numpy(x))
    assert tl.shape == jl.shape == (1, 32, 32, 2)
    assert np.abs(tl.detach().numpy() - jl).max() < 1e-4 * np.abs(jl).max()
    assert len(build_encoder(backbone).out_channels) == 5
