"""The port's Unet-resnet34 against the flax model on the same weights.

The weights are the flax model's ``init_model`` variables, carried over by
``models.bridge``.  Both sides compute in float32 here; logits agree within
1e-4 of the largest |logit| (summation order of the convolutions only) and
the updated BatchNorm statistics within 1e-5.  The smaller tests pin the
hazards one by one: XLA's asymmetric SAME padding at even sizes, the
max-pool's −inf padding, flax's BatchNorm momentum (0.9, PyTorch's 0.1)
and its biased running variance, and flax's truncated-normal init.
"""

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import pytest
import torch

from segmentation_training_pipeline_tpu.models import factory as JF
from segmentation_training_pipeline_tpu_torch.models import bridge as BR
from segmentation_training_pipeline_tpu_torch.models import factory as TF
from segmentation_training_pipeline_tpu_torch.models import layers as TLY

H = 64


@pytest.fixture(scope="module")
def models():
    jm = JF.create_model("Unet", "resnet34", 1, dtype="float32")
    var = jax.tree.map(np.asarray, JF.init_model(jm, (H, H, 3), seed=0))
    tm = TF.create_model("Unet", "resnet34", 1, dtype="float32")
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


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_flax(models, train):
    jm, var, tm = models
    x = np.random.RandomState(0).randn(2, H, H, 3).astype(np.float32)
    params, stats = TF.model_variables(tm)
    if train:
        jl, upd = jm.apply(var, jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
        tl, new_stats = TF.apply_model(tm, params, stats, torch.from_numpy(x),
                                       train=True)
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


@pytest.mark.parametrize("n,k,s", [(64, 7, 2), (64, 3, 2), (63, 3, 2),
                                   (32, 1, 2), (16, 3, 1)])
def test_conv_same_padding_matches_xla(n, k, s):
    """At even sizes a strided SAME conv pads (k−s)//2 low and the rest
    high — (2, 3) for the 7×7/2 stem, (0, 1) for a 3×3/2 conv."""
    r = np.random.RandomState(n + k)
    x = r.randn(2, n, n, 3).astype(np.float32)
    w = r.randn(k, k, 3, 5).astype(np.float32)
    conv = fnn.Conv(5, (k, k), (s, s), padding="SAME", use_bias=False)
    want = conv.apply({"params": {"kernel": jnp.asarray(w)}}, jnp.asarray(x))
    tc = TLY.Conv(3, 5, k, s)
    with torch.no_grad():
        tc.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        got = tc(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    if (n, k, s) == (64, 7, 2):
        assert TLY.same_pads(64, 7, 2) == (2, 3)
    if (n, k, s) == (64, 3, 2):
        assert TLY.same_pads(64, 3, 2) == (0, 1)


@pytest.mark.parametrize("n", [32, 33])
def test_max_pool_pads_with_minus_inf(n):
    """All-negative input: a zero pad would win the max on the edge."""
    x = -1.0 - np.random.RandomState(n).rand(2, n, n, 4).astype(np.float32)
    want = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                        padding="SAME")
    got = TLY.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def test_batchnorm_follows_flax_rule():
    """Running stats: m·running + (1 − m)·batch with m = 0.9 and the
    BIASED batch variance; the output normalises by the batch stats."""
    r = np.random.RandomState(1)
    x = (r.randn(4, 5, 5, 3) * 3 + 2).astype(np.float32)
    mean0 = r.randn(3).astype(np.float32)
    var0 = (r.rand(3) + 0.5).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = {"params": {"scale": jnp.ones(3), "bias": jnp.zeros(3)},
         "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    want, upd = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    tb = TLY.BatchNorm(3)
    with torch.no_grad():
        tb.running_mean.copy_(torch.from_numpy(mean0))
        tb.running_var.copy_(torch.from_numpy(var0))
    got = tb(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(tb.updated[0].numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tb.updated[1].numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)
    # the stored buffers stay as they were: the update is returned
    assert torch.equal(tb.running_var, torch.from_numpy(var0))


def test_upsample_matches_jax_nearest():
    x = np.random.RandomState(2).randn(1, 5, 7, 2).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (1, 10, 14, 2), "nearest")
    got = TLY.upsample2x(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def test_init_follows_flax_distributions(models):
    """variance_scaling(1, fan_in, truncated normal): std 1/sqrt(fan_in),
    cut at two of the underlying normal's std; BN scale 1, bias 0."""
    _, var, _ = models
    tm = TF.init_model(TF.create_model("Unet", "resnet34", 1,
                                       dtype="float32"), seed=0, device="cpu")
    got = dict(tm.named_parameters())
    sd = BR.state_dict_from_jax(var)
    for name in ("encoder.stage2_block1.conv1.weight",
                 "decoder.up1.conv1.conv.weight"):
        p, q = got[name].detach(), sd[name]
        fan_in = p.shape[1] * p.shape[2] * p.shape[3]
        for t in (p, q):
            assert abs(float(t.std()) * np.sqrt(fan_in) - 1.0) < 0.02
            assert float(t.abs().max()) <= 2.0 / 0.8796 / np.sqrt(fan_in)
    assert torch.equal(got["encoder.stem_bn.weight"], torch.ones(64))
    assert torch.equal(got["logits_conv.bias"], torch.zeros(1))
    again = TF.init_model(TF.create_model("Unet", "resnet34", 1,
                                          dtype="float32"), seed=0,
                          device="cpu")
    assert torch.equal(dict(again.named_parameters())[name], got[name])
