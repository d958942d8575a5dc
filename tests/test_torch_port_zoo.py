"""The port's ResNet family, PSPNet and Linknet against the flax zoo.

Weights: random from a seed (``random_weights``: non-trivial BatchNorm
scales and shifts and conv biases), carried into a flax tree by
``models.bridge`` with the BatchNorm statistics perturbed
(``perturbed_batch_stats``), then loaded back into the port; the tree's
paths and shapes are held to the flax module's own (``jax.eval_shape`` of
its ``init``), so a wrong name or layout fails.  That skips a JAX ``init``
per model, which the test clock cannot afford at ResNet-50 size.  Both
sides compute in float32 on the CPU.

Tolerances:
  * encoder taps C1..C5: 1e-5 of the largest |value| of each tap (measured
    ≤ 1.6e-6; summation order of the convolutions only);
  * logits: 1e-4 of the largest |logit| (measured ≤ 1.0e-6), as
    ``test_torch_port_model.py``;
  * train mode: logits 2e-3 of the largest |logit| (measured 7.3e-4,
    Linknet; 7.0e-5, PSPNet), updated BatchNorm statistics 2e-4 of each
    tensor's largest |value| (measured ≤ 7.7e-5).  A train-mode forward normalises by the
    batch's statistics; flax computes the batch variance as E[x²] − E[x]²,
    which loses digits in a channel whose mean dominates its spread
    (PyTorch's is two-pass), and the difference grows through the 16
    bottlenecks and Linknet's full-resolution blocks;
  * bilinear resize and the layer tests: 1e-6 absolute on values of
    order 1 (measured ≤ 2.4e-7).

Every distinct block graph has its taps held to JAX: resnet50 (bottleneck),
resnext50 (grouped 3×3), seresnet18 (SE basic block), seresnet50 (the
stride on the first 1×1, which changes no weight shape) and seresnext50.
The deeper names share those graphs; their constructor arguments are
pinned to the JAX table instead.  PSPNet runs at 64² (an 8×8 map) and at
40²: a 5×5 map, no multiple of 2, 3 or 6 (uneven, overlapping bins) and
below 6, so the 6-bin resize back is a DOWNsample, which JAX antialiases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_training_pipeline_tpu.models import factory as JF
from segmentation_training_pipeline_tpu.models import layers as JLY
from segmentation_training_pipeline_tpu.models.decoders import linknet as JLK
from segmentation_training_pipeline_tpu.models.decoders import pspnet as JPSP
from segmentation_training_pipeline_tpu.models.encoders import (
    _SPECS as JSPECS, encoder_spec)
from segmentation_training_pipeline_tpu_torch.models import bridge as BR
from segmentation_training_pipeline_tpu_torch.models import factory as TF
from segmentation_training_pipeline_tpu_torch.models import layers as TLY
from segmentation_training_pipeline_tpu_torch.models.decoders import (
    linknet as TLK, pspnet as TPSP)
from segmentation_training_pipeline_tpu_torch.models.encoders import (
    ENCODERS, build_encoder)

from torch_port_util import (few_torch_threads, perturbed_batch_stats,
                             random_weights)

B, H, CLASSES = 2, 64, 8
STATS_REL, TRAIN_REL = 2e-4, 2e-3
RESNET_FAMILY = ["resnet18", "resnet34", "resnet50", "resnet101",
                 "resnet152", "resnext50", "resnext101", "seresnet18",
                 "seresnet34", "seresnet50", "seresnet101", "seresnet152",
                 "seresnext50", "seresnext101"]


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _shared_weights(port_module, flax_module, x, seed):
    """The port module's init, bridged to flax with perturbed statistics
    and loaded back; → the flax variables.  Their paths and shapes must be
    the flax module's."""
    random_weights(port_module, seed)
    var = perturbed_batch_stats(BR.jax_from_state_dict(
        port_module.state_dict()), seed + 1)
    want = jax.eval_shape(lambda: flax_module.init(jax.random.PRNGKey(0),
                                                   jnp.asarray(x)))
    assert (jax.tree.structure(want) == jax.tree.structure(var))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(var)):
        assert a.shape == b.shape and a.dtype == b.dtype
    port_module.load_state_dict(BR.state_dict_from_jax(var))
    return var


def _batch(h, seed=0):
    return np.random.RandomState(seed).randn(B, h, h, 3).astype(np.float32)


@pytest.mark.parametrize("name", ["resnet50", "resnext50", "seresnet18",
                                  "seresnet50", "seresnext50"])
def test_encoder_taps_match_flax(name):
    cls, kw = encoder_spec(name)
    jm = cls(**kw, dtype=jnp.float32)
    tm = build_encoder(name)
    x = _batch(H)
    var = _shared_weights(tm, jm, x, seed=3)
    want = jax.jit(jm.apply)(var, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_nchw(x))
    assert [t.shape[1] for t in got] == tm.out_channels
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert _nhwc(g).shape == w.shape == (B, H >> (i + 1), H >> (i + 1),
                                             tm.out_channels[i])
        assert np.abs(_nhwc(g) - w).max() <= 1e-5 * np.abs(w).max(), i


@pytest.mark.parametrize("name", RESNET_FAMILY)
def test_encoder_table_pins_the_jax_specs(name):
    """The ported ResNet names build what the JAX table builds: the same
    class and constructor arguments (the deep variants share the block
    graphs of the tapped names above)."""
    tcls, tkw = ENCODERS[name]
    jcls, jkw = JSPECS[name]
    assert tcls.__name__ == jcls.__name__ and tkw == jkw
    expansion = 4 if jkw["bottleneck"] else 1
    assert build_encoder(name).out_channels == [64] + [
        64 * 2 ** s * expansion for s in range(4)]


def test_ported_encoders_are_the_resnet_family_and_efficientnets():
    """The port's table now holds every name of the JAX table (34
    backbones and the ``mobilenetv1`` alias), the ResNet family and the
    EfficientNets among them."""
    assert set(ENCODERS) == set(JSPECS)
    assert len(ENCODERS) == 35 and ENCODERS["mobilenetv1"] == ENCODERS[
        "mobilenet"]
    assert set(RESNET_FAMILY) | {f"efficientnetb{i}" for i in range(8)} \
        <= set(ENCODERS)
    for name in ENCODERS:
        assert ENCODERS[name][1] == JSPECS[name][1], name


@pytest.fixture(scope="module")
def models():
    """PSPNet- and Linknet-resnet50 with 8 classes, one weight set each,
    shared by every input size (no weight shape depends on it)."""
    out = {}
    for arch, seed in (("PSPNet", 5), ("Linknet", 6)):
        jm = JF.create_model(arch, "resnet50", CLASSES, dtype="float32")
        tm = TF.create_model(arch, "resnet50", CLASSES, dtype="float32")
        var = _shared_weights(tm, jm, _batch(H), seed)
        out[arch] = (jm, var, tm)
    return out


@pytest.mark.parametrize("arch,h", [("PSPNet", 64), ("PSPNet", 40),
                                    ("Linknet", 64)])
def test_logits_match_flax(models, arch, h):
    jm, var, tm = models[arch]
    x = _batch(h, seed=h)
    want = np.asarray(jax.jit(jm.apply)(var, jnp.asarray(x)))
    got = TF.apply_model(tm, *TF.model_variables(tm), torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (B, h, h, CLASSES)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("arch", ["PSPNet", "Linknet"])
def test_train_forward_and_statistics_match_flax(models, arch):
    """Train mode: the logits and every BatchNorm statistic, encoder C4
    and C5 included (PSPNet reads C3 only, but JAX still runs them)."""
    jm, var, tm = models[arch]
    x = _batch(H, seed=1)
    want, upd = jax.jit(lambda v, a: jm.apply(
        v, a, train=True, mutable=["batch_stats"]))(var, jnp.asarray(x))
    got, stats = TF.apply_model(tm, *TF.model_variables(tm),
                                torch.from_numpy(x), train=True)
    want = np.asarray(want)
    assert np.abs(got.detach().numpy() - want).max() <= TRAIN_REL * np.abs(
        want).max()
    ref = BR.state_dict_from_jax(
        {"batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])})
    assert set(ref) == set(stats)
    assert any(k.startswith("encoder.stage4_") for k in ref)
    for k, v in ref.items():
        v = v.numpy()
        err = np.abs(stats[k].numpy() - v).max() / np.abs(v).max()
        assert err <= STATS_REL, (k, err)


def test_pspnet_returns_at_stride_8_and_the_head_resizes(models):
    _, _, tm = models["PSPNet"]
    with torch.no_grad():
        y = tm.decoder(tm.encoder(_nchw(_batch(H))))
    assert tuple(y.shape) == (B, 512, H // 8, H // 8)


@pytest.mark.parametrize("n,m", [(6, 5), (3, 2), (6, 1), (8, 3), (2, 7),
                                 (1, 5)])
def test_bilinear_resize_matches_jax_both_ways(n, m):
    """Upsampling is PyTorch's half-pixel bilinear; a shrinking axis takes
    JAX's antialiased triangle weights."""
    x = np.random.RandomState(n * 10 + m).randn(2, n, 4, 3).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, m, 9, 3), "bilinear")
    got = TLY.resize_to(_nchw(x), m, 9, "bilinear")
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("n,b", [(8, 6), (7, 6), (5, 3), (7, 2), (1, 1)])
def test_adaptive_pool_matches_jax(n, b):
    x = np.random.RandomState(n + b).randn(2, n, n + 1, 4).astype(np.float32)
    want = JPSP.adaptive_avg_pool(jnp.asarray(x), b)
    got = TPSP.adaptive_avg_pool(_nchw(x), b)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-6)


def test_adaptive_pool_builds_its_matrices_in_the_input_dtype():
    """Under bf16 the reference pools with a bf16 matrix (1/48 rounded):
    so does the port."""
    x = np.random.RandomState(0).randn(1, 48, 48, 2).astype(np.float32)
    want = JPSP.adaptive_avg_pool(jnp.asarray(x, jnp.bfloat16), 6)
    got = TPSP.adaptive_avg_pool(_nchw(x).to(torch.bfloat16), 6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got.float()),
                               np.asarray(want, np.float32), atol=2e-2)
    assert float(torch.from_numpy(TPSP._adaptive_pool_matrix(48, 1)).to(
        torch.bfloat16)[0, 0]) != 1.0 / 48


@pytest.mark.parametrize("arch", ["PSPNet", "Linknet"])
def test_decoder_backward_matches_flax_in_float64(arch):
    """The decoders' train-mode forward and backward (pooling matmuls,
    resizes, concat or skip adds, BatchNorm) in float64 on narrow feature
    maps, where no rounding moves a ReLU: the gradients of every
    parameter and of every feature map within 1e-9 of their largest
    |value|.  PSPNet's C3 is 5×5: its 6-bin resize is a downsample."""
    chans = [8, 16, 24, 32, 40]
    sizes = [5] * 5 if arch == "PSPNet" else [16, 8, 4, 2, 1]
    r = np.random.RandomState(9)
    feats = [r.randn(B, n, n, c) for n, c in zip(sizes, chans)]
    if arch == "PSPNet":
        jm, tm = JPSP.PSPDecoder(conv_channels=32, dtype=jnp.float64), \
            TPSP.PSPDecoder(chans, conv_channels=32)
    else:
        jm, tm = JLK.LinknetDecoder(dtype=jnp.float64), \
            TLK.LinknetDecoder(chans)
    random_weights(tm, 4)
    var = perturbed_batch_stats(BR.jax_from_state_dict(tm.state_dict()), 5)
    tm.load_state_dict(BR.state_dict_from_jax(var))
    tm.double()
    with jax.enable_x64():
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), var)
        out = jax.eval_shape(lambda: jm.apply(v64, [jnp.asarray(f) for f in
                                                    feats], train=True,
                                              mutable=["batch_stats"]))[0]
        proj = r.randn(*out.shape)

        def f(params, fs):
            y, _ = jm.apply({"params": params,
                             "batch_stats": v64["batch_stats"]}, fs,
                            train=True, mutable=["batch_stats"])
            return (y * jnp.asarray(proj)).sum()

        jval, (jgp, jgf) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
            v64["params"], [jnp.asarray(f) for f in feats])
        jgp = BR.state_dict_from_jax({"params": jax.tree.map(np.asarray,
                                                             jgp)})
        jgf = [np.asarray(g) for g in jgf]
    params, stats = TF.model_variables(tm)
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    tf = [_nchw(f).requires_grad_(True) for f in feats]
    from torch.func import functional_call
    y = functional_call(tm, (params, stats), (tf,), {"train": True})
    tval = (y.permute(0, 2, 3, 1) * torch.from_numpy(proj)).sum()
    grads = torch.autograd.grad(tval, list(params.values()) + tf,
                                allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-12)
    for name, g in zip(params, grads):
        want = jgp[name].numpy()
        assert np.abs(g.numpy() - want).max() <= 1e-9 * np.abs(want).max(), \
            name
    for i, g in enumerate(grads[len(params):]):
        want = jgf[i]
        assert np.abs(_nhwc(g) - want).max() <= 1e-9 * max(
            np.abs(want).max(), 1e-300), i


@pytest.mark.parametrize("act", ["relu", "swish"])
def test_se_block_hidden_activation_matches_flax(act):
    r = np.random.RandomState(7)
    x = r.randn(2, 5, 5, 32).astype(np.float32)
    se = JLY.SEBlock(4, dtype=jnp.float32, act_fn=act)
    var = se.init(jax.random.PRNGKey(1), jnp.asarray(x))
    var = jax.tree.map(lambda v: np.asarray(v) + r.randn(*v.shape).astype(
        np.float32), var)          # non-zero biases: the ReLU cuts
    ts = TLY.SEBlock(32, 4, act=act)
    ts.load_state_dict(BR.state_dict_from_jax(var))
    with torch.no_grad():
        got = ts(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(se.apply(
        var, jnp.asarray(x))), atol=1e-6)


def test_grouped_conv_bn_matches_flax_and_round_trips():
    """flax's grouped kernel (kh, kw, cin/groups, cout) is PyTorch's
    (cout, cin/groups, kh, kw) by the bridge's transpose, both ways."""
    x = np.random.RandomState(2).randn(2, 8, 8, 16).astype(np.float32)
    jm = JLY.ConvBN(32, strides=(2, 2), groups=4, dtype=jnp.float32)
    var = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2),
                                           jnp.asarray(x)))
    assert var["params"]["conv"]["kernel"].shape == (3, 3, 4, 32)
    tm = TLY.ConvBN(16, 32, 3, 2, groups=4)
    sd = BR.state_dict_from_jax(var)
    assert sd["conv.weight"].shape == (32, 4, 3, 3)
    tm.load_state_dict(sd)
    back = BR.jax_from_state_dict(tm.state_dict())
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(var)):
        assert np.array_equal(a, b)
    with torch.no_grad():
        got = tm(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(jm.apply(
        var, jnp.asarray(x))), atol=1e-5)


@pytest.mark.parametrize("arch", ["PSPNet", "Linknet"])
def test_bridge_round_trips_every_new_name(models, arch):
    jm, var, tm = models[arch]
    back = BR.jax_from_state_dict(tm.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(var)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(var)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    names = set(tm.state_dict())
    want = ({f"decoder.bin{b}_conv.conv.weight" for b in (1, 2, 3, 6)}
            | {"decoder.fuse_conv.bn.running_var"} if arch == "PSPNet" else
            {f"decoder.dec{i}.{p}.conv.weight" for i in range(1, 6)
             for p in ("squeeze", "conv", "expand")}
            | {"decoder.final_conv.conv.weight"})
    assert want <= names
    assert "encoder.stage1_block1.conv3.weight" in names


@pytest.mark.parametrize("arch,exc", [("DeepLabV3", None),
                                      ("deeplab", None),
                                      ("SegNet", KeyError)])
def test_unported_and_unknown_architectures_raise(arch, exc):
    """DeepLabV3 and its aliases are ported now and build; an unknown
    name still raises."""
    if exc is None:
        assert TF.create_model(arch, "resnet50", CLASSES).architecture \
            == arch
        return
    with pytest.raises(exc, match="known"):
        TF.create_model(arch, "resnet50", CLASSES)


@pytest.mark.parametrize("alias", ["pspnet", "psp", "Linknet", "linknet"])
def test_decoder_aliases_build(alias):
    tm = TF.create_model(alias, "resnet18", 2, dtype="float32")
    with torch.no_grad():
        out = tm(torch.zeros(1, 32, 32, 3))
    assert out.shape == (1, 32, 32, 2)
