"""DeepLabV3+ in the port against the flax zoo: the aligned Xception
encoder, bonlime's aligned decoder, the generic decoder and one f32 train
step.

Weights: random from a seed (``random_weights``), carried into a flax
tree by ``models.bridge`` with perturbed BatchNorm statistics, the tree's
paths and shapes held to the flax module's own (``jax.eval_shape`` of its
``init``), as ``test_torch_port_zoo.py`` does.  The aligned encoder runs
with ``middle_units=2`` (16 in the table): the module patches both
packages' tables for that while it runs, which leaves every block graph,
width and name of the real one.

Tolerances (as ``test_torch_port_zoo.py``):
  * encoder taps and eval logits: 1e-5 of the largest |value| (measured
    ≤ 1.2e-6);
  * train mode: logits 2e-3 of the largest |logit| and BatchNorm
    statistics 2e-4 of each tensor's largest |value|: flax's batch
    variance E[x²] − E[x]² loses digits that PyTorch's two-pass one keeps;
  * one f32 train step: the loss within 1e-5 relative; the gradients (the
    first Adam moment) within 0.03 relative L2 distance per tensor
    (measured worst 0.016) and 0.015 over all of them (measured 0.0091),
    with an absolute floor of 1e-5 of the median tensor's gradient norm;
    BatchNorm statistics as in train mode.  The train-mode forward's rounding (the
    batch variance above) moves the gradients by more than their own
    rounding.  The floor is for the ``depthwise_BN`` biases: each feeds a
    pointwise conv followed by a train-mode BatchNorm, which removes a
    per-channel shift, so their gradient is 0 up to rounding (measured
    norms 4e-9 to 5e-8).  The JAX step's dropout draw
    (``capture_drop_masks``) is bound to the port's ``decoder.dropout``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_training_pipeline_tpu.models import factory as JF
from segmentation_training_pipeline_tpu.models import encoders as JE
from segmentation_training_pipeline_tpu.models.decoders import (
    deeplab as JDL)
from segmentation_training_pipeline_tpu.ops import losses as JLo
from segmentation_training_pipeline_tpu.train import optimizers as JO
from segmentation_training_pipeline_tpu.train import step as JS
from segmentation_training_pipeline_tpu_torch import config as TC
from segmentation_training_pipeline_tpu_torch.models import bridge as BR
from segmentation_training_pipeline_tpu_torch.models import encoders as TE
from segmentation_training_pipeline_tpu_torch.models import factory as TF
from segmentation_training_pipeline_tpu_torch.models import layers as TLY
from segmentation_training_pipeline_tpu_torch.models.decoders import (
    deeplab as TDL)
from segmentation_training_pipeline_tpu_torch.ops import losses as TLo
from segmentation_training_pipeline_tpu_torch.train import optimizers as TO
from segmentation_training_pipeline_tpu_torch.train import step as TS

from torch_port_util import (blob_batch, capture_drop_masks,
                             few_torch_threads, perturbed_batch_stats,
                             random_weights)

B, H, CLASSES = 2, 64, 3
MIDDLE = 2
TAP_REL, TRAIN_REL, STATS_REL = 1e-5, 2e-3, 2e-4
GRAD_REL, GRAD_REL_ALL, GRAD_FLOOR = 0.03, 0.015, 1e-5
LOSS = "binary_crossentropy + 0.25*dice_loss"
ALIASES = ["DeepLabV3", "DeepLabV3+", "DeepLabV3Plus", "deeplab"]


@pytest.fixture(autouse=True, scope="module")
def shallow_aligned_xception():
    """Both tables build ``xception_aligned`` with 2 middle units."""
    with pytest.MonkeyPatch.context() as mp:
        jcls, jkw = JE._SPECS["xception_aligned"]
        tcls, tkw = TE.ENCODERS["xception_aligned"]
        mp.setitem(JE._SPECS, "xception_aligned",
                   (jcls, {**jkw, "middle_units": MIDDLE}))
        mp.setitem(TE.ENCODERS, "xception_aligned",
                   (tcls, {**tkw, "middle_units": MIDDLE}))
        yield


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _batch(h, seed=0, b=B):
    return np.random.RandomState(seed).randn(b, h, h, 3).astype(np.float32)


def _shared_weights(port_module, flax_module, x, seed):
    random_weights(port_module, seed)
    var = perturbed_batch_stats(BR.jax_from_state_dict(
        port_module.state_dict()), seed + 1)
    want = jax.eval_shape(lambda: flax_module.init(jax.random.PRNGKey(0),
                                                   jnp.asarray(x)))
    assert jax.tree.structure(want) == jax.tree.structure(var)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(var)):
        assert a.shape == b.shape and a.dtype == b.dtype
    port_module.load_state_dict(BR.state_dict_from_jax(var))
    return var


@pytest.mark.parametrize("stride,h,b", [(32, 64, 2), (16, 64, 2),
                                        (32, 65, 1), (16, 65, 1)])
def test_aligned_xception_taps_match_flax(stride, h, b):
    """65² gives odd maps: the strided depthwise convs pad (1, 1) where 64²
    pads (0, 1), and at output stride 16 the rate-2 depthwise convs pad
    their effective 5×5 window."""
    jm = JE.encoder_spec("xception_aligned")[0](
        output_stride=stride, middle_units=MIDDLE, dtype=jnp.float32)
    tm = TE.build_encoder("xception_aligned", output_stride=stride)
    x = _batch(h, seed=h, b=b)
    var = _shared_weights(tm, jm, x, seed=2)
    want = jax.jit(jm.apply)(var, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_nchw(x))
    strides = [2, 4, 8, 16, stride]
    assert [t.shape[1] for t in got] == tm.out_channels == [64, 256, 256,
                                                           728, 2048]
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        n = -(-h // strides[i])
        assert _nhwc(g).shape == w.shape == (b, n, n, tm.out_channels[i])
        assert np.abs(_nhwc(g) - w).max() <= TAP_REL * np.abs(w).max(), i


def test_output_stride_16_dilates_exit_block_2():
    tm = TE.build_encoder("xception_aligned", output_stride=16)
    convs = {n: m for n, m in tm.named_modules()
             if isinstance(m, TLY.Conv)}
    assert convs["exit_flow_block2_separable_conv1_depthwise"].dilation == 2
    assert convs["exit_flow_block2_separable_conv1_depthwise"].span == (5, 5)
    assert convs["exit_flow_block1_separable_conv3_depthwise"].stride == 1
    assert TE.build_encoder("xception_aligned").__getattr__(
        "exit_flow_block1_separable_conv3_depthwise").stride == 2


@pytest.fixture(scope="module")
def models():
    """DeepLabV3 on the aligned Xception (bonlime's decoder) and on
    resnet34 (the generic decoder), one weight set each."""
    out = {}
    for backbone, seed in (("xception_aligned", 5), ("resnet34", 6)):
        jm = JF.create_model("DeepLabV3", backbone, CLASSES, dtype="float32")
        tm = TF.create_model("DeepLabV3", backbone, CLASSES, dtype="float32")
        var = _shared_weights(tm, jm, _batch(H), seed)
        out[backbone] = (jm, var, tm)
    return out


def test_the_factory_pairs_as_jax(models):
    tm = models["xception_aligned"][2]
    assert isinstance(tm.decoder, TDL.AlignedDeepLabDecoder)
    assert tm.encoder.out_channels[4] == 2048
    assert isinstance(models["resnet34"][2].decoder,
                      TDL.DeepLabV3PlusDecoder)
    unet = TF.create_model("Unet", "xception_aligned", 1)
    assert unet.encoder.exit_flow_block1_separable_conv3_depthwise.stride \
        == 2


@pytest.mark.parametrize("backbone,h", [("xception_aligned", 64),
                                        ("xception_aligned", 65),
                                        ("resnet34", 64), ("resnet34", 65)])
def test_logits_match_flax(models, backbone, h):
    jm, var, tm = models[backbone]
    x = _batch(h, seed=h)
    want = np.asarray(jax.jit(jm.apply)(var, jnp.asarray(x)))
    got = TF.apply_model(tm, *TF.model_variables(tm), torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (B, h, h, CLASSES)
    assert np.abs(got.numpy() - want).max() <= TAP_REL * np.abs(want).max()


def _train_forward(jm, var, x):
    drops = {}
    with capture_drop_masks(drops):
        want, upd = jax.jit(lambda v, a: jm.apply(
            v, a, train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(3)}))(var, jnp.asarray(x))
        jax.effects_barrier()
    return np.asarray(want), upd, drops


def _port_masks(drops):
    """The JAX dropout draws by the port's names, NCHW."""
    return {n.replace("Dropout_0", "dropout"): _nchw(m)
            for n, m in drops.items()}


@pytest.mark.parametrize("backbone", ["xception_aligned", "resnet34"])
def test_train_forward_and_statistics_match_flax(models, backbone):
    jm, var, tm = models[backbone]
    x = _batch(H, seed=1)
    want, upd, drops = _train_forward(jm, var, x)
    assert set(drops) == ({"decoder.Dropout_0"}
                          if backbone == "xception_aligned" else set())
    got, stats = TF.apply_model(tm, *TF.model_variables(tm),
                                torch.from_numpy(x), train=True,
                                drop_masks=_port_masks(drops))
    assert np.abs(got.detach().numpy() - want).max() <= TRAIN_REL * np.abs(
        want).max()
    ref = BR.state_dict_from_jax(
        {"batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])})
    assert set(ref) == set(stats)
    for k, v in ref.items():
        v = v.numpy()
        err = np.abs(stats[k].numpy() - v).max() / np.abs(v).max()
        assert err <= STATS_REL, (k, err)
    if backbone == "xception_aligned":
        # Keras momentum 0.99: the running mean moves 1% of the way
        k = "encoder.entry_flow_conv1_1_BN.running_mean"
        before = TF.model_variables(tm)[1][k]
        assert tm.encoder.entry_flow_conv1_1_BN.momentum == 0.99
        assert tm.decoder.aspp0_BN.eps == 1e-5
        assert not torch.equal(stats[k], before)


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture(scope="module")
def step(models):
    """One f32 train step of DeepLabV3-xception_aligned, sigmoid, bce +
    0.25·dice, Adam, on both sides; the port gets the JAX step's dropout
    draw."""
    jm, var, tm = models["xception_aligned"]
    imgs, masks = blob_batch(B, H, H, seed=4)
    masks = np.repeat(masks, CLASSES, axis=-1)
    cfg = TC.parse_dict({"architecture": "DeepLabV3",
                         "backbone": "xception_aligned", "loss": LOSS,
                         "optimizer": "Adam", "lr": 1e-3,
                         "classes": CLASSES, "dtype": "float32"})
    jloss = JLo.build_loss(LOSS, "sigmoid")
    jtx = JO.build_optimizer(cfg)
    drops = {}
    with capture_drop_masks(drops):
        jstep = JS.build_train_step(jm, jtx, jloss, {}, "sigmoid", None,
                                    donate=False)
        jnew, jlogs = jstep(JS.create_train_state(jm, var, jtx),
                            {"image": jnp.asarray(imgs),
                             "mask": jnp.asarray(masks)}, 1e-3,
                            jax.random.PRNGKey(7))
        jax.effects_barrier()
    ttx = TO.build_optimizer(cfg)
    tstep = TS.build_train_step(tm, ttx, TLo.build_loss(LOSS, "sigmoid"), {},
                                "sigmoid", None)
    tnew, tlogs = tstep(TS.create_train_state(tm, ttx, device="cpu"),
                        {"image": torch.from_numpy(imgs),
                         "mask": torch.from_numpy(masks)}, 1e-3,
                        drop_masks=_port_masks(drops))
    return dict(jnew=jnew, jlogs=jlogs, tnew=tnew, tlogs=tlogs, drops=drops)


def test_train_step_matches_jax(step):
    assert set(step["drops"]) == {"decoder.Dropout_0"}
    np.testing.assert_allclose(float(step["tlogs"]["loss"]),
                               float(step["jlogs"]["loss"]), rtol=1e-5)
    jmu = BR.state_dict_from_jax({"params": jax.tree.map(
        np.asarray, step["jnew"].opt_state[0].mu)})
    tmu = step["tnew"].opt_state[0].mu
    assert set(jmu) == set(tmu)
    floor = GRAD_FLOOR * np.median([np.linalg.norm(v.numpy())
                                    for v in jmu.values()])
    both = []
    for name, t in tmu.items():
        gj, gt = jmu[name].numpy(), t.numpy()
        dist = np.linalg.norm(gt - gj)
        assert dist <= max(GRAD_REL * np.linalg.norm(gj), floor), (
            name, dist, np.linalg.norm(gj))
        both.append((gj.ravel(), gt.ravel()))
    assert _rel_l2(np.concatenate([b for _, b in both]),
                   np.concatenate([a for a, _ in both])) <= GRAD_REL_ALL
    want = BR.state_dict_from_jax({"batch_stats": jax.tree.map(
        np.asarray, step["jnew"].batch_stats)})
    for name, v in want.items():
        v = v.numpy()
        err = np.abs(step["tnew"].batch_stats[name].numpy() - v).max()
        assert err <= STATS_REL * np.abs(v).max(), (name, err)


@pytest.mark.parametrize("backbone", ["xception_aligned", "resnet34"])
def test_bridge_round_trips_every_name(models, backbone):
    jm, var, tm = models[backbone]
    back = BR.jax_from_state_dict(tm.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(var)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(var)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    names = set(tm.state_dict())
    want = ({"decoder.aspp1_depthwise.weight",
             "decoder.image_pooling_BN.running_var",
             "decoder.decoder_conv1_pointwise.weight",
             "encoder.middle_flow_unit_2_separable_conv3_depthwise_BN.bias"}
            if backbone == "xception_aligned" else
            {"decoder.aspp.rate18_conv.weight", "decoder.aspp.rate6_bn.bias",
             "decoder.aspp.pool_conv.conv.weight",
             "decoder.low_project.bn.running_mean",
             "decoder.refine2.conv.weight"})
    assert want <= names
    if backbone == "xception_aligned":
        # a depthwise kernel: flax (3, 3, 1, C) ↔ PyTorch (C, 1, 3, 3)
        assert var["params"]["decoder"]["aspp1_depthwise"][
            "kernel"].shape == (3, 3, 1, 2048)
        assert tm.state_dict()["decoder.aspp1_depthwise.weight"].shape == (
            2048, 1, 3, 3)


@pytest.mark.parametrize("alias", ALIASES)
@pytest.mark.parametrize("backbone", ["xception_aligned", "resnet18"])
def test_every_alias_builds_the_jax_pairing(alias, backbone):
    tm = TF.create_model(alias, backbone, 2, dtype="float32")
    aligned = backbone == "xception_aligned"
    assert isinstance(tm.decoder, TDL.AlignedDeepLabDecoder if aligned
                      else TDL.DeepLabV3PlusDecoder)
    with torch.no_grad():
        out = tm(torch.zeros(1, 32, 32, 3))
    assert out.shape == (1, 32, 32, 2)
    # the config keeps the user's spelling, as the reference's does; the
    # registry names the architecture it means
    cfg = TC.parse_dict({"architecture": alias, "backbone": backbone})
    assert cfg.architecture == alias
    assert TC.ARCHITECTURES.get(cfg.architecture) == "DeepLabV3"


@pytest.mark.parametrize("alias", ["xception65", "xception_deeplab"])
def test_config_resolves_the_aligned_xception_aliases(alias):
    cfg = TC.parse_dict({"architecture": "DeepLabV3", "backbone": alias})
    assert cfg.backbone == "xception_aligned"
    assert isinstance(TF.model_from_config(cfg).decoder,
                      TDL.AlignedDeepLabDecoder)


def test_image_pooling_resize_equals_jax_bilinear():
    """A 1×1 map resized bilinearly is copied to every pixel in JAX (its
    one weight normalises to exactly 1): the port's ``resize_to`` too."""
    g = np.random.RandomState(3).randn(2, 1, 1, 5).astype(np.float32)
    for h, w in ((4, 4), (5, 3), (17, 17)):
        want = np.asarray(jax.image.resize(jnp.asarray(g), (2, h, w, 5),
                                           "bilinear"))
        got = _nhwc(TLY.resize_to(_nchw(g), h, w, "bilinear"))
        assert np.array_equal(got, want)


def test_aspp_matches_flax_on_a_map_smaller_than_its_rates():
    """The generic ASPP's 3×3 convs at rates 6/12/18 on a 3×3 map: XLA's
    SAME pads the effective 13/25/37 window, so most taps read zeros."""
    x = np.random.RandomState(5).randn(2, 3, 3, 16).astype(np.float32)
    jm = JDL.ASPP(channels=8, dtype=jnp.float32)
    tm = TDL.ASPP(16, channels=8)
    var = _shared_weights(tm, jm, x, seed=8)
    want = np.asarray(jm.apply(var, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x)))
    assert np.abs(got - want).max() <= TAP_REL * np.abs(want).max()
