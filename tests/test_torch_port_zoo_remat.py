"""The port's whole encoder table against the JAX table, ``remat: true``
and the ``keras-preact`` encoder variant at the model level.

* The table: each of the JAX table's 35 names (34 backbones and the
  ``mobilenetv1`` alias) builds the class of the same name with the same
  constructor arguments (the graphs of each class are held to flax in
  ``test_torch_port_zoo_rest.py``, ``test_torch_port_zoo.py`` and
  ``test_torch_port_deeplab.py``), and its taps have the widths it
  declares.
* ``remat``: the same f32 train-mode forward and backward with and without
  it, on the same weights and stochastic-depth keep masks, must give
  EQUAL logits, BatchNorm statistics and gradients (the recomputation
  runs the same operations on the same values).  Unet checkpoints each
  decoder stage, other decoders the whole decoder, as the JAX factory.
* ``keras-preact``: the model's logits against the flax model's with
  ``encoder_variant="keras-preact"`` within 1e-5 of the largest |logit|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_training_pipeline_tpu.models import factory as JF
from segmentation_training_pipeline_tpu.models.encoders import (
    _SPECS as JSPECS)
from segmentation_training_pipeline_tpu_torch import config as TC
from segmentation_training_pipeline_tpu_torch.models import bridge as BR
from segmentation_training_pipeline_tpu_torch.models import factory as TF
from segmentation_training_pipeline_tpu_torch.models import layers as TLY
from segmentation_training_pipeline_tpu_torch.models.encoders import (
    ENCODERS, build_encoder)
from segmentation_training_pipeline_tpu_torch.models.encoders import (
    xception_aligned as TXA)

from torch_port_util import (few_torch_threads, perturbed_batch_stats,
                             random_weights)

B, H = 2, 64


@pytest.mark.parametrize("name", sorted(JSPECS))
def test_table_pins_the_jax_specs(name):
    tcls, tkw = ENCODERS[name]
    jcls, jkw = JSPECS[name]
    assert tcls.__name__ == jcls.__name__ and tkw == jkw
    enc = build_encoder(name)
    with torch.no_grad():
        feats = enc(torch.zeros(1, 3, 32, 32))
    assert [f.shape[1] for f in feats] == enc.out_channels
    assert [f.shape[2] for f in feats] == [16, 8, 4, 2, 1]


def _remat_pair(arch, backbone, monkeypatch):
    """One model with and one without remat on the same weights; the
    number of checkpointed calls a forward makes is counted."""
    plain = random_weights(TF.create_model(arch, backbone, 2,
                                           dtype="float32"), 3)
    remat = TF.create_model(arch, backbone, 2, dtype="float32", remat=True)
    remat.load_state_dict(plain.state_dict())
    calls = []
    real = TLY.checkpoint
    monkeypatch.setattr(TLY, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    return plain, remat, calls


def _step(model, x, masks, proj):
    """Train-mode forward → (logits, new statistics, parameter
    gradients) of a fixed projection of the logits."""
    params, stats = TF.model_variables(model)
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    torch.manual_seed(11)              # the aligned decoder's dropout draw
    logits, new = TF.apply_model(model, params, stats, x, train=True,
                                 drop_masks=masks)
    grads = torch.autograd.grad((logits * proj).sum(), list(params.values()),
                                allow_unused=True, materialize_grads=True)
    return logits.detach(), new, dict(zip(params, grads))


@pytest.mark.parametrize("arch,backbone,checkpoints", [
    ("Unet", "efficientnetb0", 6), ("FPN", "efficientnetb0", 2),
    ("DeepLabV3", "xception_aligned", 2)])
def test_remat_changes_no_number(arch, backbone, checkpoints, monkeypatch):
    """Stochastic depth (efficientnet's DropPath) and the aligned DeepLab
    decoder's dropout are the traps: the recomputation must see the same
    keep masks, bound again inside the checkpointed call, and the same
    global generator state."""
    if backbone == "xception_aligned":
        cls, kw = ENCODERS[backbone]
        monkeypatch.setitem(ENCODERS, backbone, (cls, {**kw,
                                                       "middle_units": 2}))
    plain, remat, calls = _remat_pair(arch, backbone, monkeypatch)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        B, H, H, 3).astype(np.float32))
    masks = plain.sample_drop_masks(torch.Generator().manual_seed(5), B)
    assert bool(masks) == (backbone == "efficientnetb0")
    proj = torch.from_numpy(np.random.RandomState(1).randn(
        B, H, H, 2).astype(np.float32))
    want = _step(plain, x, masks, proj)
    assert not calls
    got = _step(remat, x, masks, proj)
    assert len(calls) == checkpoints
    assert torch.equal(got[0], want[0])
    assert set(got[1]) == set(want[1])
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k
    for k in want[2]:
        assert torch.equal(got[2][k], want[2][k]), k
    assert all(m.keep_mask is None for m in remat.modules()
               if isinstance(m, (TLY.DropPath, TLY.Dropout)))


def test_remat_parses_and_builds():
    cfg = TC.parse_dict({"backbone": "resnet18", "remat": True})
    model = TF.model_from_config(cfg)
    assert model.remat and model.decoder.remat


@pytest.mark.parametrize("backbone", ["resnet34", "seresnet18", "resnet50"])
def test_keras_preact_variant_matches_flax(backbone):
    jm = JF.create_model("Unet", backbone, 1, dtype="float32",
                         encoder_variant="keras-preact")
    tm = TF.create_model("Unet", backbone, 1, dtype="float32",
                         encoder_variant="keras-preact")
    assert tm.encoder_variant == "keras-preact"
    assert type(tm.encoder).__name__ == "PreactResNetEncoder"
    x = np.random.RandomState(2).randn(B, H, H, 3).astype(np.float32)
    random_weights(tm, 4)
    var = perturbed_batch_stats(BR.jax_from_state_dict(tm.state_dict()), 5)
    tm.load_state_dict(BR.state_dict_from_jax(var))
    want = np.asarray(jax.jit(jm.apply)(var, jnp.asarray(x)))
    got = TF.apply_model(tm, *TF.model_variables(tm), torch.from_numpy(x))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("backbone,variant", [
    ("efficientnetb0", "keras-preact"), ("resnet34", "keras-postact")])
def test_unknown_variants_raise_as_jax(backbone, variant):
    with pytest.raises(KeyError, match="encoder_variant"):
        TF.create_model("Unet", backbone, 1, encoder_variant=variant)


def test_sep_conv_bn_places_its_relus_as_bonlime():
    """One ReLU before the depthwise conv, or one after each BatchNorm."""
    owner = torch.nn.Module()
    TXA.add_sep_conv_bn(owner, 4, 6, "p", rate=2)
    random_weights(owner, 0)
    dw, dw_bn, pw, pw_bn = (getattr(owner, f"p_{n}") for n in (
        "depthwise", "depthwise_BN", "pointwise", "pointwise_BN"))
    x = torch.from_numpy(np.random.RandomState(3).randn(1, 4, 5, 5).astype(
        np.float32))
    relu = torch.relu
    with torch.no_grad():
        assert torch.equal(TXA.sep_conv_bn(owner, x, "p", False),
                           pw_bn(pw(dw_bn(dw(relu(x))))))
        assert torch.equal(
            TXA.sep_conv_bn(owner, x, "p", False, depth_activation=True),
            relu(pw_bn(pw(relu(dw_bn(dw(x)))))))
    assert dw.dilation == 2 and dw.groups == 4
