"""The rest of the encoder zoo in the port against the flax zoo: feature
taps C1..C5 of every graph outside the ResNet family and EfficientNet,
and the layers they add.

Weights as ``test_torch_port_zoo.py``: random from a seed, carried into a
flax tree by ``models.bridge`` with perturbed BatchNorm statistics, the
tree's paths and shapes held to the flax module's own.  Both sides compute
in float32 on the CPU; B2 at 65² (odd maps all the way down, so every
strided conv and pool pads as XLA's SAME does at odd sizes) or 64².
Depth is cut where the JAX constructor allows it, as the JAX tests cut it:
senet154 at ``stage_sizes=(1, 1, 1, 1)``, densenet at ``block_sizes=(1, 1,
1, 1)`` beside densenet121 itself.

Tolerances: taps within 1e-5 of each tap's largest |value| (measured ≤
3.5e-6, senet154); the layer tests 1e-5 of the largest |value| (measured
≤ 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from segmentation_training_pipeline_tpu.models.encoders import encoder_spec
from segmentation_training_pipeline_tpu.models.encoders import (
    inception as JIN)
from segmentation_training_pipeline_tpu.models.encoders.resnet import (
    PreactResNetEncoder as JPreact)
from segmentation_training_pipeline_tpu_torch.models import bridge as BR
from segmentation_training_pipeline_tpu_torch.models import layers as TLY
from segmentation_training_pipeline_tpu_torch.models.encoders import (
    build_encoder)
from segmentation_training_pipeline_tpu_torch.models.encoders.resnet import (
    PreactResNetEncoder as TPreact)

from torch_port_util import (few_torch_threads, perturbed_batch_stats,
                             random_weights)

B = 2
REL = 1e-5

# (id, backbone, constructor overrides, input size)
TAPPED = [
    ("vgg16", "vgg16", {}, 65),
    ("mobilenet", "mobilenet", {}, 65),
    ("mobilenetv2", "mobilenetv2", {}, 65),
    ("densenet-1111", "densenet121", {"block_sizes": (1, 1, 1, 1)}, 65),
    ("densenet121", "densenet121", {}, 65),
    ("xception", "xception", {}, 65),
    ("inceptionv3", "inceptionv3", {}, 65),
    ("inceptionresnetv2", "inceptionresnetv2", {}, 65),
    ("senet154-1111", "senet154", {"stage_sizes": (1, 1, 1, 1)}, 64),
]
PREACT = [("preact-resnet34", "resnet34", 65),
          ("preact-resnet50", "resnet50", 64),
          ("preact-seresnet18", "seresnet18", 64)]


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


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


def _taps_match(jm, tm, h, seed):
    x = np.random.RandomState(seed).randn(B, h, h, 3).astype(np.float32)
    var = _shared_weights(tm, jm, x, seed)
    want = jax.jit(jm.apply)(var, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_nchw(x))
    assert [t.shape[1] for t in got] == tm.out_channels
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert _nhwc(g).shape == w.shape
        assert np.abs(_nhwc(g) - w).max() <= REL * np.abs(w).max(), i


@pytest.mark.parametrize("backbone,kw,h", [c[1:] for c in TAPPED],
                         ids=[c[0] for c in TAPPED])
def test_encoder_taps_match_flax(backbone, kw, h):
    cls, jkw = encoder_spec(backbone)
    _taps_match(cls(**{**jkw, **kw}, dtype=jnp.float32),
                build_encoder(backbone, **kw), h, seed=len(backbone))


@pytest.mark.parametrize("backbone,h", [c[1:] for c in PREACT],
                         ids=[c[0] for c in PREACT])
def test_preact_encoder_taps_match_flax(backbone, h):
    """The classification_models pre-activation graph (``keras-preact``):
    ``bn_data`` without a scale, shortcuts off the pre-activated tensor,
    the ``stage{2,3,4}_unit1_relu1`` taps; bottleneck and SE units."""
    jkw = encoder_spec(backbone)[1]
    kw = dict(stage_sizes=jkw["stage_sizes"],
              bottleneck=jkw.get("bottleneck", False),
              se=backbone.startswith("seresnet"))
    tm = TPreact(3, **kw)
    assert "bn_data.weight" not in tm.state_dict()
    assert tm.bn_data.momentum == 0.99 and tm.bn_data.eps == 1e-3
    _taps_match(JPreact(**kw, dtype=jnp.float32), tm, h, seed=h)


CONVS = [((3, 3), 1, 1, 1, 9), ((3, 3), 2, 1, 1, 9), ((3, 3), 2, 1, 1, 8),
         ((3, 3), 1, 2, 1, 9), ((3, 3), 1, 6, 1, 4), ((3, 3), 2, 2, 4, 9),
         ((1, 7), 1, 1, 1, 9), ((7, 1), 1, 1, 1, 8), ((1, 3), 2, 1, 1, 9),
         ((2, 2), 1, 1, 1, 9), ((2, 2), 1, 3, 4, 8), ((5, 5), 2, 1, 1, 8)]


@pytest.mark.parametrize("kernel,stride,rate,groups,n", CONVS)
def test_conv_matches_flax_same_padding(kernel, stride, rate, groups, n):
    """flax ``nn.Conv(padding="SAME")`` with (kh, kw) kernels, strides,
    ``kernel_dilation`` and ``feature_group_count``: XLA pads the
    effective window (k − 1)·r + 1, asymmetrically when it is even."""
    x = np.random.RandomState(n).randn(2, n, n + 1, 8).astype(np.float32)
    jm = fnn.Conv(4, kernel, (stride, stride), padding="SAME",
                  kernel_dilation=(rate, rate), feature_group_count=groups,
                  use_bias=True)
    var = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(n),
                                           jnp.asarray(x)))
    var["params"]["bias"] = np.random.RandomState(1).randn(4).astype(
        np.float32)
    tm = TLY.Conv(8, 4, kernel, stride, bias=True, groups=groups,
                  dilation=rate)
    tm.load_state_dict({k[len("c."):]: v for k, v in BR.state_dict_from_jax(
        {"params": {"c": var["params"]}}).items()})
    want = np.asarray(jm.apply(var, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


@pytest.mark.parametrize("n", [5, 8])
@pytest.mark.parametrize("form", ["include", "exclude"])
def test_average_pools_match_flax(form, n):
    """Inception's two SAME average pools: torchvision's divides every
    window by 9, timm's by the real inputs it covers."""
    x = np.random.RandomState(n).randn(2, n, n + 1, 3).astype(np.float32)
    jf = JIN._avgpool3 if form == "include" else JIN._avgpool3_excl
    want = np.asarray(jf(jnp.asarray(x)))
    got = _nhwc(TLY.avg_pool_same(_nchw(x), 3, 1,
                                  count_include_pad=form == "include"))
    np.testing.assert_allclose(got, want, rtol=REL, atol=1e-7)
    corner = x[:, :2, :2].sum(axis=(1, 2))
    np.testing.assert_allclose(got[:, 0, 0], corner / (9 if form ==
                                                       "include" else 4),
                               rtol=1e-6)
