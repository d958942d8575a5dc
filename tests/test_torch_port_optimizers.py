"""The port's optimizers against the JAX package's optax chains.

Every optimizer name, alone and with ``clipnorm``, ``clipvalue``, weight
decay and a frozen encoder, runs three unit-lr updates on a small flax-
shaped tree (an ``encoder``, a ``decoder`` and a ``logits_conv`` subtree)
with the parameters moving by ``-lr · update`` between them; the port's
updates must equal optax's within ``RTOL``/``ATOL``: float32 elementwise
arithmetic in the same order, where ``sqrt``/``rsqrt`` and the global
norm's summation order may differ by an ulp, which three steps of Adam's
division by ``sqrt(v)`` can grow to a few.  Frozen parameters get no
update in the port and optax's zeros, and they stay bit-identical.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from segmentation_training_pipeline_tpu import config as JC
from segmentation_training_pipeline_tpu.train import optimizers as JO
from segmentation_training_pipeline_tpu_torch import config as TC
from segmentation_training_pipeline_tpu_torch.models import bridge as BR
from segmentation_training_pipeline_tpu_torch.train import optimizers as TO

from torch_port_util import few_torch_threads  # noqa: F401

RTOL, ATOL = 2e-5, 1e-7
LR = 0.01
NAMES = ["Adam", "AdamW", "Nadam", "SGD", "RMSprop", "Adagrad", "Adadelta",
         "Adamax", "Lion", "LAMB"]
VARIANTS = {
    "plain": {},
    "clipnorm": {"clipnorm": 0.5},
    "clipvalue": {"clipvalue": 0.05},
    "decay": {"weight_decay": 0.01},
    "frozen": {"clipnorm": 0.5, "weight_decay": 0.01},
}


def _tree(seed=0):
    r = np.random.RandomState(seed)

    def a(*shape):
        return r.randn(*shape).astype(np.float32)

    return {"encoder": {"conv": {"kernel": a(3, 3, 2, 4)},
                        "bn": {"scale": a(4), "bias": a(4)}},
            "decoder": {"conv": {"kernel": a(1, 1, 4, 3), "bias": a(3)}},
            "logits_conv": {"kernel": a(1, 1, 3, 1), "bias": a(1)}}


def _sd(tree):
    return BR.state_dict_from_jax({"params": jax.tree.map(np.asarray, tree)})


def _grads(step):
    """Gradients whose scale changes between steps (some clip, some
    not), with an exact zero in every tensor."""
    def f(x):
        x = x * np.float32(3.0 ** (1 - step))
        x[(0,) * x.ndim] = 0.0
        return jnp.asarray(x)

    return jax.tree.map(f, _tree(10 + step))


def _run(name, variant, patch=None):
    d = {"optimizer": name, **VARIANTS[variant], **(patch or {})}
    if name == "SGD":
        d["momentum"] = 0.9
    frozen = variant == "frozen"
    jtx = JO.build_optimizer(JC.parse_dict(d), freeze_encoder=frozen)
    ttx = TO.build_optimizer(TC.parse_dict(d), freeze_encoder=frozen)
    jp = jax.tree.map(jnp.asarray, _tree())
    tp = {k: v.clone() for k, v in _sd(_tree()).items()}
    start = {k: v.clone() for k, v in tp.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    names = ttx.trainable(tp)
    for step in range(3):
        g = _grads(step)
        ju, js = jtx.update(g, js, jp)
        tg = {k: v for k, v in _sd(g).items() if k in names}
        tu, ts = ttx.update(tg, ts, {k: tp[k] for k in names})
        want = _sd(ju)
        assert list(tu) == names
        for k, u in tu.items():
            np.testing.assert_allclose(u.numpy(), want[k].numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{k} step {step}")
        for k in set(want) - set(names):
            assert not want[k].numpy().any(), k   # optax's set_to_zero
        jp = jax.tree.map(lambda p, u: p - LR * u, jp, ju)
        for k, u in tu.items():
            tp[k] = tp[k] - LR * u
    return names, start, tp


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("name", NAMES)
def test_optimizer_matches_optax(name, variant):
    names, start, end = _run(name, variant)
    if variant == "frozen":
        enc = [k for k in start if k.startswith("encoder.")]
        assert enc and not set(enc) & set(names)
        for k in enc:
            assert torch.equal(end[k], start[k])
    else:
        assert names == list(start)


def test_weight_decay_rules():
    """AdamW decays by 1e-4 unless ``weight_decay`` is set; an explicit
    0.0 turns it off; the decay comes after the algorithm (decoupled)."""
    parts = TO.build_optimizer(TC.parse_dict({"optimizer": "AdamW"})).parts
    assert [type(p).__name__ for p in parts] == ["ScaleByAdam",
                                                 "AddDecayedWeights"]
    assert parts[-1].weight_decay == 1e-4
    off = TO.build_optimizer(TC.parse_dict({"optimizer": "AdamW",
                                            "weight_decay": 0.0}))
    assert [type(p).__name__ for p in off.parts] == ["ScaleByAdam"]
    _run("AdamW", "plain", {"weight_decay": 0.0})
    both = TO.build_optimizer(TC.parse_dict(
        {"optimizer": "Adam", "clipnorm": 1.0, "clipvalue": 0.1,
         "weight_decay": 0.1}))
    assert [type(p).__name__ for p in both.parts] == [
        "ClipByGlobalNorm", "Clip", "ScaleByAdam", "AddDecayedWeights"]


def test_frozen_clipnorm_counts_the_trainable_leaves_only():
    """The encoder's gradient is large and the rest small: counted in the
    global norm, the encoder would clip the decoder's update.  optax's
    multi_transform does not count it, nor does the port."""
    d = {"optimizer": "SGD", "clipnorm": 1.0}
    jtx = JO.build_optimizer(JC.parse_dict(d), freeze_encoder=True)
    tx = TO.build_optimizer(TC.parse_dict(d), freeze_encoder=True)
    tree = _tree()
    g = jax.tree.map(lambda x: jnp.full(x.shape, 1e-3, jnp.float32), tree)
    g["encoder"] = jax.tree.map(lambda x: jnp.full(x.shape, 10.0),
                                tree["encoder"])
    ju, _ = jtx.update(g, jtx.init(tree), tree)
    p = _sd(tree)
    names = tx.trainable(p)
    tg = {k: v for k, v in _sd(g).items() if k in names}
    u, _ = tx.update(tg, tx.init(p), {k: p[k] for k in names})
    want = _sd(ju)
    for k in names:
        assert torch.equal(u[k], tg[k]) and torch.equal(u[k], want[k])


def test_unknown_name_raises():
    class Cfg:
        optimizer, clipnorm, clipvalue, weight_decay = "Adamm", None, None, None

    with pytest.raises(KeyError, match="unknown optimizer"):
        TO.build_optimizer(Cfg())
