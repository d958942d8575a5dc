"""One f32 train step of the port's FPN + efficientnetb0 against the JAX
train step.

2×64², sigmoid, ``binary_crossentropy + 0.25*dice_loss``, Adam, with the
config-2 augmentation block, both sides from the same weights (the flax
init, carried over by ``models.bridge``), batch and augmentation draws
(``tests/torch_port_util.py``).  The JAX side runs its Pallas kernels in
interpret mode with ``STP_FUSE_ELASTIC=1`` (kernel YE, as
``examples/fpn_augmented_512.yaml`` asks), the port its kernels' plain
versions on the same switch.  The DropPath keep masks are the ones the JAX
step drew (captured with ``flax.linen.intercept_methods``) and handed to
the port's step.

Tolerances.  The augmented images differ by up to 1e-2 (the reference's
``_dot3``), which the FPN heads' ReLUs turn into small moves of the
gradients (swish, everywhere in the encoder, is smooth):
  * the loss within 1e-4 relative (measured 2.4e-5), the metrics within
    1e-3 (measured 2.6e-4: dice and iou threshold the probabilities at
    0.5, so a pixel near 0.5 can flip);
  * gradients: relative L2 distance per tensor within 0.06 (measured worst
    0.021) and over all tensors within 0.02 (measured 0.0054), plus an
    absolute floor of 1e-5 of the median tensor's gradient norm.  The
    floor is for the ``project_bn`` biases: each feeds only convolutions
    followed by train-mode BatchNorm, which removes a per-channel shift, so
    their gradient is 0 up to rounding (measured norms 1.6e-8 to 3.3e-7
    against a median of 0.14) and the relative distance of two rounding
    noises means nothing;
  * BatchNorm running statistics within 2e-4 (relative and absolute).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from segmentation_training_pipeline_tpu.models import factory as JF
from segmentation_training_pipeline_tpu.ops import losses as JLo
from segmentation_training_pipeline_tpu.ops import metrics as JM
from segmentation_training_pipeline_tpu.ops.aug import lowering as JL
from segmentation_training_pipeline_tpu.train import optimizers as JO
from segmentation_training_pipeline_tpu.train import step as JS
from segmentation_training_pipeline_tpu_torch import config as TC
from segmentation_training_pipeline_tpu_torch import kernels as K
from segmentation_training_pipeline_tpu_torch.models import bridge as BR
from segmentation_training_pipeline_tpu_torch.models import factory as TF
from segmentation_training_pipeline_tpu_torch.ops import losses as TLo
from segmentation_training_pipeline_tpu_torch.ops import metrics as TM
from segmentation_training_pipeline_tpu_torch.ops.aug import lowering as TL
from segmentation_training_pipeline_tpu_torch.train import optimizers as TO
from segmentation_training_pipeline_tpu_torch.train import step as TS

from torch_port_util import (blob_batch, capture_drop_masks,
                             few_torch_threads, interpret_kernels, jax_draws)

B, H = 2, 64
YAML = "examples/fpn_augmented_512.yaml"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _sd(tree, coll="params"):
    return BR.state_dict_from_jax({coll: _np(tree)})


@pytest.fixture(scope="module")
def both_steps():
    mp = pytest.MonkeyPatch()
    interpret_kernels(mp)
    mp.setenv("STP_FUSE_ELASTIC", "1")
    try:
        cfg = TC.parse(YAML)
        imgs, masks = blob_batch(B, H, H, seed=3)
        rng = jax.random.PRNGKey(11)

        jm = JF.create_model(cfg.architecture, cfg.backbone, cfg.classes,
                             dtype="float32")
        var = JF.init_model(jm, (H, H, 3), seed=0)
        jtx = JO.build_optimizer(cfg)
        jstep = JS.build_train_step(
            jm, jtx, JLo.build_loss(cfg.loss, cfg.activation),
            {"dice": JM.dice_score, "iou": JM.iou_score}, cfg.activation,
            None, aug_fn=JL.build_augmentation(
                JL._coerce_block(cfg.augmentation)), donate=False)
        jstate = JS.create_train_state(jm, var, jtx)
        drop = {}
        with capture_drop_masks(drop):
            jnew, jlogs = jstep(jstate, {"image": jnp.asarray(imgs),
                                         "mask": jnp.asarray(masks)},
                                cfg.lr, rng)
            jax.block_until_ready(jnew)
        jax.effects_barrier()

        tm = TF.create_model(cfg.architecture, cfg.backbone, cfg.classes,
                             dtype="float32")
        tm.load_state_dict(BR.state_dict_from_jax(_np(var)))
        ttx = TO.build_optimizer(cfg)
        aug = TL.build_augmentation(cfg.augmentation)
        tstep = TS.build_train_step(
            tm, ttx, TLo.build_loss(cfg.loss, cfg.activation),
            {m: TM.get(m) for m in cfg.metrics}, cfg.activation, None,
            aug=aug)
        tstate = TS.create_train_state(tm, ttx, device="cpu")
        aug_key, _ = jax.random.split(jax.random.fold_in(rng, 0))
        K.reset_launches()
        tnew, tlogs = tstep(
            tstate, {"image": torch.from_numpy(imgs),
                     "mask": torch.from_numpy(masks)}, cfg.lr,
            draws=jax_draws(aug, aug_key, B, H, H),
            drop_masks={n: torch.from_numpy(m) for n, m in drop.items()})
        launches = K.launch_counts()
    finally:
        mp.undo()
    return dict(jstate=jstate, jnew=jnew, jlogs=jlogs, tm=tm, tnew=tnew,
                tlogs=tlogs, launches=launches, drop=drop)


def test_loss_and_logs_match(both_steps):
    j, t = both_steps["jlogs"], both_steps["tlogs"]
    assert set(j) == set(t) == {"loss", "dice", "iou", "_wsum"}
    np.testing.assert_allclose(float(t["loss"]), float(j["loss"]), rtol=1e-4)
    for k in ("dice", "iou"):
        np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=1e-3)
    assert both_steps["launches"] == {n: 0 for n in K.KERNELS}
    assert set(both_steps["drop"]) == set(both_steps["tm"].drop_paths())


def test_gradients_match(both_steps):
    """The first Adam moment is 0.1·g: the gradients of both sides."""
    jmu = _sd(both_steps["jnew"].opt_state[0].mu)
    tmu = both_steps["tnew"].opt_state[0].mu
    assert set(jmu) == set(tmu)
    g = {n: (jmu[n].numpy() / 0.1, t.numpy() / 0.1) for n, t in tmu.items()}
    floor = 1e-5 * np.median([np.linalg.norm(gj) for gj, _ in g.values()])
    for name, (gj, gt) in g.items():
        assert np.abs(gj).max() > 0, name
        assert (np.linalg.norm(gt - gj)
                <= 0.06 * np.linalg.norm(gj) + floor), name
        if np.linalg.norm(gj) < floor:
            assert name.endswith("project_bn.bias"), name
    gj = np.concatenate([a.ravel() for a, _ in g.values()])
    gt = np.concatenate([b.ravel() for _, b in g.values()])
    assert np.linalg.norm(gt - gj) / np.linalg.norm(gj) <= 0.02


def test_batch_stats_match(both_steps):
    want = _sd(both_steps["jnew"].batch_stats, "batch_stats")
    got = both_steps["tnew"].batch_stats
    assert set(want) == set(got)
    for name, v in want.items():
        np.testing.assert_allclose(got[name].numpy(), v.numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def test_step_samples_drop_masks_from_gen(both_steps):
    """Without ``drop_masks`` the step draws them from ``gen`` after the
    augmentation's draws; without either it refuses."""
    tm = both_steps["tm"]
    cfg = TC.parse(YAML)
    ttx = TO.build_optimizer(cfg)
    step = TS.build_train_step(tm, ttx, TLo.build_loss(cfg.loss, "sigmoid"),
                               {}, "sigmoid", None)
    state = TS.create_train_state(tm, ttx, device="cpu")
    imgs, masks = blob_batch(B, 32, 32)
    batch = {"image": torch.from_numpy(imgs), "mask": torch.from_numpy(masks)}
    a, _ = step(state, batch, 1e-3, gen=torch.Generator().manual_seed(1))
    b, _ = step(state, batch, 1e-3, gen=torch.Generator().manual_seed(1))
    name = "encoder.stage6_block0.project.weight"
    assert torch.equal(a.params[name], b.params[name])
    with pytest.raises(ValueError, match="keep masks"):
        step(state, batch, 1e-3)
