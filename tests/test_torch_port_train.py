"""One train step of the port against the JAX train step.

Unet-resnet34 at 2×64² in float32, sigmoid, ``binary_crossentropy +
0.25*dice_loss``, Adam, with the config-2 augmentation block (Fliplr,
Affine, ElasticTransformation, Multiply).  Both sides start from the same
weights (the flax init, carried over by ``models.bridge``), see the same
batch and the same augmentation draws (made with ``jax.random`` along the
reference's key schedule, ``tests/torch_port_util.py``); the JAX side runs
its Pallas kernels in interpret mode, the port its kernels' plain versions.

Tolerances and why.  Every ReLU and the max-pool make the gradient a
discontinuous function of the input: an f32 rounding difference, or the
augmented images' difference of up to 1e-2 (the reference's warp dots run
as three bf16 passes, ``_dot3``), flips pre-activations that sit near 0
and moves the gradients of every tensor upstream of them.  At this size
the port's own f32 gradients move by up to ~6% of a tensor's largest
value when its input moves by 1e-6 relative.  So the f32 step is held to
that noise floor, and ``test_backward_matches_flax_in_float64`` pins the
backward itself, where no pre-activation flips:
  * loss and metrics within 1e-5 relative (measured 1.4e-6);
  * gradients: relative L2 distance per tensor within 0.15 and over all
    tensors within 0.08 (measured worst 0.072 and 0.048);
  * Adam's first moment is 0.1·g (the same bounds); its second moment
    0.001·g² within 0.2 per tensor (measured worst 0.081);
  * params: the first Adam step moves each weight by lr·g/(|g| + eps),
    about ±lr, so it follows the SIGN of g: signs agree on at least 97% of
    the entries (measured 98.8%); where the signs agree and |g| > 1e-5 on
    both sides (a thousand times Adam's eps, so the step is within
    lr·1e-3 of ±lr) the params agree within 1e-6; every entry within
    2·lr;
  * BatchNorm running statistics within 2e-4 (relative and absolute;
    measured worst 4.8e-5): the forward only, moved by the input
    difference above;
  * in float64 on the same input (model, loss and backward; the 1×1 head
    and the loss run in f32 on both sides) gradients within 1e-5 of each
    tensor's largest |g| (measured 5e-7).
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

from torch_port_util import (CONFIG2_BLOCK, blob_batch, interpret_kernels,
                             jax_draws)

B, H, LR = 2, 64, 5e-4
LOSS = "binary_crossentropy + 0.25*dice_loss"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def both_steps():
    mp = pytest.MonkeyPatch()
    interpret_kernels(mp)
    try:
        cfg = TC.parse_dict({"architecture": "Unet", "backbone": "resnet34",
                             "loss": LOSS, "optimizer": "Adam", "lr": LR,
                             "augmentation": CONFIG2_BLOCK,
                             "metrics": ["dice", "iou"]})
        imgs, masks = blob_batch(B, H, H, seed=3)
        rng = jax.random.PRNGKey(7)

        jm = JF.create_model("Unet", "resnet34", 1, dtype="float32")
        var = JF.init_model(jm, (H, H, 3), seed=0)
        jtx = JO.build_optimizer(cfg)
        jstep = JS.build_train_step(
            jm, jtx, JLo.build_loss(LOSS, "sigmoid"),
            {"dice": JM.dice_score, "iou": JM.iou_score}, "sigmoid", None,
            aug_fn=JL.build_augmentation(JL._coerce_block(CONFIG2_BLOCK)),
            donate=False)
        jstate = JS.create_train_state(jm, var, jtx)
        jnew, jlogs = jstep(jstate, {"image": jnp.asarray(imgs),
                                     "mask": jnp.asarray(masks)}, LR, rng)
        jax.block_until_ready(jnew)

        tm = TF.create_model(cfg.architecture, cfg.backbone, 1,
                             dtype="float32")
        tm.load_state_dict(BR.state_dict_from_jax(_np(var)))
        ttx = TO.build_optimizer(cfg.optimizer)
        aug = TL.build_augmentation(cfg.augmentation)
        tstep = TS.build_train_step(
            tm, ttx, TLo.build_loss(cfg.loss, "sigmoid"),
            {m: TM.get(m) for m in cfg.metrics}, "sigmoid", None, aug=aug)
        tstate = TS.create_train_state(tm, ttx, device="cpu")
        # the reference's step draws its augmentation from this key
        aug_key, _ = jax.random.split(jax.random.fold_in(rng, 0))
        K.reset_launches()
        tnew, tlogs = tstep(tstate, {"image": torch.from_numpy(imgs),
                                     "mask": torch.from_numpy(masks)}, LR,
                            draws=jax_draws(aug, aug_key, B, H, H))
        launches = K.launch_counts()
    finally:
        mp.undo()
    return dict(var=_np(var), jstate=jstate, jnew=jnew, jlogs=jlogs,
                tstate=tstate, tnew=tnew, tlogs=tlogs, launches=launches)


def _sd(tree, coll="params"):
    return BR.state_dict_from_jax({coll: _np(tree)})


def test_loss_and_logs_match(both_steps):
    j, t = both_steps["jlogs"], both_steps["tlogs"]
    assert set(j) == set(t) == {"loss", "dice", "iou", "_wsum"}
    np.testing.assert_allclose(float(t["loss"]), float(j["loss"]), rtol=1e-5)
    for k in ("dice", "iou"):
        np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=1e-5)
    assert float(t["_wsum"]) == float(j["_wsum"]) == B
    assert both_steps["launches"] == {"warp_x": 0, "warp_y": 0, "elastic": 0}
    assert both_steps["tnew"].step == 1


def _grads(both_steps):
    """The first Adam moment is 0.1·g: the gradients of both sides."""
    jmu = _sd(both_steps["jnew"].opt_state[0].mu)
    tmu = both_steps["tnew"].opt_state.mu
    return {k: (jmu[k].numpy() / 0.1, tmu[k].numpy() / 0.1) for k in tmu}


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_gradients_match(both_steps):
    g = _grads(both_steps)
    assert len(g) == len(_sd(both_steps["jstate"].params))
    for name, (gj, gt) in g.items():
        assert np.abs(gj).max() > 0, name
        assert _rel_l2(gt, gj) <= 0.15, name
    assert _rel_l2(np.concatenate([gt.ravel() for _, gt in g.values()]),
                   np.concatenate([gj.ravel() for gj, _ in g.values()])
                   ) <= 0.08


def test_adam_second_moment_matches(both_steps):
    jnu = _sd(both_steps["jnew"].opt_state[0].nu)
    for name, nu in both_steps["tnew"].opt_state.nu.items():
        assert _rel_l2(nu.numpy(), jnu[name].numpy()) <= 0.2, name
    assert both_steps["tnew"].opt_state.count == 1
    assert int(both_steps["jnew"].opt_state[0].count) == 1


def test_updated_params_match(both_steps):
    jp = _sd(both_steps["jnew"].params)
    g = _grads(both_steps)
    agree = total = 0
    for name, p in both_steps["tnew"].params.items():
        diff = np.abs(p.numpy() - jp[name].numpy())
        gj, gt = g[name]
        same = np.sign(gj) == np.sign(gt)
        firm = same & (np.abs(gj) > 1e-5) & (np.abs(gt) > 1e-5)
        assert diff[firm].max(initial=0.0) <= 1e-6, name
        assert diff.max() <= 2 * LR, name
        agree += int(same.sum())
        total += same.size
    assert agree >= 0.97 * total
    # the input state is untouched (a step returns a new state)
    old = _sd(both_steps["jstate"].params)
    for name, p in both_steps["tstate"].params.items():
        assert torch.equal(p, old[name]), name


def test_batch_stats_match(both_steps):
    want = _sd(both_steps["jnew"].batch_stats, "batch_stats")
    got = both_steps["tnew"].batch_stats
    assert set(want) == set(got)
    for name, v in want.items():
        np.testing.assert_allclose(got[name].numpy(), v.numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def test_backward_matches_flax_in_float64(both_steps):
    """Model, loss and backward on the same input in float64 (the 1×1 head
    and the loss cast to f32 on both sides, as in f32 runs)."""
    var = both_steps["var"]
    imgs, masks = blob_batch(B, H, H, seed=3)
    x = imgs.astype(np.float64) / 127.5 - 1.0
    loss_j = JLo.build_loss(LOSS, "sigmoid")
    with jax.enable_x64():
        jm = JF.SegmentationModel("Unet", "resnet34", 1, dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), var)

        def f(params):
            logits, _ = jm.apply({"params": params,
                                  "batch_stats": v64["batch_stats"]},
                                 jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
            return loss_j(jnp.asarray(masks), logits)

        jloss, jg = jax.value_and_grad(f)(v64["params"])
        jg = _sd(jg)
    tm = TF.SegmentationModel("Unet", "resnet34", 1, dtype=torch.float64)
    tm.load_state_dict(BR.state_dict_from_jax(var))
    tm.double()
    params, stats = TF.model_variables(tm)
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    logits, _ = TF.apply_model(tm, params, stats, torch.from_numpy(x),
                               train=True)
    tloss = TLo.build_loss(LOSS, "sigmoid")(torch.from_numpy(masks), logits)
    tg = torch.autograd.grad(tloss, list(params.values()))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-6)
    for name, g in zip(params, tg):
        want = jg[name].numpy()
        assert want.dtype == np.float64
        assert np.abs(g.numpy() - want).max() <= 1e-5 * np.abs(want).max(), \
            name
