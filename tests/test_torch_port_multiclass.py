"""BASELINE config 3's softmax path of the port against the JAX package.

Config 3 (``examples/multiclass_pspnet.yaml``: PSPNet-resnet50, 8 classes,
softmax, ``categorical_crossentropy + 0.5*dice_loss + 0.5*focal_loss``,
metrics accuracy, dice and iou, Adam at 5e-4) at 64², B2, float32, with
``class_weights``, on the CPU.  Both sides start from one weight set
(``random_weights``, bridged to flax, BatchNorm statistics perturbed) and one
batch: the JAX package's 3-class synthetic items, made by both packages'
generators from one seed.

Tolerances:
  * every loss and metric per example, and the loss gradients the train
    step takes: 1e-5 relative plus 1e-7 absolute (measured at most 0.05
    of that bound; float32 summation order).  The Lovász losses sort the
    errors; the draws have no ties, and ties could only reorder equal
    errors, which leaves the value as it is;
  * the train step, with ``test_torch_port_train.py``'s bounds and for its
    reasons (every ReLU and the max-pool make the f32 gradient a
    discontinuous function of the input): loss 1e-5 relative; accuracy,
    dice and iou 1e-4 absolute; gradients (the first Adam moment) within
    0.15 relative L2 distance per tensor and 0.08 over all (measured
    worst 0.015 and 0.012); the parameters the loss does not reach (C4
    and C5's stages) have a zero gradient on both sides; the first Adam
    step follows the sign of g: signs agree on at least 97% of the
    entries (measured 99.93%), where they agree and |g| > 1e-5 the
    parameters agree within 1e-6, every entry within 2·lr; BatchNorm
    statistics within 2e-4 relative and absolute (measured at most 0.38
    of that bound);
  * the eval step per example: loss 1e-5 relative, metrics 1e-4;
  * serving: the argmax masks are equal wherever the top two
    probabilities differ by more than 1e-3 (the logits agree within ~1e-6
    of the largest, ``test_torch_port_zoo.py``, so the probabilities
    within ~1e-5; measured 13 of 16384 pixels closer than that);
    ``evaluate`` within 1e-4.
"""

import csv
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from segmentation_training_pipeline_tpu import config as JC
from segmentation_training_pipeline_tpu.data import synthetic as JSY
from segmentation_training_pipeline_tpu.data.batcher import (
    prepare_mask as j_prepare_mask)
from segmentation_training_pipeline_tpu.data.datasets import (
    LambdaDataSet as JLambda)
from segmentation_training_pipeline_tpu.models import factory as JF
from segmentation_training_pipeline_tpu.ops import losses as JLo
from segmentation_training_pipeline_tpu.ops import metrics as JM
from segmentation_training_pipeline_tpu.train import checkpoint as JCK
from segmentation_training_pipeline_tpu.train import optimizers as JO
from segmentation_training_pipeline_tpu.train import step as JS
from segmentation_training_pipeline_tpu_torch import cli as TCLI
from segmentation_training_pipeline_tpu_torch import config as TC
from segmentation_training_pipeline_tpu_torch import kernels as K
from segmentation_training_pipeline_tpu_torch.data import synthetic as TSY
from segmentation_training_pipeline_tpu_torch.data.batcher import (
    prepare_mask)
from segmentation_training_pipeline_tpu_torch.data.datasets import (
    LambdaDataSet as TLambda)
from segmentation_training_pipeline_tpu_torch.models import bridge as BR
from segmentation_training_pipeline_tpu_torch.models import factory as TF
from segmentation_training_pipeline_tpu_torch.ops import losses as TLo
from segmentation_training_pipeline_tpu_torch.ops import metrics as TM
from segmentation_training_pipeline_tpu_torch.train import checkpoint as TCK
from segmentation_training_pipeline_tpu_torch.train import optimizers as TO
from segmentation_training_pipeline_tpu_torch.train import step as TS
from segmentation_training_pipeline_tpu_torch.utils import msgpack_tree as MT

from torch_port_util import (few_torch_threads, perturbed_batch_stats,
                             random_weights)

YAML = "examples/multiclass_pspnet.yaml"
B, H, CLASSES = 2, 64, 8
CLASS_WEIGHTS = [0.5, 1.0, 2.0, 1.5, 1.0, 0.75, 1.25, 3.0]
RTOL, ATOL = 1e-5, 1e-7
METRIC_ATOL = 1e-4
MARGIN = 1e-3
HEAD_SCALE = 4.0
# PSPNet reads C3: the encoder stages behind C4 and C5 get no gradient
UNREACHED = ("encoder.stage3_", "encoder.stage4_")
GRAD_REL, GRAD_REL_ALL = 0.15, 0.08


def _config3(**patch):
    """Config 3 as written, at the test's size, both packages' parses."""
    with open(YAML) as f:
        d = yaml.safe_load(f)
    d.update(shape=[H, H, 3], batch=B, dtype="float32",
             class_weights=CLASS_WEIGHTS, **patch)
    return JC.parse_dict(dict(d)), TC.parse_dict(dict(d))


def test_config3_parses_as_in_jax():
    j, t = JC.parse(YAML), TC.parse(YAML)
    keys = ("architecture", "backbone", "shape", "classes", "activation",
            "loss", "optimizer", "lr", "batch", "dtype", "metrics",
            "primary_metric")
    assert {k: getattr(t, k) for k in keys} == {k: getattr(j, k)
                                                for k in keys}
    assert (t.architecture, t.backbone, t.shape, t.classes, t.activation) \
        == ("PSPNet", "resnet50", (384, 384, 3), 8, "softmax")
    assert t.primary_mode() == j.primary_mode() == "max"


# ---------------------------------------------------------------------------
# losses and metrics, per example
# ---------------------------------------------------------------------------

def _labels(activation, c, seed):
    """Logits (3, 6, 5, c) and labels: one-hot classes under softmax,
    independent {0, 1} channels under sigmoid.  Continuous draws: no two
    Lovász errors tie."""
    r = np.random.RandomState(seed)
    logits = (r.randn(3, 6, 5, c) * 2.0).astype(np.float32)
    if activation == "softmax":
        y = np.eye(c, dtype=np.float32)[r.randint(0, c, (3, 6, 5))]
    else:
        y = (r.rand(3, 6, 5, c) > 0.6).astype(np.float32)
    return y, logits


def _takes_weights(fn):
    import inspect
    return "class_weights" in inspect.signature(fn).parameters


LOSS_CASES = [
    pytest.param(name, act, cw, id=f"{name}-{act}{'-cw' if cw else ''}")
    for name, fn, _ in JLo.registry_entries()
    for act in ("sigmoid", "softmax")
    for cw in ((False, True) if _takes_weights(fn) else (False,))]


@pytest.mark.parametrize("name,activation,weighted", LOSS_CASES)
def test_loss_per_example_and_gradient_match_jax(name, activation,
                                                 weighted):
    """Entry b is JAX's scalar loss on image b alone (its train step's
    ``jax.vmap(lambda y, lg: loss(y[None], lg[None]))``), and the
    gradient of the weighted batch loss is JAX's."""
    c = 4 if activation == "softmax" else 2
    y, logits = _labels(activation, c, seed=len(name))
    cw = [0.5, 2.0, 1.0, 1.5][:c] if weighted else None
    jfn = JLo._NAMES[name]
    kw = {"class_weights": cw} if weighted else {}
    w = np.array([1.0, 0.0, 0.5], np.float32)

    def jloss(lg):
        per = jax.vmap(lambda yt, lt: jfn(yt[None], lt[None], activation,
                                          **kw))(jnp.asarray(y), lg)
        return (per * w).sum() / w.sum(), per

    (_, want), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_(True)
    got = TLo.PER_EXAMPLE[name](torch.from_numpy(y), tl, activation, **kw)
    assert got.shape == (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    (got * torch.from_numpy(w)).sum().div(float(w.sum())).backward()
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgrad),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("expr", [
    "categorical_crossentropy + 0.5*dice_loss + 0.5*focal_loss",
    "lovasz_softmax + 0.5*jaccard - 0.25*mse + tversky_loss",
    "crossentropy + categorical_focal_loss + 0.1*mae + lovasz"],
    ids=["config3", "mixed", "aliases"])
def test_composite_loss_binds_class_weights_as_jax(expr):
    """``class_weights`` reach the terms whose function takes them, and no
    other (the Lovász and regression losses)."""
    y, logits = _labels("softmax", 4, seed=3)
    cw = [0.5, 2.0, 1.0, 1.5]
    jl = JLo.build_loss(expr, "softmax", cw)
    want = jax.vmap(lambda yt, lt: jl(yt[None], lt[None]))(
        jnp.asarray(y), jnp.asarray(logits))
    got = TLo.build_loss(expr, "softmax", cw).per_example(
        torch.from_numpy(y), torch.from_numpy(logits))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_every_name_and_alias_resolves_as_in_jax():
    for reg, port in ((JLo.registry_entries(), TLo.PER_EXAMPLE),
                      (JM.registry_entries(), TM.PER_EXAMPLE)):
        for name, _, aliases in reg:
            assert all(port[a] is port[name] for a in aliases), name
        assert len(set(port.values())) == len(reg)
    assert len(JLo.registry_entries()) == 14
    assert len(JM.registry_entries()) == 7


@pytest.mark.parametrize("name", [n for n, _, _ in JM.registry_entries()])
@pytest.mark.parametrize("activation", ["sigmoid", "softmax"])
def test_metric_per_example_matches_jax(name, activation):
    c = 4 if activation == "softmax" else 2
    y, logits = _labels(activation, c, seed=11)
    probs = np.asarray(JF.apply_activation(jnp.asarray(logits), activation))
    fn = JM.get(name)
    want = jax.vmap(lambda yt, pt: fn(yt[None], pt[None], activation))(
        jnp.asarray(y), jnp.asarray(probs))
    got = TM.get(name)(torch.from_numpy(y), torch.from_numpy(probs),
                       activation)
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_multiclass_synthetic_items_equal_jax():
    j = JSY.generate_multiclass_shapes_dataset(4, 48, seed=5)
    t = TSY.generate_multiclass_shapes_dataset(4, 48, seed=5)
    for i in range(4):
        assert j[i].id == t[i].id
        assert np.array_equal(j[i].x, t[i].x)
        assert np.array_equal(j[i].y, t[i].y)
    assert set(np.unique(np.concatenate([t[i].y for i in range(4)]))) == {
        0, 1, 2}


# ---------------------------------------------------------------------------
# one config-3 train step and eval step, then its checkpoint served
# ---------------------------------------------------------------------------

def _batch():
    ds = TSY.generate_multiclass_shapes_dataset(B, H, seed=21)
    imgs = np.stack([ds[i].x for i in range(B)])
    masks = np.stack([prepare_mask(ds[i].y, (H, H, 3), CLASSES, "softmax")
                      for i in range(B)])
    assert np.array_equal(masks, np.stack([j_prepare_mask(
        ds[i].y, (H, H, 3), CLASSES, "softmax") for i in range(B)]))
    return imgs, masks


@pytest.fixture(scope="module")
def step3():
    jcfg, tcfg = _config3()
    tm = random_weights(TF.model_from_config(tcfg), 0)
    var = perturbed_batch_stats(BR.jax_from_state_dict(tm.state_dict()), 1)
    tm.load_state_dict(BR.state_dict_from_jax(var))
    jm = JF.model_from_config(jcfg)
    imgs, masks = _batch()

    jtx = JO.build_optimizer(jcfg)
    jloss = JLo.build_loss(jcfg.loss, "softmax", jcfg.class_weights)
    jmetrics = {m: JM.get(m) for m in jcfg.metrics}
    jstep = JS.build_train_step(jm, jtx, jloss, jmetrics, "softmax", None,
                                donate=False)
    jstate = JS.create_train_state(jm, var, jtx)
    jbatch = {"image": jnp.asarray(imgs), "mask": jnp.asarray(masks)}
    jnew, jlogs = jstep(jstate, jbatch, jcfg.lr, jax.random.PRNGKey(0))
    jeval = JS.build_eval_step(jm, jloss, jmetrics, "softmax", None)(
        jstate, {**jbatch, "weight": jnp.ones(B)})

    ttx = TO.build_optimizer(tcfg)
    tloss = TLo.build_loss(tcfg.loss, "softmax", tcfg.class_weights)
    tmetrics = {m: TM.get(m) for m in tcfg.metrics}
    tstate = TS.create_train_state(tm, ttx, device="cpu")
    tbatch = {"image": torch.from_numpy(imgs),
              "mask": torch.from_numpy(masks)}
    K.reset_launches()
    tnew, tlogs = TS.build_train_step(tm, ttx, tloss, tmetrics, "softmax",
                                      None)(tstate, tbatch, tcfg.lr)
    teval = TS.build_eval_step(tm, tloss, tmetrics, "softmax", None)(
        tstate, {**tbatch, "weight": torch.ones(B)})
    return dict(var=var, jm=jm, tm=tm, lr=tcfg.lr, jstate=jstate, jnew=jnew,
                jlogs=jlogs, tstate=tstate, tnew=tnew, tlogs=tlogs,
                jeval=jeval, teval=teval, launches=K.launch_counts())


def _sd(tree, coll="params"):
    return BR.state_dict_from_jax({coll: jax.tree.map(np.asarray, tree)})


def test_step_loss_and_logs_match_jax(step3):
    j, t = step3["jlogs"], step3["tlogs"]
    assert set(j) == set(t) == {"loss", "accuracy", "dice", "iou", "_wsum"}
    np.testing.assert_allclose(float(t["loss"]), float(j["loss"]), rtol=RTOL)
    for k in ("accuracy", "dice", "iou"):
        assert abs(float(t[k]) - float(j[k])) <= METRIC_ATOL, k
    assert float(t["_wsum"]) == float(j["_wsum"]) == B
    assert step3["launches"] == {n: 0 for n in K.KERNELS}


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_step_gradients_and_update_match_jax(step3):
    """The first Adam moment is 0.1·g: both sides' gradients, then the
    first Adam step, which follows the sign of g."""
    jmu = _sd(step3["jnew"].opt_state[0].mu)
    tmu = step3["tnew"].opt_state[0].mu
    assert set(jmu) == set(tmu) == set(step3["tnew"].params)
    jp = _sd(step3["jnew"].params)
    reached, agree, total = [], 0, 0
    for name, t in tmu.items():
        gj, gt = jmu[name].numpy(), t.numpy()
        if name.startswith(UNREACHED):
            assert not gj.any() and not gt.any(), name
            continue
        assert np.abs(gj).max() > 0, name
        assert _rel_l2(gt, gj) <= GRAD_REL, name
        reached.append((gj.ravel(), gt.ravel()))
        diff = np.abs(step3["tnew"].params[name].numpy() - jp[name].numpy())
        same = np.sign(gj) == np.sign(gt)
        firm = same & (np.abs(gj) > 1e-5) & (np.abs(gt) > 1e-5)
        assert diff[firm].max(initial=0.0) <= 1e-6, name
        assert diff.max() <= 2 * step3["lr"], name
        agree += int(same.sum())
        total += same.size
    assert _rel_l2(np.concatenate([b for _, b in reached]),
                   np.concatenate([a for a, _ in reached])) <= GRAD_REL_ALL
    assert agree >= 0.97 * total


def test_step_batch_statistics_match_jax(step3):
    want = _sd(step3["jnew"].batch_stats, "batch_stats")
    got = step3["tnew"].batch_stats
    assert set(want) == set(got)
    for name, v in want.items():
        v = v.numpy()
        np.testing.assert_allclose(got[name].numpy(), v, rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def test_eval_step_matches_jax(step3):
    j, t = step3["jeval"], step3["teval"]
    assert set(j) == set(t)
    np.testing.assert_allclose(t["loss"].numpy(), np.asarray(j["loss"]),
                               rtol=RTOL)
    for k in ("accuracy", "dice", "iou"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   atol=METRIC_ATOL, err_msg=k)


@pytest.fixture(scope="module")
def served(step3, tmp_path_factory):
    """The JAX step's updated variables, the logits head scaled so that
    the argmax is decisive, written by the JAX package as fold 0."""
    root = tmp_path_factory.mktemp("config3")
    jcfg, tcfg = _config3(folds_count=1, directory=str(root))
    var = jax.tree.map(np.asarray, {"params": step3["jnew"].params,
                                    "batch_stats": step3["jnew"].batch_stats})
    ds = TSY.generate_multiclass_shapes_dataset(4, H, seed=33)
    xs = [ds[i].x for i in range(4)]
    ys = [ds[i].y for i in range(4)]
    # a random head with logits of spread HEAD_SCALE: an argmax that varies
    # over the image and rarely ties
    k = np.random.RandomState(4).randn(
        *var["params"]["logits_conv"]["kernel"].shape).astype(np.float32)
    tm = TF.model_from_config(tcfg)
    tm.load_state_dict(BR.state_dict_from_jax(var))
    with torch.no_grad():
        tm.logits_conv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
        tm.logits_conv.bias.zero_()
        x = torch.from_numpy(np.stack(xs)).float() / 127.5 - 1.0
        spread = float(tm(x).std())
    var["params"]["logits_conv"] = {
        "kernel": k * (HEAD_SCALE / spread),
        "bias": np.zeros(CLASSES, np.float32)}
    path = jcfg.weights_path(0, 0)
    JCK.save_checkpoint(path, var, {"fold": 0, "stage": 0,
                                    "encoder_variant": ""})
    ids = [f"m{i}" for i in range(4)]
    return dict(root=root, path=path, var=var, xs=xs, ys=ys, ids=ids,
                jcfg=jcfg, tcfg=tcfg)


def test_jax_written_pspnet_checkpoint_reads_and_re_encodes(served,
                                                            tmp_path):
    model = TF.model_from_config(served["tcfg"])
    sd = TCK.load_checkpoint(served["path"], model)
    want = BR.state_dict_from_jax(served["var"])
    assert set(sd) == set(want) == set(model.state_dict())
    for k, v in want.items():
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k
    raw = open(served["path"], "rb").read()
    assert MT.packb(MT.unpackb(raw)) == raw
    TCK.save_checkpoint(str(tmp_path / "port.weights"), sd)
    assert open(tmp_path / "port.weights", "rb").read() == raw


def test_served_argmax_masks_match_jax(served, tmp_path):
    jcfg, tcfg = served["jcfg"], served["tcfg"]
    xs, ids = served["xs"], served["ids"]
    # the port's probabilities mark the near ties: they agree with JAX's
    # within 1e-5, far inside MARGIN
    probs = {it.id: it.prediction for it in tcfg.predict_on_dataset(
        TLambda(xs, None, ids), device="cpu")}
    jcfg.predict_all_to_dir(JLambda(xs, None, ids), str(tmp_path / "j"))
    tcfg.predict_all_to_dir(TLambda(xs, None, ids), str(tmp_path / "t"),
                            device="cpu")
    near, classes = 0, set()
    for i in ids:
        w = cv2.imread(str(tmp_path / "j" / f"{i}.png"), cv2.IMREAD_UNCHANGED)
        g = cv2.imread(str(tmp_path / "t" / f"{i}.png"), cv2.IMREAD_UNCHANGED)
        assert g.shape == w.shape == (H, H) and g.dtype == np.uint8
        top2 = np.sort(probs[i], axis=-1)[..., -2:]
        close = top2[..., 1] - top2[..., 0] <= MARGIN
        np.testing.assert_array_equal(g[~close], w[~close])
        near += int(close.sum())
        classes |= set(np.unique(g).tolist())
    assert near <= 0.01 * len(ids) * H * H
    assert len(classes) > 1 and max(classes) < CLASSES


def test_evaluate_ignores_the_threshold_under_softmax(served):
    jcfg, tcfg = served["jcfg"], served["tcfg"]
    xs, ys, ids = served["xs"], served["ys"], served["ids"]
    want = jcfg.evaluate(JLambda(xs, ys, ids), threshold=0.3)
    got = tcfg.evaluate(TLambda(xs, ys, ids), threshold=0.3, device="cpu")
    assert tcfg.evaluate(TLambda(xs, ys, ids), device="cpu") == got
    assert set(got) == set(want) == {"accuracy", "dice", "iou"}
    for k in want:
        assert abs(got[k] - want[k]) <= METRIC_ATOL, k


def test_cli_fit_then_predict_writes_class_index_masks(tmp_path, capsys):
    """Config 3's softmax path through the CLI on class-index PNG masks,
    narrowed to PSPNet-resnet18 at 32² for the clock: the JAX CSV columns
    for config 3's metrics, and predicted masks of class indices."""
    ds = TSY.generate_multiclass_shapes_dataset(6, 32, seed=4)
    images, masks = tmp_path / "images", tmp_path / "masks"
    images.mkdir()
    masks.mkdir()
    for i in range(len(ds)):
        cv2.imwrite(str(images / f"{ds[i].id}.png"),
                    cv2.cvtColor(ds[i].x, cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(masks / f"{ds[i].id}.png"), ds[i].y)
    with open(YAML) as f:
        d = yaml.safe_load(f)
    d.update(backbone="resnet18", shape=[32, 32, 3], batch=2, classes=3,
             dtype="float32", folds_count=2, stages=[{"epochs": 1}],
             verbose=0)
    yml = tmp_path / "exp" / "cfg.yaml"
    yml.parent.mkdir()
    yml.write_text(yaml.safe_dump(d))
    assert TCLI.main(["fit", str(yml), "--images", str(images), "--masks",
                      str(masks), "--folds", "0", "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert list(res) == ["fold0.stage0"]
    with open(tmp_path / "exp" / "metrics" / "metrics-0.0.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["epoch", "lr", "accuracy", "dice", "iou", "loss",
                       "val_accuracy", "val_dice", "val_iou", "val_loss",
                       "time"]
    assert len(rows) == 2 and all(np.isfinite(float(v)) for v in rows[1])
    assert TCLI.main(["predict", str(yml), str(images),
                      str(tmp_path / "out"), "--device", "cpu"]) == 0
    for name in os.listdir(images):
        m = cv2.imread(str(tmp_path / "out" / name), cv2.IMREAD_UNCHANGED)
        assert m.shape == (32, 32) and m.dtype == np.uint8
        assert int(m.max()) < 3
