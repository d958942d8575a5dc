"""The port's fit loop against the JAX package's, on the CPU.

Both packages fit fold 0 of the same 12-image synthetic set (2 folds) with
the same config: Unet-resnet18 at 32², float32, B4, bce + 0.25·dice, Adam
(spelled ``unet`` and ``adam``: both keep the spelling in the sidecars),
``primary_metric: val_dice``, and two stages: the encoder frozen at lr 1e-3
with ``negatives: none``, then unfrozen at lr 1e-4 with ``negatives: real``
and ``ReduceLROnPlateau``.  Stage 0 starts both from the same variables, a
file the JAX package's ``save_checkpoint`` wrote (``initial_weights``).  No
augmentation, so nothing random is left in either fit.

Compared exactly: the file layout, the sidecar keys and ``done`` markers,
the summary dict's keys, the CSV headers, epochs and learning rates, the
frozen encoder's parameters (bit for bit, equal to the initial file on both
sides), and resume (a re-run skips done stages, a stage without ``done``
appends to its CSV).  Compared within a tolerance:

  * ``FIRST_RTOL`` = 1e-4 on the first epoch's train and validation loss
    (measured 1e-5 and 2e-5), and ``STAT_RTOL`` = 1e-5 on the frozen
    encoder's BatchNorm statistics after stage 0 (measured 3e-6 absolute):
    up to there both fits see the same batches and weights;
  * stage 1's update of each encoder parameter, Δ = best-0.1 − best-0.0
    (4 Adam steps at lr 1e-4, each element moving by at most 4e-4, far
    inside ``PARAM_ATOL``): non-zero in every tensor, as JAX's, with
    ‖Δport‖/‖Δjax‖ within ``DELTA_RATIO`` = [0.5, 2] (measured 0.84-1.13)
    and cosine ≥ ``DELTA_COS`` = 0.1 (measured ≥ 0.22, 0.39 over the whole
    encoder).  The directions differ for the reason below; a stage that
    left the encoder frozen, dropped its updates or took another lr would
    fail;
  * ``LOSS_RTOL`` = 1e-2 on every later loss (measured ≤ 1.1e-3),
    ``METRIC_ATOL`` = 3e-2 on dice, iou and ``best`` (measured ≤ 8e-3),
    ``PARAM_ATOL`` = 1e-2 on the trained parameters (measured 7e-3), and
    the other BatchNorm statistics within ``SHARE`` = 0.35 of the tensor's
    largest value (measured 0.21).  These are loose because the fits drift
    apart: a B4 batch at 32² reaches the deepest blocks as 4-16 values per
    channel, so the train-mode BatchNorm turns summation-order rounding into
    gradients that differ by up to ~15% per tensor
    (``test_torch_port_train.py``), and Adam moves every weight by about
    ±lr a step whatever its gradient's size, so a differing sign moves a
    weight by 2·lr.  Dice and iou threshold at 0.5: one flipped pixel moves
    a small mask's score by ~1e-2.

Also: a fit with BASELINE config 4's augmentation block on the port alone
(finite losses: the two frameworks cannot share the draws inside ``fit``),
the CLI's ``fit`` then ``predict`` on a PNG directory with the JAX CLI's
layout, and ``transforms:`` with a fully fixed spec against JAX in
evaluation and prediction.
"""

import csv
import json
import os
import shutil

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from segmentation_training_pipeline_tpu import config as JC
from segmentation_training_pipeline_tpu import infer as JI
from segmentation_training_pipeline_tpu.data.datasets import (
    LambdaDataSet as JLambda)
from segmentation_training_pipeline_tpu.models import factory as JF
from segmentation_training_pipeline_tpu.ops import losses as JLo
from segmentation_training_pipeline_tpu.ops import metrics as JM
from segmentation_training_pipeline_tpu.ops.aug import lowering as JL
from segmentation_training_pipeline_tpu.train import checkpoint as JCK
from segmentation_training_pipeline_tpu.train import step as JS
from segmentation_training_pipeline_tpu_torch import cli as TCLI
from segmentation_training_pipeline_tpu_torch import config as TC
from segmentation_training_pipeline_tpu_torch import infer as TI
from segmentation_training_pipeline_tpu_torch import kernels as K
from segmentation_training_pipeline_tpu_torch.data.datasets import (
    LambdaDataSet as TLambda)
from segmentation_training_pipeline_tpu_torch.data.synthetic import (
    generate_shapes_dataset, write_shapes_dataset)
from segmentation_training_pipeline_tpu_torch.models import bridge as BR
from segmentation_training_pipeline_tpu_torch.models import factory as TF
from segmentation_training_pipeline_tpu_torch.ops import losses as TLo
from segmentation_training_pipeline_tpu_torch.ops import metrics as TM
from segmentation_training_pipeline_tpu_torch.ops.aug import lowering as TL
from segmentation_training_pipeline_tpu_torch.train import checkpoint as TCK
from segmentation_training_pipeline_tpu_torch.train import stage as TST
from segmentation_training_pipeline_tpu_torch.train import step as TS

from torch_port_util import few_torch_threads  # noqa: F401

H, N = 32, 12
FIRST_RTOL, STAT_RTOL = 1e-4, 1e-5
LOSS_RTOL, METRIC_ATOL, PARAM_ATOL, SHARE = 1e-2, 3e-2, 1e-2, 0.35
DELTA_RATIO, DELTA_COS = (0.5, 2.0), 0.1
LOSS = "binary_crossentropy + 0.25*dice_loss"
CONFIG = {
    "architecture": "unet", "backbone": "resnet18", "shape": [H, H, 3],
    "classes": 1, "activation": "sigmoid", "loss": LOSS, "optimizer": "adam",
    "batch": 4, "dtype": "float32", "metrics": ["dice", "iou"],
    "primary_metric": "val_dice", "folds_count": 2, "random_state": 33,
    "verbose": 0,
    "stages": [
        {"epochs": 2, "freeze_encoder": True, "lr": 1e-3,
         "negatives": "none", "initial_weights": "init.weights"},
        {"epochs": 2, "unfreeze_encoder": True, "lr": 1e-4,
         "negatives": "real",
         "callbacks": {"ReduceLROnPlateau": {"monitor": "val_dice",
                                             "patience": 1,
                                             "factor": 0.5}}},
    ],
}
# BASELINE config 4's augmentation block (examples/kfold_multistage.yaml)
CONFIG4_BLOCK = {"Fliplr": 0.5, "Affine": {"rotate": [-10, 10]}}
# a transforms block that leaves no value random
FIXED_TRANSFORMS = {"Fliplr": 1.0, "Flipud": 0.0, "Multiply": 1.25}


def _data():
    ds = generate_shapes_dataset(N, H, seed=11, p_empty=0.25)
    xs = [ds[i].x for i in range(N)]
    ys = [ds[i].y for i in range(N)]
    return xs, ys


def _write_init(directory):
    jm = JF.create_model("Unet", "resnet18", 1, dtype="float32")
    var = jax.tree.map(np.asarray, JF.init_model(jm, (H, H, 3), seed=4))
    JCK.save_checkpoint(os.path.join(directory, "init.weights"), var)
    return var


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """One JAX fit and one port fit of fold 0 from the same variables."""
    xs, ys = _data()
    dirs = {s: tmp_path_factory.mktemp(f"fit_{s}") for s in "jt"}
    var = _write_init(str(dirs["j"]))
    shutil.copy(dirs["j"] / "init.weights", dirs["t"] / "init.weights")
    jcfg = JC.parse_dict(CONFIG, directory=str(dirs["j"]))
    tcfg = TC.parse_dict(CONFIG, directory=str(dirs["t"]))
    jres = jcfg.fit(JLambda(xs, ys), foldsToExecute=[0])
    tres = tcfg.fit(TLambda(xs, ys), foldsToExecute=[0], device="cpu")
    return dict(dirs=dirs, var=var, jcfg=jcfg, tcfg=tcfg, jres=jres,
                tres=tres, xs=xs, ys=ys)


def _listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _rows(path):
    return list(csv.reader(open(path)))


def test_plans_have_negatives_to_drop(fits):
    """The premise: ``negatives: none`` and ``real`` give different plans
    on fold 0."""
    k = fits["tcfg"].kfold(TLambda(fits["xs"], fits["ys"]))
    assert len(k.epoch_indices(0, 0, "none")) < len(
        k.epoch_indices(0, 0, "real"))


def test_layout_sidecars_and_summary_match_jax(fits):
    dirs = fits["dirs"]
    assert _listing(dirs["t"]) == _listing(dirs["j"]) == [
        "init.weights", "metrics/metrics-0.0.csv", "metrics/metrics-0.1.csv",
        "weights/best-0.0.weights", "weights/best-0.0.weights.json",
        "weights/best-0.1.weights", "weights/best-0.1.weights.json"]
    for s in (0, 1):
        jm = json.load(open(fits["jcfg"].weights_path(0, s) + ".json"))
        tm = json.load(open(fits["tcfg"].weights_path(0, s) + ".json"))
        assert list(tm) == list(jm)
        assert tm["done"] is True and jm["done"] is True
        for k in jm:
            if k == "best":
                assert abs(tm[k] - jm[k]) <= METRIC_ATOL
            else:
                assert tm[k] == jm[k], k
    jr, tr = fits["jres"], fits["tres"]
    assert list(tr) == list(jr) == ["fold0.stage0", "fold0.stage1"]
    for key in jr:
        assert list(tr[key]) == list(jr[key])
        assert tr[key]["epochs"] == jr[key]["epochs"] == 2
        assert os.path.relpath(tr[key]["checkpoint"], dirs["t"]) == \
            os.path.relpath(jr[key]["checkpoint"], dirs["j"])
        assert abs(tr[key]["best"] - jr[key]["best"]) <= METRIC_ATOL


@pytest.mark.parametrize("stage", [0, 1])
def test_csv_rows_match_jax(fits, stage):
    want = _rows(fits["jcfg"].metrics_path(0, stage))
    got = _rows(fits["tcfg"].metrics_path(0, stage))
    assert got[0] == want[0] == ["epoch", "lr", "dice", "iou", "loss",
                                 "val_dice", "val_iou", "val_loss", "time"]
    assert len(got) == len(want) == 3
    for row, (g, w) in enumerate(zip(got[1:], want[1:])):
        assert g[:2] == w[:2]                      # epoch, lr
        for col in range(2, 8):
            a, b = float(g[col]), float(w[col])
            if got[0][col].endswith("loss"):
                tol = (FIRST_RTOL if (stage, row) == (0, 0)
                       else LOSS_RTOL) * abs(b)
            else:
                tol = METRIC_ATOL
            assert abs(a - b) <= tol, (got[0][col], row, a, b)
        assert all(np.isfinite(float(v)) for v in g[2:])


def _port_state(cfg, stage):
    model = TF.create_model("Unet", "resnet18", 1, dtype="float32")
    return TCK.load_checkpoint(cfg.weights_path(0, stage), model)


def test_checkpoints_match_jax_and_frozen_encoder_is_bit_identical(fits):
    init = BR.state_dict_from_jax(fits["var"])
    for stage in (0, 1):
        jvar = jax.tree.map(np.asarray, JCK.load_checkpoint(
            fits["jcfg"].weights_path(0, stage), fits["var"]))
        want = BR.state_dict_from_jax(jvar)
        got = _port_state(fits["tcfg"], stage)
        assert set(got) == set(want)
        for k, v in want.items():
            g, w = got[k].numpy(), v.numpy()
            stat = k.endswith(("running_mean", "running_var"))
            if stage == 0 and k.startswith("encoder.") and not stat:
                assert torch.equal(got[k], init[k]), k
                assert torch.equal(v, init[k]), k
            elif stage == 0 and k.startswith("encoder."):
                np.testing.assert_allclose(g, w, rtol=STAT_RTOL,
                                           atol=STAT_RTOL, err_msg=k)
            elif stat:
                assert np.abs(g - w).max() <= SHARE * np.abs(w).max(), k
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_ATOL,
                                           err_msg=f"stage {stage} {k}")
        # the frozen stage still moves the encoder's BatchNorm statistics
        moved = [k for k in got if k.startswith("encoder.")
                 and k.endswith("running_mean")
                 and not torch.equal(got[k], init[k])]
        assert moved and all(not torch.equal(want[k], init[k])
                             for k in moved)


def _jax_state(fits, stage):
    return BR.state_dict_from_jax(jax.tree.map(np.asarray, JCK.load_checkpoint(
        fits["jcfg"].weights_path(0, stage), fits["var"])))


def test_unfrozen_stage_moves_the_encoder_as_jax(fits):
    """Stage 1 (``unfreeze_encoder``) updates every encoder parameter, by
    as much as JAX's stage 1 and in a like direction."""
    t0, t1 = (_port_state(fits["tcfg"], s) for s in (0, 1))
    j0, j1 = (_jax_state(fits, s) for s in (0, 1))
    enc = [k for k in t0 if k.startswith("encoder.") and not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    assert enc
    for k in enc:
        dt = (t1[k] - t0[k]).double().flatten()
        dj = (j1[k] - j0[k]).double().flatten()
        assert dj.abs().max() > 0 and dt.abs().max() > 0, k
        ratio = float(dt.norm() / dj.norm())
        cos = float(dt @ dj / (dt.norm() * dj.norm()))
        assert DELTA_RATIO[0] <= ratio <= DELTA_RATIO[1], (k, ratio)
        assert cos >= DELTA_COS, (k, cos)


def test_refit_skips_done_stages_and_resumes_a_crashed_one(fits, tmp_path):
    """A re-run skips both stages (same summary keys as JAX); with the last
    stage's ``done`` marker cleared, that stage runs again and appends its
    rows under the existing header, in both packages."""
    xs, ys = fits["xs"], fits["ys"]
    again = fits["tcfg"].fit(TLambda(xs, ys), foldsToExecute=[0],
                             device="cpu")
    jagain = fits["jcfg"].fit(JLambda(xs, ys), foldsToExecute=[0])
    assert again == {k: {**v, "checkpoint": fits["tcfg"].weights_path(
        0, int(k[-1]))} for k, v in again.items()}
    for key in jagain:
        assert list(again[key]) == list(jagain[key]) == [
            "skipped", "checkpoint", "best"]
    for side, cfg_key, mod in (("j", "jcfg", JC), ("t", "tcfg", TC)):
        root = tmp_path / side
        shutil.copytree(fits["dirs"][side], root)
        cfg = mod.parse_dict(CONFIG, directory=str(root))
        side_meta = cfg.weights_path(0, 1) + ".json"
        meta = json.load(open(side_meta))
        meta["done"] = False
        json.dump(meta, open(side_meta, "w"))
        if side == "j":
            res = cfg.fit(JLambda(xs, ys), foldsToExecute=[0])
        else:
            res = cfg.fit(TLambda(xs, ys), foldsToExecute=[0], device="cpu")
        assert res["fold0.stage0"]["skipped"] is True
        assert res["fold0.stage1"]["epochs"] == 2
        rows = _rows(cfg.metrics_path(0, 1))
        assert len(rows) == 5 and rows[0][0] == "epoch"
        assert [r[0] for r in rows[1:]] == ["0", "1", "0", "1"]
        assert json.load(open(side_meta))["done"] is True
    assert _rows(tmp_path / "t" / "metrics" / "metrics-0.1.csv")[0] == \
        _rows(tmp_path / "j" / "metrics" / "metrics-0.1.csv")[0]


def test_fit_with_config4_augmentation_runs(tmp_path):
    """The port alone: BASELINE config 4's block through ``fit`` (on the
    CPU the kernels' plain versions run and nothing is launched)."""
    xs, ys = _data()
    cfg = TC.parse_dict({**CONFIG, "augmentation": CONFIG4_BLOCK,
                         "stages": [{**CONFIG["stages"][0], "epochs": 1,
                                     "initial_weights": None},
                                    {**CONFIG["stages"][1], "epochs": 1}]},
                        directory=str(tmp_path))
    K.reset_launches()
    timings = []
    res = TST.fit_pipeline(cfg, TLambda(xs, ys), foldsToExecute=[1],
                           device="cpu", timings=timings)
    assert list(res) == ["fold1.stage0", "fold1.stage1"]
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}
    # one record per epoch: the split of its wall time and its work
    assert [(t["stage"], t["epoch"]) for t in timings] == [(0, 0), (1, 0)]
    k = cfg.kfold(TLambda(xs, ys))
    assert [t["images"] for t in timings] == [
        len(k.epoch_indices(1, 0, "none")), len(k.epoch_indices(1, 0))]
    assert all(t["steps"] == -(-t["images"] // 4) and min(
        t["first_batch_s"], t["val_s"], t["checkpoint_s"]) >= 0
        and t["first_batch_s"] <= t["train_s"] for t in timings)
    for s in (0, 1):
        rows = _rows(cfg.metrics_path(1, s))
        assert len(rows) == 2
        assert all(np.isfinite(float(v)) for v in rows[1][2:])


@pytest.mark.parametrize("mesh,trains", [
    ({"data": -1, "space": 2}, (ValueError, "mesh 0x2 .* does not cover 1 "
                                "devices.*--nproc-per-node 2")),
    ({"hosts": 2, "data": -1}, (ValueError, "divisible by the DCN/hosts")),
    ({"data": 2}, (ValueError, "does not cover 1 devices.*torchrun "
                               "--nproc-per-node 2")),
    ({"data": -1}, True), ({"hosts": 1, "data": -1, "space": 1}, True)],
    ids=["data-space2", "hosts2", "data2", "data-all", "kitchen-sink"])
def test_fit_refuses_meshes_over_more_than_one_device(mesh, trains, tmp_path):
    """In one process (no process group) a mesh over more than one device
    is refused before the fit reads the data: ``data`` or ``hosts`` above 1
    with the JAX package's ``ValueError`` (``data`` naming torchrun, since
    torch drives one card per process; ``space: 2`` over all processes
    leaves a data axis of 0, as in JAX).
    ``data: -1`` means every process, here one: those meshes train."""
    xs, ys = _data()
    cfg = TC.parse_dict({**CONFIG, "mesh": mesh,
                         "stages": [{**CONFIG["stages"][0], "epochs": 1,
                                     "initial_weights": None}]},
                        directory=str(tmp_path))
    if trains is not True:
        error, text = trains
        with pytest.raises(error, match=text):
            TST.fit_pipeline(cfg, TLambda(xs, ys), foldsToExecute=[1],
                             device="cpu")
        assert not os.path.exists(cfg.weights_dir)
        return
    res = TST.fit_pipeline(cfg, TLambda(xs, ys), foldsToExecute=[1],
                           device="cpu")
    assert list(res) == ["fold1.stage0"]
    assert TCK.checkpoint_meta(cfg.weights_path(1, 0))["done"] is True


def test_cli_fit_then_predict(tmp_path, capsys):
    """``fit`` on a PNG directory prints the summary dict as JSON and
    writes the JAX layout; ``predict`` writes one PNG mask per image."""
    images, masks = write_shapes_dataset(str(tmp_path / "data"), 8, H,
                                         seed=2)
    cfgd = {**CONFIG, "stages": [{"epochs": 1}]}
    yml = tmp_path / "exp" / "cfg.yaml"
    yml.parent.mkdir()
    yml.write_text(yaml.safe_dump(cfgd))
    with pytest.raises(SystemExit, match="need --masks"):
        TCLI.main(["fit", str(yml), "--images", images, "--device", "cpu"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        TCLI.main(["fit", str(yml), "--images", images, "--masks", masks,
                   "--rle-csv", "x.csv", "--device", "cpu"])
    capsys.readouterr()
    assert TCLI.main(["fit", str(yml), "--images", images, "--masks", masks,
                      "--folds", "0", "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert list(res) == ["fold0.stage0"]
    assert list(res["fold0.stage0"]) == ["best", "epochs", "checkpoint"]
    assert _listing(tmp_path / "exp") == [
        "cfg.yaml", "metrics/metrics-0.0.csv", "weights/best-0.0.weights",
        "weights/best-0.0.weights.json"]
    assert TCLI.main(["predict", str(yml), images, str(tmp_path / "out"),
                      "--device", "cpu"]) == 0
    assert f"wrote 8 masks to {tmp_path / 'out'}" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "out")) == sorted(
        os.listdir(images))
    m = cv2.imread(str(tmp_path / "out" / "shape0000.png"),
                   cv2.IMREAD_UNCHANGED)
    assert m.shape == (H, H) and set(np.unique(m)) <= {0, 255}


def test_fixed_transforms_match_jax_in_eval_and_predict(fits):
    """A transforms block with no random value: the eval step's
    per-example logs and the predict program's probabilities of both
    packages on the fit's JAX checkpoint."""
    jvar = jax.tree.map(np.asarray, JCK.load_checkpoint(
        fits["jcfg"].weights_path(0, 1), fits["var"]))
    xs, ys = fits["xs"][:4], fits["ys"][:4]
    imgs = np.stack(xs)
    masks = (np.stack(ys)[..., None] > 0).astype(np.uint8)
    weight = np.array([1, 1, 1, 0], np.float32)

    _, jt = JL.build_transform_fn(JL._coerce_block(FIXED_TRANSFORMS), [])
    jm = JF.create_model("Unet", "resnet18", 1, dtype="float32")
    jeval = JS.build_eval_step(jm, JLo.build_loss(LOSS, "sigmoid"),
                               {"dice": JM.dice_score, "iou": JM.iou_score},
                               "sigmoid", None, transform_fn=jt)
    jstate = JS.TrainState(jvar["params"], jvar["batch_stats"], None,
                           jnp.zeros((), jnp.int32))
    want = jeval(jstate, {"image": jnp.asarray(imgs),
                          "mask": jnp.asarray(masks),
                          "weight": jnp.asarray(weight)})

    aug, tt = TL.build_transform_fn(
        TC.parse_dict({"transforms": FIXED_TRANSFORMS}).transforms, [])
    assert aug is None
    tm = TF.create_model("Unet", "resnet18", 1, dtype="float32")
    tm.load_state_dict(BR.state_dict_from_jax(jvar))
    params, stats = TF.model_variables(tm)
    teval = TS.build_eval_step(tm, TLo.build_loss(LOSS, "sigmoid"),
                               {"dice": TM.get("dice"), "iou": TM.get("iou")},
                               "sigmoid", None, transform=tt)
    got = teval(TS.TrainState(params, stats, None, 0),
                {"image": torch.from_numpy(imgs),
                 "mask": torch.from_numpy(masks),
                 "weight": torch.from_numpy(weight)})
    assert set(got) == set(want) == {"loss", "dice", "iou", "weight"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    red = TS.reduce_per_example(got)
    np.testing.assert_allclose(float(red["loss"]),
                               float((np.asarray(want["loss"]) * weight)
                                     .sum()), rtol=1e-5)
    assert float(red["weight"]) == 3.0

    # the transform changes what the model sees: without it, other values
    plain = TS.build_eval_step(tm, TLo.build_loss(LOSS, "sigmoid"), {},
                               "sigmoid", None)(
        TS.TrainState(params, stats, None, 0),
        {"image": torch.from_numpy(imgs), "mask": torch.from_numpy(masks),
         "weight": torch.from_numpy(weight)})
    assert not torch.allclose(plain["loss"], got["loss"])

    cfgd = {**CONFIG, "transforms": FIXED_TRANSFORMS}
    jcfg = JC.parse_dict(cfgd, directory=fits["jcfg"].directory)
    tcfg = TC.parse_dict(cfgd, directory=fits["jcfg"].directory)
    batch = np.concatenate([imgs, imgs[::-1]])
    want = JI.InferenceBundle(jcfg, [0], 1, tta=False).predict_probs(batch)
    got = TI.InferenceBundle(tcfg, [0], 1, tta=False,
                             device="cpu").predict_probs(batch)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("yaml_name", ["quickstart_binary.yaml",
                                       "kfold_multistage.yaml"])
def test_baseline_configs_1_and_4_fit_on_the_cpu(yaml_name, tmp_path):
    """BASELINE configs 1 and 4 as their YAMLs parse, cut to 32², B4, one
    epoch a stage and fold 0 of 10 images: every stage trains and is
    marked done."""
    import dataclasses

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = TC.parse(os.path.join(root, "examples", yaml_name))
    cfg = dataclasses.replace(
        cfg, shape=(H, H, 3), batch=4, verbose=0, directory=str(tmp_path),
        stages=[dataclasses.replace(s, epochs=1) for s in cfg.stages])
    xs, ys = _data()
    res = cfg.fit(TLambda(xs[:10], ys[:10]), foldsToExecute=[0],
                  device="cpu")
    assert list(res) == [f"fold0.stage{s}" for s in range(len(cfg.stages))]
    for s in range(len(cfg.stages)):
        assert TCK.checkpoint_meta(cfg.weights_path(0, s))["done"] is True
        rows = _rows(cfg.metrics_path(0, s))
        assert len(rows) == 2 and np.isfinite(float(rows[1][4]))
