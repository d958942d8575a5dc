"""The port's serving path against the JAX package's, on the same files.

BASELINE config 5's settings at a small size: Unet-resnet34 at 64², B8,
float32, two folds, flip TTA, threshold 0.5.  The JAX package writes both
fold checkpoints (``init_model`` at seeds 0 and 1, batch statistics
perturbed, the logits head scaled so that the probabilities spread over
(0, 1) instead of sitting at 0.5); both packages serve them from one
directory through one config.  The port runs on the CPU.

Tolerances:
  * probabilities: ``PROB_ATOL`` = 2e-4 absolute.  Logits agree within
    1e-4 of the largest |logit| (``test_torch_port_model.py``), the largest
    |logit| here stays under 8 (the fixture checks it), and sigmoid's slope
    is at most 1/4: 0.25 · 1e-4 · 8.  TTA views, folds and the bilinear
    resize back to the original size are averages, which keep the bound.
    Softmax over two classes is a sigmoid of the logit difference, whose
    error is at most twice as large: ``2 * PROB_ATOL``.
  * masks: a pixel whose JAX probability lies within the tolerance of the
    threshold (softmax: of the other class) may fall either side; the
    comparison leaves those out, counts them, and requires every other
    pixel equal.
  * ``evaluate``: 1e-5 on each metric.

JAX's bundle pads a batch to a multiple of the 8 virtual CPU devices
(``tests/conftest.py``); B8 gives both sides the same rows.
"""

import csv
import json
import os

import cv2
import jax
import numpy as np
import pytest
import torch
import yaml

from segmentation_training_pipeline_tpu import cli as JCLI
from segmentation_training_pipeline_tpu import config as JC
from segmentation_training_pipeline_tpu import infer as JI
from segmentation_training_pipeline_tpu.data.datasets import (
    LambdaDataSet as JLambda)
from segmentation_training_pipeline_tpu.models import factory as JF
from segmentation_training_pipeline_tpu.train import checkpoint as JCK
from segmentation_training_pipeline_tpu_torch import cli as TCLI
from segmentation_training_pipeline_tpu_torch import config as TC
from segmentation_training_pipeline_tpu_torch import infer as TI
from segmentation_training_pipeline_tpu_torch.data.datasets import (
    LambdaDataSet as TLambda)
from segmentation_training_pipeline_tpu_torch.models import bridge as BR
from segmentation_training_pipeline_tpu_torch.models import factory as TF
from segmentation_training_pipeline_tpu_torch.utils.rle import (rle_decode,
                                                                rle_encode)
from torch_port_util import few_torch_threads, perturbed_batch_stats

H, B = 64, 8
PROB_ATOL = 2e-4
METRIC_ATOL = 1e-5
HEAD_SCALE = 20.0
CONFIG = {"architecture": "Unet", "backbone": "resnet34", "shape": [H, H, 3],
          "classes": 1, "activation": "sigmoid", "batch": B,
          "dtype": "float32", "folds_count": 2, "flipPred": True,
          "threshold": 0.5, "metrics": ["iou", "dice"],
          "stages": [{"epochs": 1}]}
# original sizes of the served images: the config's, and others that go
# through cv2's resizes both ways
SIZES = [(H, H), (H, H), (80, 96), (H, H), (50, 64), (H, H), (64, 100),
         (H, H), (H, H), (72, 40)]


def _images(sizes, seed):
    """uint8 images with a bright disc (the mask) and noise."""
    r = np.random.RandomState(seed)
    xs, ys = [], []
    for h, w in sizes:
        yy, xx = np.mgrid[0:h, 0:w]
        m = ((yy - r.uniform(0.3, 0.7) * h) ** 2
             + (xx - r.uniform(0.3, 0.7) * w) ** 2
             < (r.uniform(0.15, 0.3) * min(h, w)) ** 2)
        x = 60.0 + 120.0 * m[..., None] + r.normal(0.0, 25.0, (h, w, 3))
        xs.append(np.clip(x, 0, 255).astype(np.uint8))
        ys.append(m.astype(np.uint8) * 255)
    return xs, ys


def _configs(tmp, **patch):
    d = {**CONFIG, **patch}
    return (JC.parse_dict(d, directory=str(tmp)),
            TC.parse_dict(d, directory=str(tmp)))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Two fold checkpoints of Unet-resnet34 (one sigmoid head, and one
    two-class softmax head in a second directory) written by JAX."""
    jm = JF.create_model("Unet", "resnet34", 1, dtype="float32")
    init = jax.jit(JF.init_model, static_argnums=(0, 1))
    roots = {"sigmoid": tmp_path_factory.mktemp("serve"),
             "softmax": tmp_path_factory.mktemp("serve_softmax")}
    for f in range(2):
        var = perturbed_batch_stats(
            jax.tree.map(np.asarray, init(jm, (H, H, 3), f)), f + 1)
        r = np.random.RandomState(10 + f)
        k = var["params"]["logits_conv"]["kernel"]
        k = (HEAD_SCALE * np.abs(k).max() * r.uniform(-1, 1, k.shape)
             ).astype(np.float32)
        bias = r.uniform(-0.5, 0.5, 1).astype(np.float32)
        heads = {"sigmoid": {"kernel": k, "bias": bias},
                 # logits ∓ half the sigmoid head's: the same decision
                 "softmax": {"kernel": np.concatenate([-k, k], -1) / 2,
                             "bias": np.concatenate([-bias, bias]) / 2}}
        for kind, head in heads.items():
            v = {**var, "params": {**var["params"], "logits_conv": head}}
            cfg = JC.parse_dict(CONFIG, directory=str(roots[kind]))
            JCK.save_checkpoint(cfg.weights_path(f, 0), v,
                                {"fold": f, "stage": 0,
                                 "encoder_variant": ""})
            if kind == "sigmoid":   # the premise of PROB_ATOL
                tm = TF.create_model("Unet", "resnet34", 1, dtype="float32")
                tm.load_state_dict(BR.state_dict_from_jax(v))
                xs, _ = _images([(H, H)] * B, 0)
                x = torch.from_numpy(np.stack(xs)).float() / 127.5 - 1.0
                logits = TF.apply_model(tm, *TF.model_variables(tm), x)
                assert 2.0 < float(logits.abs().max()) < 8.0
    xs, ys = _images(SIZES, 1)
    return roots, xs, ys


@pytest.fixture(scope="module")
def predictions(served):
    """``predict_on_dataset`` of both packages over the mixed-size set."""
    roots, xs, ys = served
    jcfg, tcfg = _configs(roots["sigmoid"])
    ids = [f"im{i}" for i in range(len(xs))]
    want = {it.id: it.prediction for it in
            jcfg.predict_on_dataset(JLambda(xs, ys, ids))}
    got = {it.id: it.prediction for it in
           tcfg.predict_on_dataset(TLambda(xs, ys, ids), device="cpu")}
    return want, got


def _masks_agree(got, want, p_jax, thr=0.5, tol=PROB_ATOL):
    """Equal outside the pixels whose JAX probability is within ``tol`` of
    ``thr``; returns how many pixels were left out."""
    near = np.abs(p_jax - thr) < tol
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[~near], want[~near])
    return int(near.sum())


@pytest.mark.parametrize("tta", [False, "flip", "flips", "d4"])
def test_predict_probs_matches_jax(served, tta):
    roots, _, _ = served
    jcfg, tcfg = _configs(roots["sigmoid"])
    imgs = np.stack(_images([(H, H)] * B, 2)[0])
    want = JI.InferenceBundle(jcfg, [0, 1], 0, tta=tta).predict_probs(imgs)
    bundle = TI.InferenceBundle(tcfg, [0, 1], 0, tta=tta, device="cpu")
    got = bundle.predict_probs(imgs)
    assert got.dtype == np.float32 and got.shape == want.shape == (B, H, H, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)


def test_flip_pred_is_the_default_tta(served):
    roots, _, _ = served
    _, tcfg = _configs(roots["sigmoid"])
    assert TI.InferenceBundle(tcfg, [0], 0, device="cpu").tta == "flip"
    assert tcfg.load([0, 1], 0, device="cpu").folds == [0, 1]


def test_predict_on_dataset_matches_jax(predictions):
    want, got = predictions
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PROB_ATOL,
                                   err_msg=k)


def test_crops_match_jax(served):
    """``crops: 2`` on non-square originals: 4 tiles each, 12 tiles in two
    chunks (the second padded), stitched back with cv2."""
    roots, _, _ = served
    jcfg, tcfg = _configs(roots["sigmoid"], crops=2)
    xs, _ = _images([(100, 150), (90, 64), (128, 96)], 3)
    want = [it.prediction for it in jcfg.predict_on_dataset(JLambda(xs))]
    got = [it.prediction for it in
           tcfg.predict_on_dataset(TLambda(xs), device="cpu")]
    for x, g, w in zip(xs, got, want):
        assert g.shape == w.shape == (*x.shape[:2], 1)
        np.testing.assert_allclose(g, w, rtol=0, atol=PROB_ATOL)


def test_predict_all_to_dir_writes_jax_masks(served, predictions, tmp_path):
    roots, xs, _ = served
    jcfg, tcfg = _configs(roots["sigmoid"])
    ids = [f"im{i}" for i in range(len(xs))]
    assert jcfg.predict_all_to_dir(JLambda(xs, ids=ids),
                                   str(tmp_path / "j")) == len(xs)
    assert tcfg.predict_in_directory(TLambda(xs, ids=ids),
                                     str(tmp_path / "t"),
                                     device="cpu") == len(xs)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))
    left_out = 0
    for i in ids:
        w = cv2.imread(str(tmp_path / "j" / f"{i}.png"), cv2.IMREAD_UNCHANGED)
        g = cv2.imread(str(tmp_path / "t" / f"{i}.png"), cv2.IMREAD_UNCHANGED)
        assert g.dtype == np.uint8 and set(np.unique(g)) <= {0, 255}
        left_out += _masks_agree(g, w, predictions[0][i][..., 0])
    assert left_out < 0.01 * sum(x.shape[0] * x.shape[1] for x in xs)


def test_predict_to_csv_writes_jax_rows(served, predictions, tmp_path):
    roots, xs, _ = served
    jcfg, tcfg = _configs(roots["sigmoid"])
    ids = [f"im{i}" for i in range(len(xs))]
    assert jcfg.predict_to_csv(JLambda(xs, ids=ids),
                               str(tmp_path / "j.csv")) == len(xs)
    assert tcfg.predict_to_csv(TLambda(xs, ids=ids), str(tmp_path / "t.csv"),
                               device="cpu") == len(xs)
    rows = [list(csv.reader(open(tmp_path / f"{s}.csv"))) for s in "jt"]
    assert rows[1][0] == rows[0][0] == ["id", "rle_mask"]
    assert [r[0] for r in rows[1]] == [r[0] for r in rows[0]]
    for (i, w), (_, g), x in zip(rows[0][1:], rows[1][1:], xs):
        _masks_agree(rle_decode(g, x.shape), rle_decode(w, x.shape),
                     predictions[0][i][..., 0])


def test_evaluate_matches_jax(served):
    roots, xs, ys = served
    jcfg, tcfg = _configs(roots["sigmoid"])
    want = jcfg.evaluate(JLambda(xs, ys))
    got = tcfg.evaluateAll(TLambda(xs, ys), device="cpu")
    assert set(got) == set(want) == {"iou", "dice"}
    for k in want:
        assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])


def test_softmax_writes_jax_argmax_masks(served, tmp_path):
    roots, _, _ = served
    jcfg, tcfg = _configs(roots["softmax"], classes=2,
                          activation="softmax")
    xs, _ = _images([(H, H)] * 4 + [(70, 50)], 4)
    probs = [it.prediction for it in jcfg.predict_on_dataset(JLambda(xs))]
    jcfg.predict_all_to_dir(JLambda(xs), str(tmp_path / "j"))
    tcfg.predict_to_directory(TLambda(xs), str(tmp_path / "t"), device="cpu")
    classes = set()
    for i, p in enumerate(probs):
        w = cv2.imread(str(tmp_path / "j" / f"{i}.png"), cv2.IMREAD_UNCHANGED)
        g = cv2.imread(str(tmp_path / "t" / f"{i}.png"), cv2.IMREAD_UNCHANGED)
        classes |= set(np.unique(w).tolist())
        _masks_agree(g, w, p[..., 1] - p[..., 0], thr=0.0,
                     tol=2 * PROB_ATOL)
    assert classes == {0, 1}


def _cli_inputs(served, tmp_path, ids):
    """The YAML beside the checkpoints, and images ``ids`` of the served
    set as PNG files with their masks as an RLE CSV."""
    roots, xs, ys = served
    yml = roots["sigmoid"] / "config5.yaml"
    yml.write_text(yaml.safe_dump(CONFIG))
    src = tmp_path / "src"
    src.mkdir()
    rows = [["id", "rle_mask"]]
    for i in ids:
        k = int(i[2:])
        cv2.imwrite(str(src / f"{i}.png"),
                    cv2.cvtColor(xs[k], cv2.COLOR_RGB2BGR))
        rows.append([i, rle_encode(ys[k] > 0)])
    with open(tmp_path / "labels.csv", "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return str(yml), src


def test_cli_predict_gives_the_jax_layout(served, predictions, tmp_path,
                                          monkeypatch, capsys):
    monkeypatch.setenv("STP_COMPILATION_CACHE", "0")
    ids = ["im0", "im2", "im4"]
    yml, src = _cli_inputs(served, tmp_path, ids)
    assert JCLI.main(["predict", yml, str(src), str(tmp_path / "j")]) == 0
    assert TCLI.main(["predict", yml, str(src), str(tmp_path / "t"),
                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"wrote 3 masks to {tmp_path / 't'}" in out
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j")) == [f"{i}.png" for i in ids]
    for i in ids:
        w = cv2.imread(str(tmp_path / "j" / f"{i}.png"), cv2.IMREAD_UNCHANGED)
        g = cv2.imread(str(tmp_path / "t" / f"{i}.png"), cv2.IMREAD_UNCHANGED)
        _masks_agree(g, w, predictions[0][i][..., 0])


def test_cli_evaluate_matches_jax(served, tmp_path, monkeypatch, capsys):
    """``evaluate --rle-csv`` over PNG files: the same JSON dict."""
    monkeypatch.setenv("STP_COMPILATION_CACHE", "0")
    yml, src = _cli_inputs(served, tmp_path, ["im1", "im2", "im6"])
    args = ["evaluate", yml, "--images", str(src), "--rle-csv",
            str(tmp_path / "labels.csv")]
    capsys.readouterr()
    assert JCLI.main(args) == 0
    want = json.loads(capsys.readouterr().out)
    assert TCLI.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert set(got) == set(want) == {"iou", "dice"}
    for k in want:
        assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])


def test_missing_checkpoint_raises_as_in_jax(served):
    roots, _, _ = served
    jcfg, tcfg = _configs(roots["sigmoid"])
    with pytest.raises(FileNotFoundError, match="fold 5"):
        JI.InferenceBundle(jcfg, [5], 0)
    with pytest.raises(FileNotFoundError, match="fold 5"):
        TI.InferenceBundle(tcfg, [0, 5], 0, device="cpu")
    empty = _configs(roots["sigmoid"] / "nothing")[1]
    with pytest.raises(FileNotFoundError, match="no trained fold"):
        next(empty.predict_on_dataset(TLambda([]), device="cpu"))


def test_refusals(served):
    """d4 on a non-square frame raises in both packages (rot90 changes
    H/W); ``transforms:`` at predict time builds its transform
    (``test_torch_port_fit.py`` holds it to JAX)."""
    roots, _, _ = served
    jcfg, tcfg = _configs(roots["sigmoid"], shape=[H, 48, 3])
    with pytest.raises(ValueError, match="square"):
        JI.InferenceBundle(jcfg, [0], 0, tta="d4")
    with pytest.raises(ValueError, match="square"):
        TI.InferenceBundle(tcfg, [0], 0, tta="d4", device="cpu")
    _, tcfg = _configs(roots["sigmoid"], transforms={"Fliplr": 1.0})
    assert TI.InferenceBundle(tcfg, [0], 0, device="cpu").transform is not None
