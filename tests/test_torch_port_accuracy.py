"""``examples/accuracy_evidence_torch.py`` (BASELINE configs 1-4 trained and
evaluated by the port) against ``examples/accuracy_evidence.py``.

  * both scripts' ``main`` run with ``parse_dict`` replaced by a recorder
    whose ``fit`` and ``evaluate`` do nothing: the same four experiment
    dicts, datasets, fit folds and evaluate folds, in the same order;
  * the synthetic datasets of the four configs (seeds 7, 11, 13 and 17,
    ``p_empty`` 0.25 for 17) equal the JAX package's, array for array;
  * the port script trains and evaluates configs 1 and 3 on the CPU at
    n 16 and one epoch: the JAX script's keys, IoU and dice finite and in
    [0, 1]; ``--device cuda`` on a host without a card raises;
  * ``examples/accuracy_gap_torch.py`` scores the validation images with
    ``cfg.evaluate`` to the CSV's best ``val_iou`` (the same weights on
    the same images), and its round-2 formula (the one that wrote
    ``docs/evidence/accuracy.json``) pools classes as that formula did.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import segmentation_training_pipeline_tpu as JS
import segmentation_training_pipeline_tpu_torch as TS
from segmentation_training_pipeline_tpu.data import synthetic as JD
from segmentation_training_pipeline_tpu_torch.data import synthetic as TD

from torch_port_util import few_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(monkeypatch, package):
    """Replace ``package.parse_dict`` with a recorder: each call appends
    (dict, fit folds, evaluate folds, the fit's dataset)."""
    calls = []

    class Stub:
        def __init__(self, d):
            self.entry = [d, None, None, None]
            calls.append(self.entry)

        def fit(self, ds, foldsToExecute=None, **kw):
            self.entry[1], self.entry[3] = foldsToExecute, ds

        def evaluate(self, ds, folds=None, **kw):
            self.entry[2] = folds
            return {"iou": 0.5, "dice": 0.5}

    monkeypatch.setattr(package, "parse_dict",
                        lambda d, directory=".": Stub(d))
    return calls


def _items(ds):
    return [(ds[i].x, ds[i].y) for i in range(len(ds))]


@pytest.mark.parametrize("epochs", [25, 3])
def test_config_dicts_folds_and_datasets_equal_jax(epochs, tmp_path,
                                                   monkeypatch):
    jax_calls = _record(monkeypatch, JS)
    monkeypatch.setattr("sys.argv", [
        "accuracy_evidence.py", "--config", "all", "--n", "8",
        "--epochs", str(epochs), "--out", str(tmp_path / "jax")])
    _script("accuracy_evidence").main()
    port_calls = _record(monkeypatch, TS)
    _script("accuracy_evidence_torch").main([
        "--config", "all", "--n", "8", "--epochs", str(epochs),
        "--device", "cpu", "--out", str(tmp_path / "port")])
    assert len(jax_calls) == len(port_calls) == 4
    for (jd, jf, je, jds), (td, tf, te, tds) in zip(jax_calls, port_calls):
        assert td == jd
        assert list(tf) == list(jf)
        assert (te and list(te)) == (je and list(je))
        for (jx, jy), (tx, ty) in zip(_items(jds), _items(tds)):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
    for out in ("jax", "port"):
        keys = json.loads((tmp_path / out / "accuracy.json").read_text())
        assert list(keys) == list(_script("accuracy_evidence_torch").KEYS
                                  .values())


@pytest.mark.parametrize("gen,size,seed,kw", [
    ("generate_shapes_dataset", 128, 7, {}),
    ("generate_shapes_dataset", 256, 11, {}),
    ("generate_multiclass_shapes_dataset", 128, 13, {}),
    ("generate_shapes_dataset", 128, 17, {"p_empty": 0.25}),
], ids=["config1", "config2", "config3", "config4"])
def test_synthetic_datasets_equal_jax(gen, size, seed, kw):
    j = getattr(JD, gen)(8, size=size, seed=seed, **kw)
    t = getattr(TD, gen)(8, size=size, seed=seed, **kw)
    assert len(j) == len(t) == 8
    for i in range(8):
        assert t[i].id == j[i].id
        np.testing.assert_array_equal(t[i].x, j[i].x)
        np.testing.assert_array_equal(t[i].y, j[i].y)
    if "p_empty" in kw:
        assert any(not t[i].y.any() for i in range(8))


@pytest.mark.parametrize("config,key", [
    ("1", "config1_unet_resnet34_128"),
    ("3", "config3_pspnet_resnet34_multiclass_128"),
])
def test_port_script_trains_and_evaluates_on_the_cpu(config, key, tmp_path):
    res = _script("accuracy_evidence_torch").main([
        "--config", config, "--n", "16", "--epochs", "1", "--device", "cpu",
        "--seed", "5", "--out", str(tmp_path)])
    written = json.loads((tmp_path / "accuracy.json").read_text())
    assert written == res and list(written) == [key]
    for v in written[key].values():
        assert np.isfinite(v) and 0.0 <= v <= 1.0
    assert set(written[key]) == {"iou", "dice"}
    run = json.loads((tmp_path / "run.json").read_text())
    assert run["device"] == {"platform": "cpu"} and run["seed"] == 5
    assert (tmp_path / f"config{config}" / "metrics"
            / "metrics-0.0.csv").exists()


def test_port_script_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _script("accuracy_evidence_torch").main([
            "--config", "1", "--device", "cuda", "--out", str(tmp_path)])


def test_gap_script_scores_validation_as_the_fit_did(tmp_path):
    out = _script("accuracy_gap_torch").main([
        "--config", "3", "--n", "5", "--epochs", "1", "--device", "cpu",
        "--out", str(tmp_path)])
    assert out["n_train"] + out["n_val"] == 5
    assert abs(out["evaluate_val"]["iou"] - out["csv_best_val_iou"]) < 1e-4
    for part in ("evaluate", "evaluate_train", "evaluate_val",
                 "evaluate_round2"):
        assert 0.0 <= out[part]["iou"] <= 1.0


def test_round2_scores_follow_the_jax_evidence_formula(monkeypatch):
    """The round-2 formula on hand-made predictions: a softmax tie marks
    both classes, and intersection and union pool over the classes."""
    from segmentation_training_pipeline_tpu_torch.data.datasets import (
        LambdaDataSet)

    gap = _script("accuracy_gap_torch")
    y = np.array([[0, 1], [2, 2]], np.uint8)
    probs = np.zeros((2, 2, 3), np.float32)
    probs[0, 0] = [0.5, 0.5, 0.0]          # a tie: classes 0 and 1 marked
    probs[0, 1] = [0.1, 0.8, 0.1]
    probs[1, 0] = [0.1, 0.1, 0.8]
    probs[1, 1] = [0.7, 0.2, 0.1]          # wrong
    cfg = TS.parse_dict({"classes": 3, "activation": "softmax",
                         "shape": [2, 2, 3]})

    class Item:
        def __init__(self, y, p):
            self.y, self.prediction = y, p

    def fake_predict(cfg, ds, folds=None, device="cpu", **kw):
        return [Item(y, probs)]

    import segmentation_training_pipeline_tpu_torch.infer as TI
    monkeypatch.setattr(TI, "predict_on_dataset", fake_predict)
    got = gap.round2_scores(cfg, LambdaDataSet([y], [y]), [0], "cpu")
    # hard marks 5 (class, pixel) cells, the truth 4; 3 agree
    assert abs(got["iou"] - 3 / (5 + 4 - 3)) < 1e-6
    assert abs(got["dice"] - 6 / 9) < 1e-6
