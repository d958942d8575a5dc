"""One initial weight file for both packages' accuracy fits:
``examples/accuracy_evidence_torch.py --write-init`` / ``--init`` and
``examples/accuracy_reference_jax.py --init``.

  * ``--write-init`` writes each config's fold-0 init (``numpy_init``:
    the port's init laws drawn from ``numpy.random.default_rng``) as a
    flax checkpoint with its sha256; the JAX package's ``load_checkpoint``
    reads it into its template (``template_variables``) unchanged: the
    same tree, shapes and dtypes, every leaf equal to the port's tensor;
  * the draws are the same on every call (config 4, the same model at
    the same ``random_state``, gets config 1's sha256), every
    conv kernel inside ±2 of its scale, biases and BatchNorm as
    ``init_model`` leaves them;
  * the JAX reference script's ``parse_dict`` calls equal
    ``examples/accuracy_evidence.py``'s apart from stage 0's
    ``initial_weights``, which is the file for every config; the port
    script's ``--init`` calls are the same, and both runs record each
    file's sha256 in ``run.json``;
  * both fits start from that file: config 4 itself (Unet-resnet34 128²,
    B16, the encoder frozen at lr 1e-3, ``negatives: real``) in float32
    from its written init, stage 0 cut to 4 epochs of one step each
    (``steps_per_epoch: 1``) on 80 of its images: the first step's train
    loss and the validation loss after it within ``FIRST_RTOL`` = 1e-4
    of JAX's, each later one within ``STEP_RTOL`` = 1e-3.  Measured: the
    first step equal to the CSV's six digits, then 3e-6, 8.8e-5 and
    7.8e-5 (validation 3e-6 to 6e-5): float32 rounding grows ~30× a step
    through the ReLUs
    (``tests/test_torch_port_train.py``), while a wrong learning rate,
    freeze or plan would move the second step's loss by far more.  The
    bfloat16 runs on the card and on the CPU part at this step and epoch
    the same way (PERF.md §6).
"""

import csv
import hashlib
import importlib.util
import json
from importlib import import_module
from pathlib import Path

import numpy as np
import pytest

import segmentation_training_pipeline_tpu as JS
import segmentation_training_pipeline_tpu_torch as TS
from segmentation_training_pipeline_tpu.models import factory as JF
from segmentation_training_pipeline_tpu.train import checkpoint as JCK
from segmentation_training_pipeline_tpu_torch.models import bridge as BR
from segmentation_training_pipeline_tpu_torch.models import factory as TF
from segmentation_training_pipeline_tpu_torch.models.layers import (
    _TRUNC_STD, BatchNorm, Conv)

from torch_port_util import few_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FIRST_RTOL, STEP_RTOL = 1e-4, 1e-3


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sha(path):
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Configs 1 and 4's inits, written once for the module by two calls
    of ``--write-init``: the directory and each call's digests."""
    port = _script("accuracy_evidence_torch")
    init = tmp_path_factory.mktemp("init")
    return init, {c: port.main(["--config", c, "--write-init", str(init)])
                  for c in "14"}


def test_write_init_is_read_by_jax_unchanged(written):
    port = _script("accuracy_evidence_torch")
    init, calls = written
    digests = calls["1"]
    path = init / "config1.weights"
    assert digests == {"1": _sha(path)}
    assert (init / "config1.weights.sha256").read_text().split()[0] \
        == digests["1"]
    d = port.config_dicts(25)["1"]
    jcfg = JS.parse_dict(d)
    template = JF.template_variables(JF.model_from_config(jcfg), jcfg.shape)
    loaded = JCK.load_checkpoint(str(path), template)
    model = port.numpy_init(TF.model_from_config(TS.parse_dict(d)).cpu(),
                            33)
    want = _flat(BR.jax_from_state_dict(model.state_dict()))
    got, tmpl = _flat(loaded), _flat(template)
    assert sorted(got) == sorted(tmpl) == sorted(want)
    for k in tmpl:
        assert got[k].shape == tmpl[k].shape and got[k].dtype == tmpl[k].dtype
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    # config 4 is the same model at the same random_state: another call
    # draws the same bytes
    assert calls["4"] == {"4": digests["1"]} == {"4": _sha(
        init / "config4.weights")}


def test_numpy_init_has_the_init_model_laws():
    port = _script("accuracy_evidence_torch")
    model = port.numpy_init(TF.create_model("Unet", "resnet18", 1).cpu(), 5)
    convs = [m for m in model.modules() if isinstance(m, Conv)]
    assert convs
    for m in convs:
        std = np.sqrt(1.0 / m.weight[0].numel()) / _TRUNC_STD
        w = m.weight.detach().numpy() / std
        assert np.abs(w).max() <= 2.0 and 0.5 < w.std() < 1.2
        if m.bias is not None:
            assert not m.bias.detach().any()
    for m in model.modules():
        if isinstance(m, BatchNorm):
            assert not m.bias.detach().any() and not m.running_mean.any()
            assert (m.running_var == 1).all()
            assert m.weight is None or (m.weight == 1).all()


def _record(monkeypatch, package):
    calls = []

    class Stub:
        def __init__(self, d):
            calls.append(d)

        def fit(self, ds, foldsToExecute=None, **kw):
            pass

        def evaluate(self, ds, folds=None, **kw):
            return {"iou": 0.5, "dice": 0.5}

    monkeypatch.setattr(package, "parse_dict",
                        lambda d, directory=".": Stub(d))
    return calls


def test_reference_script_dicts_equal_the_jax_evidence_script(
        tmp_path, monkeypatch):
    init = tmp_path / "init"
    init.mkdir()
    for c in "1234":
        (init / f"config{c}.weights").write_bytes(c.encode())
    calls = _record(monkeypatch, JS)
    monkeypatch.setattr("sys.argv", [
        "accuracy_evidence.py", "--config", "all", "--n", "8",
        "--epochs", "9", "--out", str(tmp_path / "jax")])
    _script("accuracy_evidence").main()
    evidence, calls[:] = list(calls), []
    ref = _script("accuracy_reference_jax")
    ref.main(["--config", "all", "--n", "8", "--epochs", "9", "--init",
              str(init), "--out", str(tmp_path / "ref")])
    calls_with_init = list(calls)
    assert len(calls) == len(evidence) == 4
    for c, got, want in zip("1234", calls, evidence):
        stages = [dict(s) for s in got["stages"]]
        assert stages[0].pop("initial_weights") == str(
            init / f"config{c}.weights")
        assert not any("initial_weights" in s for s in stages[1:])
        assert {**got, "stages": stages} == want
    calls[:] = []
    ref.main(["--config", "all", "--n", "8", "--epochs", "9",
              "--out", str(tmp_path / "own")])
    assert calls == evidence
    # the port script's --init sets the same stage-0 file; both runs keep
    # each file's sha256
    port = _script("accuracy_evidence_torch")
    port_calls = _record(monkeypatch, TS)
    port.main(["--config", "all", "--n", "8", "--epochs", "9", "--init",
               str(init), "--device", "cpu", "--out", str(tmp_path / "port")])
    assert port_calls == calls_with_init
    for out in ("ref", "port"):
        run = json.loads((tmp_path / out / "run.json").read_text())
        assert run["init_sha256"] == {
            port.KEYS[c]: _sha(init / f"config{c}.weights") for c in "1234"}


def test_config4_first_steps_agree_in_float32(tmp_path, written):
    port = _script("accuracy_evidence_torch")
    init, _ = written
    d = port.config_dicts(25)["4"]
    stage0 = {**d["stages"][0], "epochs": 4, "steps_per_epoch": 1,
              "initial_weights": str(init / "config4.weights")}
    d = {**d, "dtype": "float32", "stages": [stage0]}
    rows = {}
    for name, package, kw in (("jax", JS, {}), ("port", TS,
                                                 {"device": "cpu"})):
        synthetic = import_module(package.__name__ + ".data.synthetic")
        ds = synthetic.generate_shapes_dataset(80, size=128, seed=17,
                                               p_empty=0.25)
        cfg = package.parse_dict(d, directory=str(tmp_path / name))
        cfg.fit(ds, foldsToExecute=[0], verbose=0, **kw)
        rows[name] = list(csv.DictReader(open(cfg.metrics_path(0, 0))))
    assert len(rows["jax"]) == len(rows["port"]) == 4
    for step, (j, t) in enumerate(zip(rows["jax"], rows["port"])):
        rtol = FIRST_RTOL if step == 0 else STEP_RTOL
        for col in ("loss", "val_loss"):
            assert abs(float(t[col]) - float(j[col])) <= \
                rtol * abs(float(j[col])), (col, j, t)
