"""The port's callbacks and tfevents writer against the JAX package's.

Callbacks are host arithmetic on a ``TrainingControl``: the same metric
stream through the same callback must give the same learning rates (per
batch and per epoch), the same stop epoch, the same CSV text and the same
TensorBoard records, exactly.  The ``time`` column is left out of the CSV
comparison (wall clock).  Each package's event files decode with the
other's reader.
"""

import os

import numpy as np
import pytest

from segmentation_training_pipeline_tpu.train import callbacks as JCB
from segmentation_training_pipeline_tpu.utils import tfevents as JTE
from segmentation_training_pipeline_tpu_torch.train import callbacks as TCB
from segmentation_training_pipeline_tpu_torch.utils import tfevents as TTE

from torch_port_util import few_torch_threads  # noqa: F401

EPOCHS, STEPS = 12, 3


def _stream(seed=0):
    """val_loss falls then plateaus, val_dice rises then plateaus, loss
    turns NaN at epoch 9."""
    r = np.random.RandomState(seed)
    out = []
    for e in range(EPOCHS):
        v = max(0.9 - 0.1 * e, 0.5) + 0.001 * r.rand()
        out.append({"dice": float(r.rand()), "loss": 1.0 / (e + 1) if e != 9
                    else float("nan"), "val_dice": min(0.1 * e, 0.55),
                    "val_loss": v, "time": float(e)})
    return out


SPECS = [
    ("EarlyStopping", {"monitor": "val_dice", "patience": 2}),
    ("EarlyStopping", {"monitor": "val_loss", "min_delta": 0.05,
                       "mode": "min"}),
    ("ReduceLROnPlateau", {"monitor": "val_dice", "patience": 2,
                           "factor": 0.5}),
    ("ReduceLROnPlateau", {"monitor": "val_loss", "patience": 1,
                           "factor": 0.2, "cooldown": 2, "min_lr": 1e-5}),
    ("CyclicLR", {"base_lr": 1e-4, "max_lr": 1e-2, "step_size": 4}),
    ("CyclicLR", {"base_lr": 1e-4, "max_lr": 1e-2, "step_size": 3,
                  "mode": "triangular2"}),
    ("CyclicLR", {"step_size": 2, "mode": "exp_range", "gamma": 0.9}),
    ("LRVariator", {"toVal": 1e-5, "steps": 20}),
    ("LRVariator", {"fromVal": 1e-2, "toVal": 1e-4, "steps": 10,
                    "style": "cos"}),
    ("TerminateOnNaN", {}),
    ("LearningRateScheduler", {"schedule": {0: 5e-3, 3: 1e-3, 7: 1e-4}}),
]


def _run(cb_mod, specs, directory, csv_append=False):
    """The fit loop's callback protocol over the metric stream; → (lr per
    batch, lr per epoch end, epochs run)."""
    control = cb_mod.TrainingControl(base_lr=1e-3)
    cbs = [c for c in (cb_mod.instantiate(s, directory) for s in specs)
           if c is not None]
    cbs.append(cb_mod.CSVLogger(os.path.join(directory, "m.csv"),
                                append=csv_append))
    for c in cbs:
        c.on_train_begin(control)
    batch_lrs, epoch_lrs, run = [], [], 0
    for epoch, logs in enumerate(_stream()):
        for _ in range(STEPS):
            for c in cbs:
                c.on_batch_begin(control)
            batch_lrs.append(control.effective_lr)
            control.global_step += 1
        for c in cbs:
            c.on_epoch_end(epoch, dict(logs), control)
        epoch_lrs.append(control.effective_lr)
        run = epoch + 1
        if control.stop_training:
            break
    for c in cbs:
        c.on_train_end(control)
    return batch_lrs, epoch_lrs, run


def _csv_less_time(path):
    lines = open(path).read().splitlines()
    col = lines[0].split(",").index("time")
    return [",".join(v for i, v in enumerate(ln.split(",")) if i != col)
            for ln in lines]


@pytest.mark.parametrize("name,args", SPECS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(SPECS)])
def test_callback_matches_jax(name, args, tmp_path):
    spec = [{"name": name, "args": dict(args)}]
    for side in "jt":
        os.makedirs(tmp_path / side)
    want = _run(JCB, spec, str(tmp_path / "j"))
    got = _run(TCB, spec, str(tmp_path / "t"))
    assert got == want
    assert _csv_less_time(tmp_path / "t" / "m.csv") == _csv_less_time(
        tmp_path / "j" / "m.csv")


def test_all_callbacks_together_and_tensorboard(tmp_path):
    """Every callback at once plus ``TensorBoard`` and a named CSVLogger
    (paths relative to the experiment directory); ``ModelCheckpoint`` is
    the fit loop's own and instantiates to nothing."""
    specs = [{"name": n, "args": dict(a)} for n, a in SPECS
             if n != "TerminateOnNaN"]
    specs += [{"name": "TensorBoard", "args": {"log_dir": "tb"}},
              {"name": "CSVLogger", "args": {"filename": "extra.csv"}},
              {"name": "ModelCheckpoint", "args": {"monitor": "val_dice"}}]
    res = {}
    for side, mod in (("j", JCB), ("t", TCB)):
        d = tmp_path / side
        d.mkdir()
        res[side] = _run(mod, specs, str(d))
        assert mod.instantiate(specs[-1], str(d)) is None
    assert res["t"] == res["j"]
    for f in ("m.csv", "extra.csv"):
        assert _csv_less_time(tmp_path / "t" / f) == _csv_less_time(
            tmp_path / "j" / f)
    files = {s: [tmp_path / s / "tb" / f for f in
                 os.listdir(tmp_path / s / "tb")] for s in "jt"}
    assert len(files["t"]) == len(files["j"]) == 1
    want = JTE.read_scalars(str(files["j"][0]))
    got = TTE.read_scalars(str(files["t"][0]))
    # wall time differs; steps, tags and float32 values are equal
    assert [r for r in got if r[1] != "time"] == [
        r for r in want if r[1] != "time"]
    assert len(got) > EPOCHS
    # each package's file decodes with the other's reader
    assert JTE.read_scalars(str(files["t"][0])) == got
    assert TTE.read_scalars(str(files["j"][0])) == want
    with pytest.raises(KeyError, match="unknown callback"):
        TCB.instantiate({"name": "Nope", "args": {}}, str(tmp_path))


def test_csv_logger_appends_on_resume_as_jax(tmp_path):
    """A crashed stage's CSV keeps its rows and header; the resumed run
    adopts that header's columns (a new key is dropped, a missing one is
    nan) without a second header line."""
    for side, mod in (("j", JCB), ("t", TCB)):
        d = tmp_path / side
        d.mkdir()
        path = str(d / "m.csv")
        control = mod.TrainingControl(base_lr=1e-3)
        first = mod.CSVLogger(path)
        first.on_train_begin(control)
        first.on_epoch_end(0, {"loss": 0.5, "val_loss": 0.7}, control)
        first.on_train_end(control)
        again = mod.CSVLogger(path, append=True)
        again.on_train_begin(control)
        again.on_epoch_end(1, {"loss": 0.4, "dice": 0.2}, control)
        again.on_train_end(control)
        fresh = mod.CSVLogger(str(d / "n.csv"), append=True)
        fresh.on_train_begin(control)
        fresh.on_epoch_end(0, {"loss": 0.3}, control)
        fresh.on_train_end(control)
    for f in ("m.csv", "n.csv"):
        got = open(tmp_path / "t" / f).read()
        assert got == open(tmp_path / "j" / f).read()
    assert got.count("epoch") == 1


def test_tfevents_bytes_match_jax(tmp_path, monkeypatch):
    """With the clock and host name fixed, both writers write the same
    bytes."""
    for mod in (JTE, TTE):
        monkeypatch.setattr(mod.time, "time", lambda: 1700000000.25)
        monkeypatch.setattr(mod.socket, "gethostname", lambda: "host")
    jw = JTE.EventFileWriter(str(tmp_path / "j"))
    tw = TTE.EventFileWriter(str(tmp_path / "t"))
    for w in (jw, tw):
        w.add_scalars(1, {"loss": 0.25, "val_dice": 1 / 3, "lr": 1e-3})
        w.add_scalars(300, {"loss": float("inf")})
        w.close()
    assert os.path.basename(tw.path).split(".")[:4] == os.path.basename(
        jw.path).split(".")[:4]
    assert open(tw.path, "rb").read() == open(jw.path, "rb").read()
    assert TTE._masked_crc(b"abc") == JTE._masked_crc(b"abc")
