"""``debug:`` in the port: ``true`` fails a fit on the first non-finite
train step with ``FloatingPointError``, as the JAX package's
``jax_debug_nans`` does; ``checks`` also runs each step under autograd's
anomaly mode, whose error names the backward op; neither leaves global
state behind, and a finite fit writes the same CSV with ``debug: true``
as without it.

The fits are Unet-resnet18 at 32², B2, f32, one stage of one epoch on
fold 0 of 4 synthetic items.  An lr of 1e39 overflows float32: the first
update sets parameters to ±inf or NaN (inf · 0), which both packages
catch in the first step.
"""

import csv

import jax
import pytest
import torch

from segmentation_training_pipeline_tpu import config as JC
from segmentation_training_pipeline_tpu.data.datasets import (
    LambdaDataSet as JLambda)
from segmentation_training_pipeline_tpu_torch import config as TC
from segmentation_training_pipeline_tpu_torch.data.datasets import (
    LambdaDataSet as TLambda)
from segmentation_training_pipeline_tpu_torch.data.synthetic import (
    generate_shapes_dataset)
from segmentation_training_pipeline_tpu_torch.models import factory as TF
from segmentation_training_pipeline_tpu_torch.ops import losses as TLo
from segmentation_training_pipeline_tpu_torch.train import optimizers as TO
from segmentation_training_pipeline_tpu_torch.train import step as TS

from torch_port_util import few_torch_threads  # noqa: F401

H = 32
CONFIG = {
    "architecture": "Unet", "backbone": "resnet18", "shape": [H, H, 3],
    "classes": 1, "activation": "sigmoid", "optimizer": "Adam",
    "loss": "binary_crossentropy + 0.25*dice_loss", "batch": 2,
    "dtype": "float32", "metrics": ["dice"], "primary_metric": "val_dice",
    "folds_count": 2, "random_state": 5, "verbose": 0,
    "stages": [{"epochs": 1, "lr": 1e-3}],
}


def _data(mod, n=4):
    ds = generate_shapes_dataset(n, H, seed=3, p_empty=0.25)
    return mod([ds[i].x for i in range(n)], [ds[i].y for i in range(n)])


def _anomaly():
    return torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()


@pytest.mark.parametrize("debug", [True, "checks"])
def test_a_non_finite_step_fails_the_fit(tmp_path, debug):
    before = _anomaly()
    cfg = TC.parse_dict({**CONFIG, "debug": debug,
                         "stages": [{"epochs": 1, "lr": 1e39}]},
                        directory=str(tmp_path))
    assert cfg.debug == debug
    with pytest.raises(FloatingPointError, match="non-finite"):
        cfg.fit(_data(TLambda), foldsToExecute=[0], device="cpu")
    assert _anomaly() == before


def test_the_jax_fit_fails_too(tmp_path):
    cfg = JC.parse_dict({**CONFIG, "debug": True,
                         "stages": [{"epochs": 1, "lr": 1e39}]},
                        directory=str(tmp_path))
    before = bool(jax.config.jax_debug_nans)
    with pytest.raises(FloatingPointError):
        cfg.fit(_data(JLambda), foldsToExecute=[0])
    assert bool(jax.config.jax_debug_nans) == before


def test_a_finite_fit_writes_the_same_csv_under_debug(tmp_path):
    rows = {}
    for debug in (False, True):
        d = tmp_path / str(debug)
        cfg = TC.parse_dict({**CONFIG, "debug": debug}, directory=str(d))
        cfg.fit(_data(TLambda, 6), foldsToExecute=[0], device="cpu")
        with open(cfg.metrics_path(0, 0)) as f:
            rows[debug] = [{k: v for k, v in r.items() if k != "time"}
                           for r in csv.DictReader(f)]
    assert rows[True] == rows[False] and len(rows[True]) == 1


class _SqrtLoss:
    """A loss whose forward is finite (0) and whose backward is NaN:
    sqrt's backward at 0 gives inf, which the backward of d·d multiplies
    by d = 0 (``MulBackward0``)."""

    def per_example(self, y, logits):
        d = logits - logits.detach()
        return torch.sqrt((d * d).mean(dim=(1, 2, 3)))


class _NanLoss:
    def per_example(self, y, logits):
        return logits.mean(dim=(1, 2, 3)) * float("nan")


def _step(loss, debug):
    model = TF.init_model(TF.create_model("Unet", "resnet18", 1,
                                          dtype="float32"), 0, "cpu")
    tx = TO.build_optimizer(TC.parse_dict(CONFIG))
    step = TS.build_train_step(model, tx, loss, {}, "sigmoid", None,
                               debug=debug)
    batch = {"image": torch.zeros(2, H, H, 3, dtype=torch.uint8),
             "mask": torch.zeros(2, H, H, 1)}
    return step(TS.create_train_state(model, tx, "cpu"), batch, 1e-3)


def test_checks_names_the_backward_op_that_made_the_nan():
    before = _anomaly()
    with pytest.raises(FloatingPointError, match="'MulBackward0' returned "
                       "nan"):
        _step(_SqrtLoss(), "checks")
    assert _anomaly() == before
    with pytest.raises(FloatingPointError, match="non-finite gradients"):
        _step(_SqrtLoss(), True)
    state, logs = _step(_SqrtLoss(), False)       # no check: NaN passes
    assert not all(bool(torch.isfinite(p).all())
                   for p in state.params.values())


@pytest.mark.parametrize("debug", [True, "checks"])
def test_a_non_finite_loss_raises_before_the_backward_pass(debug):
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        _step(_NanLoss(), debug)


def test_a_finite_step_is_the_same_under_debug():
    want = _step(TLo.build_loss("binary_crossentropy", "sigmoid"), False)
    for debug in (True, "checks"):
        got = _step(TLo.build_loss("binary_crossentropy", "sigmoid"), debug)
        assert torch.equal(got[1]["loss"], want[1]["loss"])
        assert all(torch.equal(got[0].params[k], v)
                   for k, v in want[0].params.items())
