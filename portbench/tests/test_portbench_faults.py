"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have, and the same run unbroken comes out
correct.  The harness's look for a card is skipped (the run is on the
CPU, at a small size, in float32, where the program agrees with the
reference to rounding); the cells' own limits decide."""

import pytest

from portbench import faults as FL
from portbench.run import run_cell

SEED = 3000000017
TRAIN = ("unet34-train-512-b128",
         dict(size=64, batch=4, batches=3, profiled_steps=1))
SERVE = ("unet34-serve-256-b128",
         dict(size=64, batch=4, batches=2, folds=2, calibration_images=4,
              compared_calls=2))
F32 = {"dtype": "float32"}


def run(cell, fault=None):
    name, over = cell
    if fault is None:
        return run_cell(name, SEED, 0.3, False, "cpu", over, F32)
    with FL.FAULTS[fault]():
        return run_cell(name, SEED, 0.3, False, "cpu", over, F32)


@pytest.mark.parametrize("cell,fault", [
    (TRAIN, None), (TRAIN, "unchanged"), (TRAIN, "half_batch"),
    (SERVE, None), (SERVE, "altered_answer")],
    ids=["train", "train-unchanged", "train-half-batch", "serve",
         "serve-altered-answer"])
def test_fault_caught(cell, fault):
    res = run(cell, fault)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert res["correct"] is (fault is None), res["checks"]
