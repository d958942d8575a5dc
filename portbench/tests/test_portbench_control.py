"""The control comes out not correct: the plain reference computed in
float8 (``reference/lowp.py``), put in the program's place, fails at
least one of the cell's numbers.  On the CPU at a size a test run holds;
on the card (``card``) at the cell's own size on three seeds, as the
limits were set."""

import pytest
import torch

from portbench import common as C
from portbench.reference import lowp
from portbench.run import Run

SEEDS = (3000000101, 3000000102, 3000000103)
SMALL = {"unet34-train-512-b128": dict(size=64, batch=4, batches=3),
         "deeplab-xception-train-512-b48": dict(size=64, batch=4, batches=3),
         "unet34-serve-256-b128": dict(size=64, batch=4, batches=1, folds=2,
                                       calibration_images=4,
                                       compared_calls=1),
         "deeplab-xception-serve-512-b32": dict(size=64, batch=4, batches=1,
                                                calibration_images=4,
                                                compared_calls=1)}


def control_numbers(r, dev):
    """The cell's numbers with the float8 reference as the program."""
    if r.workload["traffic"] == "train":
        T = C.load_module("traffic", "train")
        ref = T.reference_readings(r, dev)
        return T.compare(T.reference_readings(r, dev, lowp.fp8), ref)
    S = C.load_module("traffic", "serve")
    from portbench.reference import train as RT

    folds = S.fold_weights(r.config, r.workload, r.seed, dev)
    pool = S.host_batches(r.workload, r.seed, dev)
    weights = [{k: v.to(dev) for k, v in w.items()} for w in folds]
    with RT.exact():
        got = {i: RT.serve_probs(r.config["reference"], weights,
                                 torch.from_numpy(pool[i % len(pool)]).to(
                                     dev), lowp.fp8).cpu().numpy()
               for i in range(r.workload["compared_calls"])}
    return S.reference_gaps(r, folds, pool, got, dev)


def failed(r, numbers):
    return [k for k, limit in r.workload["limits"].items()
            if numbers[k] > limit]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_small(cell):
    r = Run(cell, SEEDS[0], 0, False, "cpu", SMALL[cell])
    assert failed(r, control_numbers(r, torch.device("cpu")))


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_on_card(card, cell):
    for seed in SEEDS:
        r = Run(cell, seed, 0, False)
        assert failed(r, control_numbers(r, card)), seed
