"""The ``space`` axis across the zoo and through ``cfg.fit``, on two gloo
ranks at ``mesh: {data: 1, space: 2}`` on the CPU
(``torch_port_space_worker.py``; the layer functions and the step against
JAX are ``test_torch_port_space.py``).

  * One f32 SGD step at lr 1 (its update is the gradient) at 64² B2,
    bce + 0.25·dice, of FPN-efficientnetb0 (SE means, drop paths),
    Linknet-resnet18, PSPNet-resnet34 (the bins), DeepLabV3 on the aligned
    Xception (image pooling, dilated separable convs, the head's dropout
    with a bound keep mask), Unet-vgg16 (2×2 VALID pools) and
    Unet-densenet121 (2×2 average pools), Unet-resnet18 with ``remat``
    (the backward pass recomputes each part's halo exchanges, in the same
    order on both ranks), against the port's one-process
    step from the same init and generator seed: the loss within 1e-5, the
    parameters an lr-1e-3 step gives (init − 1e-3·gradient: SGD is linear
    in lr) within 5e-4, the BatchNorm statistics within 1e-4, every
    tensor's gradient within 10% of its norm or within a floor of 1e-5 of
    the model's median gradient norm (``tests/test_torch_port_deeplab.py``'s
    rule): a doubled or halved gradient fails for every tensor above the
    floor, and below it sit only gradients that are zero up to rounding
    (~1e-8: BatchNorm biases whose shift the next BatchNorm removes); the
    two ranks' gradients and statistics bit for bit equal (their sha256
    digests).  The ranks' collectives: a halo in every model, group sums
    where a mean or the bins are.
  * The two-stage fit of ``test_torch_port_ddp.py`` with ``mesh: {data: 1,
    space: 2}``: the JAX layout written once (rank 1's writers raise if
    called), a re-run that skips both stages on both ranks, its CSVs
    against the one-process fit within the two-process tests' 2e-3.
"""

import csv
import json
import os

import numpy as np
import pytest

from segmentation_training_pipeline_tpu_torch.models import encoders as TE

import segmentation_training_pipeline_tpu_torch as stp
import torch_port_ddp_worker as W
import torch_port_space_worker as SW
from torch_port_util import few_torch_threads

LOSS_ATOL, PARAM_ATOL, STAT_ATOL = 1e-5, 5e-4, 1e-4
GRAD_NORM_REL, GRAD_FLOOR = 0.1, 1e-5
NAMES = [SW.model_name(*m) for m in SW.MODELS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' model steps and fit, with the one-process steps and fit
    computed here while the ranks run."""
    out = str(tmp_path_factory.mktemp("space_models"))
    procs = SW.start("models", out, 1, 2)
    try:
        with pytest.MonkeyPatch.context() as mp:
            cls, kw = TE.ENCODERS["xception_aligned"]
            mp.setitem(TE.ENCODERS, "xception_aligned",
                       (cls, {**kw, "middle_units": SW.MIDDLE}))
            one = {SW.model_name(*m): SW.model_step(*m) for m in SW.MODELS}
        one_dir = str(tmp_path_factory.mktemp("space_fit_one"))
        cfg = stp.parse_dict(SW.space_fit_config(one_dir),
                             directory=one_dir)
        fit = cfg.fit(W.fit_dataset(), foldsToExecute=[0], verbose=0,
                      device="cpu")
    finally:
        SW.wait(procs)
    import torch

    ranks = []
    for r in range(2):
        path = os.path.join(out, f"models-{r}.pt")
        ranks.append(torch.load(path))
        os.remove(path)
    summaries = []
    for r in range(2):
        with open(os.path.join(out, f"summary-{r}.json")) as f:
            summaries.append(json.load(f))
    return dict(out=out, one=one, ranks=ranks, one_dir=one_dir, fit=fit,
                summaries=summaries)


def _max_diff(a: dict, b: dict) -> float:
    assert set(a) == set(b)
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


@pytest.mark.parametrize("name", NAMES)
def test_space_model_step_matches_one_process(runs, name):
    one = runs["one"][name]
    r0, r1 = (r[name] for r in runs["ranks"])
    # the group's logs count once: rank 1 logs zeros
    assert r1["loss"] == 0.0
    assert abs(r0["loss"] - one["loss"]) < LOSS_ATOL
    assert 1e-3 * _max_diff(r0["grads"], one["grads"]) < PARAM_ATOL
    assert _max_diff(r0["stats"], one["stats"]) < STAT_ATOL
    norms = {k: float(g.norm()) for k, g in one["grads"].items()}
    floor = GRAD_FLOOR * float(np.median(list(norms.values())))
    bad = []
    for k, want in one["grads"].items():
        dist = float((r0["grads"][k] - want).norm())
        if dist > max(GRAD_NORM_REL * norms[k], floor):
            bad.append((k, dist, norms[k]))
    assert not bad, bad[:5]
    assert r0["digest"] == SW.digest(r0["grads"], r0["stats"]) == \
        r1["digest"]


@pytest.mark.parametrize("name", NAMES)
def test_space_model_step_collectives(runs, name):
    """Every model exchanges halos; the SE means (EfficientNet), PSPNet's
    bins and DeepLab's image pooling sum over the group; both ranks the
    same."""
    c0, c1 = (r[name]["space"] for r in runs["ranks"])
    assert c0 == c1
    assert c0["halo"] > 0
    means = name.startswith(("FPN-efficientnet", "PSPNet", "DeepLabV3"))
    assert (c0["space_sum"] > 0) == means, c0


def _rows(d: str, stage: int):
    with open(os.path.join(d, "metrics", f"metrics-0.{stage}.csv")) as f:
        return list(csv.DictReader(f))


def test_space_fit_writes_the_layout_once_and_skips_on_rerun(runs):
    out = runs["out"]
    keys = [f"fold0.stage{s}" for s in range(len(W.FIT_STAGES))]
    for s in range(len(W.FIT_STAGES)):
        with open(os.path.join(out, "weights",
                               f"best-0.{s}.weights.json")) as f:
            assert json.load(f)["done"] is True
        assert os.path.exists(os.path.join(out, "metrics",
                                           f"metrics-0.{s}.csv"))
    assert len(os.listdir(os.path.join(out, "logs"))) == len(
        os.listdir(os.path.join(runs["one_dir"], "logs")))
    for s in runs["summaries"]:
        assert list(s["again"]) == keys
        assert all(s["again"][k].get("skipped") is True for k in keys)
    a, b = runs["summaries"]
    assert [a["first"][k]["best"] for k in keys] == \
        [b["first"][k]["best"] for k in keys]


def test_space_fit_matches_one_process(runs):
    keys = [f"fold0.stage{s}" for s in range(len(W.FIT_STAGES))]
    for k in keys:
        assert runs["summaries"][0]["first"][k]["best"] == pytest.approx(
            runs["fit"][k]["best"], rel=2e-3)
    for s in range(len(W.FIT_STAGES)):
        mp, sp = _rows(runs["out"], s), _rows(runs["one_dir"], s)
        assert len(mp) == len(sp) == 2
        for a, b in zip(mp, sp):
            assert a["lr"] == b["lr"]
            for k in ("loss", "iou", "val_loss", "val_iou"):
                assert float(a[k]) == pytest.approx(float(b[k]), rel=2e-3,
                                                    abs=1e-5), k
