"""Data parallelism of the port on two gloo ranks, on the CPU.

Two processes (``torch_port_ddp_worker.py``) join a gloo group through a
file store in the test's temporary directory (never a fixed port: xdist
workers run side by side); each has an init timeout, and each is waited
for with a timeout of its own, killed on expiry, so a rank blocked in a
collective fails its test instead of hanging the suite.

  * One f32 SGD step at lr 1e-3 of Unet-resnet18 at 32², global B8 (4 rows
    a rank), from the JAX package's init carried over by ``models/bridge``:
    without an augmentation block against JAX's ``data: 2`` mesh step on
    the same weights and batch (GSPMD's grad psum and global-batch
    BatchNorm), and with the config-2 block and a ``transforms:`` block
    against the port's own one-process step at B8 from the same generator
    seed.  Bounds as ``tests/test_sharding.py``'s: the loss within 1e-5,
    the parameters within 5e-4, the BatchNorm statistics within 1e-4; the
    ranks' parameters bit for bit equal; then rank 0 in a group of one on
    the whole batch equal to the one-process step bit for bit (one
    BatchNorm formula in every process).  SGD, not Adam: Adam's first step
    is ±lr·sign(g) and turns reduction-order noise on near-zero gradients
    into 2·lr flips (``test_sharding.py``).
  * A two-stage, two-epoch ``fit_pipeline`` in which rank 1's checkpoint,
    CSV and event-file writers raise if called, then a re-run that skips
    both stages on both ranks; its CSVs against the one-process fit of the
    same config within the JAX two-process test's 2e-3.
"""

import csv
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_training_pipeline_tpu.config import parse_dict as jparse
from segmentation_training_pipeline_tpu.models import factory as JF
from segmentation_training_pipeline_tpu.ops.losses import build_loss
from segmentation_training_pipeline_tpu.parallel.mesh import (
    MeshSpec, batch_sharding, build_mesh, replicated)
from segmentation_training_pipeline_tpu.train import optimizers as JO
from segmentation_training_pipeline_tpu.train import step as JS
import segmentation_training_pipeline_tpu_torch as stp
from segmentation_training_pipeline_tpu_torch.models import bridge as BR

import torch_port_ddp_worker as W
from torch_port_util import CONFIG2_BLOCK, few_torch_threads

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 2
TIMEOUT_S = 240
LOSS_ATOL, PARAM_ATOL, STAT_ATOL = 1e-5, 5e-4, 1e-4
TRANSFORMS = [{"Fliplr": 0.5}, {"Multiply": [0.9, 1.1]}]


def spawn(mode: str, out: str) -> None:
    """Run both ranks of ``mode`` on the directory ``out``; fail with
    their output if either exits non-zero or outlives ``TIMEOUT_S``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(HERE), HERE, env.get("PYTHONPATH", "")])
    store = os.path.join(out, f"store-{mode}")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_port_ddp_worker.py"),
         mode, str(r), str(WORLD), store, out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{o[-4000:]}"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ddp_step"))
    # the JAX init and its one-process and data: 2 steps
    cfg = jparse(W.STEP_CONFIG)
    jm = JF.create_model("Unet", "resnet18", 1, dtype="float32")
    var = JF.init_model(jm, (32, 32, 3), seed=0)
    tx = JO.build_optimizer(cfg)
    jstep = JS.build_train_step(jm, tx, build_loss(cfg.loss, "sigmoid"), {},
                                "sigmoid", "tf", aug_fn=None, donate=False)
    state = JS.create_train_state(jm, var, tx)
    r = np.random.RandomState(0)
    batch = {"image": r.randint(0, 255, (8, 32, 32, 3), dtype=np.uint8),
             "mask": (r.rand(8, 32, 32, 1) > 0.5).astype(np.float32)}
    mesh = build_mesh(MeshSpec(data=WORLD, space=1),
                      devices=jax.devices()[:WORLD])
    jnew, jlogs = jstep(jax.device_put(state, replicated(mesh)),
                        {k: jax.device_put(v, batch_sharding(mesh))
                         for k, v in batch.items()},
                        jnp.asarray(1e-3, jnp.float32), jax.random.PRNGKey(1))
    jax.block_until_ready(jnew)

    init = BR.state_dict_from_jax(_np(var))
    tbatch = {"image": torch.from_numpy(batch["image"]),
              "mask": torch.from_numpy(batch["mask"]),
              "weight": torch.ones(8)}
    blocks = {"transforms": TRANSFORMS, "augmentation": CONFIG2_BLOCK}
    torch.save(init, os.path.join(out, "init.pt"))
    torch.save(tbatch, os.path.join(out, "batch.pt"))
    with open(os.path.join(out, "blocks.json"), "w") as f:
        json.dump(blocks, f)
    spawn("step", out)
    ranks = [torch.load(os.path.join(out, f"step-{r}.pt"))
             for r in range(WORLD)]
    # one thread, as the ranks run: PyTorch's CPU sums and convolutions
    # split their work by the thread count, which moves their rounding
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {"plain": W.run_step(init, tbatch),
               "block": W.run_step(init, tbatch, blocks)}
    finally:
        torch.set_num_threads(threads)
    return dict(jnew=jnew, jlogs=jlogs, ranks=ranks, one=one)


def _max_diff(a: dict, b: dict) -> float:
    assert set(a) == set(b)
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def test_two_ranks_match_jax_data2_mesh_step(steps):
    ranks = [r["plain"] for r in steps["ranks"]]
    loss = sum(float(r["logs"]["loss"]) for r in ranks)
    assert abs(loss - float(steps["jlogs"]["loss"])) < LOSS_ATOL
    jp = BR.state_dict_from_jax({"params": _np(steps["jnew"].params)})
    js = BR.state_dict_from_jax({"batch_stats":
                                 _np(steps["jnew"].batch_stats)})
    assert _max_diff(ranks[0]["params"], jp) < PARAM_ATOL
    assert _max_diff(ranks[0]["stats"], js) < STAT_ATOL
    # the logs are the ranks' shares: the real rows sum to the batch
    assert sum(float(r["logs"]["_wsum"]) for r in ranks) == 8


def test_two_ranks_match_one_process_step_with_the_block(steps):
    ranks = [r["block"] for r in steps["ranks"]]
    params, stats, logs = steps["one"]["block"]
    loss = sum(float(r["logs"]["loss"]) for r in ranks)
    assert abs(loss - float(logs["loss"])) < LOSS_ATOL
    assert _max_diff(ranks[0]["params"], params) < PARAM_ATOL
    assert _max_diff(ranks[0]["stats"], stats) < STAT_ATOL


@pytest.mark.parametrize("case", ["plain", "block"])
def test_ranks_hold_bit_equal_parameters(steps, case):
    a, b = (r[case] for r in steps["ranks"])
    for part in ("params", "stats"):
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part])


@pytest.mark.parametrize("case", ["plain", "block"])
def test_group_of_one_equals_the_one_process_step(steps, case):
    """One BatchNorm formula in every process: rank 0 alone in a group of
    one (every collective runs, over one rank) takes the one-process
    step's parameters and statistics bit for bit."""
    solo = steps["ranks"][0]["solo"][case]
    params, stats, _ = steps["one"][case]
    for got, want in ((solo["params"], params), (solo["stats"], stats)):
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("case", ["plain", "block"])
def test_one_gradient_all_reduce_per_step(steps, case):
    """Resnet18-Unet's BatchNorm layers each all-reduce their float64
    sums once forward, (s1, s2, n): 2C + 1 values, and once backward,
    (g1, g2): 2C values (their scale and bias are trained, from the local
    sums), then one flat bucket: 2·BN + 1 calls, the bucket the trainable
    parameters' bytes."""
    from segmentation_training_pipeline_tpu_torch.models import (
        factory as TF)
    from segmentation_training_pipeline_tpu_torch.models.layers import (
        BatchNorm)

    model = TF.create_model("Unet", "resnet18", 1, dtype="float32")
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    forward_bytes = sum(8 * (2 * m.bias.numel() + 1) for m in bns)
    backward_bytes = sum(8 * 2 * m.bias.numel() for m in bns)
    grad_bytes = sum(4 * p.numel() for p in model.parameters())
    for r in steps["ranks"]:
        assert r[case]["counts"] == {
            "all_reduce": 2 * len(bns) + 1,
            "bytes": forward_bytes + backward_bytes + grad_bytes}


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ddp_fit"))
    spawn("fit", out)
    one = str(tmp_path_factory.mktemp("ddp_fit_one"))
    cfg = stp.parse_dict(W.fit_config(one), directory=one)
    res = cfg.fit(W.fit_dataset(), foldsToExecute=[0], verbose=0,
                  device="cpu")
    summaries = []
    for r in range(WORLD):
        with open(os.path.join(out, f"summary-{r}.json")) as f:
            summaries.append(json.load(f))
    return dict(out=out, one=one, res=res, summaries=summaries)


def _rows(d: str, stage: int):
    with open(os.path.join(d, "metrics", f"metrics-0.{stage}.csv")) as f:
        return list(csv.DictReader(f))


def test_two_rank_fit_writes_the_layout_once(fits):
    out, one = fits["out"], fits["one"]
    for s in range(len(W.FIT_STAGES)):
        for name in (f"weights/best-0.{s}.weights",
                     f"weights/best-0.{s}.weights.json",
                     f"metrics/metrics-0.{s}.csv"):
            assert os.path.exists(os.path.join(out, name)), name
    # the primary's event files, as many as one process writes
    assert len(os.listdir(os.path.join(out, "logs"))) == len(
        os.listdir(os.path.join(one, "logs")))
    for s in range(len(W.FIT_STAGES)):
        with open(os.path.join(out, "weights",
                               f"best-0.{s}.weights.json")) as f:
            assert json.load(f)["done"] is True


def test_two_rank_fit_rerun_skips_on_both_ranks(fits):
    keys = [f"fold0.stage{s}" for s in range(len(W.FIT_STAGES))]
    for s in fits["summaries"]:
        assert list(s["again"]) == keys
        assert all(s["again"][k].get("skipped") is True for k in keys)
        assert [s["first"][k]["epochs"] for k in keys] == [2, 2]
    a, b = fits["summaries"]
    assert [a["first"][k]["best"] for k in keys] == \
        [b["first"][k]["best"] for k in keys]


def test_two_rank_fit_matches_one_process(fits):
    keys = [f"fold0.stage{s}" for s in range(len(W.FIT_STAGES))]
    for k in keys:
        assert fits["summaries"][0]["first"][k]["best"] == pytest.approx(
            fits["res"][k]["best"], rel=2e-3)
    for s in range(len(W.FIT_STAGES)):
        mp, sp = _rows(fits["out"], s), _rows(fits["one"], s)
        assert len(mp) == len(sp) == 2
        for a, b in zip(mp, sp):
            assert a["lr"] == b["lr"]
            for k in ("loss", "iou", "val_loss", "val_iou"):
                assert float(a[k]) == pytest.approx(float(b[k]), rel=2e-3,
                                                    abs=1e-5), k
