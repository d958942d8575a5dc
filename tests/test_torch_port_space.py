"""The ``space`` axis of the port (spatial partitioning of H), on gloo
ranks on the CPU.

Ranks are processes of ``torch_port_space_worker.py`` joined by a file
store in the test's temporary directory, each with an init timeout and a
``communicate`` timeout, as ``test_torch_port_ddp.py`` spawns them (a
process group in the pytest process would make every later BatchNorm of
the xdist worker all-reduce).

  * Every layer function the model reaches on a slab, on 2 ranks at
    ``space: 2``, against the whole map in one process: forward and input
    gradient within 1e-6 of the largest value (f32 rounding is relative:
    the gradients reach ~10), and the collective each case takes (a halo,
    a gather where the output level runs whole or the halo is taller than
    the slab, a group sum for the means and PSPNet's bins, none for a
    nearest 2× upsample or a 2×2 pool of an even slab).
  * One f32 SGD step of Unet-resnet18 at 32², global B8, on 4 ranks at
    ``data: 2, space: 2``, against the JAX package's ``MeshSpec(data=2,
    space=2)`` step on ``jax.devices()[:4]`` from the same weights
    (``models/bridge``) and batch (``tests/test_sharding.py:_setup``):
    the loss within 1e-5, parameters within 5e-4, BatchNorm statistics
    within 1e-4.  At 32² the stride-32 level holds one row and runs whole,
    so a gradient counted twice or lost would show in the gradients (a
    step at lr 1, whose update is the gradient, on both sides), but not
    at lr 1e-3 within 5e-4.  Every tensor's gradient is held to the JAX
    package's ONE-DEVICE step within 10% of its norm: float32 reduction
    order moves these BatchNorm-fed gradients by up to ~2% of their norm
    (JAX's own data-parallel step against its one-device step), a doubled
    gradient is 100% off and a halved one 50%.  JAX's ``data: 2, space:
    2`` step is no reference for gradients: its encoder gradients depart
    from its own one-device step by 1.9-2.5× their norm at 32² (and at
    64²) while its loss agrees to 1e-7 (``test_jax_space_step_gradients_
    depart_from_its_one_device_step``).
  * The config-2 block and a ``transforms:`` block on the same 4 ranks
    against the port's one-process step from the same generator seed.
  * The ranks' parameters bit for bit equal; every rank's collectives.
  * An H the space axis does not divide raises JAX's ``ValueError``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_training_pipeline_tpu.config import parse_dict as jparse
from segmentation_training_pipeline_tpu.models import factory as JF
from segmentation_training_pipeline_tpu.ops.losses import build_loss
from segmentation_training_pipeline_tpu.parallel import mesh as JM
from segmentation_training_pipeline_tpu.train import optimizers as JO
from segmentation_training_pipeline_tpu.train import step as JS
from segmentation_training_pipeline_tpu_torch.models import bridge as BR
from segmentation_training_pipeline_tpu_torch.parallel import mesh as TM

import torch_port_ddp_worker as W
import torch_port_space_worker as SW
from torch_port_util import CONFIG2_BLOCK, few_torch_threads

LAYER_REL = 1e-6
LOSS_ATOL, PARAM_ATOL, STAT_ATOL = 1e-5, 5e-4, 1e-4
GRAD_NORM_REL = 0.1
TRANSFORMS = [{"Fliplr": 0.5}, {"Multiply": [0.9, 1.1]}]
DATA, SPACE = 2, 2


def spawn(mode: str, out: str, data: int, space: int) -> None:
    SW.wait(SW.start(mode, out, data, space))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# --- the layer functions, split against whole -----------------------------

LAYER_CASES = list(SW.layer_cases())


@pytest.fixture(scope="module")
def layers(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("space_layers"))
    spawn("layers", out, 1, 2)
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"layers-{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


@pytest.mark.parametrize("name", LAYER_CASES)
def test_layer_on_slabs_matches_the_whole_map(layers, name):
    for rank in layers:
        got = rank[name]
        assert got["forward"] <= LAYER_REL * max(1.0, got["scale"]), got
        assert got["grad"] <= LAYER_REL * max(1.0, got["grad_scale"]), got


def _kinds(case: dict) -> set:
    return {k for k, v in case["counts"].items()
            if v and not k.endswith("_bytes")}


def test_layers_take_the_collective_their_level_needs(layers):
    """A window that stays on split levels exchanges a halo (forward and
    backward); one whose output level runs whole, a halo taller than the
    slab and a shrink gather; means and bins sum over the group; a
    nearest 2× upsample, a 1×1 conv and a 2×2 pool of an even slab need
    nothing."""
    for rank in layers:
        for name, case in rank.items():
            if name.startswith("one_row") and not name.endswith("s1"):
                assert not case["split_out"], name
                want = {"gather"}
            elif name in ("conv_k3_dilation12_s1", "bilinear_shrink_x2",
                          "bilinear_shrink_to_no_level"):
                want = {"gather"}
            elif name in ("pspnet_bins", "se_block",
                          "deeplab_image_pooling"):
                want = {"space_sum"}
            elif name in ("nearest_up_x2", "conv_k1_s1", "conv_k1_s2",
                          "conv_k1x7_s1", "vgg_max_pool_2x2",
                          "densenet_avg_pool_2x2", "dropout_bound_mask",
                          "nearest_up_x4_whole_to_split"):
                want = set()
            else:
                want = {"halo"}
            assert _kinds(case) == want, (name, case["counts"])
            if want:
                calls = case["counts"][next(iter(want))]
                assert calls % 2 == 0, (name, case["counts"])


# --- one step at data 2 × space 2 against JAX's ---------------------------

@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("space_step"))
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
    init = BR.state_dict_from_jax(_np(var))
    tbatch = {"image": torch.from_numpy(batch["image"]),
              "mask": torch.from_numpy(batch["mask"]),
              "weight": torch.ones(8)}
    blocks = {"transforms": TRANSFORMS, "augmentation": CONFIG2_BLOCK}
    torch.save(init, os.path.join(out, "init.pt"))
    torch.save(tbatch, os.path.join(out, "batch.pt"))
    with open(os.path.join(out, "blocks.json"), "w") as f:
        json.dump(blocks, f)
    mesh = JM.build_mesh(JM.MeshSpec(data=DATA, space=SPACE),
                         devices=jax.devices()[:DATA * SPACE])
    dstate = jax.device_put(state, JM.replicated(mesh))
    dbatch = {k: jax.device_put(v, JM.batch_sharding(mesh))
              for k, v in batch.items()}
    jax_out = {}
    # the mesh step at the test's lr and at lr 1; the one-device step at
    # lr 1 (the gradients' reference)
    for name, lr, st, b in (("plain", 1e-3, dstate, dbatch),
                            ("grad_space", 1.0, dstate, dbatch),
                            ("grad", 1.0, state, batch)):
        new, logs = jstep(st, b, jnp.asarray(lr, jnp.float32),
                          jax.random.PRNGKey(1))
        jax.block_until_ready(new)
        jax_out[name] = (new, logs)
    spawn("step", out, DATA, SPACE)
    ranks = []
    for r in range(DATA * SPACE):
        path = os.path.join(out, f"step-{r}.pt")
        ranks.append(torch.load(path))
        os.remove(path)
    one = SW.run_step(init, tbatch, blocks)
    return dict(jax=jax_out, init=init, ranks=ranks, one=one)


def _max_diff(a: dict, b: dict) -> float:
    assert set(a) == set(b)
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def _jax_params(new) -> dict:
    return BR.state_dict_from_jax({"params": _np(new.params)})


def _jax_stats(new) -> dict:
    return BR.state_dict_from_jax({"batch_stats": _np(new.batch_stats)})


def _loss(ranks, case) -> float:
    """The group's logs count once: the ranks' losses sum to the batch's."""
    return sum(float(r[case]["logs"]["loss"]) for r in ranks)


def test_space_step_matches_jax_data2_space2_step(steps):
    new, logs = steps["jax"]["plain"]
    ranks = steps["ranks"]
    assert abs(_loss(ranks, "plain") - float(logs["loss"])) < LOSS_ATOL
    assert _max_diff(ranks[0]["plain"]["params"], _jax_params(new)) \
        < PARAM_ATOL
    assert _max_diff(ranks[0]["plain"]["stats"], _jax_stats(new)) \
        < STAT_ATOL
    # the real rows: each data block's once
    assert sum(float(r["plain"]["logs"]["_wsum"]) for r in ranks) == 8
    assert [float(r["plain"]["logs"]["_wsum"]) for r in ranks] == \
        [4.0, 0.0, 4.0, 0.0]


def _norm_rel(got, want) -> float:
    return float((got - want).norm() / want.norm())


def _grads(init: dict, new: dict) -> dict:
    """The lr-1 SGD step's update: the gradient."""
    return {k: init[k].float() - new[k].float() for k in new}


def test_space_step_gradients_match_jax_one_device(steps):
    """Every tensor's gradient within 10% of its norm of the JAX
    one-device step's, a bound its doubled and its halved gradient both
    fail."""
    want = _grads(steps["init"], _jax_params(steps["jax"]["grad"][0]))
    got = _grads(steps["init"], steps["ranks"][0]["grad"]["params"])
    assert set(got) == set(want)
    bad = []
    for k in want:
        assert want[k].norm() > 0, k
        assert _norm_rel(2 * want[k], want[k]) > GRAD_NORM_REL
        assert _norm_rel(0.5 * want[k], want[k]) > GRAD_NORM_REL
        if _norm_rel(got[k], want[k]) > GRAD_NORM_REL:
            bad.append((k, _norm_rel(got[k], want[k])))
    assert not bad, bad[:5]


def test_jax_space_step_gradients_depart_from_its_one_device_step(steps):
    """Why the gradients are held to the one-device step: the JAX
    package's own ``data: 2, space: 2`` step agrees on the loss but not
    on the encoder's gradients, by more than their norm."""
    init = steps["init"]
    one = _grads(init, _jax_params(steps["jax"]["grad"][0]))
    space = _grads(init, _jax_params(steps["jax"]["grad_space"][0]))
    assert abs(float(steps["jax"]["grad_space"][1]["loss"])
               - float(steps["jax"]["grad"][1]["loss"])) < 1e-6
    worst = max(_norm_rel(space[k], one[k]) for k in one
                if k.startswith("encoder."))
    assert worst > 1.0, worst


def test_space_block_step_matches_one_process_step(steps):
    params, stats, logs = steps["one"]
    ranks = steps["ranks"]
    assert abs(_loss(ranks, "block") - float(logs["loss"])) < LOSS_ATOL
    assert _max_diff(ranks[0]["block"]["params"], params) < PARAM_ATOL
    assert _max_diff(ranks[0]["block"]["stats"], stats) < STAT_ATOL


@pytest.mark.parametrize("case", ["plain", "grad", "block"])
def test_space_ranks_hold_bit_equal_parameters(steps, case):
    a = steps["ranks"][0][case]
    assert a["digest"] == SW.digest(a["params"], a["stats"])
    assert all(b[case]["digest"] == a["digest"] for b in steps["ranks"][1:])


def test_space_collectives_per_step(steps):
    """Over the world: the BatchNorm all-reduces and the one gradient
    bucket, as without the space axis.  On each space group: halos (each
    window's forward and backward, but no backward for the stem's: the
    images need no gradient), gathers (the stride-32 level's two inputs
    and the logits, forward and backward) and no group sum in
    Unet-resnet18, the same on every rank and in every step."""
    from segmentation_training_pipeline_tpu_torch.models import (
        factory as TF)
    from segmentation_training_pipeline_tpu_torch.models.layers import (
        BatchNorm)

    model = TF.create_model("Unet", "resnet18", 1, dtype="float32")
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    first = steps["ranks"][0]["plain"]["space"]
    for r in steps["ranks"]:
        for case in ("plain", "grad", "block"):
            assert r[case]["counts"]["all_reduce"] == 2 * n_bn + 1
            assert r[case]["space"] == first
    assert first["halo"] > 0 and first["gather"] > 0
    assert first["space_sum"] == 0
    assert first["halo"] % 2 == 1 and first["gather"] == 6
    # the logits: 4 rows of 32 × 32 × 1 float32, gathered from 2 slabs
    assert first["gather_bytes"] >= 2 * 4 * 32 * 32 * 4


def test_uneven_h_raises_as_jax():
    jm = JM.build_mesh(JM.MeshSpec(data=DATA, space=SPACE),
                       devices=jax.devices()[:DATA * SPACE])
    with pytest.raises(ValueError) as want:
        JM.shard_batch({"image": np.zeros((4, 33, 32, 3), np.uint8)}, jm)
    tm = TM.build_mesh(TM.MeshSpec(data=DATA, space=SPACE), world=4,
                       rank=1, local_world=4)
    with pytest.raises(ValueError) as got:
        tm.slab(33)
    tail = "should be divisible by 2, but it is equal to 33"
    assert tail in str(want.value) and tail in str(got.value)
    assert tm.slab(32) == slice(16, 32)
