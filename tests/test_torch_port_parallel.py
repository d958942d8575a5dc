"""The port's ``parallel/`` package and the row cuts of data parallelism,
in one process on the CPU (the two-process runs are
``test_torch_port_ddp.py``).

  * ``MeshSpec.from_config`` and ``build_mesh`` against the JAX package's
    on its 8-device CPU mesh (the port's world 8 on one node): the same
    data, space and hosts factors, the same ``ValueError`` texts, and with
    ``space`` above 1 each rank's data index, H slab and rows where JAX's
    mesh puts device ``r`` (``reshape(data, space)``).
  * ``shard_batch`` against the JAX ``shard_batch``'s addressable shards:
    each rank's rows, whole in H, then its H slab (``Mesh.slab``), on the
    ``data`` and ``data × space`` meshes; the 1-D ``weight`` whole.
  * Without a process group the bootstrap is a no-op and this process is
    the primary.
  * ``Augmentation.take`` for every registry name and alias:
    ``apply(take(d, rows), x[rows]) == apply(d, x)[rows]`` exactly at 32²
    B4, rows 2:4; the config-2 block, ``transform_fn``'s rows and the
    train step's rows of the draws, keep masks and transforms too.
  * ``InferenceBundle(devices=["cpu", "cpu"])`` against one device on an
    odd batch (zero-padded, split, brought back in order).
"""

import os

import jax
import numpy as np
import pytest
import torch

from segmentation_training_pipeline_tpu.parallel import mesh as JM
from segmentation_training_pipeline_tpu_torch import config as TC
from segmentation_training_pipeline_tpu_torch.models import factory as TF
from segmentation_training_pipeline_tpu_torch.ops import losses as TLo
from segmentation_training_pipeline_tpu_torch.ops.aug import lowering as TL
from segmentation_training_pipeline_tpu_torch.parallel import (
    distributed as TD)
from segmentation_training_pipeline_tpu_torch.parallel import mesh as TM
from segmentation_training_pipeline_tpu_torch.train import optimizers as TO
from segmentation_training_pipeline_tpu_torch.train import step as TS

from torch_port_util import CONFIG2_BLOCK, few_torch_threads

# (data, space, hosts): test_multihost.py's cases, then data-only ones
MESH_CASES = [(4, 2, 2), (4, 2, 0), (4, 2, 3), (8, 1, 0), (8, 1, 2),
              (8, 1, 4), (8, 1, 3), (-1, 1, 0), (-1, 1, 2), (0, 1, 8),
              (4, 1, 0), (16, 1, 0)]


def _jax_mesh(spec):
    try:
        m = JM.build_mesh(spec)
    except ValueError as e:
        return e
    return m


@pytest.mark.parametrize("data,space,hosts", MESH_CASES)
def test_build_mesh_matches_jax(data, space, hosts):
    cfg = {"data": data, "space": space, "hosts": hosts}
    jspec = JM.MeshSpec.from_config(cfg)
    tspec = TM.MeshSpec.from_config(cfg)
    assert (tspec.data, tspec.space, tspec.hosts) == (jspec.data,
                                                      jspec.space,
                                                      jspec.hosts)
    assert TM.MeshSpec.from_config({}) == TM.MeshSpec()
    want = _jax_mesh(jspec)
    if isinstance(want, ValueError):
        with pytest.raises(ValueError) as got:
            TM.build_mesh(tspec, world=8, rank=0, local_world=8)
        assert str(got.value) == str(want)
        return
    for rank in range(8):
        m = TM.build_mesh(tspec, world=8, rank=rank, local_world=8)
        assert (m.data, m.space, m.world, m.rank) == (
            want.devices.shape[0], want.devices.shape[1], 8, rank)
        assert m.hosts == (hosts if hosts > 0 else 1)
        # the layout: rank r is device r, at (d, s) of JAX's mesh
        (d, s), = np.argwhere(want.devices == jax.devices()[rank])
        assert (m.d, m.s) == (d, s)
        per = 16 // m.data
        assert m.rows(16) == slice(d * per, (d + 1) * per)
        assert m.slab(32) == slice(s * 32 // m.space,
                                   (s + 1) * 32 // m.space)


def test_build_mesh_hosts_default_to_the_node_count():
    """torchrun numbers ranks node-major: on 2 nodes of 4, ``hosts: 0`` is
    2 and rank 5 takes the sixth block of rows."""
    m = TM.build_mesh(TM.MeshSpec(), world=8, rank=5, local_world=4)
    assert (m.data, m.hosts) == (8, 2)
    assert m.rows(16) == slice(10, 12)
    with pytest.raises(ValueError, match="DCN/hosts factor"):
        TM.build_mesh(TM.MeshSpec(data=8, hosts=3), world=8, rank=0,
                      local_world=4)
    with pytest.raises(ValueError, match="not divisible by the mesh data"):
        m.rows(12)


def test_one_process_data_axis_names_torchrun():
    with pytest.raises(ValueError, match="does not cover 1 devices"
                       r".*torchrun --nproc-per-node 4"):
        TM.build_mesh(TM.MeshSpec(data=4))
    m = TM.build_mesh()
    assert (m.data, m.world, m.rank, m.rows(5)) == (1, 1, 0, slice(0, 5))


@pytest.mark.parametrize("data,space", [(8, 1), (4, 2), (2, 4)])
def test_shard_batch_matches_jax_shards(data, space):
    """Each rank's rows whole in H (the augmentation reads any source
    row), then its slab: JAX's shard of device ``rank``."""
    r = np.random.RandomState(0)
    batch = {"image": r.randint(0, 255, (16, 8, 4, 3)).astype(np.uint8),
             "mask": r.rand(16, 8, 4, 1).astype(np.float32),
             "weight": r.rand(16).astype(np.float32)}
    jm = JM.build_mesh(JM.MeshSpec(data=data, space=space))
    jout = JM.shard_batch(batch, jm)
    order = list(jm.devices.flat)
    assert jout["weight"].sharding.is_fully_replicated
    for rank in range(8):
        tm = TM.build_mesh(TM.MeshSpec(data=data, space=space), world=8,
                           rank=rank, local_world=8)
        tout = TM.shard_batch({k: torch.from_numpy(v)
                               for k, v in batch.items()}, tm)
        np.testing.assert_array_equal(tout["weight"].numpy(),
                                      batch["weight"])
        for k in ("image", "mask"):
            assert tout[k].shape[1] == 8
            shard = next(s for s in jout[k].addressable_shards
                         if order.index(s.device) == rank)
            np.testing.assert_array_equal(
                tout[k][:, tm.slab(8)].numpy(), np.asarray(shard.data))


def test_single_process_bootstrap_noop():
    assert TD.maybe_initialize(force=False) is False
    assert not TD.active()
    assert TD.process_count() == 1 and TD.process_index() == 0
    assert TD.is_primary() is True
    TD.barrier("no group")
    TD.shutdown()


def test_guard_scan_covers_parallel():
    import test_torch_port_guards as G

    names = {os.path.relpath(p, G.PKG) for p in G.SOURCES
             if str(p).startswith(str(G.PKG))}
    assert {os.path.join("parallel", f) for f in
            ("__init__.py", "distributed.py", "mesh.py",
             "spatial.py")} <= names


# --- take: every name's draws cut to rows 2:4 -----------------------------

B, H = 4, 32
ROWS = slice(2, 4)
_ARGS = {
    "sometimes": {"then": {"Add": 3}, "else": {"Multiply": 0.9}},
    "oneof": [{"Add": 3}, {"Affine": {"rotate": [-20, 20]}}],
    "someof": {"n": [0, 2], "children": [{"Add": 3}, {"Fliplr": 0.5}]},
    "withchannels": {"channels": [0], "children": {"Add": [-20, 20]}},
    "withhueandsaturation": {"children": {"Add": [-20, 20]}},
    "withbrightnesschannels": {"children": {"Add": [-20, 20]}},
    "withcolorspace": {"to_colorspace": "HSV",
                       "children": {"Add": [-20, 20]}},
    "blendalphasegmapclassids": {"class_ids": [1],
                                 "foreground": {"Add": 30}},
    "averagepooling": 2, "maxpooling": 2, "minpooling": 2,
    "medianpooling": 3,
    "centercroptofixedsize": {"width": 24, "height": 24},
    "croptofixedsize": {"width": 24, "height": 24},
    "padtofixedsize": {"width": 40, "height": 40},
    "randomcrop": {"width": 24, "height": 24},
    "changecolorspace": {"to_colorspace": "HSV"},
    "resize": 0.5, "scale": 0.5,
    "affine": {"rotate": [-30, 30], "scale": [0.8, 1.2],
               "shear": [-10, 10], "cval": [0, 255]},
}


def _spec(name):
    args = _ARGS.get(name)
    if args is None and (name in TL._BLEND or name in TL._BLEND_CANON):
        args = {"foreground": {"Affine": {"rotate": [-20, 20]}},
                "background": {"Add": [-20, 20]}}
    return [{"name": name, "args": args}]


def _batch(b=B, h=H):
    r = np.random.RandomState(0)
    x = torch.from_numpy(r.randint(0, 255, (b, h, h, 3)).astype(np.uint8))
    m = torch.from_numpy((r.rand(b, h, h, 1) > 0.5).astype(np.float32))
    return x, m


def _holds(aug):
    x, m = _batch()
    d = aug.sample(torch.Generator().manual_seed(0), B, H, H, 3)
    fi, fm = aug.apply(d, x, m)
    ri, rm = aug.apply(aug.take(d, ROWS), x[ROWS], m[ROWS])
    assert torch.equal(ri, fi[ROWS]) and torch.equal(rm, fm[ROWS])


@pytest.mark.parametrize("name", sorted(TL.PORTED_AUGMENTERS))
def test_take_matches_the_batch_rows(name):
    _holds(TL.build_augmentation(_spec(name)))


def test_take_of_the_config2_block():
    _holds(TL.build_augmentation(CONFIG2_BLOCK))


def test_transform_fn_takes_its_rows():
    """A rank's rows transform as the whole batch's do."""
    _, t = TL.build_transform_fn(CONFIG2_BLOCK, None)
    x, m = _batch()
    fi, fm = t(x, m)
    ri, rm = t(x[ROWS], m[ROWS], ROWS, B)
    assert torch.equal(ri, fi[ROWS]) and torch.equal(rm, fm[ROWS])


def test_train_step_hands_the_model_its_rows(monkeypatch):
    """Rank 1 of 2's step feeds the model its rows of what the one-process
    step feeds it: the transformed, augmented images and the keep masks
    of the stochastic-depth layers, all drawn for the global batch."""
    cfg = TC.parse_dict({"architecture": "Unet",
                         "backbone": "efficientnetb0", "shape": [H, H, 3],
                         "dtype": "float32", "optimizer": "SGD"})
    model = TF.init_model(TF.create_model("Unet", "efficientnetb0", 1,
                                          dtype="float32"), 0, "cpu")
    assert model.drop_paths()
    seen = []
    real = TS.apply_model

    def record(model, params, stats, x, train=False, drop_masks=None):
        seen.append((x.detach().clone(), dict(drop_masks)))
        return real(model, params, stats, x, train, drop_masks)

    monkeypatch.setattr(TS, "apply_model", record)
    monkeypatch.setattr(TS.dist, "all_reduce_flat", lambda ts: None)
    aug, transform = TL.build_transform_fn([{"Fliplr": 0.5}], CONFIG2_BLOCK)
    x, m = _batch()
    batch = {"image": x, "mask": m, "weight": torch.ones(B)}
    mesh = TM.build_mesh(TM.MeshSpec(data=2), world=2, rank=1,
                         local_world=2)
    for me in (None, mesh):
        tx = TO.build_optimizer(cfg)
        step = TS.build_train_step(model, tx, TLo.build_loss(
            "binary_crossentropy", "sigmoid"), {}, "sigmoid", None, aug=aug,
            transform=transform, mesh=me)
        b = batch if me is None else TM.shard_batch(batch, me)
        step(TS.create_train_state(model, tx, "cpu"), b, 1e-3,
             gen=torch.Generator().manual_seed(3))
    (xf, kf), (xr, kr) = seen
    assert torch.equal(xr, xf[ROWS])
    assert set(kr) == set(kf) == set(model.drop_paths())
    assert all(torch.equal(kr[k], kf[k][ROWS]) for k in kf)


# --- data-sharded serving -------------------------------------------------

def test_inference_bundle_over_two_devices(tmp_path):
    from segmentation_training_pipeline_tpu_torch.infer import (
        InferenceBundle)
    from segmentation_training_pipeline_tpu_torch.train.checkpoint import (
        save_checkpoint)

    cfg = TC.parse_dict({"architecture": "Unet", "backbone": "resnet18",
                         "shape": [H, H, 3], "dtype": "float32",
                         "folds_count": 2, "testTimeAugmentation": "flip"},
                        directory=str(tmp_path))
    for fold in (0, 1):
        model = TF.init_model(TF.create_model("Unet", "resnet18", 1,
                                              dtype="float32"), fold, "cpu")
        save_checkpoint(cfg.weights_path(fold, 0), model.state_dict(),
                        {"done": True})
    one = InferenceBundle(cfg, [0, 1], 0, device="cpu")
    two = InferenceBundle(cfg, [0, 1], 0, device="cpu",
                          devices=["cpu", "cpu"])
    assert len(one.replicas) == 1 and len(two.replicas) == 2
    x, _ = _batch(5)
    p1, p2 = one.predict_probs(x.numpy()), two.predict_probs(x.numpy())
    assert p1.shape == p2.shape == (5, H, H, 1)
    np.testing.assert_allclose(p2, p1, rtol=0, atol=1e-6)
