"""One rank of the space-axis tests (``test_torch_port_space.py``,
``test_torch_port_space_models.py``).

Not a pytest module: ``python torch_port_space_worker.py MODE RANK WORLD
DATA SPACE STORE DIR`` joins a gloo group of ``WORLD`` ranks through the
file store ``STORE``, lays it out as ``mesh: {data: DATA, space: SPACE}``
and runs, on the CPU:

  * ``layers``: every case of ``layer_cases`` on its slab under
    ``spatial.partitioned`` beside the whole map in this process: the
    largest forward and input-gradient errors and the collectives of each
    case go to ``DIR/layers-{RANK}.json``;
  * ``step``: from ``DIR/init.pt`` and ``DIR/batch.pt``, one f32 SGD step
    of Unet-resnet18 at lr 1e-3 and one at lr 1 (its update is the
    gradient) without a block, then one at lr 1e-3 under the blocks of
    ``DIR/blocks.json``: new variables (rank 0; the others their digest),
    logs and counts of each to ``DIR/step-{RANK}.pt``;
  * ``models``: one f32 SGD step at lr 1 of each ``MODELS`` entry at 64²
    B2 (``model_step``; the gradients and statistics from rank 0, the
    others' digest), to ``DIR/models-{RANK}.pt``; then
    ``space_fit_config``'s two-stage fit and the same fit again, rank 1's
    writers raising if called, to ``DIR/summary-{RANK}.json``.
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

import torch_port_ddp_worker as W

# (architecture, backbone, remat) of the model steps; DeepLab's dropout
# mask is bound, so both sides drop the same values; remat recomputes the
# halo exchanges in the backward pass
MODELS = [("FPN", "efficientnetb0", False), ("Linknet", "resnet18", False),
          ("PSPNet", "resnet34", False),
          ("DeepLabV3", "xception_aligned", False),
          ("Unet", "vgg16", False), ("Unet", "densenet121", False),
          ("Unet", "resnet18", True)]


def model_name(arch: str, backbone: str, remat: bool) -> str:
    return f"{arch}-{backbone}" + ("-remat" if remat else "")
HERE = os.path.dirname(os.path.abspath(__file__))
TIMEOUT_S = 240
MODEL_H, MODEL_B, MIDDLE = 64, 2, 2
MODEL_LOSS = "binary_crossentropy + 0.25*dice_loss"
DROPOUT = "decoder.dropout"


def start(mode: str, out: str, data: int, space: int) -> list:
    """Start the ``data × space`` ranks of ``mode`` on the directory
    ``out`` (a file store in it)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(HERE), HERE, env.get("PYTHONPATH", "")])
    world = data * space
    store = os.path.join(out, f"store-{mode}")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(r), str(world),
         str(data), str(space), store, out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]


def wait(procs: list) -> None:
    """Wait for every rank, each within ``TIMEOUT_S`` (killed on expiry);
    fail with its output if one exits non-zero."""
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


def shallow_xception():
    """``xception_aligned`` with MIDDLE middle units (16 in the table), as
    the DeepLab tests build it."""
    from segmentation_training_pipeline_tpu_torch.models import (
        encoders as TE)

    cls, kw = TE.ENCODERS["xception_aligned"]
    TE.ENCODERS["xception_aligned"] = (cls, {**kw, "middle_units": MIDDLE})


def space_fit_config(workdir: str, mesh=None) -> dict:
    """The PR-15 two-stage fit config, with ``mesh`` if given."""
    cfg = W.fit_config(workdir)
    if mesh:
        cfg["mesh"] = mesh
    return cfg


def layer_cases():
    """name → (whole NCHW shape, (hg, wg), fn): each ``fn`` maps a map of
    that level (a slab under ``spatial.partitioned``) through one layer
    function of the port, its weights drawn from the case's seed."""
    from segmentation_training_pipeline_tpu_torch.models import layers as L
    from segmentation_training_pipeline_tpu_torch.models.decoders import (
        pspnet as P)
    from segmentation_training_pipeline_tpu_torch.parallel import spatial

    gen = torch.Generator().manual_seed(0)

    def conv(k, s, groups=1, dilation=1, c=4):
        m = L.Conv(c, c, k, s, bias=True, groups=groups, dilation=dilation)
        m.reset_parameters(gen)
        with torch.no_grad():
            m.bias.uniform_(-1, 1, generator=gen)
        return m

    def se():
        m = L.SEBlock(4, 2, "relu")
        for c in (m.reduce, m.expand):
            c.reset_parameters(gen)
        return m

    def dropout(mask):
        d = L.Dropout(0.3)
        d.keep_mask = mask
        return lambda x: d(x, True)

    big, lvl16 = (2, 4, 16, 16), (16, 16)
    cases = {}
    for k in (1, 3, 5, 7):
        for s in (1, 2):
            cases[f"conv_k{k}_s{s}"] = (big, lvl16, conv(k, s))
    cases.update({
        "conv_k1x7_s1": (big, lvl16, conv((1, 7), 1)),
        "conv_k7x1_s1": (big, lvl16, conv((7, 1), 1)),
        "conv_k3_dilation2_s1": (big, lvl16, conv(3, 1, dilation=2)),
        "conv_k3_dilation2_s2": (big, lvl16, conv(3, 2, dilation=2)),
        # a halo of 12 rows around an 8-row slab reads the gathered map
        "conv_k3_dilation12_s1": (big, lvl16, conv(3, 1, dilation=12)),
        "depthwise_k5_s2": (big, lvl16, conv(5, 2, groups=4)),
        "max_pool_k3_s2": (big, lvl16, lambda x: L.max_pool_same(x, 3, 2)),
        "max_pool_k3_s1": (big, lvl16, lambda x: L.max_pool_same(x, 3, 1)),
        "avg_pool_k3_s1_with_pads": (big, lvl16,
                                     lambda x: L.avg_pool_same(x, 3, 1)),
        "avg_pool_k3_s1_without_pads": (big, lvl16, lambda x: L.avg_pool_same(
            x, 3, 1, count_include_pad=False)),
        "avg_pool_k3_s2_with_pads": (big, lvl16,
                                     lambda x: L.avg_pool_same(x, 3, 2)),
        "avg_pool_k3_s2_without_pads": (big, lvl16, lambda x: L.avg_pool_same(
            x, 3, 2, count_include_pad=False)),
        "nearest_up_x2": ((2, 4, 8, 8), lvl16, L.upsample2x),
        "bilinear_up_x2": ((2, 4, 8, 8), lvl16, lambda x: L.resize_to(
            x, 2 * x.shape[2], 2 * x.shape[3], "bilinear")),
        "bilinear_up_x4": ((2, 4, 4, 4), lvl16, lambda x: L.resize_to(
            x, 4 * x.shape[2], 4 * x.shape[3], "bilinear")),
        # a whole level (stride 8 of 24) up to a split one (stride 2)
        "nearest_up_x4_whole_to_split": ((2, 4, 3, 3), (24, 24),
                                         lambda x: L.resize_to(
                                             x, 12, 12)),
        "bilinear_shrink_x2": (big, lvl16, lambda x: L.resize_to(
            x, x.shape[2] // 2, x.shape[3] // 2, "bilinear")),
        "bilinear_shrink_to_no_level": (big, lvl16, lambda x: L.resize_to(
            x, 12, 12, "bilinear")),
        "pspnet_bins": (big, lvl16, lambda x: torch.cat([L.resize_to(
            P.adaptive_avg_pool(x, b), x.shape[2], x.shape[3], "bilinear")
            for b in (1, 2, 3, 6)], dim=1)),
        "se_block": (big, lvl16, se()),
        "deeplab_image_pooling": (big, lvl16, lambda x: L.resize_to(
            spatial.mean_hw(x), x.shape[2], x.shape[3], "bilinear")),
        "vgg_max_pool_2x2": (big, lvl16,
                             lambda x: spatial.valid_pool(x, 2,
                                                          F.max_pool2d)),
        "densenet_avg_pool_2x2": (big, lvl16,
                                  lambda x: spatial.valid_pool(
                                      x, 2, F.avg_pool2d)),
        "dropout_bound_mask": (big, lvl16, dropout(
            torch.rand(big, generator=gen) < 0.7)),
        # stride 16 of 32: one row a rank; the stride-32 level runs whole
        "one_row_conv_k3_s2": ((2, 4, 2, 2), (32, 32), conv(3, 2)),
        "one_row_max_pool_k3_s2": ((2, 4, 2, 2), (32, 32),
                                   lambda x: L.max_pool_same(x, 3, 2)),
        "one_row_vgg_max_pool_2x2": ((2, 4, 2, 2), (32, 32),
                                     lambda x: spatial.valid_pool(
                                         x, 2, F.max_pool2d)),
        "one_row_conv_k3_s1": ((2, 4, 2, 2), (32, 32), conv(3, 1)),
    })
    return cases


def run_layers(mesh, out: str, rank: int) -> None:
    from segmentation_training_pipeline_tpu_torch.parallel import (
        distributed as D)
    from segmentation_training_pipeline_tpu_torch.parallel import spatial

    results = {}
    for i, (name, (shape, (hg, wg), fn)) in enumerate(
            layer_cases().items()):
        r = np.random.RandomState(100 + i)
        x = torch.from_numpy(r.standard_normal(shape).astype(np.float32))
        xw = x.clone().requires_grad_(True)
        yw = fn(xw)
        weights = torch.from_numpy(
            r.standard_normal(tuple(yw.shape)).astype(np.float32))
        (yw * weights).sum().backward()
        D.reset_counts()
        with spatial.partitioned(mesh, hg, wg):
            sp = spatial.current()
            split_in = sp.level_split(sp.stride(shape[3]))
            n = shape[2] // mesh.space
            xs = (x[:, :, mesh.s * n:(mesh.s + 1) * n] if split_in
                  else x).clone().requires_grad_(True)
            ys = fn(xs)
            split_out = ys.shape[2] != yw.shape[2]
            loss = (ys * spatial.slab_of(weights, ys)).sum()
            # a whole output is every rank's: its share is 1/S
            (loss if split_out else loss / mesh.space).backward()
        gx = xs.grad
        if not split_in:   # a whole input's gradient is the group's sum
            D.all_reduce_(gx)
        m = ys.shape[2]
        ref_y = yw.narrow(2, mesh.s * m, m) if split_out else yw
        ref_g = (xw.grad[:, :, mesh.s * n:(mesh.s + 1) * n] if split_in
                 else xw.grad)
        results[name] = dict(
            forward=float((ys.detach() - ref_y.detach()).abs().max()),
            grad=float((gx - ref_g).abs().max()),
            scale=float(yw.detach().abs().max()),
            grad_scale=float(ref_g.abs().max()),
            split_in=split_in, split_out=split_out,
            counts=D.space_counts())
    with open(os.path.join(out, f"layers-{rank}.json"), "w") as f:
        json.dump(results, f)


def run_step(init: dict, batch: dict, blocks=None, mesh=None,
             lr: float = 1e-3):
    """One step of ``W.STEP_CONFIG`` from ``init`` at ``lr`` → (params,
    stats, logs)."""
    from segmentation_training_pipeline_tpu_torch.train import step as TS

    model, tx, step = W.build_step(blocks, mesh)
    model.load_state_dict(init)
    state = TS.create_train_state(model, tx, device="cpu")
    gen = torch.Generator().manual_seed(W.AUG_SEED)
    new, logs = step(state, batch, lr, gen=gen)
    return new.params, new.batch_stats, {k: v.detach() for k, v in
                                         logs.items()}


def model_batch():
    r = np.random.RandomState(3)
    h, b = MODEL_H, MODEL_B
    return {"image": torch.from_numpy(
                r.randint(0, 255, (b, h, h, 3)).astype(np.uint8)),
            "mask": torch.from_numpy(
                (r.rand(b, h, h, 1) > 0.5).astype(np.float32)),
            "weight": torch.ones(b)}


def dropout_mask(model) -> torch.Tensor:
    """A keep mask of DeepLab's head dropout at 64² (stride 16)."""
    c = model.decoder.concat_projection.weight.shape[0]
    h = MODEL_H // 16
    r = np.random.RandomState(4)
    return torch.from_numpy(r.rand(MODEL_B, c, h, h) < 0.9)


def model_step(arch: str, backbone: str, remat: bool = False,
               mesh=None) -> dict:
    """One f32 SGD step at lr 1 (the update is the gradient) of
    ``arch``-``backbone`` from init seed 0 on ``model_batch`` → variables,
    loss and the space collectives."""
    from segmentation_training_pipeline_tpu_torch import config as TC
    from segmentation_training_pipeline_tpu_torch.models import factory as TF
    from segmentation_training_pipeline_tpu_torch.ops import losses as TLo
    from segmentation_training_pipeline_tpu_torch.parallel import (
        distributed as D)
    from segmentation_training_pipeline_tpu_torch.parallel.mesh import (
        shard_batch)
    from segmentation_training_pipeline_tpu_torch.train import (
        optimizers as TO)
    from segmentation_training_pipeline_tpu_torch.train import step as TS

    cfg = TC.parse_dict({"architecture": arch, "backbone": backbone,
                         "shape": [MODEL_H, MODEL_H, 3], "dtype": "float32",
                         "optimizer": "SGD", "loss": MODEL_LOSS})
    model = TF.init_model(TF.create_model(arch, backbone, 1,
                                          dtype="float32", remat=remat),
                          0, "cpu")
    tx = TO.build_optimizer(cfg)
    step = TS.build_train_step(model, tx, TLo.build_loss(MODEL_LOSS,
                                                         "sigmoid"),
                               {}, "sigmoid", None, mesh=mesh)
    batch = model_batch()
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    masks = ({DROPOUT: dropout_mask(model)} if arch == "DeepLabV3"
             else None)
    D.reset_counts()
    state = TS.create_train_state(model, tx, "cpu")
    new, logs = step(state, batch, 1.0,
                     gen=torch.Generator().manual_seed(5), drop_masks=masks)
    return dict(grads={k: state.params[k] - new.params[k]
                       for k in new.params},
                stats=new.batch_stats, loss=float(logs["loss"]),
                space=D.space_counts())


def digest(*parts: dict) -> str:
    """sha256 of the tensors of ``parts`` in key order: ranks whose
    digests are equal hold bit for bit equal tensors."""
    h = hashlib.sha256()
    for part in parts:
        for k in sorted(part):
            h.update(k.encode())
            h.update(part[k].contiguous().numpy().tobytes())
    return h.hexdigest()


def kept(result: dict, rank: int, tensors) -> dict:
    """What a rank writes: rank 0 everything, the others their digest of
    ``tensors`` and the rest (the tests hold rank 0's tensors to the
    reference and every rank's digest to rank 0's)."""
    out = dict(result, digest=digest(*(result[k] for k in tensors)))
    if rank:
        for k in tensors:
            del out[k]
    return out


def main():
    mode, rank, world, data, space, store, out = sys.argv[1:8]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from segmentation_training_pipeline_tpu_torch.parallel import (
        distributed as D)
    from segmentation_training_pipeline_tpu_torch.parallel.mesh import (
        MeshSpec, build_mesh, shard_batch)

    D.maybe_initialize(force=True, backend="gloo",
                       init_method=f"file://{store}", world_size=world,
                       rank=rank, timeout_s=60)
    mesh = build_mesh(MeshSpec(data=int(data), space=int(space)))
    if (mesh.rank, mesh.world, mesh.d, mesh.s) != (
            rank, world, rank // mesh.space, rank % mesh.space):
        raise RuntimeError(f"rank {rank}: mesh {mesh}")
    if mode == "layers":
        run_layers(mesh, out, rank)
    elif mode == "step":
        init = torch.load(os.path.join(out, "init.pt"))
        batch = shard_batch(torch.load(os.path.join(out, "batch.pt")), mesh)
        with open(os.path.join(out, "blocks.json")) as f:
            blocks = json.load(f)
        result = {}
        for name, b, lr in (("plain", None, 1e-3), ("grad", None, 1.0),
                            ("block", blocks, 1e-3)):
            D.reset_counts()
            params, stats, logs = run_step(init, batch, b, mesh, lr)
            result[name] = kept(dict(params=params, stats=stats, logs=logs,
                                     counts=D.counts(),
                                     space=D.space_counts()),
                                rank, ("params", "stats"))
        torch.save(result, os.path.join(out, f"step-{rank}.pt"))
    elif mode == "models":
        shallow_xception()
        torch.save({model_name(*m): kept(model_step(*m, mesh=mesh), rank,
                                         ("grads", "stats"))
                    for m in MODELS}, os.path.join(out, f"models-{rank}.pt"))
        import segmentation_training_pipeline_tpu_torch as stp

        if rank != 0:
            W._forbid_writes()
        cfg = stp.parse_dict(space_fit_config(out, {"data": int(data),
                                                    "space": int(space)}),
                             directory=out)
        first = cfg.fit(W.fit_dataset(), foldsToExecute=[0], verbose=0,
                        device="cpu")
        again = cfg.fit(W.fit_dataset(), foldsToExecute=[0], verbose=0,
                        device="cpu")
        with open(os.path.join(out, f"summary-{rank}.json"), "w") as f:
            json.dump({"first": first, "again": again}, f)
    D.shutdown()
    print(f"rank {rank}: ok", flush=True)


if __name__ == "__main__":
    main()
