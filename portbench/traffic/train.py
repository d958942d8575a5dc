"""Training traffic: the program's train step driven as ``fit`` drives it.

The cell's workload file gives the batch, the square image size, the
augmentation block (the config-2 block), how many distinct batches live on
the card (cycled), how many steps set-up runs and the reference follows,
and the limits of the comparison.  Every input comes from the run's seed:
the weights (``common.make_weights``), the batches
(``common.synthetic_batch``) and, for every step, fresh augmentation draws
and dropout keep masks from one generator on the card (``Feed``), in the
program's draw structure (``reference/aug.py`` names it).

Set-up builds the train state once and runs its first steps through the
window's own call and feed; the window then dispatches steps with no
per-step synchronisation, as ``fit`` does, and ends at a synchronise after
the last step.  After the window the program's state is freed and the
plain reference (``reference/train.py``) follows the first steps from the
same weights, batches and draws.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from portbench import common as C
from portbench.reference import aug as RA

Tensor = torch.Tensor


class Feed:
    """The step inputs of a run, step after step: a batch of the cycle,
    fresh augmentation draws and (DeepLab) dropout keep masks."""

    def __init__(self, wl: dict, cfg: dict, seed: int, device):
        b, s = wl["batch"], wl["size"]
        gen = C.generator(seed, "batches", device)
        self.batches = [C.synthetic_batch(gen, b, s, s)
                        for _ in range(wl["batches"])]
        self.gen = C.generator(seed, "draws", device)
        self.block = wl["augmentation"]
        self.statics = RA.BlockStatics(self.block, s, s)
        self.b, self.s = b, s
        self.dropout = cfg.get("bound_dropout")
        self.i = 0

    def _u(self, lo: float, hi: float) -> Tensor:
        return torch.rand((self.b,), generator=self.gen,
                          device=self.gen.device) * (hi - lo) + lo

    def draws(self):
        b, s, blk, st = self.b, self.s, self.block, self.statics
        aff = blk["Affine"]
        scale = self._u(*aff["scale"])
        zeros = torch.zeros((b,), device=self.gen.device)
        el = blk["ElasticTransformation"]
        shape = RA.noise_shape(b, s, s, st.radius, st.stride)
        geo = [{"flip": torch.rand((b,), generator=self.gen,
                                   device=self.gen.device) < blk["Fliplr"]},
               dict(sx=scale, sy=scale,
                    tx=self._u(*aff["translate_percent"]["x"]),
                    ty=self._u(*aff["translate_percent"]["y"]),
                    rot=self._u(*aff["rotate"]), shx=zeros, shy=zeros),
               dict(alpha=self._u(*el["alpha"]),
                    sigma=torch.full((b,), float(el["sigma"]),
                                     device=self.gen.device),
                    noise_x=torch.rand(shape, generator=self.gen,
                                       device=self.gen.device) * 2.0 - 1.0,
                    noise_y=torch.rand(shape, generator=self.gen,
                                       device=self.gen.device) * 2.0 - 1.0)]
        return [geo, {"mul": self._u(*blk["Multiply"])}]

    def keep_masks(self) -> Optional[Dict[str, Tensor]]:
        d = self.dropout
        if not d:
            return None
        n = self.s // d["stride"]
        keep = torch.rand((self.b, d["channels"], n, n), generator=self.gen,
                          device=self.gen.device) >= d["rate"]
        return {d["name"]: keep}

    def next(self):
        images, masks = self.batches[self.i % len(self.batches)]
        self.i += 1
        return ({"image": images, "mask": masks}, self.draws(),
                self.keep_masks())


@dataclass
class Readings:
    """What the comparison reads of one side's first steps: each step's
    loss, and per leaf the first gradient's norm, the parameters' change
    and the running statistics' change after the compared steps."""
    losses: List[float] = field(default_factory=list)
    grad: Dict[str, float] = field(default_factory=dict)
    change: Dict[str, float] = field(default_factory=dict)
    stats: Dict[str, float] = field(default_factory=dict)


def _norms(tensors: Dict[str, Tensor]) -> Dict[str, float]:
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack([tensors[k].double().norm() for k in names])
    return dict(zip(names, vals.tolist()))


def _changes(now: Dict[str, Tensor], start: Dict[str, Tensor]
             ) -> Dict[str, float]:
    return _norms({k: now[k] - start[k] for k in now})


def program_pieces(cfg: dict, wl: dict, device):
    """The program's model, optimizer and train step for the cell."""
    from segmentation_training_pipeline_tpu_torch import config as PC
    from segmentation_training_pipeline_tpu_torch.models import factory as MF
    from segmentation_training_pipeline_tpu_torch.ops import losses as LO
    from segmentation_training_pipeline_tpu_torch.ops.aug import (
        lowering as LW)
    from segmentation_training_pipeline_tpu_torch.train import (
        optimizers as OP)
    from segmentation_training_pipeline_tpu_torch.train import step as ST

    s = wl["size"]
    pcfg = PC.parse_dict({
        "architecture": cfg["architecture"], "backbone": cfg["backbone"],
        "shape": [s, s, 3], "classes": cfg["classes"],
        "activation": cfg["activation"], "batch": wl["batch"],
        "dtype": cfg["dtype"], "loss": cfg["loss"],
        "optimizer": cfg["optimizer"], "lr": cfg["lr"], "metrics": [],
        "augmentation": wl["augmentation"]})
    model = MF.create_model(pcfg.architecture, pcfg.backbone, pcfg.classes,
                            dtype=pcfg.dtype)
    tx = OP.build_optimizer(pcfg)
    step = ST.build_train_step(
        model, tx, LO.build_loss(pcfg.loss, pcfg.activation), {},
        pcfg.activation, None,
        aug=LW.build_augmentation(pcfg.augmentation))
    return model, tx, step, ST


def _first_grads(opt_state) -> Dict[str, Tensor]:
    """The gradient Adam took at its first step: mu / (1 − b1)."""
    for part in opt_state:
        if hasattr(part, "mu"):
            return {k: v / 0.1 for k, v in part.mu.items()}
    raise ValueError("the optimizer state holds no first moment")


class Program:
    """Set-up of the program's side: the state built once, its first steps
    run through the window's call and feed, their readings kept."""

    def __init__(self, r, device):
        wl, cfg = r.workload, r.config
        self.wl, self.cfg, self.r = wl, cfg, r
        weights = C.make_weights(cfg, r.seed, device)
        model, tx, self.step, ST = program_pieces(cfg, wl, device)
        model.load_state_dict(weights)
        del weights
        self.state = ST.create_train_state(model, tx, device)
        self.model = model
        self.feed = Feed(wl, cfg, r.seed, device)
        self.lr = cfg["lr"]
        self.device = device
        self.readings = Readings()

    def call(self) -> Tensor:
        batch, draws, keep = self.feed.next()
        self.state, logs = self.step(self.state, batch, self.lr,
                                     draws=draws, drop_masks=keep)
        return logs["loss"]

    def first_steps(self) -> None:
        wl, rd = self.wl, self.readings
        s0 = {k: v.clone() for k, v in self.state.batch_stats.items()}
        for i in range(wl["warm_steps"]):
            rd.losses.append(float(self.call()))
            if i == 0:
                rd.grad = _norms(_first_grads(self.state.opt_state))
            if i + 1 == wl["compared_steps"]:
                p0 = C.make_weights(self.cfg, self.r.seed, self.device)
                rd.change = _changes(self.state.params, p0)
                rd.stats = _changes(self.state.batch_stats, s0)
                del p0
        rd.losses = rd.losses[:wl["compared_steps"]]

    def free(self) -> None:
        self.state = self.model = self.step = None


def reference_readings(r, device, quant: Optional[Callable] = None
                       ) -> Readings:
    """The plain reference (``quant``: its operands rounded) through the
    compared steps from the same weights, batches and draws."""
    from portbench.reference import train as RT

    wl, cfg = r.workload, r.config
    weights = C.make_weights(cfg, r.seed, device)
    feed = Feed(wl, cfg, r.seed, device)
    with RT.exact():
        ref = RT.TrainReference(cfg["reference"], weights, cfg["lr"],
                                wl["augmentation"], quant)
        for _ in range(wl["compared_steps"]):
            batch, draws, keep = feed.next()
            ref.step(batch["image"], batch["mask"], draws,
                     None if keep is None else next(iter(keep.values())))
    now = ref.state()
    params = dict(ref.model.named_parameters())
    rd = Readings(losses=list(ref.losses), grad=_norms(ref.first_grads))
    rd.change = _changes({k: now[k] for k in params},
                         {k: weights[k] for k in params})
    rd.stats = _changes({k: now[k] for k in now if k not in params},
                        {k: weights[k] for k in now if k not in params})
    return rd


def _leaf_gap(got: Dict[str, float], want: Dict[str, float],
              keys) -> float:
    """The worst leaf's gap between two norms, over the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    keys = list(keys)
    if not keys:
        return 0.0
    med = statistics.median(want[k] for k in keys)
    return max(abs(got.get(k, 0.0) - want[k]) / max(want[k], med, 1e-30)
               for k in keys)


def moving_leaves(ref: Readings) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of
    the median leaf's."""
    med = statistics.median(ref.grad.values())
    return [k for k, v in ref.grad.items() if v >= 1e-3 * med]


def compare(got: Readings, ref: Readings) -> Dict[str, float]:
    """The numbers read of the first steps, each a relative gap between
    the program's reading and the reference's:

      loss_first   the first step's loss;
      grad_median  the first gradient's norm, the median leaf's gap;
      change       the parameters' change, the worst leaf's gap;
      stats        the running statistics' change, the worst leaf's gap.

    A leaf's gap is over the reference's norm of that leaf or of the
    median leaf, whichever is larger.  Leaves whose reference gradient is
    under a thousandth of the median leaf's are left out of the gradient
    and change numbers: their gradient is nought but for rounding (a
    BatchNorm's shift followed by a linear layer and another BatchNorm),
    so the gradient and Adam's move of it are round-off alone.  A cell's
    ``limits`` name the numbers it compares (the worst step's loss and
    the worst leaf's gradient swing with the later steps and the smallest
    leaves: ``calibrate.py --detail`` reads them; see PERF.md)."""
    med = statistics.median(ref.grad.values())
    moving = moving_leaves(ref)
    steps = [abs(a - b) / abs(b) for a, b in zip(got.losses, ref.losses)]
    if len(got.losses) != len(ref.losses):
        steps = [float("inf")]
    gaps = sorted(abs(got.grad.get(k, 0.0) - ref.grad[k])
                  / max(ref.grad[k], med) for k in moving)
    return {"change": _leaf_gap(got.change, ref.change, moving),
            "stats": _leaf_gap(got.stats, ref.stats, ref.stats),
            "loss_first": steps[0], "grad_median": statistics.median(gaps)}


def run(r):
    """One run of a training cell → ``r.result``'s fields."""
    dev = torch.device("cuda" if r.device is None else r.device)
    cuda = dev.type == "cuda"
    wl = r.workload
    r.mark("harness imports")
    prog = Program(r, dev)
    r.mark("train state")
    prog.first_steps()
    r.setup_done()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    while True:
        losses.append(prog.call())
        if time.perf_counter() - t0 >= r.seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    r.window_done()
    steps = len(losses)
    img_s = steps * wl["batch"] / window
    r.e2e["train_img_per_s"] = img_s
    r.attempted = steps
    r.failed = int((~torch.isfinite(torch.stack(losses))).sum())
    if r.trace:
        from portbench import trace as T
        tr = T.profile(prog.call, wl["profiled_steps"])
        r.layer.update(trace=tr, img_per_s=img_s)
    r.read_memory()
    prog.free()
    if cuda:
        torch.cuda.empty_cache()
    r.compare(compare(prog.readings, reference_readings(r, dev)))
