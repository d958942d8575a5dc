"""Serving traffic: flip-TTA fold-ensemble prediction, one closed-loop
client.

The cell's workload file gives the batch, the square image size, the
folds and how many distinct batches of uint8 images the client holds in
host memory (cycled).  Set-up makes each fold's weights from the seed on
the card, sets their BatchNorm running statistics to the batch statistics
of a calibration batch (a trained model's BatchNorms hold such values; the
reference computes them), writes one checkpoint per fold under ``TMPDIR``
with the program's writer, and loads them through the program's serving
entry (``PipelineConfig.load`` → ``InferenceBundle``).  The client calls
``predict_probs`` on the next batch as soon as the last call returned:
each call is timed on the host clock from upload to the probabilities in
host memory.  After the window a sample of the finished calls, drawn from
the seed, is held to the plain reference (``reference/train.py:
serve_probs``).
"""

from __future__ import annotations

import random
import statistics
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import common as C


def fold_weights(cfg: dict, wl: dict, seed: int, device
                 ) -> List[Dict[str, torch.Tensor]]:
    """Every fold's weights on the host: drawn on the card, their running
    statistics those of a calibration batch from the seed."""
    from portbench.reference import train as RT

    s = wl["size"]
    gen = C.generator(seed, "calibration", device)
    images, _ = C.synthetic_batch(gen, wl["calibration_images"], s, s)
    out = []
    with RT.exact():
        for f in range(wl["folds"]):
            w = C.make_weights(cfg, C.subseed(seed, f"fold{f}"), device)
            w.update(RT.batch_statistics(cfg["reference"], w, images))
            out.append({k: v.cpu() for k, v in w.items()})
    return out


def host_batches(wl: dict, seed: int, device) -> List[np.ndarray]:
    s = wl["size"]
    gen = C.generator(seed, "images", device)
    return [C.synthetic_batch(gen, wl["batch"], s, s)[0].cpu().numpy()
            for _ in range(wl["batches"])]


def load_program(cfg: dict, wl: dict, folds, seed: int, tmp: str, device):
    """Checkpoints written with the program's writer, loaded by its
    serving entry → the ``InferenceBundle``."""
    from segmentation_training_pipeline_tpu_torch import config as PC
    from segmentation_training_pipeline_tpu_torch.train import (
        checkpoint as CK)

    s = wl["size"]
    pcfg = PC.parse_dict({
        "architecture": cfg["architecture"], "backbone": cfg["backbone"],
        "shape": [s, s, 3], "classes": cfg["classes"],
        "activation": cfg["activation"], "batch": wl["batch"],
        "dtype": cfg["dtype"], "folds_count": wl["folds"],
        "flipPred": True, "stages": [{"epochs": 1}]}, directory=tmp)
    for f, w in enumerate(folds):
        CK.save_checkpoint(pcfg.weights_path(f, 0), w, {
            "architecture": cfg["architecture"],
            "backbone": cfg["backbone"], "fold": f, "stage": 0,
            "seed": C.subseed(seed, f"fold{f}"), "encoder_variant": ""})
    # one card: an index keeps the bundle from splitting across cards
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    return pcfg.load(list(range(wl["folds"])), 0, device=str(device))


def reference_gaps(r, folds, pool, got: Dict[int, np.ndarray], device,
                   quant: Optional[Callable] = None) -> Dict[str, float]:
    """``mean_gap``: the mean |p − reference| over every pixel of the
    sampled calls; ``image_gap``: the largest one image's mean gap."""
    from portbench.reference import train as RT

    weights = [{k: v.to(device) for k, v in w.items()} for w in folds]
    total, n, worst = 0.0, 0, 0.0
    with RT.exact():
        for call, probs in got.items():
            images = torch.from_numpy(pool[call % len(pool)]).to(device)
            want = RT.serve_probs(r.config["reference"], weights, images,
                                  quant)
            gap = (torch.from_numpy(probs).to(device) - want).abs()
            total += float(gap.double().sum())
            n += gap.numel()
            worst = max(worst, float(gap.mean(dim=(1, 2, 3)).max()))
    return {"mean_gap": total / n, "image_gap": worst}


def sample_calls(seed: int, done: int, k: int) -> List[int]:
    """``k`` of the ``done`` finished calls, drawn from the seed."""
    rng = random.Random(C.subseed(seed, "sample"))
    return sorted(rng.sample(range(done), min(k, done)))


def run(r):
    dev = torch.device("cuda" if r.device is None else r.device)
    cuda = dev.type == "cuda"
    wl = r.workload
    r.mark("harness imports")
    folds = fold_weights(r.config, wl, r.seed, dev)
    r.mark("fold weights")
    pool = host_batches(wl, r.seed, dev)
    with tempfile.TemporaryDirectory(prefix="portbench-serve-") as tmp:
        bundle = load_program(r.config, wl, folds, r.seed, tmp, dev)
    r.mark("checkpoints written and loaded")
    for i in range(wl["warm_calls"]):
        bundle.predict_probs(pool[i % len(pool)])
    r.setup_done()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    outs, times = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < r.seconds:
        t = time.perf_counter()
        outs.append(bundle.predict_probs(pool[len(outs) % len(pool)]))
        times.append(time.perf_counter() - t)
    window = time.perf_counter() - t0
    r.window_done()
    r.attempted = len(outs)
    want_shape = (wl["batch"], wl["size"], wl["size"], r.config["classes"])
    r.failed = sum(1 for o in outs
                   if o.shape != want_shape or not np.isfinite(o).all())
    r.e2e["serve_img_per_s"] = len(outs) * wl["batch"] / window
    ms = [t * 1e3 for t in times]
    r.e2e["serve_call_ms_p90"] = C.p90(ms)
    r.log(f"calls {len(ms)} in {window:.3f} s; median "
          f"{statistics.median(ms):.3f} ms")
    if r.trace:
        from portbench import trace as T
        k = len(outs)
        tr = T.profile(lambda: bundle.predict_probs(pool[k % len(pool)]),
                       wl["profiled_calls"])
        r.layer.update(trace=tr, img_per_s=r.e2e["serve_img_per_s"])
    r.read_memory()
    got = {i: outs[i] for i in sample_calls(r.seed, len(outs),
                                            wl["compared_calls"])}
    del bundle, outs
    if cuda:
        torch.cuda.empty_cache()
    r.compare(reference_gaps(r, folds, pool, got, dev))
