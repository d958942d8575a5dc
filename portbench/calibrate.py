"""Readings that the comparison's limits are set from, at a cell's own
size on the card: the program's numbers on many seeds, the control's (the
reference in float8, ``reference/lowp.py``, in the program's place) and
those of faults planted in the program (``faults.py``), all in one
process.

    python portbench/calibrate.py --workload CELL --seeds 1,2,3 \\
        [--control 1,2,3] [--faults half_batch:1,2,3] [--out FILE]

A training cell reads each seed's first steps (no window); a serving cell
reads as many calls as a run compares.  One JSON line per seed and side.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import common as C  # noqa: E402
from portbench import faults as FL  # noqa: E402
from portbench.reference import lowp  # noqa: E402
from portbench.run import Run  # noqa: E402


def _detail(got, ref):
    """Each step's loss gap and the worst (``loss``), the worst leaf's
    first gradient (``grad``, over the leaves ``compare`` keeps), and each
    number's six worst leaves (``grad_leaves``, …)."""
    import statistics

    T = C.load_module("traffic", "train")
    med = statistics.median(ref.grad.values())
    steps = [abs(a - b) / abs(b) for a, b in zip(got.losses, ref.losses)]
    out = {"loss_steps": steps, "loss": max(steps),
           "grad": T._leaf_gap(got.grad, ref.grad, T.moving_leaves(ref)),
           "grad_median_leaf": med}
    for key in ("grad", "change", "stats"):
        g, w = getattr(got, key), getattr(ref, key)
        m = statistics.median(w.values())
        rows = sorted(((abs(g.get(k, 0.0) - v) / max(v, m), k, g.get(k),
                        v, ref.grad.get(k, 0.0) / med) for k, v in w.items()),
                      reverse=True)
        out[f"{key}_leaves"] = rows[:6]
    return out


def _train(r, dev, control: bool, faults, detail: bool = False):
    T = C.load_module("traffic", "train")
    out = {}

    def program():
        prog = T.Program(r, dev)
        prog.first_steps()
        prog.free()
        torch.cuda.empty_cache()
        return prog.readings

    got = program()
    ref = T.reference_readings(r, dev)
    out["program"] = T.compare(got, ref)
    out["losses"] = {"program": got.losses, "reference": ref.losses}
    if detail:
        out["program_detail"] = _detail(got, ref)
    if control:
        ctl = T.reference_readings(r, dev, lowp.fp8)
        out["control"] = T.compare(ctl, ref)
        if detail:
            out["control_detail"] = _detail(ctl, ref)
    for name in faults:
        with FL.FAULTS[name]():
            out[name] = T.compare(program(), ref)
    return out


def _serve(r, dev, control: bool, faults, detail: bool = False):
    S = C.load_module("traffic", "serve")
    from portbench.reference import train as RT

    wl = r.workload
    folds = S.fold_weights(r.config, wl, r.seed, dev)
    pool = S.host_batches(wl, r.seed, dev)
    calls = range(wl["compared_calls"])

    def program():
        import tempfile

        with tempfile.TemporaryDirectory(prefix="portbench-cal-") as tmp:
            bundle = S.load_program(r.config, wl, folds, r.seed, tmp, dev)
        for i in range(wl["warm_calls"]):
            bundle.predict_probs(pool[i % len(pool)])
        got = {i: bundle.predict_probs(pool[i % len(pool)]) for i in calls}
        del bundle
        torch.cuda.empty_cache()
        return got

    out = {"program": S.reference_gaps(r, folds, pool, program(), dev)}
    if control:
        weights = [{k: v.to(dev) for k, v in w.items()} for w in folds]
        with RT.exact():
            ctl = {i: RT.serve_probs(r.config["reference"], weights,
                                     torch.from_numpy(pool[i % len(pool)])
                                     .to(dev), lowp.fp8).cpu().numpy()
                   for i in calls}
        del weights
        out["control"] = S.reference_gaps(r, folds, pool, ctl, dev)
    for name in faults:
        with FL.FAULTS[name]():
            out[name] = S.reference_gaps(r, folds, pool, program(), dev)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--faults", default="", help="NAME:s1,s2;NAME:…")
    p.add_argument("--out", default="")
    p.add_argument("--detail", action="store_true",
                   help="add each number's worst leaves and steps")
    a = p.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    control = {int(s) for s in a.control.split(",") if s}
    faults = {}
    for item in filter(None, a.faults.split(";")):
        name, ss = item.split(":")
        for s in ss.split(","):
            faults.setdefault(int(s), []).append(name)
    dev = torch.device("cuda")
    print(f"card: {C.power_limit()}", file=sys.stderr, flush=True)
    lines = []
    for seed in sorted(set(seeds) | control | set(faults)):
        r = Run(a.workload, seed, 0, False)
        kind = _train if r.workload["traffic"] == "train" else _serve
        res = kind(r, dev, seed in control, faults.get(seed, []),
                   a.detail)
        line = json.dumps({"workload": a.workload, "seed": seed,
                           "sound": seed in seeds, **res})
        print(line, flush=True)
        lines.append(line)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
