"""The benchmark of ``segmentation_training_pipeline_tpu_torch`` on the card.

    python portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

``CELL`` names ``portbench/workloads/CELL.json``, which names its
configuration (``configs/``) and its traffic kind (``traffic/<kind>.py``).
The traffic module builds the program's state from the seed, runs its
first steps or calls as set-up, measures for ``--seconds``, and holds what
the timed path produced to the plain reference (``reference/``).  With
``--trace 0`` the result carries the cell's end-to-end metrics; with
``--trace 1`` a traced run reads the per-layer metrics that
``BENCHMARK.json`` lists for the cell, each by its reader
``layer_metrics/<metric>.py``.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last: each
number compared beside its limit); the last lines of standard error list
the same numbers.

A run exits with another code than 0 and prints no result when CUDA is
not there or the card count is short of the cell's, and when a module of
JAX or of the JAX package is loaded (top-level names compared whole).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, Optional  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import common as C  # noqa: E402


class GuardError(RuntimeError):
    """A module of JAX or of the JAX package is loaded."""


class Run:
    """One run of one cell: its inputs, what it measured, what it
    compared."""

    def __init__(self, workload: str, seed: int, seconds: float,
                 trace: bool, device: Optional[str] = None,
                 overrides: Optional[dict] = None,
                 config_overrides: Optional[dict] = None):
        self.name = workload
        self.workload = {**C.load_json("workloads", workload),
                         **(overrides or {})}
        self.config = {**C.load_json("configs", self.workload["config"]),
                       **(config_overrides or {})}
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.device = device
        self.cuda = device is None or str(device).startswith("cuda")
        self.e2e: Dict[str, float] = {}
        self.layer: Dict[str, object] = {}
        self.checks: Dict[str, dict] = {}
        self.attempted = self.failed = 0
        self.setup_peak = self.memory_peak = 0

    def log(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    def guard(self, when: str) -> None:
        found = C.forbidden_loaded()
        if found:
            raise GuardError(f"{when}: loaded {', '.join(found)}")

    def mark(self, part: str) -> None:
        """Log the seconds since the process started, at the end of a
        part of set-up, so that a slow set-up shows where it went."""
        self.log(f"set-up {part} done at {time.perf_counter() - T0:.3f} s")

    def setup_done(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
            self.setup_peak = torch.cuda.max_memory_allocated()
        self.e2e["setup_s"] = time.perf_counter() - T0
        self.guard("after set-up")

    def window_done(self) -> None:
        if self.cuda:
            self.e2e["peak_mem_gib"] = torch.cuda.max_memory_allocated() \
                / 2 ** 30
        self.guard("after the window")

    def read_memory(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
            self.memory_peak = max(self.setup_peak,
                                   torch.cuda.max_memory_allocated())

    def compare(self, numbers: Dict[str, float]) -> None:
        """Hold each number the cell's ``limits`` name to its limit; a
        number the traffic kind reads and the cell does not compare is left
        out."""
        limits = self.workload["limits"]
        for k, limit in limits.items():
            self.checks[k] = {"value": numbers[k], "limit": limit}
        for k, v in numbers.items():
            if k not in limits:
                self.log(f"reading {k} {v!r} (held to no limit)")

    @property
    def correct(self) -> bool:
        return (bool(self.checks) and self.failed == 0
                and all(c["value"] <= c["limit"]
                        for c in self.checks.values()))


def _applies(metric: dict, cell: str, reported) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported(metric)


def result(r: Run, bench: dict) -> dict:
    cell = r.name
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell,
                                                      lambda m: True)]
    names = {m["name"] for m in e2e}
    metrics = {}
    if not r.trace:
        for m in e2e:
            if m["name"] in r.e2e:
                metrics[m["name"]] = {"value": r.e2e[m["name"]],
                                      "unit": m["unit"]}
    else:
        from portbench import counts as CN

        s = r.workload["size"]
        inputs = SimpleNamespace(
            **r.layer, workload=r.workload, config=r.config,
            batch=r.workload["batch"], size=s,
            counts=CN.counts_for(r.config, s, s))
        for m in bench["per_layer"]:
            if not _applies(m, cell, lambda m: m["moves"] in names):
                continue
            v = C.load_module("layer_metrics", m["name"]).read(inputs)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if r.cuda else "cpu",
              "kind": (torch.cuda.get_device_name(0) if r.cuda else "cpu"),
              "count": r.workload["chips"],
              "memory_peak_bytes": r.memory_peak}
    out = {"correct": r.correct, "attempted": r.attempted,
           "failed": r.failed, "metrics": metrics, "device": device}
    tr = r.layer.get("trace")
    if tr is not None:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops,
                            "idle_gaps": tr.idle_gaps}
    out["checks"] = r.checks
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: Optional[str] = None, overrides: Optional[dict] = None,
             config_overrides: Optional[dict] = None) -> dict:
    """Set-up, window and comparison of one cell → the result object.
    ``device`` and the overrides serve the CPU tests; the command runs
    the cell as its files state it, on the card."""
    r = Run(workload, seed, seconds, trace, device, overrides,
            config_overrides)
    r.guard("at the start")
    C.load_module("traffic", r.workload["traffic"]).run(r)
    r.guard("at the end")
    return result(r, C.benchmark())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    need = C.load_json("workloads", a.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"the cell needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {C.power_limit()}", file=sys.stderr, flush=True)
    try:
        res = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    except GuardError as e:
        print(f"refused: {e}", file=sys.stderr)
        return 3
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
