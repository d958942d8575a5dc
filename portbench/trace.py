"""The device trace of a few steps or calls, read into what the per-layer
metrics need: every kernel's name and interval, the union of the device's
busy intervals, and the idle gaps with what the host was doing in each.

``profile(fn, n)`` runs ``fn`` ``n`` times under ``torch.profiler`` (CPU
and CUDA activities), each call inside a ``portbench.unit`` range,
synchronises, writes the Chrome trace to a temporary file under
``TMPDIR``, reads it and deletes it.
"""

from __future__ import annotations

import bisect
import json
import os
import statistics
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the host's calls into CUDA: launches, copies, allocations, waits
_API_CATS = ("cuda_runtime", "cuda_driver")
UNIT = "portbench.unit"


@dataclass
class Trace:
    units: int                       # steps or calls profiled
    window_s: float                  # host clock from first call to sync
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    busy_s: float = 0.0              # union of device intervals
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)
    host_s: Optional[float] = None   # a unit's host time outside CUDA calls

    def kernel_seconds(self, fragments, exclude=()) -> Optional[float]:
        """Device seconds of the kernels whose lower-cased name holds one
        of ``fragments`` and none of ``exclude``; None when none ran."""
        total, hit = 0.0, False
        for name, _, dur in self.kernels:
            low = name.lower()
            if any(f in low for f in fragments) and not any(
                    f in low for f in exclude):
                total += dur
                hit = True
        return total if hit else None


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(intervals: List[Tuple[float, float]], t0: float, t1: float
         ) -> List[Tuple[float, float]]:
    """The idle stretches of [t0, t1] between the intervals' union."""
    out, at = [], t0
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, t1)))
        at = max(at, e)
    if at < t1:
        out.append((at, t1))
    return [(s, e) for s, e in out if e > s]


def _top_level(ops: List[dict]) -> Dict[int, Tuple[list, list]]:
    """Per host thread, the outermost operator spans (starts, spans)."""
    by_tid: Dict[int, list] = {}
    for e in sorted(ops, key=lambda e: (e["ts"], -e.get("dur", 0))):
        spans = by_tid.setdefault(e["tid"], [])
        end = e["ts"] + e.get("dur", 0)
        if spans and e["ts"] < spans[-1][1]:
            continue
        spans.append((e["ts"], end, e["name"]))
    return {t: ([s[0] for s in v], v) for t, v in by_tid.items()}


def host_outside_api(events: List[dict]) -> Optional[float]:
    """The median over the ``UNIT`` ranges of the range's host time less
    the union of the CUDA runtime and driver calls inside it, on any
    thread (the backward dispatches from autograd's own): what the host
    spends in Python, the dispatcher and autograd, without a launch's
    own cost or a wait on a full launch queue.  None without ranges."""
    units = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == UNIT
             and "dur" in e]
    if not units:
        return None
    api = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("cat") in _API_CATS and "dur" in e]
    out = []
    for s, e in units:
        inside = [(max(a, s), min(b, e)) for a, b in api if a < e and b > s]
        out.append((e - s - union_seconds(inside)) * 1e-6)
    return statistics.median(out)


def parse(events: List[dict], units: int, window_s: float) -> Trace:
    """A Chrome trace's events → ``Trace`` (seconds)."""
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS
           and "dur" in e]
    tr = Trace(units=units, window_s=window_s)
    tr.kernels = [(e["name"], e["ts"] * 1e-6, e["dur"] * 1e-6)
                  for e in dev if e["cat"] == "kernel"]
    iv = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    tr.busy_s = union_seconds(iv) * 1e-6
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * 1e-6
    tr.device_ops = [[k, v] for k, v in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:10]]
    tr.host_s = host_outside_api(events)
    # an idle gap belongs to the host operator that launched the device
    # work ending it (its launch's correlation), outermost on its thread
    ops = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation")
           and "dur" in e and e.get("name") != UNIT]
    top = _top_level(ops)
    launch_at = {e.get("args", {}).get("correlation"): (e["tid"], e["ts"])
                 for e in events if e.get("cat") == "cuda_runtime"}
    first = sorted(dev, key=lambda e: e["ts"])
    starts = [e["ts"] for e in first]
    if iv:
        t0 = min(s for s, _ in iv)
        t1 = max(e for _, e in iv)
        labels: Dict[str, float] = {}
        for s, e in gaps(iv, t0, t1):
            i = bisect.bisect_left(starts, e)
            label = "host"
            if i < len(first):
                corr = first[i].get("args", {}).get("correlation")
                tid, ts = launch_at.get(corr, (None, None))
                if tid in top:
                    begin, spans = top[tid]
                    j = bisect.bisect_right(begin, ts) - 1
                    if j >= 0 and spans[j][1] >= ts:
                        label = spans[j][2]
            labels[label] = labels.get(label, 0.0) + (e - s) * 1e-6
        tr.idle_gaps = [[k, v] for k, v in sorted(
            labels.items(), key=lambda kv: -kv[1])[:10]]
    return tr


def profile(fn: Callable[[], object], n: int) -> Trace:
    """``n`` calls of ``fn`` under the profiler, ended by a synchronise."""
    from torch.profiler import ProfilerActivity, profile as _profile
    from torch.profiler import record_function

    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            with record_function(UNIT):
                fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return parse(events, n, window)
