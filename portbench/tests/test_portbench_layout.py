"""The harness finds a configuration, a workload and a per-layer metric
added as files of their own, in a copy of the benchmark where no existing
file under ``portbench/`` is edited (``BENCHMARK.json``, the index, gains
their entries)."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import counts as CN

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
torch.set_num_threads(2)
from portbench import run as R, trace as T
assert R.__file__.startswith(sys.argv[1]), R.__file__
res = R.run_cell("tiny-train", 3000000019, 0.2, False, "cpu",
                 config_overrides={"dtype": "float32"})
r = R.Run("tiny-train", 1, 0, True, "cpu")
r.layer["trace"] = T.Trace(units=2, window_s=1.0,
                           kernels=[("bn_stats_kernel", 0.0, 0.25)],
                           busy_s=0.25)
print(json.dumps({"run": res, "traced": R.result(r, R.C.benchmark())}))
"""


def test_new_files_are_found(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "unet-resnet34.json").read_text())
    cfg["name"] = "unet-resnet34-copy"
    cfg["counts"] = {"64x64": CN.count(cfg["reference"], 64, 64)}
    (pb / "configs" / "unet-resnet34-copy.json").write_text(json.dumps(cfg))
    wl = json.loads((pb / "workloads" / "unet34-train-512-b128.json")
                    .read_text())
    wl.update(name="tiny-train", config="unet-resnet34-copy", size=64,
              batch=4, batches=3)
    (pb / "workloads" / "tiny-train.json").write_text(json.dumps(wl))
    (pb / "layer_metrics" / "bn_share.train.py").write_text(
        "def read(t):\n"
        "    s = t.trace.kernel_seconds(('bn_',))\n"
        "    return None if s is None else 100.0 * s / t.trace.window_s\n")
    for m in bench["end_to_end"]:
        if "train_img_per_s" == m["name"]:
            m["workloads"].append("tiny-train")
    bench["workloads"].append({"name": "tiny-train",
                               "config": "unet-resnet34-copy",
                               "traffic": "train", "chips": 1, "why": "a"})
    bench["per_layer"].append({
        "name": "bn_share.train", "unit": "%", "better": "lower",
        "source": "device_trace", "layer": "batch norm",
        "moves": "train_img_per_s", "workloads": ["tiny-train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path),
                          str(ROOT)], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["run"]["correct"] is True, res["run"]["checks"]
    assert set(res["run"]["metrics"]) == {"train_img_per_s", "setup_s"}
    assert res["traced"]["metrics"]["bn_share.train"]["value"] == 25.0
    # the traced line reads every per-layer metric listed for the cell
    # that finds something to read, and nothing of another cell's
    assert "conv_roofline.serve" not in res["traced"]["metrics"]
    after = {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert before == after


def test_unfrozen_size_is_refused():
    cfg = json.loads((ROOT / "portbench" / "configs" / "unet-resnet34.json")
                     .read_text())
    assert CN.counts_for(cfg, 512, 512) is cfg["counts"]["512x512"]
    with pytest.raises(KeyError, match="no counts frozen at 64x64"):
        CN.counts_for(cfg, 64, 64)
