"""The metric arithmetic on synthetic kernel events: the union of busy
intervals, idle gaps and what the host did in them, attribution by kernel
name, the rooflines, the shares and the 90th percentile."""

import statistics
from types import SimpleNamespace

import pytest

from portbench import common as C
from portbench import trace as T


def events():
    """Two host operators launching three kernels and a copy (µs)."""
    k = lambda name, ts, dur, corr: {"cat": "kernel", "name": name, "ts": ts,
                                     "dur": dur, "args": {"correlation": corr}}
    rt = lambda ts, corr: {"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                           "ts": ts, "dur": 2, "tid": 1,
                           "args": {"correlation": corr}}
    op = lambda name, ts, dur: {"cat": "cpu_op", "name": name, "ts": ts,
                                "dur": dur, "tid": 1}
    return [{"cat": "user_annotation", "name": T.UNIT, "ts": 0, "dur": 150,
             "tid": 1},
            op("aten::convolution", 0, 50), op("aten::cudnn_convolution", 1, 40),
            op("BatchNormTrain", 100, 50),
            rt(10, 1), rt(20, 2), rt(110, 3),
            k("sm90_xmma_fprop_implicit_gemm_bf16", 12, 30, 1),
            k("void at::native::vectorized_elementwise_kernel<4, conv>", 30, 20, 2),
            k("bn_stats_kernel<bf16>", 112, 8, 3),
            {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 125, "dur": 5,
             "args": {"correlation": 9}}]


def test_union_and_gaps():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26)]
    assert T.union_seconds(iv) == 25
    assert T.gaps(iv, 0, 40) == [(15, 20), (30, 40)]
    assert T.union_seconds([]) == 0


def test_parse():
    tr = T.parse(events(), units=1, window_s=200e-6)
    assert len(tr.kernels) == 3
    # kernels 12-42 and 30-50 overlap: busy 12-50, 112-120, 125-130
    assert tr.busy_s == pytest.approx(51e-6)
    # gap 50-112 ends at the kernel launched inside BatchNormTrain; the
    # gap 120-125 ends at a copy no host operator launched
    assert dict(tr.idle_gaps) == pytest.approx({"BatchNormTrain": 62e-6,
                                                 "host": 5e-6})
    assert tr.device_ops[0][0] == "sm90_xmma_fprop_implicit_gemm_bf16"


def test_attribution():
    tr = T.parse(events(), 1, 200e-6)
    conv = C.load_module("layer_metrics", "conv_roofline.train")
    assert tr.kernel_seconds(conv.FRAGMENTS, conv.EXCLUDE) == \
        pytest.approx(30e-6)
    bn = C.load_module("layer_metrics", "bn_roofline.train")
    assert tr.kernel_seconds(bn.FRAGMENTS) == pytest.approx(8e-6)
    aug = C.load_module("layer_metrics", "aug_roofline.train")
    assert tr.kernel_seconds(aug.FRAGMENTS) is None


def inputs(tr, **kw):
    counts = {"conv": [[2e9, 1e6, 1e6, 1e4, 0, 1, 2],
                       [1e6, 4e6, 4e6, 1e2, 1, 0, 2]],
              "bn": [1e6, 3e6], "forward_flops": 2.001e9,
              "train_flops": 6.003e9}
    return SimpleNamespace(trace=tr, batch=4, size=64, counts=counts,
                           workload={"folds": 2}, **kw)


def test_host_outside_api():
    """A unit's host time less the union of the CUDA calls inside it, on
    any thread; the median over units; None without units."""
    unit = lambda ts, dur: {"cat": "user_annotation", "name": T.UNIT,
                            "ts": ts, "dur": dur, "tid": 1}
    api = lambda ts, dur, tid=1, cat="cuda_runtime": {
        "cat": cat, "name": "cudaLaunchKernel", "ts": ts, "dur": dur,
        "tid": tid}
    ev = [unit(0, 100), unit(200, 100), unit(400, 100),
          # unit 1: 10 + 30 (a wait on a full queue), one on another thread
          api(5, 10), api(50, 30), api(60, 30, tid=2),
          # unit 2: a driver call straddling its start counts its inside
          api(190, 20, cat="cuda_driver"),
          # unit 3: none; an operator's own span is not a CUDA call
          {"cat": "cpu_op", "name": "aten::add", "ts": 410, "dur": 50,
           "tid": 1}]
    # units read 100 - 50, 100 - 10, 100: the median
    assert T.host_outside_api(ev) == pytest.approx(90e-6)
    assert T.host_outside_api([api(0, 5)]) is None


def test_rooflines():
    tr = T.parse(events(), 2, 200e-6)
    t = inputs(tr, img_per_s=100.0)
    conv = C.load_module("layer_metrics", "conv_roofline.train")
    # layer 1 FLOP-bound: 8e9/989e12 s a pass, 3 passes; layer 2
    # byte-bound: (8e6·4 + 1e2)·2 B / 3.35e12, 2 passes; 2 units
    least = 3 * 8e9 / 989e12 + 2 * (32e6 + 100) * 2 / 3.35e12
    assert conv.read(t) == pytest.approx(100 * least * 2 / 30e-6)
    fwd = C.load_module("layer_metrics", "conv_roofline.serve")
    least = 8e9 / 989e12 + (32e6 + 100) * 2 / 3.35e12
    assert fwd.read(t) == pytest.approx(100 * least * 4 * 2 / 30e-6)
    bn = C.load_module("layer_metrics", "bn_roofline.train")
    assert bn.read(t) == pytest.approx(100 * 4e6 * 4 * 10 / 3.35e12 * 2
                                       / 8e-6)
    assert C.load_module("layer_metrics", "aug_roofline.train").read(t) \
        is None
    mfu = C.load_module("layer_metrics", "train_mfu")
    assert mfu.read(t) == pytest.approx(100 * 6.003e9 * 100 / 989e12)
    smfu = C.load_module("layer_metrics", "serve_mfu")
    assert smfu.read(t) == pytest.approx(100 * 2.001e9 * 4 * 100 / 989e12)
    # one unit, 0-150 µs on the host, with three 2 µs CUDA calls
    assert C.load_module("layer_metrics", "host_dispatch_ms.train").read(
        t) == pytest.approx(0.144)


def test_shares_and_counts():
    tr = T.parse(events(), 2, 200e-6)
    t = inputs(tr)
    for name in ("device_idle_share.train", "device_idle_share.serve"):
        assert C.load_module("layer_metrics", name).read(t) == \
            pytest.approx(100 * (1 - 51 / 200))
    assert C.load_module("layer_metrics", "launches_per_step.train").read(
        t) == 1.5
    assert C.load_module("layer_metrics", "launches_per_call.serve").read(
        t) == 1.5
    empty = inputs(T.Trace(units=1, window_s=1.0))
    for name in ("device_idle_share.train", "launches_per_step.train",
                 "conv_roofline.train", "bn_roofline.train", "train_mfu"):
        assert C.load_module("layer_metrics", name).read(empty) is None


def test_p90():
    ms = [float(i) for i in range(1, 101)]
    assert C.p90(ms) == statistics.quantiles(ms, n=10)[8] == 90.9
    assert C.p90([3.0]) == 3.0
