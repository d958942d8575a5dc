"""The CUDA kernels' plain PyTorch versions against the reference Pallas
kernels run in interpret mode (the same inputs on both sides).

Kernels X+Y (fused affine warp) against ``pallas_warp.warp_joint_fused``,
the elastic resample against ``pallas_elastic.warp_elastic_joint`` in both
of its branches (lane rolls at width 64, the windowed gather at width
128).  Tolerances: images within 1e-2 on the 0..255 scale for the warp
(the reference's x/y-scale dots run as three bf16 MXU passes, ``_dot3``,
leaving about 2^-16 relative error), 1e-3 for the elastic resample (f32
blend order only); masks exactly equal.  On the CPU the wrappers run the
plain versions and no kernel launches.
"""

import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from segmentation_training_pipeline_tpu.ops.aug import pallas_elastic as JPE
from segmentation_training_pipeline_tpu.ops.aug import pallas_warp as JPW
from segmentation_training_pipeline_tpu_torch import kernels as K
from segmentation_training_pipeline_tpu_torch.ops.aug import elastic as TE
from segmentation_training_pipeline_tpu_torch.ops.aug import fast_warp as TFW
from segmentation_training_pipeline_tpu_torch.ops.aug import fused_warp as TW
from segmentation_training_pipeline_tpu_torch.ops.aug import shear as TS

from torch_port_util import few_torch_threads  # noqa: F401


def _batch(b, h, w, seed):
    r = np.random.RandomState(seed)
    img = (r.rand(b, h, w, 3) * 255).astype(np.float32)
    msk = (r.rand(b, h, w, 2) > 0.5).astype(np.float32)
    return img, msk


def _factors(b, h, seed):
    """Decomposition factors in the config-2 range (rotate ±15°, scale
    0.85..1.15, translate ±10%) plus flips (negative e1)."""
    r = np.random.RandomState(seed)
    t = math.tan(math.radians(15.0)) * 1.15 / 0.85
    s1 = r.uniform(-t, t, b)
    e1 = r.uniform(0.8, 1.25, b) * np.where(r.rand(b) < 0.5, -1.0, 1.0)
    e2 = r.uniform(0.8, 1.25, b)
    tx = r.uniform(-0.1, 0.1, b) * h + np.where(e1 < 0, h - 1.0, 0.0)
    ty = r.uniform(-0.1, 0.1, b) * h
    s2 = r.uniform(-t, t, b)
    return [np.asarray(v, np.float32) for v in (s1, e1, e2, tx, ty, s2)]


@pytest.mark.parametrize("h,seed", [(64, 0), (64, 1), (128, 2)])
def test_warp_xy_plain_matches_pallas(h, seed):
    img, msk = _batch(3, h, h, seed)
    f = _factors(3, h, seed + 10)
    px, py = TFW.canvas_pads(h, h, 0.33)   # q=4 pads at 64², 128²
    ji, jm = JPW.warp_joint_fused(jnp.asarray(img), jnp.asarray(msk),
                                  *map(jnp.asarray, f), px, py, 0.0,
                                  interpret=True)
    ti, tm = TW.warp_joint_fused(torch.from_numpy(img), torch.from_numpy(msk),
                                 *map(torch.from_numpy, f), px, py, 0.0)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-2, rtol=0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_warp_xy_nonzero_fill_matches_pallas():
    img, msk = _batch(2, 64, 64, 5)
    f = _factors(2, 64, 6)
    ji, jm = JPW.warp_joint_fused(jnp.asarray(img), jnp.asarray(msk),
                                  *map(jnp.asarray, f), 24, 24, 7.0,
                                  interpret=True)
    ti, tm = TW.warp_joint_fused(torch.from_numpy(img), torch.from_numpy(msk),
                                 *map(torch.from_numpy, f), 24, 24, 7.0)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-2, rtol=0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("w,k,d", [(64, 19, 18.0), (128, 19, 18.0),
                                   (64, 6, 9.0)])
def test_elastic_plain_matches_pallas(w, k, d):
    """Width 64 runs the reference's roll sweep, width 128 its windowed
    gather (K ≤ 30); d > K exercises offsets outside [-K, K] (roll sweep:
    no candidate → 0)."""
    img, msk = _batch(2, 64, w, 3)
    r = np.random.RandomState(4)
    dy = r.uniform(-d, d, (2, 64, w)).astype(np.float32)
    dx = r.uniform(-d, d, (2, 64, w)).astype(np.float32)
    ji, jm = JPE.warp_elastic_joint(jnp.asarray(img), jnp.asarray(msk),
                                    jnp.asarray(dy), jnp.asarray(dx), k,
                                    interpret=True)
    ti, tm = TE.warp_elastic_joint(torch.from_numpy(img),
                                   torch.from_numpy(msk),
                                   torch.from_numpy(dy), torch.from_numpy(dx),
                                   k)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-3, rtol=0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("axis", ["y", "x"])
def test_elastic_half_tie_rounds_up(axis):
    """Displacements with an exact .5 fraction: nearest rounds the tie UP
    (floor(f + 0.5)), as the reference (test_pallas_elastic.py::
    test_half_tie_rounds_like_oracle); half-to-even would differ on even
    floors."""
    img, msk = _batch(2, 64, 64, 7)
    r = np.random.RandomState(2)
    d = r.randint(-4, 4, (2, 64, 64)).astype(np.float32) + 0.5
    z = np.zeros_like(d)
    dy, dx = (d, z) if axis == "y" else (z, d)
    ji, jm = JPE.warp_elastic_joint(jnp.asarray(img), jnp.asarray(msk),
                                    jnp.asarray(dy), jnp.asarray(dx), 6,
                                    interpret=True)
    ti, tm = TE.warp_elastic_joint(torch.from_numpy(img),
                                   torch.from_numpy(msk),
                                   torch.from_numpy(dy), torch.from_numpy(dx),
                                   6)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-3, rtol=0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    # the tie really went up: the mask equals the source shifted by ceil(d)
    src = msk[..., 0]
    yy, xx = np.mgrid[0:64, 0:64]
    ok = ((np.abs(yy + dy - 31.5) <= 32.0)
          & (np.abs(xx + dx - 31.5) <= 32.0))
    sy = yy + np.ceil(dy).astype(int)
    sx = xx + np.ceil(dx).astype(int)
    b = np.arange(2)[:, None, None]
    want = np.where(ok, src[b, sy.clip(0, 63), sx.clip(0, 63)], 0.0)
    np.testing.assert_array_equal(tm.numpy()[..., 0], want)


def test_cpu_wrappers_launch_nothing():
    K.reset_launches()
    img, msk = _batch(1, 32, 32, 0)
    f = _factors(1, 32, 0)
    planes, kinds = TW.joint_planes(torch.from_numpy(img),
                                    torch.from_numpy(msk))
    scal = torch.from_numpy(np.stack(
        [f[0], f[1], f[3], f[2], f[4], f[5]], 1))
    TW.warp_y(TW.warp_x(planes, kinds, scal, 8), kinds, scal, 8)
    d = torch.zeros(1, 32, 32)
    TE.elastic_resample(planes, kinds, d, d, 4)
    TW.warp_ye(planes, kinds, scal, d, d, 8, 4)
    TS.shear_pass(planes, torch.zeros(1, 32), kinds, 32, 0, 0.0)
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


@pytest.mark.parametrize("fn", ["warp_x", "warp_y", "elastic", "shear",
                                "warp_ye"])
def test_non_cpu_tensor_launches_or_raises(fn):
    """A tensor that is not on the CPU never takes the plain version: it
    goes to the CUDA launch path, which refuses a non-CUDA device."""
    planes = torch.empty(1, 2, 8, 8, device="meta")
    kinds = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        if fn == "elastic":
            d = torch.empty(1, 8, 8, device="meta")
            TE.elastic_resample(planes, kinds, d, d, 2)
        elif fn == "shear":
            TS.shear_pass(planes, torch.empty(1, 8, device="meta"), kinds,
                          8, 0, 0.0)
        elif fn == "warp_ye":
            d = torch.empty(1, 8, 8, device="meta")
            TW.warp_ye(planes, kinds, torch.empty(1, 6, device="meta"), d, d,
                       4, 2)
        else:
            scal = torch.empty(1, 6, device="meta")
            getattr(TW, fn)(planes, kinds, scal, 4)
    assert K.KERNELS[fn].launches == 0


@pytest.mark.parametrize("fn,shape,pad,match", [
    ("warp_x", (1, 1, 2, 29056), 0, "CUDA"),       # the widest row at pad 0
    ("warp_x", (1, 1, 2, 29057), 0, "shared memory"),
    ("warp_x", (1, 1, 2, 2048), 27009, "shared memory"),
    ("warp_x", (1, 65536, 2, 8), 4, "grid axis"),
    ("warp_ye", (1, 1, 2, 19370), 4, "CUDA"),      # the widest row
    ("warp_ye", (1, 1, 2, 19371), 4, "shared memory"),
    ("warp_ye", (65536, 1, 2, 8), 4, "grid axis"),
    ("warp_y", (1, 1, 2, 29057), 4, "CUDA"),       # no shared memory
    ("warp_y", (1, 65536, 2, 8), 4, "grid axis"),
    ("warp_y", (1, 1, 65536, 8), 4, "grid axis"),
    ("elastic", (1, 1, 2, 19370), 3, "CUDA"),      # the widest row
    ("elastic", (1, 1, 2, 19371), 3, "shared memory"),
    ("elastic", (65536, 1, 2, 8), 3, "grid axis"),
    ("elastic", (1, 1, 65536, 8), 3, "grid axis"),
    ("shear", (1, 65535, 65535, 8), 0, "CUDA"),    # the largest grid
    ("shear", (1, 65536, 2, 8), 0, "grid axis"),
    ("shear", (1, 1, 65536, 8), 0, "grid axis")])
def test_rows_wider_than_a_block_are_refused(fn, shape, pad, match):
    """Kernels X, YE and elastic keep rows in one block's shared memory
    (227 KB on the H100), and every kernel runs on a 3-D grid; the wrapper
    names either limit before it reaches the device.  A row that fits goes
    on to the CUDA checks.  ``pad`` is the elastic kernel's K and the
    shear's ``src_shift``; the shear's lines are (B, C, L, N)."""
    b, c, h, w = shape
    planes = torch.empty(shape, device="meta")
    kinds = torch.zeros(c, dtype=torch.int32, device="meta")
    scal = torch.empty(b, 6, device="meta")
    d = torch.empty(b, h, w, device="meta")
    with pytest.raises(ValueError, match=match):
        if fn == "warp_ye":
            TW.warp_ye(planes, kinds, scal, d, d, pad, 3)
        elif fn == "elastic":
            TE.elastic_resample(planes, kinds, d, d, pad)
        elif fn == "shear":
            TS.shear_pass(planes, torch.empty(b, h, device="meta"), kinds, w,
                          pad, 0.0)
        else:
            getattr(TW, fn)(planes, kinds, scal, pad)
    assert K.KERNELS[fn].launches == 0


@pytest.mark.parametrize("n,norig,shift,lo,hi", [
    (20, 12, 4, -3.0, 3.0),        # the x-pass: a third of a line is fill
    (16, 16, 0, -4.0, 4.0),        # the y-pass: the frame is the line
    (16, 16, 0, -9.5, 9.5),        # .5 ties, lines shifted half out
    (13, 7, 3, -30.0, 30.0)])      # lines shifted out of the frame whole
def test_shear_bound_counts_the_columns_outputs_use(n, norig, shift, lo, hi):
    """``chip_smoke.shear_bytes`` counts, of each line, only the source
    columns that change an output: the same count as poisoning each column
    with NaN in turn and seeing which lines' outputs take it up."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    r = np.random.RandomState(n)
    b, c, l = 2, 3, 5
    x = torch.from_numpy(r.rand(b, c, l, n).astype(np.float32))
    offs = torch.from_numpy(r.uniform(lo, hi, (b, l)).astype(np.float32))
    offs[0, :2] = torch.tensor([lo + 0.5, 0.5])    # fraction exactly .5
    kinds = torch.tensor([0, 1, 0], dtype=torch.int32)
    used = 0
    for j in range(n):
        poisoned = x.clone()
        poisoned[..., j] = float("nan")
        out = TS.shear_pass_plain(poisoned, offs, kinds, norig, shift, 0.0)
        used += int(out.isnan().any(-1).sum())
    fixed = offs.numel() * 4 + kinds.numel() * 4 + x.numel() * 4
    assert cs.shear_bytes(x, offs, kinds, norig, shift, 0.0) == (
        used * 4 + fixed)


def test_build_needs_nvcc(monkeypatch):
    monkeypatch.setattr(K.shutil, "which", lambda name: None)
    monkeypatch.setattr(K.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.find_nvcc()


def test_kernel_sources_are_hopper_cuda():
    for k in K.KERNELS.values():
        src = (K.CSRC_DIR / k.source).read_text()
        assert f'extern "C" int {k.symbol}(' in src
        # round-half-to-even conversions would break the tie rule
        assert not re.search(r"\b(rintf|nearbyintf|__float2int_rn)\s*\(",
                             src)
        if k.name.startswith("bn_"):
            # flax's BatchNorm has no TPU kernel: XLA lowered it
            assert k.source == "batchnorm.cu"
            assert k.replaces == "none: flax nn.BatchNorm, XLA-lowered"
            assert f"{k.name}_kernel" in src
            continue
        if k.name == "shear":
            # masks take the upper tap at a fraction of 0.5 or more
            assert "frac >= 0.5f ? vn : vo" in src
            assert "((int)kfloor % n + n) % n" in src   # floor modulo
        else:
            assert ("floorf(f + 0.5f)" in src or "floorf(fy + 0.5f)" in src)
        assert k.replaces.startswith(
            "segmentation_training_pipeline_tpu/ops/aug/pallas_")
    assert {k.replaces.split("/")[-1] for k in K.KERNELS.values()
            if not k.name.startswith("bn_")} == {
        "pallas_warp.py:279", "pallas_warp.py:296", "pallas_elastic.py:155",
        "pallas_shear.py:98", "pallas_warp.py:312"}
    assert "arch=compute_90a,code=sm_90a" in K.NVCC_FLAGS
    assert "-fmad=false" in K.NVCC_FLAGS
