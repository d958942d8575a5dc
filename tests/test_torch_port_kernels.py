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

import math
import re

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
    assert K.launch_counts() == {"warp_x": 0, "warp_y": 0, "elastic": 0}


@pytest.mark.parametrize("fn", ["warp_x", "warp_y", "elastic"])
def test_non_cpu_tensor_launches_or_raises(fn):
    """A tensor that is not on the CPU never takes the plain version: it
    goes to the CUDA launch path, which refuses a non-CUDA device."""
    planes = torch.empty(1, 2, 8, 8, device="meta")
    kinds = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        if fn == "elastic":
            d = torch.empty(1, 8, 8, device="meta")
            TE.elastic_resample(planes, kinds, d, d, 2)
        else:
            scal = torch.empty(1, 6, device="meta")
            getattr(TW, fn)(planes, kinds, scal, 4)
    assert K.KERNELS[fn].launches == 0


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
        assert "floorf(f + 0.5f)" in src or "floorf(fy + 0.5f)" in src
    assert "arch=compute_90a,code=sm_90a" in K.NVCC_FLAGS
    assert "-fmad=false" in K.NVCC_FLAGS
