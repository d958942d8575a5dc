"""The shear kernel, kernel YE and the two warp paths that reach them,
against the JAX package on the same inputs.

  * the shear kernel's plain version against ``shear_pass_tpu`` in
    interpret mode, at the cases of tests/test_pallas_shear.py: images
    within 1e-6 (the same f32 operations in the same order), masks exact;
  * kernel YE's plain version (after kernel X) against ``warp_fused_tpu``
    with dy/dx in interpret mode: images within 1e-2 on the 0..255 scale
    (the reference's x/y-scale dots run as three bf16 MXU passes,
    ``_dot3``, about 2^-16 relative), masks exact;
  * kernel YE against kernel Y then the elastic kernel, both plain: equal
    bit for bit (the only extra canvas row YE reads carries weight 0);
  * the unfused multipass warp against the JAX one, whose CPU shear is the
    XLA roll+select oracle and whose scale pass is the same f32 einsums:
    images within 1e-3 (f32 summation order of the einsums), masks exact;
  * the config-2 block through both lowerings on the same draws, under
    ``STP_FUSE_ELASTIC=1`` and under ``STP_PALLAS_WARP=0``: images within
    1e-2 (the elastic field agrees to 1e-5 and the ``_dot3`` residual),
    masks exact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from segmentation_training_pipeline_tpu.ops.aug import fast_warp as JFW
from segmentation_training_pipeline_tpu.ops.aug import lowering as JL
from segmentation_training_pipeline_tpu.ops.aug import pallas_shear as JPS
from segmentation_training_pipeline_tpu.ops.aug import pallas_warp as JPW
from segmentation_training_pipeline_tpu.ops.aug import warp as JW
from segmentation_training_pipeline_tpu_torch import kernels as K
from segmentation_training_pipeline_tpu_torch.ops.aug import elastic as TE
from segmentation_training_pipeline_tpu_torch.ops.aug import fast_warp as TFW
from segmentation_training_pipeline_tpu_torch.ops.aug import fused_warp as TW
from segmentation_training_pipeline_tpu_torch.ops.aug import lowering as TL
from segmentation_training_pipeline_tpu_torch.ops.aug import shear as TS

from torch_port_util import (CONFIG2_BLOCK, blob_batch, few_torch_threads,
                             interpret_kernels, jax_draws)

NO_LAUNCHES = {n: 0 for n in K.KERNELS}


def _lines(b, c, k, l, n, seed):
    r = np.random.RandomState(seed)
    img = r.rand(b, c, l, n).astype(np.float32)
    msk = (r.rand(b, k, l, n) > 0.5).astype(np.float32)
    kinds = np.array([0] * c + [1] * k, np.int32)
    return np.concatenate([img, msk], 1), kinds


def _shear_both(x, offs, kinds, norig, shift, fill=0.0):
    want = JPS.shear_pass_tpu(jnp.asarray(x), jnp.asarray(offs),
                              jnp.asarray(kinds), norig=norig,
                              src_shift=shift, fill=fill, interpret=True)
    got = TS.shear_pass(torch.from_numpy(x), torch.from_numpy(offs),
                        torch.from_numpy(kinds), norig, shift, fill)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("offs_range,shift,norig", [
    ((-20, 20), 5, 50),
    ((-5, 5), 0, 64),
    ((-60, 60), 16, 32),   # mostly out of bounds: the fill
    ((0, 0), 0, 64),       # identity
])
def test_shear_plain_matches_pallas(offs_range, shift, norig):
    x, kinds = _lines(2, 3, 2, 16, 64, 0)
    offs = np.random.RandomState(1).uniform(*offs_range, (2, 16)).astype(
        np.float32)
    K.reset_launches()
    want, got = _shear_both(x, offs, kinds, norig, shift)
    assert np.abs(got[:, :3] - want[:, :3]).max() < 1e-6
    np.testing.assert_array_equal(got[:, 3:], want[:, 3:])
    assert K.launch_counts() == NO_LAUNCHES


def test_shear_integer_offsets_and_half_ties():
    """Integer offsets move lines exactly (negative ones too: the floor
    modulo); a fraction of exactly .5 sends the mask to the upper tap."""
    x, kinds = _lines(1, 1, 1, 8, 32, 2)
    r = np.random.RandomState(3)
    offs = r.randint(-8, 8, (1, 8)).astype(np.float32)
    want, got = _shear_both(x, offs, kinds, 32, 0, fill=3.0)
    np.testing.assert_array_equal(got, want)
    for line in range(8):
        o = int(offs[0, line])
        q = np.arange(32)
        ok = (q + o >= 0) & (q + o < 32)
        np.testing.assert_array_equal(
            got[0, :, line][:, ok], x[0, :, line][:, (q + o)[ok]])
        assert (got[0, :, line][:, ~ok] == 3.0).all()
    half = offs + 0.5
    want, got = _shear_both(x, half, kinds, 32, 0)
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
    q = np.arange(31)
    for line in range(8):
        o = int(np.ceil(half[0, line]))
        ok = (q + o >= 0) & (q + o < 32) & (q + half[0, line] <= 31.5)
        np.testing.assert_array_equal(got[0, 1, line, :31][ok],
                                      x[0, 1, line, (q + o)[ok]])


@pytest.mark.parametrize("axis", [1, 2])
def test_shear_pass_matches_xla_oracle(axis):
    """The port's ``_shear_pass`` (join, transpose, kernel, crop) against
    the JAX one on its XLA roll+select path, both axes."""
    r = np.random.RandomState(axis)
    img = (r.rand(2, 40, 48, 3) * 255).astype(np.float32)
    msk = (r.rand(2, 40, 48, 1) > 0.5).astype(np.float32)
    lines = 40 if axis == 2 else 48
    offs = r.uniform(-9, 9, (2, lines)).astype(np.float32)
    kw = (dict(src_shift=4, orig_n=40) if axis == 2
          else dict(out_slice=(4, 32)))
    ji, jm = JFW._shear_pass(jnp.asarray(img), jnp.asarray(msk),
                             jnp.asarray(offs), axis=axis, fill=0.0, **kw)
    ti, tm = TFW._shear_pass(torch.from_numpy(img), torch.from_numpy(msk),
                             torch.from_numpy(offs), axis=axis, fill=0.0,
                             **kw)
    assert ti.shape == ji.shape
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def _planes(b, h, w, seed):
    r = np.random.RandomState(seed)
    img = (r.rand(b, h, w, 3) * 255).astype(np.float32)
    msk = (r.rand(b, h, w, 2) > 0.5).astype(np.float32)
    return TW.joint_planes(torch.from_numpy(img), torch.from_numpy(msk))


def _scalars(b, h, seed):
    r = np.random.RandomState(seed)
    t = np.tan(np.radians(15.0)) * 1.15 / 0.85
    e1 = r.uniform(0.8, 1.25, b) * np.where(r.rand(b) < 0.5, -1.0, 1.0)
    cols = [r.uniform(-t, t, b), e1,
            r.uniform(-0.1, 0.1, b) * h + np.where(e1 < 0, h - 1.0, 0.0),
            r.uniform(0.8, 1.25, b), r.uniform(-0.1, 0.1, b) * h,
            r.uniform(-t, t, b)]
    return torch.from_numpy(np.stack(cols, 1).astype(np.float32))


def _disp(b, h, w, bound, seed):
    r = np.random.RandomState(seed)
    return [torch.from_numpy(((r.rand(b, h, w) * 2 - 1) * bound).astype(
        np.float32)) for _ in range(2)]


@pytest.mark.parametrize("kb,py", [(6, 12), (12, 16)])
def test_warp_ye_plain_matches_pallas(kb, py):
    planes, kinds = _planes(3, 64, 64, kb)
    scal = _scalars(3, 64, kb + 1)
    dy, dx = _disp(3, 64, 64, kb + 2.0, kb)   # some offsets beyond K
    want = JPW.warp_fused_tpu(jnp.asarray(planes.numpy()),
                              jnp.asarray(kinds.numpy()),
                              jnp.asarray(scal.numpy()), 12, py, 0.0,
                              dy=jnp.asarray(dy.numpy()),
                              dx=jnp.asarray(dx.numpy()), k=kb,
                              interpret=True)
    got = TW.warp_ye(TW.warp_x(planes, kinds, scal, 12), kinds, scal, dy, dx,
                     py, kb)
    want = np.asarray(want)
    np.testing.assert_allclose(got[:, :3].numpy(), want[:, :3], atol=1e-2,
                               rtol=0)
    np.testing.assert_array_equal(got[:, 3:].numpy(), want[:, 3:])


@pytest.mark.parametrize("fill", [0.0, 5.0])
def test_warp_ye_is_y_then_elastic(fill):
    planes, kinds = _planes(2, 48, 40, 7)
    scal = _scalars(2, 48, 8)
    dy, dx = _disp(2, 48, 40, 9.0, 9)
    mid = TW.warp_x_plain(planes, kinds, scal, 12, fill)
    want = TE.elastic_resample_plain(TW.warp_y_plain(mid, kinds, scal, 12,
                                                     fill), kinds, dy, dx, 8,
                                     fill)
    got = TW.warp_ye_plain(mid, kinds, scal, dy, dx, 12, 8, fill)
    assert torch.equal(got, want)


def test_warp_ye_needs_the_band():
    planes, kinds = _planes(1, 16, 16, 0)
    scal = _scalars(1, 16, 0)
    d = torch.zeros(1, 16, 16)
    with pytest.raises(ValueError, match="K\\+1"):
        TW.warp_ye(planes, kinds, scal, d, d, 8, 8)
    meta = planes.to("meta")
    with pytest.raises(ValueError, match="K\\+1"):
        TW.warp_ye(meta, kinds.to("meta"), scal.to("meta"), d.to("meta"),
                   d.to("meta"), 4, 4)


def _mats(b, h, seed, rot=25.0, shear=10.0, trans=8.0):
    r = np.random.RandomState(seed)
    c = (h - 1) / 2.0
    ang = jnp.asarray(r.uniform(-rot, rot, b) * np.pi / 180.0, jnp.float32)
    sx = jnp.asarray(r.uniform(0.8, 1.25, b), jnp.float32)
    sy = jnp.asarray(r.uniform(0.8, 1.25, b), jnp.float32)
    sh = jnp.asarray(r.uniform(-shear, shear, b) * np.pi / 180.0,
                     jnp.float32)
    m = JW.compose(JW.rotation_about(c, c, ang), JW.scale_about(c, c, sx, sy))
    m = JW.compose(JW.shear_about(c, c, sh, jnp.zeros_like(sh)), m)
    m = JW.compose(JW.translation(
        jnp.asarray(r.uniform(-trans, trans, b), jnp.float32),
        jnp.asarray(r.uniform(-trans, trans, b), jnp.float32)), m)
    return m


@pytest.mark.parametrize("seed,fill,pad_frac", [(1, 0.0, 0.5),
                                                (2, 127.0, 0.5),
                                                (3, 0.0, 0.2)])
def test_unfused_warp_matches_jax(seed, fill, pad_frac):
    imgs, masks = blob_batch(3, 64, 64, seed)
    imgs = imgs.astype(np.float32)
    mats = _mats(3, 64, seed + 10)
    ji, jm = JFW.warp_joint_multipass(jnp.asarray(imgs), jnp.asarray(masks),
                                      mats, fill=fill, pad_frac=pad_frac,
                                      fused=False)
    K.reset_launches()
    ti, tm = TFW.warp_joint_multipass(torch.from_numpy(imgs),
                                      torch.from_numpy(masks),
                                      torch.from_numpy(np.array(mats)),
                                      fill=fill, pad_frac=pad_frac,
                                      fused=False)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-3, rtol=0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert K.launch_counts() == NO_LAUNCHES


def test_unfused_disp_takes_the_elastic_kernel():
    """fused=False with a displacement: the affine passes, then the
    separate elastic resample (the JAX fallback, fast_warp.py:376-383)."""
    imgs, masks = blob_batch(2, 64, 64, 35)
    imgs = imgs.astype(np.float32)
    mats = _mats(2, 64, 36, rot=10.0)
    dx, dy = _disp(2, 64, 64, 5.0, 4)
    ji, jm = JFW.warp_joint_multipass(
        jnp.asarray(imgs), jnp.asarray(masks), mats, fused=False,
        interpret=True, disp=(jnp.asarray(dx.numpy()),
                              jnp.asarray(dy.numpy())), disp_k=6)
    ti, tm = TFW.warp_joint_multipass(
        torch.from_numpy(imgs), torch.from_numpy(masks),
        torch.from_numpy(np.array(mats)), fused=False, disp=(dx, dy),
        disp_k=6)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-3, rtol=0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_switch_reads_stp_pallas_warp(monkeypatch):
    """Unset or 1: fused; 0/false: unfused.  On a tensor that is not on
    the CPU the unfused path reaches the shear kernel's launch, which
    refuses a non-CUDA device: no plain version is taken."""
    monkeypatch.delenv("STP_PALLAS_WARP", raising=False)
    assert TFW._env_fused()
    monkeypatch.setenv("STP_PALLAS_WARP", "False")
    assert not TFW._env_fused()
    imgs = torch.empty(1, 16, 16, 3, device="meta")
    masks = torch.empty(1, 16, 16, 1, device="meta")
    mats = torch.eye(3, device="meta")[None]
    with pytest.raises(ValueError, match="CUDA"):
        TFW.warp_joint_multipass(imgs, masks, mats)
    assert K.KERNELS["shear"].launches == 0
    monkeypatch.setenv("STP_PALLAS_WARP", "1")
    with pytest.raises(ValueError, match="CUDA"):
        TFW.warp_joint_multipass(imgs, masks, mats)
    assert K.KERNELS["warp_x"].launches == 0


def _block_both(monkeypatch, b, h, seed, env):
    interpret_kernels(monkeypatch)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    imgs, masks = blob_batch(b, h, h, seed)
    key = jax.random.PRNGKey(seed)
    ji, jm = JL.build_augmentation(JL._coerce_block(CONFIG2_BLOCK))(
        key, jnp.asarray(imgs), jnp.asarray(masks))
    aug = TL.build_augmentation(CONFIG2_BLOCK)
    ti, tm = aug.apply(jax_draws(aug, key, b, h, h), torch.from_numpy(imgs),
                       torch.from_numpy(masks))
    return np.asarray(ji), np.asarray(jm), ti.numpy(), tm.numpy()


@pytest.mark.parametrize("env", [{"STP_FUSE_ELASTIC": "1"},
                                 {"STP_PALLAS_WARP": "0"},
                                 {"STP_PALLAS_WARP": "0",
                                  "STP_FUSE_ELASTIC": "1"}],
                         ids=["fuse-elastic", "unfused", "unfused-fuse"])
@pytest.mark.parametrize("h,seed", [(64, 0), (128, 1)])
def test_config2_block_paths_match_jax(env, h, seed, monkeypatch):
    ji, jm, ti, tm = _block_both(monkeypatch, 3, h, seed, env)
    np.testing.assert_allclose(ti, ji, atol=1e-2, rtol=0)
    np.testing.assert_array_equal(tm, jm)
    assert ti.min() >= 0.0 and ti.max() <= 255.0


def test_fuse_elastic_routes_through_kernel_ye(monkeypatch):
    """With STP_FUSE_ELASTIC set the lowering hands the field to the
    multipass warp (kernel YE); unset, the elastic kernel runs after."""
    calls = []
    ye = TW.warp_ye
    el = TE.elastic_resample
    monkeypatch.setattr(TW, "warp_ye",
                        lambda *a: calls.append("ye") or ye(*a))
    monkeypatch.setattr(TE, "elastic_resample",
                        lambda *a: calls.append("elastic") or el(*a))
    aug = TL.build_augmentation(CONFIG2_BLOCK)
    imgs, masks = blob_batch(2, 32, 32)
    args = (torch.Generator().manual_seed(0), torch.from_numpy(imgs),
            torch.from_numpy(masks))
    monkeypatch.delenv("STP_FUSE_ELASTIC", raising=False)
    aug(*args)
    monkeypatch.setenv("STP_FUSE_ELASTIC", "1")
    aug(*args)
    monkeypatch.setenv("STP_FUSE_ELASTIC", "false")
    aug(*args)
    assert calls == ["elastic", "ye", "elastic"]


def test_exact_f32_pins_and_restores_precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        with TFW._exact_f32(torch.device("cpu")):
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.is_autocast_enabled("cpu")
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(before)
