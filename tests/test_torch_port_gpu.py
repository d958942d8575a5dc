"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an sm_90 card, ``nvcc`` and PyTorch built for CUDA, and
skip elsewhere (the decision is made inside the fixture, never at import).
They import nothing of JAX, so they also run on a machine without it:

    python -m pytest tests/test_torch_port_gpu.py -q -p no:cacheprovider --noconftest

``chip_smoke.py`` holds the kernels to their plain versions at the train
shapes; these cover the edges the train shapes do not reach: non-square
frames, a non-zero fill, mask ties, displacements beyond K, argument
checks and the launch counts.  Tolerances: images within 1e-3 (both sides
run the same f32 operations in the same order; the kernel is built with
``-fmad=false``), masks equal.
"""

import math

import numpy as np
import pytest
import torch

from segmentation_training_pipeline_tpu_torch import kernels as K
from segmentation_training_pipeline_tpu_torch.ops.aug import elastic as EL
from segmentation_training_pipeline_tpu_torch.ops.aug import fused_warp as FW
from segmentation_training_pipeline_tpu_torch.ops.aug import lowering as LW


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    K.build()
    return torch.device("cuda")


def _planes(b, c, h, w, seed):
    r = np.random.RandomState(seed)
    planes = (r.rand(b, c, h, w) * 255).astype(np.float32)
    planes[:, c // 2:] = (planes[:, c // 2:] > 127).astype(np.float32)
    kinds = np.array([0] * (c // 2) + [1] * (c - c // 2), np.int32)
    return torch.from_numpy(planes), torch.from_numpy(kinds)


def _scalars(b, h, seed):
    """(s1, e1, tx, e2, ty, s2) in the config-2 range, flips included."""
    r = np.random.RandomState(seed)
    t = math.tan(math.radians(15.0)) * 1.15 / 0.85
    e1 = r.uniform(0.8, 1.25, b) * np.where(r.rand(b) < 0.5, -1.0, 1.0)
    cols = [r.uniform(-t, t, b), e1,
            r.uniform(-0.1, 0.1, b) * h + np.where(e1 < 0, h - 1.0, 0.0),
            r.uniform(0.8, 1.25, b), r.uniform(-0.1, 0.1, b) * h,
            r.uniform(-t, t, b)]
    return torch.from_numpy(np.stack(cols, 1).astype(np.float32))


def _check(got, want, kinds):
    image = (kinds == 0).view(1, -1, 1, 1).expand_as(got)
    assert float((got - want)[image].abs().max()) <= 1e-3
    assert torch.equal(got[~image], want[~image])


@pytest.mark.parametrize("b,c,h,w,pad,fill", [
    (2, 4, 64, 64, 24, 0.0), (3, 4, 64, 96, 32, 7.0), (1, 2, 128, 128, 64, 0.0),
    (2, 4, 33, 47, 12, 0.0)])
def test_warp_kernels_match_plain(card, b, c, h, w, pad, fill):
    planes, kinds = _planes(b, c, h, w, h + w)
    scal = _scalars(b, h, b + c)
    want_x = FW.warp_x_plain(planes, kinds, scal, pad, fill)
    want_y = FW.warp_y_plain(want_x, kinds, scal, pad, fill)
    gp, gk, gs = planes.to(card), kinds.to(card), scal.to(card)
    got_x = FW.warp_x(gp, gk, gs, pad, fill)
    _check(got_x.cpu(), want_x, kinds)
    _check(FW.warp_y(got_x, gk, gs, pad, fill).cpu(), want_y, kinds)


@pytest.mark.parametrize("w,k,d", [(64, 19, 18.0), (128, 19, 18.0),
                                   (64, 6, 9.0), (96, 3, 0.5)])
def test_elastic_kernel_matches_plain(card, w, k, d):
    planes, flags = _planes(2, 4, 64, w, w + k)
    r = np.random.RandomState(k)
    dy = torch.from_numpy(r.uniform(-d, d, (2, 64, w)).astype(np.float32))
    dx = torch.from_numpy(r.uniform(-d, d, (2, 64, w)).astype(np.float32))
    want = EL.elastic_resample_plain(planes, flags, dy, dx, k, 3.0)
    got = EL.elastic_resample(planes.to(card), flags.to(card), dy.to(card),
                              dx.to(card), k, 3.0)
    _check(got.cpu(), want, flags)


def test_elastic_half_ties_round_up_on_card(card):
    planes, flags = _planes(2, 4, 64, 64, 1)
    r = np.random.RandomState(2)
    d = torch.from_numpy(r.randint(-4, 4, (2, 64, 64)).astype(np.float32)
                         + 0.5)
    z = torch.zeros_like(d)
    for dy, dx in ((d, z), (z, d)):
        want = EL.elastic_resample_plain(planes, flags, dy, dx, 6)
        got = EL.elastic_resample(planes.to(card), flags.to(card),
                                  dy.to(card), dx.to(card), 6)
        _check(got.cpu(), want, flags)


def test_config2_block_on_card_matches_cpu(card):
    """The whole block with the same draws: kernels on the card, plain
    versions on the CPU.  sin/cos/exp and the blur's sums round
    differently on the card, moving a coordinate by ~1e-5 px: images
    within 0.05, masks differing in at most 1e-3 of the pixels."""
    aug = LW.build_augmentation({
        "Fliplr": 0.5,
        "Affine": {"rotate": [-15, 15], "scale": [0.85, 1.15],
                   "translate_percent": {"x": [-0.1, 0.1], "y": [-0.1, 0.1]}},
        "ElasticTransformation": {"alpha": [0, 40], "sigma": 6},
        "Multiply": [0.9, 1.1]})
    r = np.random.RandomState(0)
    imgs = torch.from_numpy((r.rand(3, 128, 128, 3) * 255).astype(np.uint8))
    masks = torch.from_numpy((r.rand(3, 128, 128, 1) > 0.5).astype(
        np.float32))
    draws = aug.sample(torch.Generator().manual_seed(1), 3, 128, 128)

    def to(x):
        if isinstance(x, torch.Tensor):
            return x.to(card)
        if isinstance(x, dict):
            return {k: to(v) for k, v in x.items()}
        return [to(v) for v in x]

    ci, cm = aug.apply(draws, imgs, masks)
    K.reset_launches()
    gi, gm = aug.apply(to(draws), imgs.to(card), masks.to(card))
    assert K.launch_counts() == {"warp_x": 1, "warp_y": 1, "elastic": 1}
    assert float((gi.cpu() - ci).abs().max()) <= 0.05
    assert float((gm.cpu() != cm).float().mean()) <= 1e-3


def test_wrappers_check_arguments(card):
    planes, kinds = _planes(1, 2, 16, 16, 0)
    scal = _scalars(1, 16, 0).to(card)
    planes, kinds = planes.to(card), kinds.to(card)
    before = K.launch_counts()
    with pytest.raises(ValueError, match="float32"):
        FW.warp_x(planes.double(), kinds, scal, 4)
    with pytest.raises(ValueError, match="contiguous"):
        FW.warp_y(planes.transpose(2, 3), kinds, scal, 4)
    with pytest.raises(ValueError, match="int32"):
        FW.warp_x(planes, kinds.long(), scal, 4)
    with pytest.raises(ValueError, match="scalars"):
        FW.warp_x(planes, kinds, scal[:, :5].contiguous(), 4)
    d = torch.zeros(1, 16, 15, device=card)
    with pytest.raises(ValueError, match="displacements"):
        EL.elastic_resample(planes, kinds, d, d, 2)
    with pytest.raises(ValueError, match="tensors on"):
        FW.warp_x(planes, kinds.cpu(), scal, 4)
    assert K.launch_counts() == before
    FW.warp_x(planes, kinds, scal, 4)
    torch.cuda.synchronize()
    assert K.launch_counts()["warp_x"] == before["warp_x"] + 1
