"""The CUDA kernels against their plain PyTorch versions, on the card, and
the scale-free BatchNorm's backward there.

These tests need an sm_90 card, ``nvcc`` and PyTorch built for CUDA, and
skip elsewhere (the decision is made inside the fixture, never at import).
They import nothing of JAX, so they also run on a machine without it:

    python -m pytest tests/test_torch_port_gpu.py -q -p no:cacheprovider --noconftest

``chip_smoke.py`` holds the kernels to their plain versions at the train
shapes; these cover the edges the train shapes do not reach: non-square
frames, a non-zero fill, mask ties, displacements beyond K, argument
checks, the shear kernel's negative offsets (the sign of the modulo) and
mostly out-of-bounds lines, kernel YE's band check, the three warp paths
and the launch counts.  Every kernel tiles rows or lines and columns, so
the cases also take widths that are no multiple of 4, 32 or 128, heights
and line counts that are no multiple of a tile, one and five channels,
one image, ``py = K + 1``, elastic offsets of ±K at the frame's edges
(the mod-W wrap), mask ties in dy and in the shear's offsets, misaligned
rows and lines, 2048- to 40000-wide frames and lines and the widest row
or largest grid each wrapper accepts.  Tolerances: all five kernels
equal their plain versions throughout (their redesigns moved no f32
operation; both sides run the same f32 operations in the same order and
the kernels are built with ``-fmad=false``); the whole block on the card
against the CPU as stated there.
"""

import math

import numpy as np
import pytest
import torch

from segmentation_training_pipeline_tpu_torch import kernels as K
from segmentation_training_pipeline_tpu_torch.ops.aug import elastic as EL
from segmentation_training_pipeline_tpu_torch.ops.aug import fused_warp as FW
from segmentation_training_pipeline_tpu_torch.ops.aug import lowering as LW
from segmentation_training_pipeline_tpu_torch.ops.aug import shear as SH


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


def _check(got, want):
    """Equal throughout, image and mask channels alike."""
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,c,h,w,pad,fill", [
    (2, 4, 64, 64, 24, 0.0), (3, 4, 64, 96, 32, 7.0), (1, 2, 128, 128, 64, 0.0),
    (2, 4, 33, 47, 12, 0.0), (1, 4, 37, 100, 20, 5.0), (2, 1, 24, 64, 16, 0.0),
    (2, 5, 32, 64, 16, 0.0), (1, 2, 16, 2048, 64, 0.0),
    (1, 2, 3, 29056, 0, 0.0),    # kernel X's widest row at pad 0
    (2, 3, 50, 130, 8, 2.0),     # 16-row tiles and 128-column blocks, ragged
    (1, 65535, 1, 4, 2, 0.0),    # the most planes a grid axis takes
    (1, 2, 65535, 5, 3, 0.0)])   # the tallest frame
def test_warp_kernels_match_plain(card, b, c, h, w, pad, fill):
    planes, kinds = _planes(b, c, h, w, h + w)
    scal = _scalars(b, h, b + c)
    want_x = FW.warp_x_plain(planes, kinds, scal, pad, fill)
    want_y = FW.warp_y_plain(want_x, kinds, scal, pad, fill)
    gp, gk, gs = planes.to(card), kinds.to(card), scal.to(card)
    got_x = FW.warp_x(gp, gk, gs, pad, fill)
    _check(got_x.cpu(), want_x)
    _check(FW.warp_y(got_x, gk, gs, pad, fill).cpu(), want_y)


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
    _check(got.cpu(), want)


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
        _check(got.cpu(), want)


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
    assert K.launch_counts() == {"warp_x": 1, "warp_y": 1, "elastic": 1,
                                 "shear": 0, "warp_ye": 0}
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


@pytest.mark.parametrize("b,c,l,n,lo,hi,shift,norig", [
    (2, 4, 48, 64, -20.0, 20.0, 5, 50),
    (2, 4, 48, 96, -9.7, -0.1, 0, 96),          # negative offsets
    (2, 4, 48, 64, -300.0, 300.0, 16, 32),      # mostly off-frame
    (2, 4, 48, 768, -40.0, 40.0, 128, 512),     # the x-pass's canvas
    (2, 4, 37, 47, -30.0, 30.0, 6, 40),         # N % 4 != 0, ragged tile
    (1, 5, 50, 763, -100.0, 100.0, 128, 512),   # misaligned line starts
    (3, 1, 9, 130, -64.0, 64.0, 0, 130),
    (2, 2, 6, 4097, -500.0, 500.0, 1024, 2048),  # a wide, ragged line
    (1, 2, 3, 40000, -900.0, 900.0, 0, 40000),  # many chunks a line
    (1, 65535, 1, 8, -4.0, 4.0, 0, 8),          # the most planes an axis takes
    (1, 2, 65535, 4, -2.0, 2.0, 1, 3)])         # the most lines it takes
def test_shear_kernel_matches_plain(card, b, c, l, n, lo, hi, shift, norig):
    """Offsets of ±(N / 2) and more wrap lines around; the head of the
    first image's offsets takes integer and .5 values, and every third
    line of the last image a .5 fraction (mask ties)."""
    planes, kinds = _planes(b, c, l, n, n)
    r = np.random.RandomState(n)
    offs = torch.from_numpy(r.uniform(lo, hi, (b, l)).astype(np.float32))
    head = torch.tensor([-1.0, -0.5, -64.0, -65.5])[:l]
    offs[0, :len(head)] = head
    offs[-1, 1::3] = torch.floor(offs[-1, 1::3]) + 0.5
    for fill in (0.0, 3.0):
        want = SH.shear_pass_plain(planes, offs, kinds, norig, shift, fill)
        got = SH.shear_pass(planes.to(card), offs.to(card), kinds.to(card),
                            norig, shift, fill)
        _check(got.cpu(), want)


def test_shear_kernel_reads_misaligned_lines(card):
    """Input lines that start 4 bytes past a 16-byte boundary, with
    N % 4 == 0: the kernel's loads take any alignment, and only its
    stores (to the new, aligned output) are 16 bytes wide."""
    b, c, l, n = 2, 3, 10, 64
    planes, kinds = _planes(b, c, l, n, 5)
    r = np.random.RandomState(5)
    offs = torch.from_numpy(r.uniform(-70.0, 70.0, (b, l)).astype(np.float32))
    want = SH.shear_pass_plain(planes, offs, kinds, 48, 8, 2.0)
    buf = torch.zeros(planes.numel() + 1, device=card)
    x = buf[1:].view(b, c, l, n)
    x.copy_(planes)
    assert x.data_ptr() % 16 == 4 and x.is_contiguous()
    got = SH.shear_pass(x, offs.to(card), kinds.to(card), 48, 8, 2.0)
    _check(got.cpu(), want)


def _edge_disp(b, h, w, k, seed):
    """dy, dx within ±(K + 2), with integer offsets of exactly ±K at the
    frame's edges: column K reads column 0 and column W − 1 − K reads
    column W − 1 and its wrapped neighbour 0 (weight 0); rows likewise.
    Every fifth column of dy has a fraction of .5 (a mask tie)."""
    r = np.random.RandomState(seed)
    dy, dx = (r.uniform(-k - 2, k + 2, (b, h, w)).astype(np.float32)
              for _ in range(2))
    dy[..., ::5] = np.floor(dy[..., ::5]) + 0.5
    if w > 2 * k + 1:
        dx[:, ::2, k] = -k - 0.25
        dx[:, ::2, w - 1 - k] = k + 0.25
        dx[:, 1::2, k] = -k
        dx[:, 1::2, w - 1 - k] = k
    if h > 2 * k + 1:
        dy[:, k, ::2] = -k - 0.25
        dy[:, h - 1 - k, ::2] = k + 0.25
    return torch.from_numpy(dy), torch.from_numpy(dx)


@pytest.mark.parametrize("b,c,h,w,k,fill", [
    (2, 4, 33, 47, 6, 0.0), (1, 5, 37, 100, 19, 3.0),
    (2, 1, 24, 47, 7, 3.0), (2, 5, 41, 64, 11, 0.0),
    (2, 4, 65, 130, 19, 5.0),
    (1, 2, 16, 2048, 19, 0.0),
    (1, 1, 3, 4097, 2, 0.0),              # one row a tile, dynamic memory
    (1, 2, 5, 19370, 3, 0.0),             # the widest row
    (65535, 1, 1, 4, 1, 0.0)])            # the most images a grid axis takes
def test_elastic_kernel_edges_match_plain(card, b, c, h, w, k, fill):
    """Row tiles of the elastic kernel at ragged heights and widths, with
    ±K offsets at the frame's edges, the mod-W wrap and .5 ties in dy."""
    planes, flags = _planes(b, c, h, w, h + w + k)
    dy, dx = _edge_disp(b, h, w, k, k + 1)
    want = EL.elastic_resample_plain(planes, flags, dy, dx, k, fill)
    got = EL.elastic_resample(planes.to(card), flags.to(card), dy.to(card),
                              dx.to(card), k, fill)
    _check(got.cpu(), want)


def test_elastic_kernel_reads_misaligned_fields(card):
    """dy and dx that start 4 bytes past a 16-byte boundary take the
    kernel's scalar staging instead of its 16-byte loads."""
    b, c, h, w, k = 2, 3, 20, 64, 5
    planes, flags = _planes(b, c, h, w, 9)
    dy, dx = _edge_disp(b, h, w, k, 3)
    want = EL.elastic_resample_plain(planes, flags, dy, dx, k, 1.0)
    n = b * h * w
    buf = torch.zeros(2 * n + 1, device=card)
    gdy, gdx = buf[1:n + 1].view(b, h, w), buf[n + 1:].view(b, h, w)
    gdy.copy_(dy)
    gdx.copy_(dx)
    assert gdy.data_ptr() % 16 == 4 and gdy.is_contiguous()
    got = EL.elastic_resample(planes.to(card), flags.to(card), gdy, gdx, k,
                              1.0)
    _check(got.cpu(), want)


@pytest.mark.parametrize("b,c,h,w,py,k,fill", [
    (2, 4, 64, 64, 24, 19, 0.0), (2, 4, 48, 80, 12, 6, 5.0),
    (2, 4, 33, 47, 4, 3, 0.0),
    (1, 4, 37, 100, 20, 19, 0.0),         # py = K + 1, one image
    (2, 1, 24, 47, 8, 7, 3.0), (2, 5, 40, 64, 12, 11, 0.0),
    (1, 2, 16, 2048, 20, 19, 0.0),
    (1, 2, 5, 19370, 4, 3, 0.0)])         # kernel YE's widest row
def test_warp_ye_kernel_matches_plain(card, b, c, h, w, py, k, fill):
    planes, kinds = _planes(b, c, h, w, h + k)
    scal = _scalars(b, h, k)
    dy, dx = _edge_disp(b, h, w, k, k)
    want = FW.warp_ye_plain(planes, kinds, scal, dy, dx, py, k, fill)
    got = FW.warp_ye(planes.to(card), kinds.to(card), scal.to(card),
                     dy.to(card), dx.to(card), py, k, fill)
    _check(got.cpu(), want)
    # kernel YE equals kernel Y then the elastic kernel on the card
    two = EL.elastic_resample(FW.warp_y(planes.to(card), kinds.to(card),
                                        scal.to(card), py, fill),
                              kinds.to(card), dy.to(card), dx.to(card), k,
                              fill)
    _check(got.cpu(), two.cpu())


def test_warp_ye_refuses_a_short_band(card):
    planes, kinds = _planes(1, 2, 16, 16, 0)
    d = torch.zeros(1, 16, 16, device=card)
    before = K.launch_counts()
    with pytest.raises(ValueError, match="K\\+1"):
        FW.warp_ye(planes.to(card), kinds.to(card),
                   _scalars(1, 16, 0).to(card), d, d, 8, 8)
    with pytest.raises(ValueError, match="offsets"):
        SH.shear_pass(planes.to(card), torch.zeros(1, 15, device=card),
                      kinds.to(card), 16, 0, 0.0)
    assert K.launch_counts() == before


@pytest.mark.parametrize("env,expect", [
    ({}, {"warp_x": 1, "warp_y": 1, "elastic": 1}),
    ({"STP_FUSE_ELASTIC": "1"}, {"warp_x": 1, "warp_ye": 1}),
    ({"STP_PALLAS_WARP": "0"}, {"shear": 2, "elastic": 1})])
def test_warp_paths_launch_their_kernels(card, env, expect, monkeypatch):
    """Each switch picks kernels; the card's result stays within the CPU's
    plain result (0.05 and 1e-3 of the mask pixels, see above)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    aug = LW.build_augmentation({
        "Fliplr": 0.5,
        "Affine": {"rotate": [-15, 15], "scale": [0.85, 1.15],
                   "translate_percent": {"x": [-0.1, 0.1], "y": [-0.1, 0.1]}},
        "ElasticTransformation": {"alpha": [0, 40], "sigma": 6}})
    r = np.random.RandomState(3)
    imgs = torch.from_numpy((r.rand(2, 128, 128, 3) * 255).astype(np.uint8))
    masks = torch.from_numpy((r.rand(2, 128, 128, 1) > 0.5).astype(
        np.float32))
    draws = aug.sample(torch.Generator().manual_seed(2), 2, 128, 128)
    ci, cm = aug.apply(draws, imgs, masks)

    def to(x):
        if isinstance(x, torch.Tensor):
            return x.to(card)
        if isinstance(x, dict):
            return {k: to(v) for k, v in x.items()}
        return [to(v) for v in x]

    K.reset_launches()
    gi, gm = aug.apply(to(draws), imgs.to(card), masks.to(card))
    assert K.launch_counts() == {n: expect.get(n, 0) for n in K.KERNELS}
    assert float((gi.cpu() - ci).abs().max()) <= 0.05
    assert float((gm.cpu() != cm).float().mean()) <= 1e-3


def test_prefetcher_copies_pinned_batches_to_the_card(card):
    """The fit loop's input path: batches built and pinned on the worker
    thread arrive on the card in order, equal to the numpy batches."""
    from segmentation_training_pipeline_tpu_torch.data.batcher import (
        Prefetcher)

    batches = [{"image": np.full((2, 8, 8, 3), i, np.uint8),
                "weight": np.arange(2, dtype=np.float32)} for i in range(6)]
    got = list(Prefetcher(lambda: iter(batches), device=card, depth=2))
    torch.cuda.synchronize()
    assert len(got) == 6
    for b, want in zip(got, batches):
        assert b["image"].is_cuda and b["image"].dtype == torch.uint8
        assert np.array_equal(b["image"].cpu().numpy(), want["image"])
        assert np.array_equal(b["weight"].cpu().numpy(), want["weight"])


def test_scale_free_batchnorm_trains_on_the_card(card):
    """The keras-preact graph's ``bn_data`` has no scale: cuDNN's backward
    gives no bias gradient for a batch norm without a weight, so the
    layer passes a constant 1 (``models/layers.py:BatchNorm``).  Its
    train-mode output and gradients on the card equal the CPU's."""
    from segmentation_training_pipeline_tpu_torch.models.layers import (
        BatchNorm)

    x = torch.from_numpy(np.random.RandomState(0).randn(4, 3, 9, 7).astype(
        np.float32))
    out = {}
    for dev in ("cpu", card):
        bn = BatchNorm(3, 0.99, 1e-3, scale=False).to(dev)
        with torch.no_grad():
            bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
        xd = x.to(dev).detach().clone().requires_grad_(True)
        y = bn(xd, train=True)
        (y * torch.arange(y.numel(), device=dev).view_as(y).sin()).sum(
            ).backward()
        out[str(dev)] = [t.detach().cpu() for t in (y, xd.grad, bn.bias.grad)]
    assert bn.weight is None
    for cpu, gpu in zip(out["cpu"], out[str(card)]):
        assert cpu.shape == gpu.shape
        torch.testing.assert_close(gpu, cpu, rtol=1e-5, atol=1e-5)


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    return [_to(v, device) for v in x]


@pytest.mark.parametrize("b,c,m,h,w,fill,u8,disp", [
    (2, 3, 1, 64, 64, 0.0, True, False), (1, 1, 1, 37, 101, 0.0, True, True),
    (3, 5, 2, 96, 48, 9.0, False, True), (1, 3, 1, 2, 2, 0.0, False, False),
    (2, 3, 1, 33, 1030, 0.0, True, True)])
def test_exact_gather_on_card_matches_cpu(card, b, c, m, h, w, fill, u8,
                                          disp):
    """``warp.warp_joint`` on the card against the CPU: rotations past 90°,
    zooms that sample outside the frame (the fill), a displacement field,
    uint8 and f32 taps, a 2×2 frame, one image, odd sizes.  The gather is
    PyTorch ops, one IEEE operation each on either device: images within
    1e-4, masks equal."""
    from segmentation_training_pipeline_tpu_torch.ops.aug import warp as W

    torch.backends.cuda.matmul.allow_tf32 = False
    r = np.random.RandomState(h + w)
    imgs = torch.from_numpy((r.rand(b, h, w, c) * 255).round().astype(
        np.float32))
    masks = torch.from_numpy((r.rand(b, h, w, m) > 0.5).astype(np.float32))
    theta = torch.from_numpy(r.uniform(-3.1, 3.1, b).astype(np.float32))
    zoom = torch.from_numpy(r.uniform(0.6, 1.6, b).astype(np.float32))
    mats = W.compose(W.rotation_about((w - 1) / 2, (h - 1) / 2, theta),
                     W.scale_about((w - 1) / 2, (h - 1) / 2, zoom, zoom))
    field = None
    if disp:
        field = tuple(torch.from_numpy((4 * r.randn(b, h, w)).astype(
            np.float32)) for _ in range(2))
    ci, cm = W.warp_joint(imgs, masks, mats, field, fill, gather_u8=u8)
    gi, gm = W.warp_joint(imgs.to(card), masks.to(card), mats.to(card),
                          None if field is None else _to(list(field), card),
                          fill, gather_u8=u8)
    assert float((gi.cpu() - ci).abs().max()) <= 1e-4
    assert torch.equal(gm.cpu(), cm)
    if h > 2:
        assert (ci == fill).any()


@pytest.mark.parametrize("spec,route,launches", [
    ({"Rot90": [0, 3]}, "flips", {}),
    ({"CropAndPad": {"percent": [-0.08, 0.08]}, "Pad": {"px": [0, 9]}},
     "multipass", {"warp_x": 1, "warp_y": 1}),
    ({"CenterCropToFixedSize": {"width": 80, "height": 70},
      "PadToFixedSize": {"width": 120, "height": 120, "pad_cval": 16}},
     "multipass", {"warp_x": 1, "warp_y": 1}),
    ({"PiecewiseAffine": {"scale": [0.01, 0.02]}}, "elastic",
     {"elastic": 1}),
    ({"Affine": {"rotate": [-10, 10], "cval": [0, 255]},
      "PerspectiveTransform": {"scale": [0.0, 0.02]}}, "multipass+elastic",
     {"warp_x": 1, "warp_y": 1, "elastic": 1}),
    ({"PerspectiveTransform": {"scale": [0.05, 0.1]}}, "gather", {}),
], ids=["rot90", "crop-pad", "fixed-size", "piecewise", "affine-perspective",
        "gather"])
def test_geometric_routes_on_card(card, spec, route, launches):
    """Each route of the new names launches the kernels it should, and
    the block on the card agrees with the CPU on the same draws (as the
    config-2 block: images within 0.05, masks differing in at most 1e-3
    of the pixels)."""
    b, h = 2, 96
    aug = LW.build_augmentation(spec)
    assert aug.segments[0].route(h, h) == route
    r = np.random.RandomState(3)
    imgs = torch.from_numpy((r.rand(b, h, h, 3) * 255).astype(np.uint8))
    masks = torch.from_numpy((r.rand(b, h, h, 1) > 0.5).astype(np.float32))
    draws = aug.sample(torch.Generator().manual_seed(2), b, h, h)
    ci, cm = aug.apply(draws, imgs, masks)
    K.reset_launches()
    gi, gm = aug.apply(_to(draws, card), imgs.to(card), masks.to(card))
    assert K.launch_counts() == {n: launches.get(n, 0) for n in K.KERNELS}
    assert float((gi.cpu() - ci).abs().max()) <= 0.05
    assert float((gm.cpu() != cm).float().mean()) <= 1e-3
