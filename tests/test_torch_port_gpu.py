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
and the launch counts; the batch-norm kernels on channel counts, map
sizes, layouts and types the train shapes do not reach.  Every kernel tiles rows or lines and columns, so
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
    x_y_elastic = {"warp_x": 1, "warp_y": 1, "elastic": 1}
    assert K.launch_counts() == {n: x_y_elastic.get(n, 0)
                                 for n in K.KERNELS}
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
    """The keras-preact graph's ``bn_data`` has no scale: the batch-norm
    kernels take a null weight (flax's ``use_scale=False``) and still
    give the bias its gradient.  Its train-mode output and gradients on
    the card equal the CPU's, through the four kernels."""
    from segmentation_training_pipeline_tpu_torch.models.layers import (
        BatchNorm)

    x = torch.from_numpy(np.random.RandomState(0).randn(4, 3, 9, 7).astype(
        np.float32))
    out = {}
    K.reset_launches()
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
    assert {n: K.launch_counts()[n] for n in BN_KERNELS} == {
        n: 1 for n in BN_KERNELS}
    for cpu, gpu in zip(out["cpu"], out[str(card)]):
        assert cpu.shape == gpu.shape
        torch.testing.assert_close(gpu, cpu, rtol=1e-5, atol=1e-5)


BN_KERNELS = ("bn_stats", "bn_apply", "bn_grad_stats", "bn_grad_apply")


def _one_value_off(t):
    """``t``'s values in its layout (NCHW or channels-last), one value (2
    bytes in bfloat16, 4 in float32) past the 16-byte aligned start of a
    buffer."""
    b, c, h, w = t.shape
    n = t.numel()
    flat = torch.empty(n + 16, dtype=t.dtype, device=t.device)[1:n + 1]
    out = (flat.view(b, h, w, c).permute(0, 3, 1, 2)
           if t.is_contiguous(memory_format=torch.channels_last)
           and not t.is_contiguous() else flat.view(b, c, h, w))
    out.copy_(t)
    return out


def _ulps_apart(a, b):
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16, torch.float64: torch.int64}[a.dtype]
    return int((a.contiguous().view(ints).long()
                - b.contiguous().view(ints).long()).abs().max())


@pytest.mark.parametrize("shape,dtype,layout,scale", [
    ((2, 3, 5, 7), torch.float32, "nchw", True),         # odd planes
    ((2, 40, 9, 7), torch.bfloat16, "channels_last", True),   # 5 columns
    ((3, 37, 11, 13), torch.float32, "channels_last", False),  # 2 tiles
    ((1, 300, 2, 2), torch.bfloat16, "nchw", True),      # below a slice
    ((8, 2048, 1, 1), torch.float32, "nchw", True),      # H·W = 1: rows
    ((5, 24, 1, 1), torch.float64, "nchw", False),
    ((4, 64, 128, 128), torch.bfloat16, "nchw", True),   # many slices
    ((2, 96, 64, 64), torch.float32, "channels_last", True),
    ((2, 16, 32, 32), torch.float64, "channels_last", True),
    ((64, 33, 40, 40), torch.bfloat16, "channels_last", False),
    ((2, 40, 9, 7), torch.float16, "channels_last", True),    # 5 columns
    ((4, 64, 128, 128), torch.float16, "nchw", False),   # many slices
    ((3, 37, 11, 13), torch.float16, "channels_last", True),  # no vectors
    ((1, 128, 200, 200), torch.bfloat16, "channels_last", True),  # ragged
    ((1, 16, 256, 256), torch.bfloat16, "nchw", True),   # 1 cluster a tile
    ((16, 512, 16, 16), torch.bfloat16, "channels_last", True),  # layer 4
    ((4, 1040, 8, 8), torch.bfloat16, "channels_last", False),  # 17 tiles
    ((2, 3, 16, 16), torch.bfloat16, "channels_last", True),  # 6-byte rows
    ((4, 64, 32, 32), torch.bfloat16, "channels_last+2", True),  # off 16 B
    ((4, 64, 32, 32), torch.float32, "nchw+4", False),   # off 16 bytes
    # bn_grad_apply's ring on rows and on planes, its direct tiles walking
    # on past a wave with a ragged last tile
    ((16, 64, 128, 128), torch.bfloat16, "channels_last", True),
    ((8, 96, 24, 24), torch.bfloat16, "nchw", False),
    ((16, 400, 32, 32), torch.bfloat16, "channels_last", True),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_batchnorm_kernels_match_their_plain_versions(card, shape, dtype,
                                                      layout, scale):
    """Each batch-norm kernel against its plain version on the card, at
    channel counts that are no multiple of a vector or a tile, a few
    values a channel and many slices of them, H·W = 1, both layouts and
    no scale: the float64 sums within 1e-12 of the sum of their terms'
    magnitudes (another order of addition), every output derived from
    given sums equal (the same operations in the same order), two
    launches bit-identical, one launch counted each.  The cases also hold
    the redesigned reductions' clusters (a cluster with blocks past the
    map, one cluster a tile, tiles narrower than a row) and maps one value
    off 16-byte alignment (``+2``, ``+4`` bytes: one value at a time),
    and each of bn_grad_apply's modes (the ring, direct loads, one value
    at a time) and its blocks walking on past a wave."""
    from segmentation_training_pipeline_tpu_torch.models import (
        batchnorm as BN)

    gen = torch.Generator(device=card).manual_seed(sum(shape))
    c, dims = shape[1], (0, 2, 3)
    fmt = (torch.channels_last if layout.startswith("channels_last")
           else torch.contiguous_format)
    x = (3 + 2 * torch.randn(shape, generator=gen, device=card)).to(
        dtype).contiguous(memory_format=fmt)
    dy = torch.randn(shape, generator=gen, device=card).to(dtype).contiguous(
        memory_format=fmt)
    if "+" in layout:
        x, dy = _one_value_off(x), _one_value_off(dy)
        assert x.data_ptr() % 16 == x.element_size()
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    w = (0.5 + torch.rand(c, generator=gen, device=card)).to(acc) \
        if scale else None
    b, rm = (torch.randn(c, generator=gen, device=card).to(acc)
             for _ in range(2))
    rv = (1 + torch.rand(c, generator=gen, device=card)).to(acc)
    K.reset_launches()
    sums = BN.bn_stats(x)
    app = BN.bn_apply(x, sums, w, b, rm, rv, 0.99, 1e-3)
    mean, invstd = app[1], app[2]
    gs, dw, db = BN.bn_grad_stats(dy, x, mean, invstd, w)
    dx = BN.bn_grad_apply(dy, x, gs, sums, mean, invstd, w)
    assert K.launch_counts() == {n: int(n in BN_KERNELS) for n in K.KERNELS}
    xd, dyd = x.double(), dy.double()
    d = (x.to(acc) - mean.view(1, -1, 1, 1)).double()
    for got, want, scale_of in (
            (sums, BN.bn_stats_plain(x), torch.cat([
                xd.abs().sum(dims), (xd * xd).sum(dims), xd.new_ones(1)])),
            (gs, BN.bn_grad_stats_plain(dy, x, mean, invstd, w)[0],
             torch.cat([dyd.abs().sum(dims), (dyd * d).abs().sum(dims)]))):
        assert float(((got - want).abs() / scale_of).max()) <= 1e-12
    assert float(sums[2 * c]) == x.numel() // c
    for got, want in zip(app, BN.bn_apply_plain(x, sums, w, b, rm, rv, 0.99,
                                                1e-3)):
        assert got.dtype == want.dtype and _ulps_apart(got, want) == 0
    assert _ulps_apart(db, gs[:c].to(acc)) == 0
    if scale:
        assert _ulps_apart(dw, (gs[c:] * invstd.double()).to(acc)) == 0
    else:
        assert dw is None
    want = BN.bn_grad_apply_plain(dy, x, gs, sums, mean, invstd, w)
    assert dx.dtype == dtype and _ulps_apart(dx, want) == 0
    assert dx.is_contiguous(memory_format=fmt)
    # the reductions' order depends on the shape alone
    assert torch.equal(BN.bn_stats(x), sums)
    assert torch.equal(BN.bn_grad_stats(dy, x, mean, invstd, w)[0], gs)
    assert torch.equal(BN.bn_grad_apply(dy, x, gs, sums, mean, invstd, w), dx)


def test_batchnorm_layer_on_the_card_matches_the_cpu(card):
    """The layer's train mode through the four kernels against its plain
    versions on the CPU, on a channels-last input with a gradient of
    another layout (copied to the input's before the backward kernels)
    and on a strided view (copied to contiguous first)."""
    from segmentation_training_pipeline_tpu_torch.models.layers import (
        BatchNorm)

    r = np.random.RandomState(4)
    x = torch.from_numpy((2 + r.randn(3, 24, 10, 12)).astype(np.float32))
    g = torch.from_numpy(r.randn(3, 24, 10, 12).astype(np.float32))
    for view in ("channels_last", "strided"):
        out = {}
        for dev in ("cpu", card):
            bn = BatchNorm(24).to(dev)
            xd = x.to(dev)
            if view == "channels_last":
                xd = xd.contiguous(memory_format=torch.channels_last)
            else:
                xd = torch.cat([xd, xd], 3)[..., ::2]
            xd = xd.detach().requires_grad_(True)
            y = bn(xd, train=True)
            y.backward(g.to(dev))
            out[str(dev)] = [t.detach().cpu() for t in (
                y, *bn.updated, xd.grad, bn.weight.grad, bn.bias.grad)]
        for cpu, gpu in zip(out["cpu"], out[str(card)]):
            torch.testing.assert_close(gpu, cpu, rtol=1e-5, atol=1e-5)


def test_batchnorm_kernels_on_two_streams(card):
    """Launches on two streams of one card at once: each stream has its
    own tickets and partial sums, so neither disturbs the other's last
    block, and every result equals the same launch on the default
    stream."""
    from segmentation_training_pipeline_tpu_torch.models import (
        batchnorm as BN)

    gen = torch.Generator(device=card).manual_seed(7)
    xs = [(3 + torch.randn(shape, generator=gen, device=card)).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
        for shape in ((16, 64, 128, 128), (16, 64, 96, 128))]
    dys = [torch.randn_like(x) for x in xs]
    want = []
    for x, dy in zip(xs, dys):
        sums = BN.bn_stats(x)
        mean = (sums[:64] / sums[128]).float()
        invstd = torch.ones(64, device=card)
        want.append((sums, BN.bn_grad_stats(dy, x, mean, invstd, None)[0],
                     mean, invstd))
    streams = [torch.cuda.Stream(card) for _ in xs]
    got = [[] for _ in xs]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(card))
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                _, _, mean, invstd = want[i]
                got[i].append((BN.bn_stats(xs[i]), BN.bn_grad_stats(
                    dys[i], xs[i], mean, invstd, None)[0]))
    torch.cuda.synchronize(card)
    for i, s in enumerate(streams):
        assert (card.index or 0, s.cuda_stream) in BN._SCRATCH
        for sums, gs in got[i]:
            assert torch.equal(sums, want[i][0])
            assert torch.equal(gs, want[i][1])


def test_float16_model_trains_through_the_batchnorm_kernels(card):
    """A config's ``dtype: float16``: the model runs under float16
    autocast, so its batch norms take float16 maps.  One train-mode
    forward and backward of Unet-resnet18 at 64² B2 launches each
    batch-norm kernel once a layer, on float16 inputs, with finite
    gradients; its logits within 5e-2 (relative L2) of the float32
    model's from the same init, TF32 off (float16's rounding over the
    layers, some 1e-3; a broken kernel would be of order 1)."""
    from segmentation_training_pipeline_tpu_torch.models import (
        batchnorm as BN)
    from segmentation_training_pipeline_tpu_torch.models import (
        factory as MF)

    x = torch.from_numpy(np.random.RandomState(2).rand(2, 64, 64, 3).astype(
        np.float32)).to(card)
    logits = {}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for dtype in ("float16", "float32"):
        model = MF.init_model(MF.create_model("Unet", "resnet18", 1,
                                              dtype=dtype), 0, card)
        layers = [m for m in model.modules() if isinstance(m, BN.BatchNorm)]
        seen = set()
        hooks = [m.register_forward_pre_hook(
            lambda _m, args: seen.add(args[0].dtype)) for m in layers]
        K.reset_launches()
        out = model(x, train=True)
        out.square().mean().backward()
        torch.cuda.synchronize(card)
        for h in hooks:
            h.remove()
        assert seen == {getattr(torch, dtype)}
        assert {n: K.launch_counts()[n] for n in BN_KERNELS} == {
            n: len(layers) for n in BN_KERNELS}
        assert all(bool(torch.isfinite(p.grad).all())
                   for p in model.parameters() if p.grad is not None)
        logits[dtype] = out.detach().float()
    a, b = logits["float16"], logits["float32"]
    assert bool(torch.isfinite(a).all())
    assert float((a - b).norm() / b.norm()) <= 5e-2


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


# each pixelwise and colour name in one of its forms
PHOTO_ON_CARD = {
    "add": {"Add": {"value": [-20, 20], "per_channel": True}},
    "addelementwise": {"AddElementwise": [-20, 20]},
    "multiplyelementwise": {"MultiplyElementwise": {
        "mul": [0.8, 1.2], "per_channel": True}},
    "linearcontrast": {"LinearContrast": [0.6, 1.4]},
    "gammacontrast": {"GammaContrast": {"gamma": [0.7, 1.7],
                                        "per_channel": True}},
    "sigmoidcontrast": {"SigmoidContrast": {"gain": [5, 10],
                                            "cutoff": [0.3, 0.6]}},
    "logcontrast": {"LogContrast": [0.4, 1.6]},
    "invert": {"Invert": 0.5},
    "solarize": {"Solarize": {"p": [0.2, 0.8], "threshold": [64, 192]}},
    "posterize": {"Posterize": [1, 8]},
    "gaussian": {"AdditiveGaussianNoise": [0, 15]},
    "laplace": {"AdditiveLaplaceNoise": [0, 15]},
    "poisson": {"AdditivePoissonNoise": [0, 15]},
    "impulse": {"ImpulseNoise": 0.1},
    "salt": {"Salt": 0.1},
    "pepper": {"Pepper": 0.1},
    "saltandpepper": {"SaltAndPepper": 0.1},
    "coarsesaltandpepper": {"CoarseSaltAndPepper": 0.2},
    "coarsesalt": {"CoarseSalt": {"p": 0.2, "size_percent": 0.05}},
    "coarsepepper": {"CoarsePepper": 0.2},
    "dropout": {"Dropout": [0, 0.2]},
    "dropout2d": {"Dropout2d": {"p": 0.7, "nb_keep_channels": 2}},
    "totaldropout": {"TotalDropout": 0.5},
    "coarsedropout": {"CoarseDropout": {"p": 0.3, "size_percent": 0.1}},
    "cutout": {"Cutout": {"nb_iterations": [1, 3], "size": 0.15,
                          "cval": [0, 255]}},
    "replaceelementwise": {"ReplaceElementwise": {
        "mask": 0.1, "replacement": [0, 255], "per_channel": True}},
    "channelshuffle": {"ChannelShuffle": 0.5},
    "noop": {"Noop": None},
    "resize-float": {"Resize": 0.75},
    "resize-int": {"Resize": 40},
    "sometimes": {"Sometimes": {"p": 0.5, "then": [{"Add": 30}],
                                "else": [{"GammaContrast": [0.5, 2.0]}]}},
    "oneof": {"OneOf": [{"Invert": 1.0}, {"Salt": 0.1},
                        {"LogContrast": [0.5, 1.5]}]},
    "someof": {"SomeOf": {"n": [0, 2], "children": [
        {"Pepper": 0.1}, {"Multiply": 0.8}, {"Cutout": 2}]}},
    # the colour names, the histogram names (72×100: CLAHE pads to odd
    # tiles) and the channel and colourspace scopes
    "grayscale": {"Grayscale": [0.0, 1.0]},
    "addtohueandsaturation": {"AddToHueAndSaturation": [-40, 40]},
    "addtohue": {"AddToHue": [-255, 255]},
    "addtosaturation": {"AddToSaturation": [-75, 75]},
    "multiplyhueandsaturation": {"MultiplyHueAndSaturation": [0.5, 1.5]},
    "multiplyhue": {"MultiplyHue": [-3.0, 3.0]},
    "multiplysaturation": {"MultiplySaturation": [0.0, 3.0]},
    "removesaturation": {"RemoveSaturation": [0.2, 1.0]},
    "changecolortemperature": {"ChangeColorTemperature": [1000, 11000]},
    "changecolorspace-hls": {"ChangeColorspace": {
        "to_colorspace": "HLS", "alpha": [0.5, 1.0]}},
    "changecolorspace-ycrcb": {"ChangeColorspace": "YCrCb"},
    "autocontrast": {"Autocontrast": {"cutoff": 3}},
    "histogramequalization": {"HistogramEqualization": None},
    "clahe": {"CLAHE": [1, 10]},
    "clahe-grid4": {"AllChannelsCLAHE": {"clip_limit": 3,
                                         "tile_grid_size": 4}},
    "withchannels": {"WithChannels": {"channels": [0, 2], "children": [
        {"Add": [-30, 30]}]}},
    "withhueandsaturation": {"WithHueAndSaturation": {"children": [
        {"Add": {"value": [-40, 40], "per_channel": True}}]}},
    "withbrightnesschannels": {"WithBrightnessChannels": {"children": [
        {"LinearContrast": [0.5, 1.5]}]}},
    "withcolorspace": {"WithColorspace": {"to_colorspace": "HSV",
                                          "children": [{"Multiply": [0.7,
                                                                     1.3]}]}},
    # the filters (their convolutions under PyTorch's default cuDNN TF32:
    # each turns it off for itself); JpegCompression pads 72×100 to 80×112
    "averageblur": {"AverageBlur": [1, 7]},
    "gaussianblur": {"GaussianBlur": [0.0, 3.0]},
    "sharpen": {"Sharpen": {"alpha": [0, 1], "lightness": [0.75, 1.5]}},
    "emboss": {"Emboss": [0, 1]},
    "edgedetect": {"EdgeDetect": [0, 0.75]},
    "directededgedetect": {"DirectedEdgeDetect": None},
    "motionblur": {"MotionBlur": {"k": [3, 9], "angle": [0, 360]}},
    "averagepooling": {"AveragePooling": 3},
    "maxpooling": {"MaxPooling": 2},
    "minpooling": {"MinPooling": 3},
    "medianpooling": {"MedianPooling": 3},
    "medianblur": {"MedianBlur": None},
    "medianblur-k7": {"MedianBlur": 7},
    "bilateralblur": {"BilateralBlur": {"d": [3, 11]}},
    "jpegcompression": {"JpegCompression": [0, 100]},
    "canny": {"Canny": {"alpha": [0.5, 1.0], "sobel_kernel_size": 5}},
    "meanshiftblur": {"MeanShiftBlur": None},
    "cartoon": {"Cartoon": {"blur_ksize": 5}},
    # weather, the quantisers, Jigsaw and the blends (photometric
    # children: the masks stay put, see the FrequencyNoise test for their
    # routing); the streak convolutions under cuDNN's default TF32
    "clouds": {"Clouds": [0.2, 0.6]},
    "fog": {"Fog": [0.1, 0.4]},
    "snowflakes": {"Snowflakes": {"density": [0.01, 0.05],
                                  "speed": [0.05, 0.2]}},
    "rain": {"Rain": None},
    "fastsnowylandscape": {"FastSnowyLandscape": None},
    "uniformcolorquantization": {"UniformColorQuantization": [2, 16]},
    "jigsaw": {"Jigsaw": {"nb_rows": 5, "nb_cols": 7, "max_steps": [1, 9]}},
    "blendalpha": {"BlendAlpha": {"factor": [0, 1], "per_channel": True,
                                  "foreground": {"Add": 40},
                                  "background": {"Multiply": 0.8}}},
    "alpha": {"Alpha": {"foreground": {"Add": -40}}},
    "blendalphaelementwise": {"BlendAlphaElementwise": {
        "foreground": {"Add": 40}}},
    "alphaelementwise": {"AlphaElementwise": {"foreground": {"Add": 40}}},
    "blendalphaverticallineargradient": {"BlendAlphaVerticalLinearGradient": {
        "foreground": {"Add": 40}, "start_at": [0, 0.3]}},
    "blendalphahorizontallineargradient": {
        "BlendAlphaHorizontalLinearGradient": {"foreground": {"Add": 40}}},
    "blendalpharegulargrid": {"BlendAlphaRegularGrid": {
        "foreground": {"Add": 40}, "nb_rows": [2, 8]}},
    "blendalphacheckerboard": {"BlendAlphaCheckerboard": {
        "foreground": {"Add": 40}}},
    "blendalphasimplexnoise": {"BlendAlphaSimplexNoise": {
        "foreground": {"Add": 40}}},
    "simplexnoisealpha": {"SimplexNoiseAlpha": {"foreground": {"Add": 40},
                                                "sigmoid": False}},
    "blendalphafrequencynoise": {"BlendAlphaFrequencyNoise": {
        "foreground": {"Add": 40}}},
    "frequencynoisealpha": {"FrequencyNoiseAlpha": {
        "foreground": {"Add": 40}, "exponent": -4}},
    "blendalphasomecolors": {"BlendAlphaSomeColors": {
        "foreground": {"Add": 40}}},
    "blendalphasegmapclassids": {"BlendAlphaSegMapClassIds": {
        "class_ids": 1, "foreground": {"Add": 40}}},
}


def _batch(b, h, w, seed):
    r = np.random.RandomState(seed)
    imgs = torch.from_numpy((r.rand(b, h, w, 3) * 255).astype(np.uint8))
    masks = torch.from_numpy((r.rand(b, h, w, 1) > 0.5).astype(np.float32))
    return imgs, masks


@pytest.mark.parametrize("spec", list(PHOTO_ON_CARD.values()),
                         ids=list(PHOTO_ON_CARD))
def test_photometric_names_on_card(card, spec):
    """Each name on the card against the port on the CPU on the same
    draws (72×100, so the coarse grids and Resize's sizes are no
    divisors of the frame): images within 1e-3 on 0..255 (pow, exp and
    log2 round differently there), masks equal, no kernel launched; and
    the name's draws made by a generator on the card."""
    b, h, w = 3, 72, 100
    aug = LW.build_augmentation(spec)
    imgs, masks = _batch(b, h, w, 4)
    draws = aug.sample(torch.Generator().manual_seed(5), b, h, w)
    ci, cm = aug.apply(draws, imgs, masks)
    K.reset_launches()
    gi, gm = aug.apply(_to(draws, card), imgs.to(card), masks.to(card))
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}
    assert float((gi.cpu() - ci).abs().max()) <= 1e-3
    assert torch.equal(gm.cpu(), cm)
    own = aug.sample(torch.Generator(device=card).manual_seed(5), b, h, w)
    oi, om = aug.apply(own, imgs.to(card), masks.to(card))
    assert oi.is_cuda and bool(torch.isfinite(oi).all())


@pytest.mark.parametrize("spec,launches", [
    ({"Rotate": [-15, 15]}, {"warp_x": 1, "warp_y": 1}),
    ({"TranslateY": {"px": [-9, 9]}, "ShearX": [-10, 10]},
     {"warp_x": 1, "warp_y": 1}),
    ({"Add": 5, "Sometimes": {"p": 0.5, "then": [
        {"Affine": {"rotate": [-10, 10], "cval": 128}}]}},
     {"warp_x": 1, "warp_y": 1}),
    ({"SomeOf": {"n": [0, 2], "children": [
        {"Rotate": [-10, 10]}, {"ScaleY": [0.8, 1.2]}, {"Add": 3}]}},
     {"warp_x": 2, "warp_y": 2}),
    ({"Fliplr": 0.5, "Rotate": [-15, 15],
      "Sometimes": {"p": 0.5, "then": [{"ElasticTransformation": {
          "alpha": [0, 40], "sigma": 6}}]},
      "OneOf": [{"GammaContrast": [0.7, 1.4]},
                {"LinearContrast": [0.9, 1.1]}],
      "Resize": 0.75},
     {"warp_x": 1, "warp_y": 1, "elastic": 1}),
], ids=["rotate", "sugar-run", "sometimes-after-photo", "someof-warps",
        "train-photo"])
def test_sugar_and_combinators_on_card(card, spec, launches):
    """The sugar names and warps inside combinators launch their kernels
    once per geometric run (a combinator runs every child), and the block
    on the card agrees with the CPU on the same draws as the config-2
    block does (images within 0.05, masks differing in at most 1e-3 of
    the pixels)."""
    b, h = 2, 96
    aug = LW.build_augmentation(spec)
    imgs, masks = _batch(b, h, h, 3)
    draws = aug.sample(torch.Generator().manual_seed(2), b, h, h)
    ci, cm = aug.apply(draws, imgs, masks)
    K.reset_launches()
    gi, gm = aug.apply(_to(draws, card), imgs.to(card), masks.to(card))
    assert K.launch_counts() == {n: launches.get(n, 0) for n in K.KERNELS}
    assert float((gi.cpu() - ci).abs().max()) <= 0.05
    assert float((gm.cpu() != cm).float().mean()) <= 1e-3


def test_filters_turn_tf32_off_for_their_convolutions(card):
    """With cuDNN's TF32 on (PyTorch's default on the card), GaussianBlur
    and MotionBlur of 0..255 values stay within 1e-3 of the CPU, while a
    convolution of the same planes run directly under TF32 is off by
    more than that bar (by 6.4e-3 on an H100: the check sees TF32);
    ``fast_warp._exact_f32`` turns it off inside and gives the caller's
    setting back."""
    import torch.nn.functional as F

    from segmentation_training_pipeline_tpu_torch.ops.aug import (
        fast_warp as MP, photometric as TP)

    torch.backends.cudnn.allow_tf32 = True
    imgs, _ = _batch(2, 64, 80, 6)
    x = imgs.float()
    sigma, k = torch.tensor([2.0, 3.0]), torch.tensor([7.0, 9.0])
    angle = torch.tensor([30.0, 100.0])
    for fn in (lambda t, d: TP.gaussian_blur(t, sigma.to(d), 8),
               lambda t, d: TP.motion_blur(t, k.to(d), angle.to(d), 4)):
        want = fn(x, "cpu")
        got = fn(x.to(card), card)
        assert float((got.cpu() - want).abs().max()) <= 1e-3
        assert torch.backends.cudnn.allow_tf32
    planes = TP._planes(x)                           # (1, 6, 64, 80)
    weight = torch.rand(16, planes.shape[1], 9, 9,
                        generator=torch.Generator().manual_seed(0)) / 243.0
    plain = F.conv2d(planes, weight)
    tf32 = F.conv2d(planes.to(card), weight.to(card))
    assert float((tf32.cpu() - plain).abs().max()) > 1e-3
    with MP._exact_f32(card):
        assert not torch.backends.cudnn.allow_tf32
        exact = F.conv2d(planes.to(card), weight.to(card))
    assert torch.backends.cudnn.allow_tf32
    assert float((exact.cpu() - plain).abs().max()) <= 1e-3


def test_streaks_and_segment_products_turn_tf32_off(card):
    """With cuDNN's and cuBLAS's TF32 on, Rain's streak convolution and
    the segment argmin's and means' products stay within 1e-3 of the CPU
    (the assignment equal where the CPU's two best distances differ by
    more than 1e-4 relative), while the same products run directly
    under TF32 are off by more than that; ``fast_warp._exact_f32`` gives
    the caller's settings back."""
    from segmentation_training_pipeline_tpu_torch.ops.aug import (
        fast_warp as MP, photometric as TP, segment as SG)

    torch.backends.cudnn.allow_tf32 = True
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        imgs, _ = _batch(2, 64, 80, 7)
        x = imgs.float()
        r = torch.Generator().manual_seed(1)
        u = torch.rand((2, 64, 80, 1), generator=r)
        args = (torch.tensor([0.05, 0.1]), torch.tensor([0.2, 0.3]),
                torch.tensor([-15.0, 10.0]))
        want = TP.rain(x, u, *args)
        got = TP.rain(x.to(card), u.to(card), *(a.to(card) for a in args))
        assert float((got.cpu() - want).abs().max()) <= 1e-3
        assert torch.backends.cudnn.allow_tf32
        feats = torch.rand((2, 4096, 5), generator=r) * 255.0
        seeds = torch.rand((2, 200, 5), generator=r) * 255.0
        valid = torch.rand((2, 200), generator=r) < 0.8
        ca = SG.chunked_argmin(feats, seeds, valid)
        ga = SG.chunked_argmin(feats.to(card), seeds.to(card),
                               valid.to(card)).cpu()
        assert torch.get_float32_matmul_precision() == "high"
        d = ((feats[:, :, None].double() - seeds[:, None].double()) ** 2
             ).sum(-1).masked_fill(~valid[:, None], float("inf"))
        best2 = d.sort(-1).values[..., :2]
        clear = (best2[..., 1] - best2[..., 0]) > 1e-4 * best2[..., 1]
        assert torch.equal(ga[clear], ca[clear])
        cm, cc = SG.segment_means(ca, feats, 200)
        gm, gc = SG.segment_means(ca.to(card), feats.to(card), 200)
        assert float((gm.cpu() - cm).abs().max()) <= 1e-3
        assert torch.equal(gc.cpu(), cc)
        # TF32 is on for a product that takes it (64-long sums)
        wide = torch.rand((2, 512, 64), generator=r) * 255.0
        tf32 = torch.bmm(wide.to(card), wide.to(card).transpose(1, 2))
        plain = torch.bmm(wide, wide.transpose(1, 2))
        assert float((tf32.cpu() - plain).abs().max()) > 1e-3
        with MP._exact_f32(card):
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)


@pytest.mark.parametrize("h,w", [(33, 47), (65, 31)])
def test_frequency_noise_at_odd_sizes_on_card(card, h, w):
    """FrequencyNoise's cuFFT against the CPU's FFT at odd H and W: the
    alpha maps within 1e-4, images within 1e-3, and the masks (a flipped
    foreground) routed alike wherever the CPU's alpha is farther than
    1e-5 from 0.5."""
    aug = LW.build_augmentation({"BlendAlphaFrequencyNoise": {
        "foreground": [{"Fliplr": 1.0}, {"Add": 30}]}})
    seg = aug.segments[0]
    imgs, masks = _batch(4, h, w, 8)
    draws = aug.sample(torch.Generator().manual_seed(2), 4, h, w)
    ci, cm = aug.apply(draws, imgs, masks)
    gd = _to(draws, card)
    gi, gm = aug.apply(gd, imgs.to(card), masks.to(card))
    base = imgs.float()
    ca = seg.alpha(draws[0]["alpha"], base, masks)
    ga = seg.alpha(gd[0]["alpha"], base.to(card), masks.to(card))
    assert float((ga.cpu() - ca).abs().max()) <= 1e-4
    assert float((gi.cpu() - ci).abs().max()) <= 1e-3
    far = (ca - 0.5).abs() > 1e-5
    assert float((~far).float().mean()) < 1e-3
    assert torch.equal(gm.cpu()[far.expand_as(cm)], cm[far.expand_as(cm)])


@pytest.mark.parametrize("spec", [
    {"Superpixels": {"n_segments": [60, 120], "p_replace": [0.5, 1.0]}},
    {"KMeansColorQuantization": [2, 16]}], ids=["superpixels", "kmeans"])
def test_segment_quantisers_at_512_on_card(card, spec):
    """Superpixels and KMeansColorQuantization at 512² B16 (the default
    max_size 128 downscales 4×) on the card against the CPU on the same
    draws: a near-tie argmin falls either way, recolours a pixel and moves
    its cells' means (and, over the rounds, others') by a fraction of a
    gray level, so the share of values off by more than 0.5 is held at or
    under 1% (``chip_smoke.SEGMENT_ATOL``); masks equal."""
    aug = LW.build_augmentation(spec)
    imgs, masks = _batch(16, 512, 512, 9)
    draws = aug.sample(torch.Generator().manual_seed(3), 16, 512, 512)
    ci, cm = aug.apply(draws, imgs, masks)
    gi, gm = aug.apply(_to(draws, card), imgs.to(card), masks.to(card))
    off = ((gi.cpu() - ci).abs() > 0.5).float().mean()
    assert float(off) <= 1e-2, float(off)
    assert torch.equal(gm.cpu(), cm)
