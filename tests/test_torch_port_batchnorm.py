"""Train-mode BatchNorm of the port (``models/batchnorm.py``) against
flax's ``nn.BatchNorm(use_running_average=False)``, on the CPU.

On the CPU the four kernel wrappers run their plain versions, so the
Function under test here is the plain one: float64 sums, flax's
normalisation order, the same float32 rounding points as the kernels.
The same numpy inputs (an offset of 3 and a spread of 2, so E[x²] sits
well above the variance) go through both sides: the output, the updated
running statistics and, through ``jax.vjp``, the input's, scale's and
bias's gradients against one random cotangent.

Tolerances.  float32: flax sums in float32 (mean, then E[x²] − mean²),
the port in float64 rounded once, so the two differ by float32 rounding
of the variance's cancellation, a few 1e-7 relative; output and
statistics within rtol 1e-5 / atol 1e-5, the input gradient within
rtol 1e-4 / atol 1e-5 of its largest value (its two sums subtract
nearly equal terms), the scale's and bias's within 1e-4 relative to
their largest value.  bfloat16 and float16 values (float32 arithmetic on
16-bit inputs and outputs, float16 a config's ``dtype`` too): the output
and input gradient within one step of the type (2⁻⁷ relative for bf16,
2⁻¹⁰ for f16) of the largest value, since a float32 difference in the
last bit can round a value to the neighbouring 16-bit number; the
float32 statistics and parameter gradients as in float32 (bf16 a little
wider: the bf16 cotangent's sums).  In float32 the port is also held
within 1e-6 of the largest value to the same layer in float64: flax's
float32 sums put it several times farther (up to 8e-6 here).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_training_pipeline_tpu_torch import kernels as K
from segmentation_training_pipeline_tpu_torch.models import batchnorm as BN

from torch_port_util import few_torch_threads  # noqa: F401

SHAPE = (4, 16, 16, 16)
CASES = [(dtype, scale, m, eps)
         for dtype in ("float32", "bfloat16", "float16")
         for scale in (True, False)
         for m, eps in ((0.9, 1e-5), (0.99, 1e-3))]


def _inputs(shape, seed):
    """x (NCHW), scale, bias, running mean and variance, a cotangent."""
    r = np.random.RandomState(seed)
    c = shape[1]
    x = (3.0 + 2.0 * r.randn(*shape) * r.uniform(0.5, 2.0, (1, c, 1, 1))
         ).astype(np.float32)
    w = r.uniform(0.5, 1.5, c).astype(np.float32)
    b = r.uniform(-0.5, 0.5, c).astype(np.float32)
    rm = r.uniform(-1.0, 1.0, c).astype(np.float32)
    rv = r.uniform(0.5, 2.0, c).astype(np.float32)
    g = r.randn(*shape).astype(np.float32)
    return x, w, b, rm, rv, g


def _flax(x, w, b, rm, rv, g, scale, momentum, eps, dtype):
    """Flax's train-mode BatchNorm on NHWC: y, the new statistics and the
    gradients (x, scale, bias), as NCHW numpy."""
    jd = jnp.dtype(dtype)
    mod = nn.BatchNorm(use_running_average=False, momentum=momentum,
                       epsilon=eps, use_scale=scale, dtype=jd)
    stats = {"mean": jnp.asarray(rm), "var": jnp.asarray(rv)}
    params = {"bias": jnp.asarray(b)}
    if scale:
        params["scale"] = jnp.asarray(w)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1), jd)

    def f(xj, params):
        return mod.apply({"params": params, "batch_stats": stats}, xj,
                         mutable=["batch_stats"])

    y, new = f(xj, params)
    _, pull = jax.vjp(lambda a, p: f(a, p)[0], xj, params)
    dx, dp = pull(jnp.asarray(g.transpose(0, 2, 3, 1), jd))
    nchw = lambda t: np.asarray(t, np.float32).transpose(0, 3, 1, 2)  # noqa
    return dict(y=nchw(y), mean=np.asarray(new["batch_stats"]["mean"]),
                var=np.asarray(new["batch_stats"]["var"]), dx=nchw(dx),
                dw=np.asarray(dp["scale"]) if scale else None,
                db=np.asarray(dp["bias"]))


def _port(x, w, b, rm, rv, g, scale, momentum, eps, dtype):
    td = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(td).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True) if scale else None
    bt = torch.from_numpy(b).requires_grad_(True)
    y, nm, nv = BN.BatchNormTrain.apply(xt, wt, bt, torch.from_numpy(rm),
                                    torch.from_numpy(rv), momentum, eps)
    y.backward(torch.from_numpy(g).to(td))
    f = lambda t: t.detach().float().numpy()  # noqa: E731
    return dict(y=f(y), mean=f(nm), var=f(nv), dx=f(xt.grad),
                dw=f(wt.grad) if scale else None, db=f(bt.grad),
                y_dtype=y.dtype, dx_dtype=xt.grad.dtype)


def _float64(x, w, b, rm, rv, g, scale, momentum, eps):
    """The same layer in float64 numpy: y, the new statistics and the
    gradients."""
    x, g = x.astype(np.float64), g.astype(np.float64)
    w = w.astype(np.float64) if scale else np.ones_like(b, np.float64)
    ax, ch = (0, 2, 3), (1, -1, 1, 1)
    mean, var = x.mean(ax), x.var(ax)
    inv = 1.0 / np.sqrt(var + eps)
    xhat = (x - mean.reshape(ch)) * inv.reshape(ch)
    n = x.size // x.shape[1]
    dx = (w * inv).reshape(ch) * (g - g.mean(ax).reshape(ch) - xhat * (
        (g * xhat).sum(ax) / n).reshape(ch))
    return dict(y=xhat * w.reshape(ch) + b.reshape(ch),
                mean=momentum * rm + (1 - momentum) * mean,
                var=momentum * rv + (1 - momentum) * var, dx=dx,
                dw=(g * xhat).sum(ax) if scale else None, db=g.sum(ax))


def _close(got, want, rtol, atol_of_max):
    """|got − want| ≤ rtol·|want| + atol_of_max·max|want|."""
    bound = rtol * np.abs(want) + atol_of_max * np.abs(want).max()
    assert np.all(np.abs(got - want) <= bound), float(
        np.max(np.abs(got - want) - bound))


@pytest.mark.parametrize("dtype,scale,momentum,eps", CASES)
def test_plain_matches_flax_train_mode(dtype, scale, momentum, eps):
    args = _inputs(SHAPE, seed=3)
    want = _flax(*args, scale, momentum, eps, dtype)
    got = _port(*args, scale, momentum, eps, dtype)
    assert got["y_dtype"] == got["dx_dtype"] == getattr(torch, dtype)
    one_step = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}.get(dtype,
                                                                  0.0)
    _close(got["y"], want["y"], 1e-5, 1e-5 + one_step)
    _close(got["mean"], want["mean"], 1e-5, 1e-6)
    _close(got["var"], want["var"], 1e-5, 1e-6)
    _close(got["dx"], want["dx"], 1e-4, 1e-5 + one_step)
    stat_tol = 4e-4 if dtype == "bfloat16" else 1e-4
    _close(got["db"], want["db"], 0.0, stat_tol)
    if scale:
        _close(got["dw"], want["dw"], 0.0, stat_tol)
    else:
        assert got["dw"] is None and want["dw"] is None
    if dtype == "float32":
        # the float64 sums leave the port within float32 rounding of the
        # float64 layer (flax's float32 sums sit farther away)
        exact = _float64(*args, scale, momentum, eps)
        for k in ("y", "mean", "var", "dx", "db") + (("dw",) if scale
                                                      else ()):
            _close(got[k], exact[k], 0.0, 1e-6)


def test_pooled_maps_match_flax():
    """(B, C, 1, 1): PSPNet's bins and DeepLab's image pooling; the
    kernels take these as rows of C values."""
    args = _inputs((8, 16, 1, 1), seed=5)
    want = _flax(*args, True, 0.99, 1e-3, "float32")
    got = _port(*args, True, 0.99, 1e-3, "float32")
    for k in ("y", "mean", "var"):
        _close(got[k], want[k], 1e-5, 1e-5)
    _close(got["dx"], want["dx"], 1e-4, 1e-5)
    _close(got["dw"], want["dw"], 0.0, 1e-4)
    _close(got["db"], want["db"], 0.0, 1e-4)


@pytest.mark.parametrize("scale", [True, False])
def test_gradcheck_in_float64(scale):
    r = np.random.RandomState(1)
    x = torch.from_numpy(3 + r.randn(3, 4, 5, 3)).requires_grad_(True)
    w = torch.from_numpy(r.uniform(0.5, 1.5, 4)).requires_grad_(True)
    b = torch.from_numpy(r.randn(4)).requires_grad_(True)
    rm, rv = torch.zeros(4, dtype=torch.float64), torch.ones(
        4, dtype=torch.float64)

    def f(x, w, b):
        return BN.BatchNormTrain.apply(x, w if scale else None, b, rm, rv, 0.9,
                                   1e-5)[0]

    assert torch.autograd.gradcheck(f, (x, w, b) if scale else
                                    (x, w.detach(), b))


def test_layer_keeps_flax_rules_and_launches_nothing_on_the_cpu():
    """The module: train mode leaves the blended statistics in
    ``updated`` and the biased variance in them; eval mode normalises with
    the running statistics; a scale-free layer trains its bias; on the CPU
    no kernel launches."""
    K.reset_launches()
    x = torch.from_numpy(_inputs((4, 3, 6, 5), 2)[0]).requires_grad_(True)
    for scale in (True, False):
        bn = BN.BatchNorm(3, 0.9, 1e-5, scale=scale)
        y = bn(x, train=True)
        y.pow(2).sum().backward()
        mean, var = bn.updated
        xd = x.detach().double()
        torch.testing.assert_close(mean, (0.1 * xd.mean((0, 2, 3))).float())
        torch.testing.assert_close(
            var, (0.9 + 0.1 * xd.var((0, 2, 3), unbiased=False)).float())
        assert bn.bias.grad is not None and bool(bn.bias.grad.abs().sum())
        assert (bn.weight is None) == (not scale)
        with torch.no_grad():
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)
        ev = bn(x.detach(), train=False)
        want = (x.detach() - mean.view(1, 3, 1, 1)) / torch.sqrt(
            var.view(1, 3, 1, 1) + 1e-5)
        torch.testing.assert_close(ev, want, rtol=1e-5, atol=1e-5)
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def test_a_tensor_off_the_cpu_never_takes_the_plain_version():
    """A wrapper runs its plain version only for a CPU tensor: any other
    device goes to the kernel, which refuses what is not on a card."""
    x = torch.empty((2, 3, 4, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        BN.bn_stats(x)
    with pytest.raises(ValueError, match="CUDA"):
        BN.bn_grad_apply(x, x, x, x, x, x, None)


# a card's values for the CPU (an H100 80GB HBM3's SM count, resident
# blocks and clusters of 1, 2, 4 and 8 blocks, as the occupancy API gives
# them there), per kernel, and a smaller card's (fewer SMs and blocks)
CARDS = {"bn_stats": BN.Card(132, 4, 8, (528, 264, 124, 62)),
         "bn_apply": BN.Card(132, 4, 1, (528,)),
         "bn_grad_stats": BN.Card(132, 4, 8, (528, 264, 124, 62))}
SMALL_CARDS = {"bn_stats": BN.Card(114, 3, 8, (342, 171, 84, 42)),
               "bn_apply": BN.Card(114, 3, 1, (342,)),
               "bn_grad_stats": BN.Card(114, 3, 8, (342, 171, 84, 42))}
GEO_KERNELS = ("bn_stats", "bn_apply", "bn_grad_stats", "bn_grad_apply")
GEO_CASES = [
    ((16, 64, 256, 256), "channels_last", torch.bfloat16),
    ((16, 64, 256, 256), "nchw", torch.bfloat16),
    ((16, 512, 16, 16), "channels_last", torch.float32),
    ((16, 512, 16, 16), "nchw", torch.float32),
    ((2, 40, 9, 7), "channels_last", torch.bfloat16),
    ((2, 40, 9, 8), "nchw", torch.float16),
    ((3, 5, 7, 9), "nchw", torch.float32),
    ((8, 2048, 1, 1), "nchw", torch.float32),
    ((1, 3, 1, 1), "nchw", torch.float64),
    # the train step's other maps (Unet-resnet34 512² B16, bf16)
    ((16, 64, 128, 128), "channels_last", torch.bfloat16),
    ((16, 128, 64, 64), "channels_last", torch.bfloat16),
    ((16, 256, 32, 32), "channels_last", torch.bfloat16),
    ((16, 32, 256, 256), "channels_last", torch.bfloat16),
    ((16, 16, 512, 512), "channels_last", torch.bfloat16),
    # small maps (direct loads: 13 and 2 images, 17 tiles, the last
    # ragged), through the ring clusters with blocks past the map (313 of
    # 320 slices of bn_stats) and one cluster covering a tile (planes)
    ((13, 64, 16, 16), "channels_last", torch.bfloat16),
    ((2, 64, 16, 16), "channels_last", torch.bfloat16),
    ((4, 1040, 8, 8), "channels_last", torch.bfloat16),
    ((16, 512, 16, 16), "channels_last", torch.bfloat16),
    ((1, 128, 200, 200), "channels_last", torch.bfloat16),
    ((1, 16, 256, 256), "nchw", torch.bfloat16),
]


def _geometries(shape, layout, dtype, cards=CARDS):
    x = torch.empty(shape, dtype=dtype, device="meta")
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    return x, BN._new_geometry(x, True, lambda k, *_: cards[k])


def _ids(v):
    return "x".join(map(str, v)) if isinstance(v, tuple) else str(v)


@pytest.mark.parametrize("shape,layout,dtype", GEO_CASES, ids=_ids)
def test_launch_geometry_covers_every_value_once(shape, layout, dtype):
    """The kernels' grids (``_plan`` and ``_plan_grad_apply``, from
    ``_new_geometry``'s layout) on the train shapes and the edges: the
    slices cover every row or value of a tile once, in bulk pieces or
    vectors that never straddle a plane or a row's channels; rows' tiles
    hold whole vectors and at most 512 channels through the ring (256 in
    float64), 64 in the direct mode, 256 one value at a time, and
    bn_grad_apply keeps its first design's tiles of at most 32 vector
    columns, at most 65535 of them or of channels."""
    x, geos = _geometries(shape, layout, dtype)
    b, c, h, w = shape
    v = 16 // x.element_size()
    for kernel, geo in zip(GEO_KERNELS, geos[:4]):
        (code, rows, outer, inner, span, c2, slices, tw, mode, cluster,
         items) = geo
        vec = int(mode != 0)
        assert c2 == c and code == BN._DTYPES[dtype]
        assert rows == int(layout == "channels_last" or h * w == 1)
        vv = v if vec else 1
        if rows:
            assert (outer, inner) == (b * h * w, 1) and c % vv == 0
            length = outer
        else:
            assert (outer, inner) == (b, h * w) and inner % vv == 0
            assert span % vv == 0
            length = outer * inner
        filled = -(-length // span)
        assert (filled - 1) * span < length <= filled * span
        if kernel == "bn_grad_apply":
            assert slices == filled and cluster == 1
            if rows:
                assert tw % vv == 0 and 1 <= tw // vv <= 32
                assert tw // vv == min(c // vv, 32)
                assert items == -(-(c // vv) // (tw // vv)) <= 65535
            else:
                assert tw == 0 and items == c <= 65535
            continue
        assert slices % cluster == 0 and slices - filled < cluster
        assert mode == BN._mode(kernel, rows, outer, c, inner,
                                x.element_size(), (c if rows else inner)
                                % v == 0)
        if rows:
            most = {0: 256, 1: 256 * (2 if x.element_size() <= 4 else 1),
                    2: 64}[mode]
            assert tw == min(c, most) and tw % vv == 0
        else:
            assert tw == 0
    assert geos[4] == max(geos[0][6] // geos[0][9], geos[2][6] // geos[2][9])


@pytest.mark.parametrize("shape,layout,dtype", GEO_CASES, ids=_ids)
def test_cluster_partition_covers_every_slice_once_in_rank_order(
        shape, layout, dtype):
    """The reductions' and bn_apply's grids: block (s, y) of a cluster of
    ``cluster`` blocks along x is rank s % cluster of cluster s //
    cluster, and takes slice s of tiles y, y + items, …; the slices of a
    tile, in block order (clusters in order, ranks in order), cover its
    rows or values once and in order, every tile is walked by one grid
    row, and no axis, cluster or wave exceeds the card: at most 8 blocks a
    cluster (portable), 65535 grid rows, one wave of resident blocks
    (clusters) on the card, and partial sums for every cluster of a
    tile."""
    x, geos = _geometries(shape, layout, dtype)
    for kernel, geo in zip(GEO_KERNELS[:3], geos[:3]):
        (_, rows, outer, inner, span, c, slices, tw, mode, cluster,
         items) = geo
        card = CARDS[kernel]
        assert cluster in (1, 2, 4, 8) and cluster <= card.cluster
        assert mode != BN._DIRECT or cluster == 1
        assert 1 <= items <= 65535 and slices % cluster == 0
        # one wave: the clusters of this size the card holds at once
        assert slices * items <= cluster * card.clusters[
            cluster.bit_length() - 1]
        length = outer if rows else outer * inner
        tiles = -(-c // tw) if rows else c
        walked = sorted(t for y in range(items)
                        for t in range(y, tiles, items))
        assert walked == list(range(tiles))
        covered = 0
        for k in range(slices // cluster):
            for rank in range(cluster):
                s = k * cluster + rank
                u0, u1 = min(length, s * span), min(length, (s + 1) * span)
                assert u0 == covered
                covered = u1
        assert covered == length
        if kernel != "bn_apply":
            assert geos[4] >= slices // cluster
        if mode == BN._RING and not rows:
            _check_plane_stages(x, inner, length, slices,
                                2 if kernel != "bn_stats" else 1)


@pytest.mark.parametrize("shape,layout,dtype", GEO_CASES, ids=_ids)
def test_partition_depends_on_the_shape_alone(shape, layout, dtype):
    """Each sum's order (the span, slices, tile width, mode and cluster of
    the reductions and bn_apply) is the same on a smaller card; the card
    sets only the tiles on the grid at once, at most its wave's worth
    where a tile's slices fit in a wave."""
    _, geos = _geometries(shape, layout, dtype)
    _, small = _geometries(shape, layout, dtype, SMALL_CARDS)
    assert small[4] == geos[4]
    for kernel, geo, other in zip(GEO_KERNELS[:3], geos[:3], small[:3]):
        assert other[:10] == geo[:10]
        slices, cluster, items = other[6], other[9], other[10]
        tiles = -(-other[5] // other[7]) if other[1] else other[5]
        wave = cluster * SMALL_CARDS[kernel].clusters[
            cluster.bit_length() - 1]
        assert 1 <= items <= tiles
        assert items == 1 or slices * items <= wave


# the train step's maps (Unet-resnet34 512² B16, bf16, channels-last) and
# the phase's other cases: the mode each kernel reads its map in
MODES = [
    ((16, 64, 256, 256), "channels_last", torch.bfloat16, "RRR"),
    ((16, 64, 128, 128), "channels_last", torch.bfloat16, "RRR"),
    ((16, 128, 64, 64), "channels_last", torch.bfloat16, "RDR"),
    ((16, 256, 32, 32), "channels_last", torch.bfloat16, "DDD"),
    ((16, 512, 16, 16), "channels_last", torch.bfloat16, "DDD"),
    ((16, 32, 256, 256), "channels_last", torch.bfloat16, "RRR"),
    ((16, 16, 512, 512), "channels_last", torch.bfloat16, "RRR"),
    ((16, 512, 16, 16), "channels_last", torch.float32, "DDD"),
    ((16, 512, 16, 16), "nchw", torch.float32, "RRR"),
    ((16, 64, 256, 256), "nchw", torch.bfloat16, "RDD"),
    ((16, 64, 256, 256), "channels_last", torch.float32, "RRR"),
    ((2, 3, 16, 16), "channels_last", torch.bfloat16, "VVV"),
]


@pytest.mark.parametrize("shape,layout,dtype,modes", MODES, ids=_ids)
def test_small_maps_and_wide_planes_take_the_direct_mode(shape, layout,
                                                         dtype, modes):
    """``bn_stats``, ``bn_apply`` and ``bn_grad_stats`` read a map
    through the ring (R) where it is large, with 16-byte loads straight
    from device memory (D) where a channels-last map is small or a plane
    wide, one value at a time (V) where vectors do not fit."""
    _, geos = _geometries(shape, layout, dtype)
    code = {BN._RING: "R", BN._DIRECT: "D", BN._PER_VALUE: "V"}
    assert "".join(code[g[8]] for g in geos[:3]) == modes


def _check_plane_stages(x, inner, length, slices, tensors):
    """The bulk-copy path's stages of a channel's planes (``stages_of`` in
    ``csrc/batchnorm.cu``): block s of ``slices`` takes stages s, s +
    slices, …; each stage holds whole 16-byte vectors, fits a ring slot
    (8192 bytes over the tensors it streams) and spans at most 32 runs of
    H·W (one bulk copy each); together they cover the channel once."""
    elems = 8192 // tensors // x.element_size()
    v = 16 // x.element_size()
    step = elems if inner * 31 >= elems else 31 * inner
    starts = list(range(0, length, step))
    owners = [q % slices for q in range(len(starts))]
    assert sorted(set(owners)) == list(range(min(slices, len(starts))))
    for u in starts:
        e = min(length, u + step)
        assert u % v == 0 and e % v == 0 and e - u <= elems
        assert (e - 1) // inner - u // inner + 1 <= 32
