"""Shared helpers of the torch-port parity tests (tests/test_torch_port_*).

The port's augmentation takes its random draws as an argument; JAX's
threefry bits cannot be reproduced in torch, so these helpers make the
draws with ``jax.random`` along the reference lowering's key schedule and
hand the same values to the port:

  * ``aug_fn``: one key per segment (lowering.py:313);
  * geo run: one key per op plus one (lowering.py:649); the flips and
    square-rot90 fast path splits the last one per op
    (``_apply_cheap_geo``); otherwise the last one draws the run's
    ``cval``;
  * Affine: 4 keys — scale, translate, rotate, shear (lowering.py:687);
  * Crop/CropAndPad/Pad: 4 keys, one per side; the fixed-size crops and
    pads: 2 keys, the x and y offsets; PiecewiseAffine and
    PerspectiveTransform: 2 keys, the scale and the normal draws of the
    control points or corners;
  * ElasticTransformation: 3 keys — alpha, sigma, field (lowering.py:812),
    the field key split into the x and y noise (warp.py:191-196);
  * Multiply: the segment key (lowering.py:1491-1494).

It also runs the reference's Pallas kernels in interpret mode inside the
full lowering (the pattern of tests/test_pallas_elastic.py:132-141), and
perturbs the BatchNorm statistics of a flax variables tree
(``perturbed_batch_stats``) so that a swapped mean and variance would show.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from segmentation_training_pipeline_tpu.ops.aug import fast_warp as JFW
from segmentation_training_pipeline_tpu.ops.aug import lowering as JL
from segmentation_training_pipeline_tpu.ops.aug import pallas_elastic as JPE
from segmentation_training_pipeline_tpu_torch.ops.aug import lowering as TL
from segmentation_training_pipeline_tpu_torch.ops.aug import warp as TW

CONFIG2_BLOCK = {
    "Fliplr": 0.5,
    "Affine": {"rotate": [-15, 15], "scale": [0.85, 1.15],
               "translate_percent": {"x": [-0.1, 0.1], "y": [-0.1, 0.1]}},
    "ElasticTransformation": {"alpha": [0, 40], "sigma": 6},
    "Multiply": [0.9, 1.1],
}


def interpret_kernels(monkeypatch):
    """Route the JAX lowering through its Pallas kernels, run in interpret
    mode on the CPU."""
    monkeypatch.setenv("STP_PALLAS_WARP", "1")
    monkeypatch.setenv("STP_PALLAS_ELASTIC", "1")
    warp, elastic = JFW.warp_joint_multipass, JPE.warp_elastic_joint
    monkeypatch.setattr(JFW, "warp_joint_multipass",
                        lambda *a, **kw: warp(*a, **{**kw,
                                                     "interpret": True}))
    monkeypatch.setattr(JPE, "warp_elastic_joint",
                        lambda *a, **kw: elastic(*a, **{**kw,
                                                        "interpret": True}))


def _t(v):
    return torch.from_numpy(np.array(v))


def _jax_rot90_k(k, args, b):
    """JAX's Rot90 k per image (``_apply_cheap_geo`` and the warp path
    draw alike)."""
    spec = args if args is not None else [0, 3]
    spec = spec.get("k") if isinstance(spec, dict) else spec
    if isinstance(spec, (list, tuple)) and len(spec) == 2:
        return jax.random.randint(k, (b,), int(spec[0]), int(spec[1]) + 1)
    if isinstance(spec, (list, tuple)):
        arr = jnp.asarray([int(v) for v in spec], jnp.int32)
        return arr[jax.random.randint(k, (b,), 0, len(spec))]
    return jnp.full((b,), int(spec), jnp.int32)


def _jax_geo_draw(seg, i, name, a, k, b, h, w):
    """One geometric op's draws from its key ``k``, as the reference's
    ``_make_geo_run`` splits and samples it."""
    if name in TL._FLIPS:
        return {"flip": jax.random.bernoulli(k, TL._flip_p(a), (b,))}
    if name == "rot90":
        return {"k": _jax_rot90_k(k, a, b)}
    if name == "affine":
        a = a or {}
        k1, k2, k3, k4 = jax.random.split(k, 4)
        sx, sy = JL._sample_xy(k1, a.get("scale"), b, 1.0)
        tkey = ("translate_percent" if "translate_percent" in a
                else "translate_px")
        tx, ty = JL._sample_xy(k2, a.get(tkey), b, 0.0)
        rot = JL._sample(k3, a.get("rotate"), b, 0.0)
        shear = a.get("shear")
        shx, shy = JL._sample_xy(k4, shear, b, 0.0)
        if not isinstance(shear, dict):
            shy = jnp.zeros_like(shy)
        return dict(sx=sx, sy=sy, tx=tx, ty=ty, rot=rot, shx=shx, shy=shy)
    if name in TL._CROPS:
        spec = (a["px"] if isinstance(a, dict) and "px" in a
                else JL._percent_arg(a, [0, 0.1]))
        return {side: JL._sample(kk, spec, b, 0.0) for side, kk in
                zip(("left", "right", "top", "bottom"),
                    jax.random.split(k, 4))}
    if name in TL._FIXED_SIZE:
        k1, k2 = jax.random.split(k)
        return {"ux": jax.random.uniform(k1, (b,)),
                "uy": jax.random.uniform(k2, (b,))}
    if name in ("piecewiseaffine", "perspectivetransform"):
        a = JL._bare(a, "scale")
        k1, k2 = jax.random.split(k)
        if name == "piecewiseaffine":
            shape = (b, 2, int(a.get("nb_rows", 4)), int(a.get("nb_cols", 4)))
            return {"scale": JL._sample(k1, a.get("scale", [0.01, 0.05]), b),
                    "coarse": jax.random.normal(k2, shape)}
        return {"scale": JL._sample(k1, a.get("scale", [0.0, 0.06]), b),
                "offsets": jax.random.normal(k2, (b, 4, 2))}
    a = a or {}
    k1, k2, k3 = jax.random.split(k, 3)
    radius, stride = seg.elastic[i]
    shape = TW.noise_shape(b, h, w, radius, stride)
    kx, ky = jax.random.split(k3)
    return dict(
        alpha=JL._sample(k1, a.get("alpha", 20.0), b),
        sigma=JL._sample(k2, a.get("sigma", 5.0), b),
        noise_x=jax.random.uniform(kx, shape, minval=-1.0, maxval=1.0),
        noise_y=jax.random.uniform(ky, shape, minval=-1.0, maxval=1.0))


def jax_draws(aug, key, b, h, w, c=3):
    """Draws for the port's ``aug`` (a ``lowering.Augmentation``) made with
    jax.random exactly as the reference lowering draws them from ``key``."""
    keys = jax.random.split(key, max(len(aug.segments), 1))
    out = []
    for seg, k in zip(aug.segments, keys):
        if not isinstance(seg, TL._GeoRun):
            mul = JL._sample_maybe_per_channel(k, seg.mul, b, c,
                                               seg.per_channel, 1.0)
            out.append({"mul": _t(mul)})
            continue
        gk = jax.random.split(k, len(seg.geo) + 1)
        if seg.is_cheap(h, w):
            gk = jax.random.split(gk[-1], len(seg.geo))
        draws = [_jax_geo_draw(seg, i, name, s.get("args"), gk[i], b, h, w)
                 for i, (s, name) in enumerate(zip(seg.geo, seg.names))]
        if seg.cval_spec is not None:
            draws.append({"cval": JL._sample(gk[-1], seg.cval_spec, b, 0.0)})
        out.append([{n: _t(v) for n, v in d.items()} for d in draws])
    return out


def blob_batch(b, h, w, seed=0):
    """uint8 noise images and one-channel float disc masks (few mask
    boundaries, as real masks)."""
    r = np.random.RandomState(seed)
    imgs = (r.rand(b, h, w, 3) * 255).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    masks = np.stack([
        (yy - h * (0.4 + 0.05 * i)) ** 2 + (xx - w * 0.35) ** 2
        < (min(h, w) / 4.0) ** 2 for i in range(b)])
    return imgs, masks[..., None].astype(np.float32)


def capture_drop_masks(store):
    """A ``flax.linen.intercept_methods`` context under which every
    training-mode ``DropPath`` of the JAX models draws its keep mask as
    the module itself does (one ``make_rng("dropout")``, a bernoulli) and
    records it in ``store`` under the port's module name, as a (B,) bool
    array; and every training-mode ``nn.Dropout`` too, under its flax path
    with "/" → ".", as a bool array of the input's shape (NHWC).  Works
    inside ``jit`` (the mask leaves through ``jax.debug.callback``); call
    ``jax.effects_barrier()`` before reading."""
    import flax.linen as fnn
    from segmentation_training_pipeline_tpu.models import layers as JLY

    def put(name, m):
        store[name] = np.asarray(m).reshape(-1).astype(bool)

    def put_full(name, m):
        store[name] = np.asarray(m).astype(bool)

    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, fnn.Dropout) and context.method_name == "__call__":
            return dropout(mod, next_fun, args, kwargs)
        if (not isinstance(mod, JLY.DropPath)
                or context.method_name != "__call__"):
            return next_fun(*args, **kwargs)
        x = args[0]
        det = kwargs.get("deterministic", args[1] if len(args) > 1 else True)
        if mod.rate == 0.0 or det:
            return next_fun(*args, **kwargs)
        keep = 1.0 - mod.rate
        mask = jax.random.bernoulli(mod.make_rng("dropout"), keep,
                                    (x.shape[0], 1, 1, 1))
        jax.debug.callback(lambda m, n=".".join(mod.path): put(n, m), mask)
        return x * mask.astype(x.dtype) / keep

    def dropout(mod, next_fun, args, kwargs):
        # flax's own Dropout.__call__, its draw recorded
        x = args[0]
        det = kwargs.get("deterministic")
        det = mod.deterministic if det is None else det
        if mod.rate == 0.0 or det or mod.broadcast_dims:
            return next_fun(*args, **kwargs)
        keep = 1.0 - mod.rate
        mask = jax.random.bernoulli(mod.make_rng(mod.rng_collection), keep,
                                    x.shape)
        jax.debug.callback(lambda m, n=".".join(mod.path): put_full(n, m),
                           mask)
        return jax.lax.select(mask, x / keep, jnp.zeros_like(x))

    return fnn.intercept_methods(intercept)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """At most 2 PyTorch intra-op threads while a port test module runs,
    restored after it.  The tier-1 command runs 6 pytest workers on one
    host; with PyTorch's default of a thread per core in each, their
    spin-waiting OpenMP threads oversubscribe the cores: six of the port's
    files took 557 s side by side at the default and 260 s with this
    fixture (6 workers, 8-core CPU host).  A module that imports this
    fixture uses it."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def private_native_library(tmp_path_factory):
    """The JAX package's native loader, built into a directory of this
    module's own and loaded in this process, whatever other processes do.

    ``native/build.py`` compiles ``libstploader.so`` next to its source
    when the file is absent (it is git-ignored), writing one shared
    ``libstploader.so.tmp``; several pytest workers building at once on a
    fresh tree race on that file, and a worker whose build failed keeps
    ``_TRIED`` set and no library for the rest of its run.  The fixture
    points the build at a private path, clears the module's cache and the
    JAX batcher's cached loader, builds, and restores all of it after the
    module.  It fails, and never skips, when the library does not load."""
    from segmentation_training_pipeline_tpu.data import batcher as JB
    from segmentation_training_pipeline_tpu.native import build as NB

    saved = NB._SO, NB._LIB, NB._TRIED, JB._NATIVE_LOADER
    NB._SO = str(tmp_path_factory.mktemp("native") / "libstploader.so")
    NB._LIB, NB._TRIED, JB._NATIVE_LOADER = None, False, None
    try:
        lib = NB.load_native_library()
        assert lib is not None, "the native loader did not build or load"
        yield lib
    finally:
        NB._SO, NB._LIB, NB._TRIED, JB._NATIVE_LOADER = saved


def random_weights(module, seed):
    """Fill every parameter of a port module from ``seed``, much faster
    than ``models.factory.init_model``'s truncated normals at ResNet-50
    size: conv kernels N(0, 1/fan_in), BatchNorm scales 1 + N(0, 0.1²),
    every bias N(0, 0.1²); running statistics 0 and 1 (see
    ``perturbed_batch_stats``).  Returns the module."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            r = torch.randn(p.shape, generator=gen)
            if p.dim() == 4:
                p.copy_(r / float(np.sqrt(p[0].numel())))
            elif name.endswith("weight"):
                p.copy_(1.0 + 0.1 * r)
            else:
                p.copy_(0.1 * r)
        for name, b in module.named_buffers():
            b.fill_(1.0 if name.endswith("running_var") else 0.0)
    return module


def perturbed_batch_stats(var, seed=1):
    """Seeded noise on the means and a positive factor on the variances."""
    r = np.random.RandomState(seed)

    def f(path, a):
        noise = r.randn(*a.shape).astype(np.float32)
        if path[-1].key == "var":
            return (a * np.exp(0.3 * noise)).astype(np.float32)
        return (a + 0.2 * noise).astype(np.float32)

    return {**var, "batch_stats": jax.tree_util.tree_map_with_path(
        f, var["batch_stats"])}
