"""The port's HDF5 reader (``utils/hdf5.py``) against h5py, and the Keras
``.h5`` writer of ``chip_smoke.py`` against both.

Every file is written here, in ``tmp_path``, by h5py (under its default
``libver="earliest"``, superblock 0 and version 1 object headers, and
under ``libver="latest"``, superblock 3, version 2 headers, link and
attribute messages, dense storage past 8 links or attributes) or by the
writer.  Tolerance 0 throughout: every attribute and dataset the reader
returns has h5py's type, dtype, shape and bytes, and ``read_h5_weights``
returns the JAX package's layers and weights in the same order.  The
refused features each raise ``PretrainedWeightsError`` naming what the
reader met.
"""

import functools
import importlib.util
from pathlib import Path

import h5py
import numpy as np
import pytest

from segmentation_training_pipeline_tpu.models import keras_h5 as JK
from segmentation_training_pipeline_tpu_torch.models import keras_h5 as TK
from segmentation_training_pipeline_tpu_torch.models.pretrained import (
    PretrainedWeightsError)
from segmentation_training_pipeline_tpu_torch.utils import hdf5

from torch_port_util import few_torch_threads  # noqa: F401

LIBVERS = ["earliest", "latest"]
DTYPES = ["f2", "f4", "f8", "i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8"]


@functools.lru_cache(maxsize=1)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def assert_same(want, got, where):
    """h5py's value and the reader's: same type, dtype, shape and bytes
    (object arrays of ``str``: the same strings)."""
    assert type(got) is type(want), (where, type(want), type(got))
    if isinstance(want, str):
        assert got == want, where
        return
    want, got = np.asarray(want), np.asarray(got)
    assert (got.dtype, got.shape) == (want.dtype, want.shape), where
    if want.dtype == object:
        assert got.tolist() == want.tolist(), where
    else:
        assert got.tobytes() == want.tobytes(), where


def assert_reads_as_h5py(path):
    """Every group, attribute and dataset of ``path`` as h5py reads it."""
    with h5py.File(path, "r") as want, hdf5.File(str(path)) as got:
        def walk(w, g, where):
            assert sorted(g.attrs) == sorted(w.attrs), where
            for k in w.attrs:
                assert_same(w.attrs[k], g.attrs[k], f"{where}@{k}")
            for k in w:
                assert k in g, (where, k)
                if isinstance(w[k], h5py.Group):
                    walk(w[k], g[k], f"{where}{k}/")
                else:
                    assert_same(np.asarray(w[k]), g[k], where + k)
        walk(want, got, "/")


def _string_attrs(f):
    f.attrs["fixed"] = np.array([b"ab", b"cde", b""])
    f.attrs["fixed_scalar"] = np.bytes_(b"tensorflow")
    f.attrs["fixed_2d"] = np.array([[b"a", b"bb"], [b"ccc", b"d"]])
    f.attrs["vlen"] = ["x", "yy", "", "über"]
    f.attrs["vlen_scalar"] = "2.2.4"
    f.attrs["vlen_bytes"] = b"stored as a variable-length string"
    scalar, pair = h5py.h5s.create(h5py.h5s.SCALAR), \
        h5py.h5s.create_simple((2,))
    for name, pad, space, value in [
            (b"space_padded", h5py.h5t.STR_SPACEPAD, pair,
             np.array([b"ab    ", b"abcdef"], "S6")),
            (b"null_terminated", h5py.h5t.STR_NULLTERM, pair,
             np.array([b"ab\0cd\0", b"abcdef"], "S6")),
            (b"null_padded", h5py.h5t.STR_NULLPAD, scalar,
             np.array(b"ab\0cd\0", "S6")),
            (b"space_scalar", h5py.h5t.STR_SPACEPAD, scalar,
             np.array(b"xy  ", "S4"))]:
        tid = h5py.h5t.C_S1.copy()
        tid.set_size(value.dtype.itemsize)
        tid.set_strpad(pad)
        h5py.h5a.create(f.id, name, tid, space).write(value)


def _numbers(f):
    r = np.random.RandomState(0)
    for d in DTYPES:
        for order in "<>":
            dt = np.dtype(order + d)
            f.create_dataset(f"{order}{d}", data=(r.randn(3, 5) * 90)
                             .astype(dt))
            f.attrs[f"a{order}{d}"] = (r.randn(4) * 90).astype(dt)
            f.attrs[f"s{order}{d}"] = dt.type(7)
    f.create_dataset("zero_d", data=np.float64(3.25))
    f.create_dataset("big_endian_zero_d", data=np.array(-2, ">i4"))
    f.create_dataset("empty", data=np.zeros((0, 3), "f4"))
    f.create_dataset("empty_int", data=np.zeros((0,), ">i8"))


def _layouts(f):
    r = np.random.RandomState(1)
    f.create_dataset("contiguous", data=r.randn(7, 3, 2).astype("f4"))
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    for name, arr in [("compact", np.arange(10, dtype=">i2")),
                      ("compact_2d", r.randn(4, 5).astype("f8"))]:
        did = h5py.h5d.create(f.id, name.encode(),
                              h5py.h5t.py_create(arr.dtype),
                              h5py.h5s.create_simple(arr.shape), dcpl=dcpl)
        did.write(h5py.h5s.ALL, h5py.h5s.ALL, arr)


def _chunked(f):
    r = np.random.RandomState(2)
    # 100 chunks: more than one v1 B-tree node (64 entries) holds
    f.create_dataset("deflate_shuffle_fletcher32",
                     data=r.randn(100, 90).astype("f4"), chunks=(10, 9),
                     compression="gzip", shuffle=True, fletcher32=True)
    f.create_dataset("edges", data=r.randn(33, 7).astype(">f8"),
                     chunks=(4, 4))
    f.create_dataset("deflate_ints", data=np.arange(5000, dtype="i2"),
                     chunks=(128,), compression=9)
    part = f.create_dataset("partly_written", shape=(40, 40), chunks=(8, 8),
                            dtype="i4", fillvalue=-1)
    part[3:11, 20:30] = 5


def _unallocated(f):
    f.create_dataset("filled", shape=(4, 3), dtype="f4", fillvalue=2.5)
    f.create_dataset("default_fill", shape=(6,), dtype=">i2")


def _unallocated_chunks(f):
    f.create_dataset("no_chunk", shape=(20, 20), chunks=(5, 5), dtype="f8",
                     fillvalue=-0.5)


def _nested(f):
    r = np.random.RandomState(3)
    g = f.create_group("a/b/c")
    g.attrs["weight_names"] = np.array([b"conv0/kernel:0", b"conv0/bias:0"])
    g.create_dataset("conv0/kernel:0", data=r.randn(3, 3, 2, 4).astype("f4"))
    g.create_dataset("conv0/bias:0", data=r.randn(4).astype("f4"))
    f["a"].attrs["depth"] = np.int32(1)
    f.create_dataset("a/b/d", data=np.arange(3.0))


def densenet_names(n):
    """``n`` layer names of densenet201's lengths (``conv5_block32_1_bn``,
    ``conv4_block48_0_relu``, …)."""
    kinds = ["0_bn", "0_relu", "1_conv", "1_bn", "1_relu", "2_conv",
             "concat"]
    return [f"conv{4 + i // 400}_block{i // 7 + 1}_{kinds[i % 7]}"
            for i in range(n)]


def _big_group(f):
    names = densenet_names(600)
    f.attrs["layer_names"] = np.array([n.encode() for n in names])
    for i in range(11):
        f.attrs[f"extra{i}"] = np.arange(i + 1, dtype="f4")
    for i, name in enumerate(names):
        g = f.create_group(name)
        weights = [f"{name}/gamma:0"] if i % 3 == 0 else []
        g.attrs["weight_names"] = np.array([w.encode() for w in weights],
                                           dtype="S40")
        for w in weights:
            g.create_dataset(w, data=np.full(2, i, "f4"))


def _full_model(f):
    r = np.random.RandomState(4)
    f.attrs["keras_version"] = b"2.1.5"
    f.attrs["backend"] = b"tensorflow"
    f.attrs["model_config"] = '{"class_name": "Model", "config": ' + \
        "[" + ", ".join(f'{{"name": "layer_{i}"}}' for i in range(3000)) + \
        "]}"
    w = f.create_group("model_weights")
    names = ["entry_flow_conv1_1", "entry_flow_conv1_1_BN", "activation_1",
             "concat_projection", "logits_semantic"]
    w.attrs["layer_names"] = np.array([n.encode() for n in names])
    w.attrs["backend"] = b"tensorflow"
    for name in names:
        g = w.create_group(name)
        shapes = ({"kernel": (3, 3, 3, 4)} if "BN" not in name else
                  {"gamma": (4,), "beta": (4,), "moving_mean": (4,),
                   "moving_variance": (4,)})
        if name == "activation_1":
            shapes = {}
        g.attrs["weight_names"] = np.array(
            [f"{name}/{k}:0".encode() for k in shapes], dtype="S40")
        for k, shape in shapes.items():
            g.create_dataset(f"{name}/{k}:0",
                             data=r.randn(*shape).astype("f4"))
    o = f.create_group("optimizer_weights")
    o.attrs["weight_names"] = np.array([b"training/Adam/Variable:0"])
    o.create_dataset("training/Adam/Variable:0", data=np.zeros(3, "f4"))


CASES = {"strings": _string_attrs, "numbers": _numbers,
         "layouts": _layouts, "unallocated": _unallocated,
         "nested": _nested, "big_group": _big_group,
         "full_model": _full_model}
# chunked datasets under "latest" use v4 indexes: refusal cases
EARLIEST_ONLY = {"chunked": _chunked,
                 "unallocated_chunks": _unallocated_chunks}


@pytest.mark.parametrize("case,libver", [
    (case, libver) for case in sorted(CASES) for libver in LIBVERS]
    + [(case, "earliest") for case in sorted(EARLIEST_ONLY)])
def test_reader_matches_h5py(case, libver, tmp_path):
    path = tmp_path / f"{case}.h5"
    with h5py.File(path, "w", libver=libver) as f:
        {**CASES, **EARLIEST_ONLY}[case](f)
    assert_reads_as_h5py(path)


@pytest.mark.parametrize("libver", LIBVERS)
def test_read_h5_weights_matches_jax_in_order(libver, tmp_path):
    """The Keras layout, full-model and weights-only, through both
    packages' ``read_h5_weights``: the same layers and weights, in the
    order of ``layer_names`` and ``weight_names``, the layer without
    weights dropped."""
    for writer, n_layers in ((_full_model, 4), (_big_group, 200)):
        path = str(tmp_path / f"{writer.__name__}.h5")
        with h5py.File(path, "w", libver=libver) as f:
            writer(f)
        want, got = JK.read_h5_weights(path), TK.read_h5_weights(path)
        assert list(got) == list(want) and len(got) == n_layers
        for name in want:
            assert list(got[name]) == list(want[name])
            for k in want[name]:
                assert_same(want[name][k], got[name][k], f"{name}/{k}")


def _user_block(path):
    with h5py.File(path, "w", userblock_size=1024) as f:
        _nested(f)


def _sizes(offsets, lengths):
    def write(path):
        fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
        fcpl.set_sizes(offsets, lengths)
        fid = h5py.h5f.create(str(path).encode(), h5py.h5f.ACC_TRUNC,
                              fcpl=fcpl)
        with h5py.File(fid) as f:
            _string_attrs(f)
            _chunked(f)
            _nested(f)
    return write


def _superblock_2(path):
    with h5py.File(path, "w", libver=("v108", "v108")) as f:
        _string_attrs(f)
        _nested(f)


def _writer_superblock_1(path):
    _chip_smoke().write_h5(str(path), _chip_smoke().keras_tree(
        {"conv": {"kernel": np.ones((1, 1, 2, 2), "f4")}}), superblock=1)


@pytest.mark.parametrize("variant", ["user_block", "offsets_4_lengths_4",
                                     "offsets_4_lengths_8", "superblock_2",
                                     "superblock_1"])
def test_superblocks_and_sizes(variant, tmp_path):
    """Superblocks 1 and 2 (h5py writes 0 and 3 above), 4-byte offsets
    and lengths, a 1024-byte user block before the superblock."""
    write = {"user_block": _user_block,
             "offsets_4_lengths_4": _sizes(4, 4),
             "offsets_4_lengths_8": _sizes(4, 8),
             "superblock_2": _superblock_2,
             "superblock_1": _writer_superblock_1}[variant]
    path = tmp_path / "f.h5"
    write(path)
    at = 1024 if variant == "user_block" else 0
    data = path.read_bytes()
    assert data[at:at + 8] == b"\x89HDF\r\n\x1a\n"
    assert data[at + 8] == {"superblock_2": 2, "superblock_1": 1}.get(
        variant, 0)
    assert_reads_as_h5py(path)


def test_paths_and_attrs_api(tmp_path):
    path = tmp_path / "nested.h5"
    with h5py.File(path, "w") as f:
        _nested(f)
    with hdf5.File(str(path)) as f:
        assert "a/b/c" in f and "/a/b/d" in f and "a" in f
        assert "a/x" not in f and "a/b/d/e" not in f and "x/y" not in f
        assert isinstance(f["a"]["b/c"], hdf5.Group)
        got = f["a/b/c/conv0/bias:0"]
        assert got.dtype == np.float32 and got.shape == (4,)
        assert f["a"].attrs.get("depth") == 1
        assert f["a"].attrs.get("missing", []) == []
        with pytest.raises(KeyError):
            f["a/x"]
    got[0] = 1.0             # the arrays outlive the file and are writable


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

def _dataset_case(**kw):
    def write(f):
        f.create_dataset("x", data=np.arange(100.0), **kw)
    return write, lambda f: f["x"]


def _attr_case(value):
    def write(f):
        f.attrs["x"] = value
    return write, lambda f: f.attrs["x"]


def _array_type(f):
    tid = h5py.h5t.array_create(h5py.h5t.IEEE_F32LE, (3,))
    h5py.h5a.create(f.id, b"x", tid, h5py.h5s.create_simple((2,))).write(
        np.zeros((2, 3), "f4"), mtype=tid)


def _external(f):
    f.create_dataset("x", shape=(10,), dtype="f4",
                     external=[(str(Path(f.filename).with_suffix(".raw")),
                                0, 40)])


def _virtual(f):
    f.create_dataset("src", data=np.arange(4.0))
    layout = h5py.VirtualLayout(shape=(4,), dtype="f8")
    layout[:] = h5py.VirtualSource(f["src"])
    f.create_virtual_dataset("x", layout)


def _shared_type(f):
    f["t"] = np.dtype("<f4")
    f.create_dataset("x", data=np.zeros(3, "f4"), dtype=f["t"])


def _reference(f):
    f.create_group("g")
    f.attrs["x"] = f["g"].ref


REFUSED = {
    "lzf": (*_dataset_case(compression="lzf"), "lzf"),
    "scale-offset": (*_dataset_case(scaleoffset=2), "scale-offset"),
    "szip": (*_dataset_case(compression="szip"), "szip"),
    "v4 single chunk": (*_dataset_case(chunks=(100,)), "single chunk"),
    "v4 fixed array": (*_dataset_case(chunks=(10,)), "fixed array"),
    "v4 extensible array": (*_dataset_case(chunks=(10,), maxshape=(None,)),
                            "extensible array"),
    "compound": (*_attr_case(np.zeros(2, [("a", "f4"), ("b", "i4")])),
                 "compound"),
    "enum": (*_attr_case(np.array([True, False])), "enum"),
    "array": (_array_type, lambda f: f.attrs["x"], "array"),
    "reference": (_reference, lambda f: f.attrs["x"], "reference"),
    "vlen sequence": (*_attr_case(np.array(
        [np.arange(2), np.arange(3)], dtype=h5py.vlen_dtype("i8"))),
        "non-string variable-length"),
    "external storage": (_external, lambda f: f["x"], "external storage"),
    "virtual storage": (_virtual, lambda f: f["x"], "virtual storage"),
    "shared message": (_shared_type, lambda f: f["x"], "shared message"),
}
LATEST_ONLY = ("v4 single chunk", "v4 fixed array", "v4 extensible array")


@pytest.mark.parametrize("case", sorted(REFUSED) + ["truncated",
                                                    "not hdf5"])
def test_refusals_name_the_feature(case, tmp_path):
    path = tmp_path / "x.h5"
    if case == "truncated":
        with h5py.File(path, "w") as f:
            _numbers(f)
        data = path.read_bytes()
        path.write_bytes(data[:len(data) // 2])
        read, match = (lambda f: f["<f4"]), "truncated"
    elif case == "not hdf5":
        path.write_bytes(b"\x93NUMPY" + bytes(2000))
        read, match = (lambda f: f["x"]), "not an HDF5 file"
    else:
        write, read, match = REFUSED[case]
        with h5py.File(path, "w", libver="latest" if case in LATEST_ONLY
                       else "earliest") as f:
            write(f)
        with h5py.File(path, "r") as f:
            read(f)                    # h5py reads it
    with pytest.raises(PretrainedWeightsError, match=match):
        with hdf5.File(str(path)) as f:
            read(f)


def test_truncated_inside_the_data(tmp_path):
    """A file cut after its last header but inside a dataset's bytes, the
    end-of-file address patched to the cut: the read past the end is
    refused."""
    path = tmp_path / "x.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(1000.0))
    data = bytearray(path.read_bytes())
    cut = len(data) - 100
    data[40:48] = cut.to_bytes(8, "little")
    path.write_bytes(bytes(data[:cut]))
    with pytest.raises(PretrainedWeightsError, match="truncated"):
        with hdf5.File(str(path)) as f:
            f["x"]


# --------------------------------------------------------------------------
# the writer of chip_smoke.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("superblock", [0, 1])
@pytest.mark.parametrize("n_layers", [1, 8, 9, 300])
def test_writer_files_read_back(n_layers, superblock, tmp_path):
    """The writer's Keras files (up to 8 links a node, 32 nodes a B-tree
    node: 300 layers take 38 nodes and two B-tree levels) read back by
    h5py and by the reader equal to the written arrays, and through
    ``read_h5_weights`` in the written order."""
    cs = _chip_smoke()
    r = np.random.RandomState(n_layers)
    layers = {name: {"kernel": r.randn(3, 3, 2, 4).astype("f4"),
                     "bias": r.randn(4).astype("f4")}
              for name in densenet_names(n_layers)}
    meta = {"backend": np.bytes_(b"tensorflow"),
            "keras_version": np.bytes_(b"2.1.5")}
    path = tmp_path / "w.h5"
    size = cs.write_h5(str(path), ({"model_config": np.bytes_(b"{}" * 9000),
                                    **meta},
                                   {"model_weights": cs.keras_tree(layers,
                                                                   meta),
                                    "empty": ({}, {})}), superblock)
    assert size == path.stat().st_size
    assert path.read_bytes()[8] == superblock
    with h5py.File(path, "r") as f:
        assert f.attrs["model_config"] == b"{}" * 9000
        g = f["model_weights"]
        assert [n.decode() for n in g.attrs["layer_names"]] == list(layers)
        for name, ws in layers.items():
            for k, v in ws.items():
                got = np.asarray(g[f"{name}/{name}/{k}:0"])
                assert got.dtype == v.dtype and got.tobytes() == v.tobytes()
    assert_reads_as_h5py(path)
    got = TK.read_h5_weights(str(path))
    assert list(got) == list(layers)
    for name, ws in layers.items():
        assert list(got[name]) == list(ws)
        for k, v in ws.items():
            assert_same(v, got[name][k], f"{name}/{k}")


def test_writer_keras_layers_round_trip():
    """``keras_layers`` names and shapes a flat-named tree's layers as the
    converters read them, and ``keras_equal`` tells a changed bit."""
    cs = _chip_smoke()
    params = {"conv1": {"kernel": np.zeros((3, 3, 2, 4), "f4")},
              "sep_depthwise": {"kernel": np.zeros((3, 3, 1, 4), "f4")},
              "head": {"kernel": np.zeros((1, 1, 4, 2), "f4"),
                       "bias": np.zeros(2, "f4")},
              "bn": {"scale": np.zeros(4, "f4"), "bias": np.zeros(4, "f4")},
              "bn_data": {"bias": np.zeros(3, "f4")}}
    layers = cs.keras_layers(params, 0)
    assert {k: {w: v.shape for w, v in ws.items()}
            for k, ws in layers.items()} == {
        "conv1": {"kernel": (3, 3, 2, 4)},
        "sep_depthwise": {"depthwise_kernel": (3, 3, 4, 1)},
        "head": {"kernel": (1, 1, 4, 2), "bias": (2,)},
        "bn": {"gamma": (4,), "beta": (4,), "moving_mean": (4,),
               "moving_variance": (4,)},
        "bn_data": {"beta": (3,), "moving_mean": (3,),
                    "moving_variance": (3,)}}
    loaded = {k: dict(v) for k, v in params.items()}
    stats = {}
    for name, ws in layers.items():
        for k, v in ws.items():
            if k == "depthwise_kernel":
                loaded[name]["kernel"] = np.transpose(v, (0, 1, 3, 2))
            elif k in ("moving_mean", "moving_variance"):
                stats.setdefault(name, {})[
                    {"moving_mean": "mean", "moving_variance": "var"}[k]] = v
            else:
                loaded[name][{"gamma": "scale", "beta": "bias"}.get(k, k)] = v
    assert cs.keras_equal(loaded, stats, layers)
    stats["bn"]["var"] = stats["bn"]["var"].copy()
    stats["bn"]["var"].view(np.uint32)[0] ^= 1
    assert not cs.keras_equal(loaded, stats, layers)


def _fletcher32_loop(data):
    """libhdf5's ``H5_checksum_fletcher32`` as written there: 360-word
    blocks, each sum folded after a block and once more at the end."""
    s1 = s2 = i = 0
    n = len(data) // 2
    while n:
        t = min(n, 360)
        n -= t
        for _ in range(t):
            s1 += data[i] << 8 | data[i + 1]
            s2 += s1
            i += 2
        s1, s2 = (s1 & 0xFFFF) + (s1 >> 16), (s2 & 0xFFFF) + (s2 >> 16)
    if len(data) % 2:
        s1 += data[i] << 8
        s2 += s1
        s1, s2 = (s1 & 0xFFFF) + (s1 >> 16), (s2 & 0xFFFF) + (s2 >> 16)
    s1, s2 = (s1 & 0xFFFF) + (s1 >> 16), (s2 & 0xFFFF) + (s2 >> 16)
    return s2 << 16 | s1


@pytest.mark.parametrize("n", [0, 1, 2, 7, 720, 723, 5001])
@pytest.mark.parametrize("fill", ["random", "ones", "zeros"])
def test_fletcher32_matches_the_loop(n, fill):
    data = {"random": np.random.RandomState(n).randint(0, 256, n).astype(
        np.uint8).tobytes(), "ones": b"\xff" * n, "zeros": bytes(n)}[fill]
    assert hdf5._fletcher32(data) == _fletcher32_loop(data)
