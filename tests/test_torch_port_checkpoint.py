"""The port's checkpoints against the JAX package's, byte for byte.

The JAX package writes ``weights/best-{fold}.{stage}.weights`` with flax's
msgpack (``flax.serialization``); the port reads and writes the same format
with its own codec (``utils/msgpack_tree.py``), since neither flax nor
``msgpack`` may be imported by the port.  Here:

  * the codec gives ``msgpack.packb(..., strict_types=True)``'s bytes (with
    flax's ext hook for arrays) and ``unpackb``'s values, on trees with
    every type of the subset and f32, int32, uint8 and bfloat16 leaves;
  * a JAX-written Unet-resnet34 checkpoint (batch statistics perturbed, so
    that a swapped mean and variance would show) loads in the port bit for
    bit, and decoding then encoding it gives the file back byte for byte;
  * a port-written checkpoint loads in JAX's ``load_checkpoint`` bit for
    bit, and both packages write the same sidecar;
  * the sidecar's ``encoder_variant`` decides the graph; a file of another
    model raises.
"""

import json

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from segmentation_training_pipeline_tpu import config as JC
from segmentation_training_pipeline_tpu.models import factory as JF
from segmentation_training_pipeline_tpu.train import checkpoint as JCK
from segmentation_training_pipeline_tpu_torch import config as TC
from segmentation_training_pipeline_tpu_torch.models import bridge as BR
from segmentation_training_pipeline_tpu_torch.models import factory as TF
from segmentation_training_pipeline_tpu_torch.train import checkpoint as TCK
from segmentation_training_pipeline_tpu_torch.utils import msgpack_tree as MT
from torch_port_util import few_torch_threads, perturbed_batch_stats

H = 64
META = {"architecture": "Unet", "backbone": "resnet34", "fold": 0,
        "stage": 0, "epoch": 7, "best": np.float32(0.8125),
        "primary_metric": "val_dice", "encoder_variant": ""}


@pytest.fixture(scope="module")
def jax_vars():
    jm = JF.create_model("Unet", "resnet34", 1, dtype="float32")
    var = jax.tree.map(np.asarray, JF.init_model(jm, (H, H, 3), seed=0))
    return jm, perturbed_batch_stats(var)


def _bf16(a: np.ndarray):
    """The same bits as a jnp.bfloat16 numpy array and a torch tensor."""
    bits = (a.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
    return (bits.view(jnp.bfloat16),
            torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16))


def _trees(kind):
    """(numpy tree for msgpack, the same tree for the port)."""
    r = np.random.RandomState(7)
    if kind == "scalars":
        ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768,
                -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]
        t = {"none": None, "t": True, "f": False,
             "ints": {f"i{k}": v for k, v in enumerate(ints)},
             "strs": {f"s{n}": "é" * (n // 2) + "x" * (n % 2)
                      for n in (0, 31, 32, 255, 256, 65536)},
             "bins": {f"b{n}": bytes(r.randint(0, 256, n).astype(np.uint8))
                      for n in (0, 255, 256, 65536)},
             "": {}, "big": {str(k): k for k in range(70000)}}
        return t, t
    arrays = {
        "f32": r.randn(3, 5).astype(np.float32),
        "i32": r.randint(-2 ** 31, 2 ** 31 - 1, (4, 1, 2), dtype=np.int32),
        "u8": r.randint(0, 256, (17,), dtype=np.uint8),
        "scalar": np.array(2.5, np.float32),
        "empty": np.zeros((0, 3), np.float32),
        # payload lengths of 16 (fixext 16) and 256 (ext 16)
        "fix16": np.zeros((5,), np.uint8),
        "ext16": np.arange(244, dtype=np.uint8),
        "wide": r.randn(70, 1000).astype(np.float32),
    }
    jt = {"params": dict(arrays), "meta": {"n": 3}}
    tt = {"params": {k: torch.from_numpy(v.copy()) for k, v in
                     arrays.items()}, "meta": {"n": 3}}
    jt["params"]["bf16"], tt["params"]["bf16"] = _bf16(r.randn(6, 4))
    return jt, tt


def _same(a, b):
    """Port value ``a`` equals msgpack's ``b``, arrays bit for bit."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b)
        for k in b:
            _same(a[k], b[k])
    elif isinstance(b, np.ndarray):
        assert isinstance(a, torch.Tensor) and tuple(a.shape) == b.shape
        assert MT.DTYPES[b.dtype.name] == a.dtype
        assert a.reshape(-1).view(torch.uint8).numpy().tobytes() == \
            b.tobytes()
    else:
        assert type(a) is type(b) and a == b


@pytest.mark.parametrize("kind", ["scalars", "arrays"])
def test_codec_matches_msgpack(kind):
    jt, tt = _trees(kind)
    want = msgpack.packb(jt, default=serialization._msgpack_ext_pack,
                         strict_types=True)
    assert MT.packb(tt) == want
    if kind == "arrays":   # numpy leaves encode the same
        assert MT.packb({**tt, "params": {
            k: v for k, v in jt["params"].items()}}) == want
    back = MT.unpackb(want)
    _same(back, msgpack.unpackb(want,
                                ext_hook=serialization._msgpack_ext_unpack))
    assert MT.packb(back) == want


def test_codec_reads_chunked_leaves_and_refuses_to_write_them(monkeypatch):
    """flax splits a leaf over 2³⁰ bytes into chunks; the port joins them
    when reading and names the leaf when asked to write one."""
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 40)
    chunked = serialization.msgpack_serialize({"p": {"w": a}})
    assert b"__msgpack_chunked_array__" in chunked
    got = MT.unpackb(chunked)["p"]["w"]
    assert torch.equal(got, torch.from_numpy(a))
    monkeypatch.setattr(MT, "MAX_LEAF_BYTES", 40)
    with pytest.raises(ValueError, match="p/w"):
        MT.packb({"p": {"w": torch.from_numpy(a)}})


@pytest.mark.parametrize("bad", [
    {"x": 1.5}, {"x": (1, 2)}, {1: 2},
    {"x": torch.zeros(2, dtype=torch.complex64)}],
    ids=["float", "tuple", "int-key", "complex"])
def test_codec_refuses_what_flax_checkpoints_never_hold(bad):
    with pytest.raises(TypeError):
        MT.packb(bad)


def test_codec_refuses_other_ext_types_and_truncation():
    data = msgpack.packb({"x": msgpack.ExtType(2, b"ab")})
    with pytest.raises(ValueError, match="ext type 2"):
        MT.unpackb(data)
    good = MT.packb({"x": torch.ones(3)})
    with pytest.raises(ValueError, match="truncated"):
        MT.unpackb(good[:-1])


def _port_model(classes=1, backbone="resnet34"):
    return TF.create_model("Unet", backbone, classes, dtype="float32")


def test_jax_checkpoint_loads_in_port_bit_for_bit(jax_vars, tmp_path):
    _, var = jax_vars
    path = str(tmp_path / "weights" / "best-0.0.weights")
    JCK.save_checkpoint(path, var, META)
    model = _port_model()
    sd = TCK.load_checkpoint(path, model)
    want = BR.state_dict_from_jax(var)
    assert set(sd) == set(want) == set(model.state_dict())
    for k, v in want.items():
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k
        assert torch.equal(model.state_dict()[k], v), k
    raw = open(path, "rb").read()
    assert MT.packb(MT.unpackb(raw)) == raw
    assert TCK.checkpoint_meta(path) == JCK.checkpoint_meta(path)


def test_port_checkpoint_loads_in_jax_bit_for_bit(jax_vars, tmp_path):
    jm, var = jax_vars
    model = _port_model()
    model.load_state_dict(BR.state_dict_from_jax(var))
    path = str(tmp_path / "port.weights")
    TCK.save_checkpoint(path, model.state_dict(), META)
    got = JCK.load_checkpoint(path, JF.template_variables(jm, (H, H, 3)))
    assert jax.tree.structure(got) == jax.tree.structure(var)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(var)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    # keys written in jax.device_get's sorted order: the same file
    JCK.save_checkpoint(str(tmp_path / "jax.weights"), var)
    assert open(path, "rb").read() == open(tmp_path / "jax.weights",
                                           "rb").read()


def test_both_packages_write_the_same_sidecar(jax_vars, tmp_path):
    _, var = jax_vars
    model = _port_model()
    JCK.save_checkpoint(str(tmp_path / "j.weights"), var, META)
    TCK.save_checkpoint(str(tmp_path / "t.weights"), model.state_dict(),
                        META)
    j = open(tmp_path / "j.weights.json").read()
    assert open(tmp_path / "t.weights.json").read() == j
    assert json.loads(j)["best"] == 0.8125
    assert not list(tmp_path.glob("*.tmp"))


@pytest.mark.parametrize("sidecar,want", [
    (None, ""), ({"encoder_variant": ""}, ""),
    ({"encoder_variant": "keras-preact"}, "keras-preact"),
    ({"best": 0.5}, "")],
    ids=["none", "plain", "preact", "no-variant"])
def test_variant_follows_the_sidecar(tmp_path, monkeypatch, sidecar, want):
    """``encoder_weights`` on a pre-activation backbone implies the Keras
    graph only when the spec resolves to an ``.h5`` file; here
    ``imagenet`` resolves to nothing, so without a sidecar that records
    the variant both packages build the plain graph.  A sidecar that
    records it decides, and the ``keras-preact`` graph it pins builds."""
    monkeypatch.setenv("STP_PRETRAINED_DIR", str(tmp_path / "none"))
    d = {"architecture": "Unet", "backbone": "resnet34",
         "encoder_weights": "imagenet", "shape": [H, H, 3]}
    tcfg = TC.parse_dict(d, directory=str(tmp_path))
    jcfg = JC.parse_dict(d, directory=str(tmp_path))
    path = tcfg.weights_path(0, 0)
    TCK.save_checkpoint(path, {"b.bias": torch.zeros(1)}, sidecar)
    assert TF.variant_from_checkpoint(tcfg, [path]) == want
    assert JF.variant_from_checkpoint(jcfg, [path]) == want
    model = TF.model_from_config(tcfg, want)
    assert isinstance(model, TF.SegmentationModel)
    assert model.encoder_variant == want
    assert type(model.encoder).__name__ == (
        "PreactResNetEncoder" if want else "ResNetEncoder")


def _drop_leaf(var):
    params = {**var["params"], "logits_conv": {
        "kernel": var["params"]["logits_conv"]["kernel"]}}
    return {**var, "params": params}


@pytest.mark.parametrize("case", ["backbone", "missing", "shape"])
def test_a_file_of_another_model_raises(jax_vars, tmp_path, case):
    _, var = jax_vars
    path = str(tmp_path / "x.weights")
    if case == "backbone":
        TCK.save_checkpoint(path, _port_model(
            backbone="efficientnetb0").state_dict())
        exc, match = ValueError, "first differing leaf"
    elif case == "missing":
        JCK.save_checkpoint(path, _drop_leaf(var))
        exc, match = ValueError, "params/logits_conv/bias"
    else:
        TCK.save_checkpoint(path, _port_model(classes=2).state_dict())
        exc, match = RuntimeError, "size mismatch for logits_conv"
    with pytest.raises(exc, match=match):
        TCK.load_checkpoint(path, _port_model())
