"""The port's weight readers (``models/pretrained.py``, ``models/keras_h5.py``)
against the JAX package's, on the same files.

Each case builds the port model, takes its variables into the tree layout
of ``models/bridge.py`` (no JAX ``init``), writes a weights file in the
source's published naming with seeded random values of the encoder's
shapes, and loads it on both sides: every tensor of the result, encoder
BatchNorm statistics included, must be equal bit for bit (tolerance 0),
and so must the port model's state dict after ``load_into_model``.  The
torch-format files come from the writers of tests/test_pretrained.py and
the torch oracles of tests/torch_oracles.py; the Keras files from
tests/test_keras_h5.py's ``write_keras_h5`` and its exporters, or from
the encoder's own layer names.

Also: ``.npz`` in both directions, ``keras-preact`` chosen by the factory
and pinned by the sidecar, the aligned DeepLab head of a pascal_voc file,
the refusals, an f32 forward at 64² (within the model tests' 1e-4), and a
one-stage ``cfg.fit`` with ``encoder_weights`` against the JAX fit's first
epoch.
"""

import json
import os
import shutil

import numpy as np
import jax
import pytest
import torch

import test_keras_h5 as JKH
import test_pretrained as JTP
from torch_oracles import (TorchInceptionResNetV2, TorchInceptionV3,
                           TorchMobileNetV1, TorchResNet, TorchSENet154,
                           TorchXception, randomize_)

from segmentation_training_pipeline_tpu.models import factory as JF
from segmentation_training_pipeline_tpu.models import keras_h5 as JK
from segmentation_training_pipeline_tpu.models import pretrained as JP
from segmentation_training_pipeline_tpu_torch.models import bridge
from segmentation_training_pipeline_tpu_torch.models import encoders as TE
from segmentation_training_pipeline_tpu_torch.models import factory as TF
from segmentation_training_pipeline_tpu_torch.models import keras_h5 as TK
from segmentation_training_pipeline_tpu_torch.models import pretrained as TP

from torch_port_util import few_torch_threads, random_weights  # noqa: F401


@pytest.fixture(autouse=True)
def drop_weight_files(tmp_path):
    """Delete each test's files when it ends: a full-width weight file
    runs to 220 MB, and pytest keeps the temporary directories of its
    last three sessions."""
    yield
    for child in tmp_path.iterdir():
        if child.is_dir():
            shutil.rmtree(child, ignore_errors=True)
        else:
            child.unlink()


def port_model(backbone, arch="Unet", classes=1, seed=1, **kw):
    model = TF.create_model(arch, backbone, classes, dtype="float32", **kw)
    return random_weights(model, seed)


def tree_of(model):
    return bridge.jax_from_state_dict(model.state_dict())


def flat(tree):
    return bridge.flatten(tree)


def source_tree(tree, seed):
    """Random leaves of ``tree``'s shapes (positive variances)."""
    r = np.random.RandomState(seed)
    return {k: source_tree(v, r.randint(1 << 30)) if isinstance(v, dict)
            else (np.abs(r.randn(*v.shape)) + 0.1 if k == "var"
                  else r.randn(*v.shape)).astype(np.float32)
            for k, v in tree.items()}


def assert_same(want, got):
    fw, fg = flat(want), flat(got)
    assert set(fw) == set(fg)
    for k in fw:
        w, g = np.asarray(fw[k]), np.asarray(fg[k])
        assert w.dtype == g.dtype and w.shape == g.shape, k
        assert np.array_equal(w, g), k


def load_both(backbone, path, model):
    """JAX and port ``load_encoder_weights`` on one template; then the
    model loaded in place.  Returns the loaded tree."""
    tree = tree_of(model)
    want = JP.load_encoder_weights(backbone, path, tree)
    got = TP.load_encoder_weights(backbone, path, tree)
    assert_same(want, got)
    before, after = flat(tree["params"]["encoder"]), flat(
        want["params"]["encoder"])
    assert any(not np.array_equal(before[k], after[k]) for k in before)
    assert TP.load_into_model(model, backbone, path)
    sd = bridge.state_dict_from_jax(want)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    return want


def save_torch(path, state):
    torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in state.items()},
               path)
    return str(path)


def oracle_state(oracle, seed):
    randomize_(oracle, seed)
    return {k: v.numpy() for k, v in oracle.state_dict().items()}


# ---------------------------------------------------------------------------
# torch-format files, one name per family
# ---------------------------------------------------------------------------

def _resnet(enc_p, enc_s):
    return JTP._synthetic_torch_state(enc_p, enc_s, seed=3)


def _cadene_se18(enc_p, enc_s):
    state = oracle_state(TorchResNet(stage_sizes=(2, 2, 2, 2), se=True), 4)
    return {("layer0." + k if k.split(".")[0] in ("conv1", "bn1") else k): v
            for k, v in state.items()}


TORCH_CASES = {
    "resnet34": (_resnet, ".pt"),
    "resnet50": (_resnet, ".pth"),
    "resnext50": (_resnet, ".pt"),
    "seresnet18": (_cadene_se18, ".pt"),
    "senet154": (lambda p, s: oracle_state(
        TorchSENet154(stage_sizes=(1, 1, 1, 1)), 5), ".pt"),
    "efficientnetb0": (lambda p, s: JTP._synthetic_torch_effnet(p, 6), ".pt"),
    "mobilenetv2": (lambda p, s: JTP._synthetic_torch_mbv2(p, 7), ".pt"),
    "mobilenet": (lambda p, s: oracle_state(TorchMobileNetV1(), 8), ".pt"),
    "densenet121": (lambda p, s: JTP.TestDenseNetConvert
                    ._synthetic_torch_densenet(p, 9), ".pt"),
    "vgg16": (lambda p, s: JTP.TestVGGConvert._synthetic_torch_vgg(
        p, with_bn=True, seed=10), ".pt"),
    "vgg19": (lambda p, s: JTP.TestVGGConvert._synthetic_torch_vgg(
        p, with_bn=False, seed=11), ".pt"),
    "inceptionv3": (lambda p, s: oracle_state(TorchInceptionV3(), 12), ".pt"),
    "inceptionresnetv2": (lambda p, s: oracle_state(
        TorchInceptionResNetV2(), 13), ".pt"),
    "xception": (lambda p, s: oracle_state(TorchXception(), 14), ".pt"),
}


@pytest.fixture
def small_senet154(monkeypatch):
    """senet154 with one block per stage in the port's table (the oracle
    is built the same; the converter walks whatever depth the tree has)."""
    cls, kw = TE.ENCODERS["senet154"]
    monkeypatch.setitem(TE.ENCODERS, "senet154",
                        (cls, {**kw, "stage_sizes": (1, 1, 1, 1)}))


@pytest.mark.parametrize("backbone", sorted(TORCH_CASES))
def test_torch_format_matches_jax(backbone, tmp_path, small_senet154):
    write, ext = TORCH_CASES[backbone]
    model = port_model(backbone)
    tree = tree_of(model)
    state = write(tree["params"]["encoder"], tree["batch_stats"]["encoder"])
    path = save_torch(tmp_path / f"{backbone}{ext}", state)
    load_both(backbone, path, model)


def test_torch_format_lands_the_published_values(tmp_path):
    """resnet34: the loaded kernels are the file's, transposed OIHW → HWIO,
    and the statistics are the file's."""
    model = port_model("resnet34")
    tree = tree_of(model)
    state = _resnet(tree["params"]["encoder"], tree["batch_stats"]["encoder"])
    out = load_both("resnet34", save_torch(tmp_path / "r34.pt", state),
                    model)
    enc = out["params"]["encoder"]
    assert np.array_equal(enc["stem_conv"]["kernel"],
                          state["conv1.weight"].transpose(2, 3, 1, 0))
    assert np.array_equal(out["batch_stats"]["encoder"]["stage4_block3"]
                          ["bn2"]["var"], state["layer4.2.bn2.running_var"])
    assert np.array_equal(model.encoder.stem_conv.weight.detach().numpy(),
                          state["conv1.weight"])


def test_every_backbone_has_the_jax_torch_converter():
    for name in sorted(TE.ENCODERS):
        if name == "xception_aligned":
            for conv_for in (JP.torch_converter_for, TP.torch_converter_for):
                with pytest.raises(Exception, match="bonlime"):
                    conv_for(name)
            continue
        assert (TP.torch_converter_for(name).__name__
                == JP.torch_converter_for(name).__name__), name
        assert (TK.keras_converter_for(name).__name__
                == JK.keras_converter_for(name).__name__), name


# ---------------------------------------------------------------------------
# Keras .h5 files, every converter
# ---------------------------------------------------------------------------

def _bn_ws(name, p, s):
    ws = [(f"{name}/gamma:0", p["scale"])] if "scale" in p else []
    return (name, ws + [(f"{name}/beta:0", p["bias"]),
                        (f"{name}/moving_mean:0", s["mean"]),
                        (f"{name}/moving_variance:0", s["var"])])


def _conv_ws(name, sub, depthwise=False):
    k = sub["kernel"]
    key = "depthwise_kernel" if depthwise else "kernel"
    if depthwise:
        k = np.transpose(k, (0, 1, 3, 2))
    ws = [(f"{name}/{key}:0", k)]
    if "bias" in sub:
        ws.append((f"{name}/bias:0", sub["bias"]))
    return (name, ws)


def _flat_named(p, s, depthwise=lambda name: False):
    """Layers named as the encoder's submodules (preact, mobilenet v1, the
    aligned Xception and its DeepLab decoder)."""
    out = []
    for name, sub in p.items():
        if name.endswith("_se"):
            continue
        out.append(_conv_ws(name, sub, depthwise(name)) if "kernel" in sub
                   else _bn_ws(name, sub, s[name]))
    return out


def _h5_preact(p, s):
    layers = _flat_named(p, s)
    units = sorted((n for n in p if n.endswith("_se")),
                   key=lambda n: tuple(int(v) for v in
                                       n[5:-3].split("_unit")))
    convs = [p[n][part] for n in units for part in ("reduce", "expand")]
    for i, sub in enumerate(convs):
        layers.append(_conv_ws("conv2d" if i == 0 else f"conv2d_{i}", sub))
    return layers


def _h5_vgg(p, s):
    r = np.random.RandomState(21)
    layers = []
    for name in p:
        if "_conv" in name:
            st, c = name[len("stage"):].split("_conv")
            k = p[name]["kernel"]
            layers.append((f"block{st}_conv{c}", [
                (f"block{st}_conv{c}/kernel:0", k),
                (f"block{st}_conv{c}/bias:0",
                 r.randn(k.shape[-1]).astype(np.float32))]))
    return layers


def _h5_mobilenetv2(p, s):
    layers = [_conv_ws("Conv1", p["stem_conv"]),
              _bn_ws("bn_Conv1", p["stem_bn"], s["stem_bn"])]
    bi = 0
    while f"block{bi}" in p:
        bp, bs = p[f"block{bi}"], s[f"block{bi}"]
        pre = "expanded_conv" if bi == 0 else f"block_{bi}"
        if "expand" in bp:
            layers += [_conv_ws(f"{pre}_expand", bp["expand"]),
                       _bn_ws(f"{pre}_expand_BN", bp["expand_bn"],
                              bs["expand_bn"])]
        layers += [_conv_ws(f"{pre}_depthwise", bp["depthwise"], True),
                   _bn_ws(f"{pre}_depthwise_BN", bp["dw_bn"], bs["dw_bn"]),
                   _conv_ws(f"{pre}_project", bp["project"]),
                   _bn_ws(f"{pre}_project_BN", bp["project_bn"],
                          bs["project_bn"])]
        bi += 1
    return layers + [_conv_ws("Conv_1", p["head_conv"]),
                     _bn_ws("Conv_1_bn", p["head_bn"], s["head_bn"])]


def _h5_efficientnet(p, s):
    import re
    import string

    layers = [_conv_ws("stem_conv", p["stem_conv"]),
              _bn_ws("stem_bn", p["stem_bn"], s["stem_bn"])]
    for name in p:
        m = re.fullmatch(r"stage(\d+)_block(\d+)", name)
        if not m:
            continue
        pre = (f"block{int(m.group(1)) + 1}"
               f"{string.ascii_lowercase[int(m.group(2))]}")
        bp, bs = p[name], s[name]
        if "expand" in bp:
            layers += [_conv_ws(f"{pre}_expand_conv", bp["expand"]),
                       _bn_ws(f"{pre}_expand_bn", bp["expand_bn"],
                              bs["expand_bn"])]
        layers += [_conv_ws(f"{pre}_dwconv", bp["depthwise"], True),
                   _bn_ws(f"{pre}_bn", bp["dw_bn"], bs["dw_bn"]),
                   _conv_ws(f"{pre}_se_reduce", bp["se"]["reduce"]),
                   _conv_ws(f"{pre}_se_expand", bp["se"]["expand"]),
                   _conv_ws(f"{pre}_project_conv", bp["project"]),
                   _bn_ws(f"{pre}_project_bn", bp["project_bn"],
                          bs["project_bn"])]
    return layers + [_conv_ws("top_conv", p["head_conv"]),
                     _bn_ws("top_bn", p["head_bn"], s["head_bn"])]


def _h5_densenet(p, s):
    import re

    layers = [_conv_ws("conv1/conv", p["stem_conv"]),
              _bn_ws("conv1/bn", p["stem_bn"], s["stem_bn"])]
    for name in p:
        m = re.fullmatch(r"block(\d+)_layer(\d+)", name)
        if m:
            b, li = int(m.group(1)) + 1, int(m.group(2))
            bp, bs = p[name], s[name]
            layers += [_bn_ws(f"conv{b}_block{li}_0_bn", bp["bn1"], bs["bn1"]),
                       _conv_ws(f"conv{b}_block{li}_1_conv", bp["conv1"]),
                       _bn_ws(f"conv{b}_block{li}_1_bn", bp["bn2"], bs["bn2"]),
                       _conv_ws(f"conv{b}_block{li}_2_conv", bp["conv2"])]
        m = re.fullmatch(r"trans(\d+)_conv", name)
        if m:
            b = int(m.group(1))
            layers += [_bn_ws(f"pool{b + 1}_bn", p[f"trans{b}_bn"],
                              s[f"trans{b}_bn"]),
                       _conv_ws(f"pool{b + 1}_conv", p[name])]
    return layers + [_bn_ws("bn", p["final_bn"], s["final_bn"])]


def _sep_ws(name, sep):
    return (name, [
        (f"{name}/depthwise_kernel:0",
         np.transpose(sep["depthwise"]["kernel"], (0, 1, 3, 2))),
        (f"{name}/pointwise_kernel:0", sep["pointwise"]["kernel"])])


def _h5_xception(p, s):
    layers = [_conv_ws("block1_conv1", p["stem_conv1"]),
              _bn_ws("block1_conv1_bn", p["stem_bn1"], s["stem_bn1"]),
              _conv_ws("block1_conv2", p["stem_conv2"]),
              _bn_ws("block1_conv2_bn", p["stem_bn2"], s["stem_bn2"])]
    n_blocks = sum(1 for n in p if n.startswith("block"))
    auto = 0
    for ours in range(1, n_blocks + 1):
        bp, bs = p[f"block{ours}"], s[f"block{ours}"]
        if "shortcut" in bp:
            layers += [
                _conv_ws("conv2d" if auto == 0 else f"conv2d_{auto}",
                         bp["shortcut"]),
                _bn_ws("batch_normalization" if auto == 0
                       else f"batch_normalization_{auto}",
                       bp["shortcut_bn"], bs["shortcut_bn"])]
            auto += 1
        si = 1
        while f"sep{si}" in bp:
            layers += [_sep_ws(f"block{ours + 1}_sepconv{si}", bp[f"sep{si}"]),
                       _bn_ws(f"block{ours + 1}_sepconv{si}_bn",
                              bp[f"bn{si}"], bs[f"bn{si}"])]
            si += 1
    kb = n_blocks + 2
    return layers + [
        _sep_ws(f"block{kb}_sepconv1", p["exit_sep1"]),
        _bn_ws(f"block{kb}_sepconv1_bn", p["exit_bn1"], s["exit_bn1"]),
        _sep_ws(f"block{kb}_sepconv2", p["exit_sep2"]),
        _bn_ws(f"block{kb}_sepconv2_bn", p["exit_bn2"], s["exit_bn2"])]


def _h5_inceptionv3(p, s):
    state = oracle_state(TorchInceptionV3(), 31)
    return JKH._auto_pair_layers(state, JK._inc3_torch_sequence())


def _h5_inceptionresnetv2(p, s):
    state = oracle_state(TorchInceptionResNetV2(), 32)
    layers = JKH._auto_pair_layers(state, JK._irv2_torch_sequence())

    def named(lname, pre):
        layers.append((lname, [
            (f"{lname}/kernel:0",
             np.transpose(state[f"{pre}.conv2d.weight"], (2, 3, 1, 0))),
            (f"{lname}/bias:0", state[f"{pre}.conv2d.bias"])]))

    for n, pre, count in (("block35", "repeat", 10), ("block17", "repeat_1",
                                                      20),
                          ("block8", "repeat_2", 9)):
        for i in range(count):
            named(f"{n}_{i + 1}_conv", f"{pre}.{i}")
    named("block8_10_conv", "block8")
    layers.append(("conv_7b", [("conv_7b/kernel:0", np.transpose(
        state["conv2d_7b.conv.weight"], (2, 3, 1, 0)))]))
    layers.append(("conv_7b_bn", [
        ("conv_7b_bn/beta:0", state["conv2d_7b.bn.bias"]),
        ("conv_7b_bn/moving_mean:0", state["conv2d_7b.bn.running_mean"]),
        ("conv_7b_bn/moving_variance:0", state["conv2d_7b.bn.running_var"])]))
    return layers


def _cadene(oracle, seed):
    """A file writer: the torch oracle's Cadene state dict, exported in the
    creation order ``convert_h5_cadene_senet`` matches."""
    def write(path):
        JKH._export_cadene_h5(oracle_state(oracle(), seed), path)
    return write


def _mobilenet_v1(p, s):
    return _flat_named(p, s, lambda n: n.startswith("conv_dw"))


def _aligned(p, s):
    return _flat_named(p, s, lambda n: n.endswith("_depthwise"))


H5_CASES = {
    # backbone: (layers from the source encoder tree, or a file writer;
    #            create_model keywords)
    "resnet34": (_h5_preact, {"encoder_variant": "keras-preact"}),
    "resnet50": (_h5_preact, {"encoder_variant": "keras-preact"}),
    "seresnet18": (_h5_preact, {"encoder_variant": "keras-preact"}),
    "vgg16": (_h5_vgg, {}),
    "mobilenetv2": (_h5_mobilenetv2, {}),
    "efficientnetb0": (_h5_efficientnet, {}),
    "densenet121": (_h5_densenet, {}),
    "mobilenet": (_mobilenet_v1, {}),
    "xception": (_h5_xception, {}),
    "inceptionv3": (_h5_inceptionv3, {}),
    "inceptionresnetv2": (_h5_inceptionresnetv2, {}),
    "seresnet50": (_cadene(lambda: TorchResNet(
        stage_sizes=(3, 4, 6, 3), bottleneck=True, se=True,
        stride_on_conv1=True), 33), {}),
    "resnext50": (_cadene(lambda: TorchResNet(
        stage_sizes=(3, 4, 6, 3), bottleneck=True, groups=32,
        width_factor=2), 34), {}),
    "senet154": (_cadene(lambda: TorchSENet154(stage_sizes=(1, 1, 1, 1)),
                         35), {}),
    "xception_aligned": (_aligned, {}),
}
# writers that cover every encoder leaf from the source tree
EXACT = (_h5_preact, _h5_mobilenetv2, _h5_efficientnet, _h5_densenet,
         _h5_xception, _mobilenet_v1, _aligned)


@pytest.mark.parametrize("backbone", sorted(H5_CASES))
def test_keras_h5_matches_jax(backbone, tmp_path, small_senet154):
    write, kw = H5_CASES[backbone]
    model = port_model(backbone, **kw)
    src = source_tree(tree_of(model), 40)
    p, s = src["params"]["encoder"], src["batch_stats"]["encoder"]
    path = str(tmp_path / f"{backbone}.h5")
    if write.__name__ == "write":
        write(path)
    else:
        JKH.write_keras_h5(path, write(p, s))
    out = load_both(backbone, path, model)
    if write in EXACT:
        assert_same({"e": p, "s": s}, {"e": out["params"]["encoder"],
                                       "s": out["batch_stats"]["encoder"]})


def test_read_h5_weights_matches_jax(tmp_path):
    model = port_model("mobilenet")
    src = source_tree(tree_of(model), 41)
    path = str(tmp_path / "m.h5")
    JKH.write_keras_h5(path, _mobilenet_v1(src["params"]["encoder"],
                                           src["batch_stats"]["encoder"]))
    want, got = JK.read_h5_weights(path), TK.read_h5_weights(path)
    assert want.keys() == got.keys()
    for ln in want:
        assert want[ln].keys() == got[ln].keys()
        for k in want[ln]:
            assert np.array_equal(want[ln][k], got[ln][k])


def test_aligned_deeplab_head_matches_jax(tmp_path):
    """A bonlime pascal_voc save carries the DeepLab decoder and the
    logits head: both load, as JAX loads them; a head of another class
    count warns and keeps its init."""
    model = port_model("xception_aligned", "DeepLabV3", classes=5)
    src = source_tree(tree_of(model), 42)
    layers = (_aligned(src["params"]["encoder"],
                       src["batch_stats"]["encoder"])
              + _aligned(src["params"]["decoder"],
                         src["batch_stats"]["decoder"])
              + [_conv_ws("logits_semantic", src["params"]["logits_conv"])])
    path = str(tmp_path / "xception_aligned.h5")
    JKH.write_keras_h5(path, layers)
    out = load_both("xception_aligned", path, model)
    assert_same(src, out)
    other = port_model("xception_aligned", "DeepLabV3", classes=3)
    with pytest.warns(UserWarning, match="logits head keeps its fresh init"):
        got = TP.load_encoder_weights("xception_aligned", path,
                                      tree_of(other))
    with pytest.warns(UserWarning, match="logits head keeps its fresh init"):
        want = JP.load_encoder_weights("xception_aligned", path,
                                       tree_of(other))
    assert_same(want, got)


# ---------------------------------------------------------------------------
# .npz both ways, the preact variant, the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_both_directions(writer, tmp_path):
    model = port_model("efficientnetb0", seed=3)
    src = source_tree(tree_of(model), 43)
    path = str(tmp_path / "enc.npz")
    (TP if writer == "port" else JP).export_encoder_npz(path, src)
    target = port_model("efficientnetb0", seed=4)
    out = load_both("efficientnetb0", path, target)
    assert_same({"p": src["params"]["encoder"],
                 "s": src["batch_stats"]["encoder"]},
                {"p": out["params"]["encoder"],
                 "s": out["batch_stats"]["encoder"]})
    a, b = np.load(path), None
    other = str(tmp_path / "again.npz")
    (JP if writer == "port" else TP).export_encoder_npz(other, src)
    b = np.load(other)
    assert sorted(a.files) == sorted(b.files)
    assert all(np.array_equal(a[k], b[k]) for k in a.files)


def test_imagenet_resolves_under_the_pretrained_dir(tmp_path, monkeypatch):
    """``imagenet`` finds ``{backbone}.pt`` under STP_PRETRAINED_DIR (and
    both packages resolve the same file); an ``.h5`` there makes the
    factory build ``keras-preact`` for a pre-activation backbone, which a
    checkpoint sidecar then pins."""
    from segmentation_training_pipeline_tpu import config as JC
    from segmentation_training_pipeline_tpu_torch import config as TC
    from segmentation_training_pipeline_tpu_torch.train import (
        checkpoint as TCK)

    monkeypatch.setenv("STP_PRETRAINED_DIR", str(tmp_path))
    d = {"architecture": "Unet", "backbone": "resnet34",
         "encoder_weights": "imagenet", "shape": [64, 64, 3]}
    tcfg = TC.parse_dict(d, directory=str(tmp_path / "exp"))
    jcfg = JC.parse_dict(d, directory=str(tmp_path / "exp"))
    assert TF._variant_for_config(tcfg) == JF._variant_for_config(jcfg) == ""
    model = port_model("resnet34", encoder_variant="keras-preact")
    src = source_tree(tree_of(model), 44)
    JKH.write_keras_h5(str(tmp_path / "resnet34.h5"),
                       _h5_preact(src["params"]["encoder"],
                                  src["batch_stats"]["encoder"]))
    for spec in ("imagenet", "pascal_voc", str(tmp_path / "resnet34.h5")):
        assert (TP.resolve_pretrained_path("resnet34", spec)
                == JP.resolve_pretrained_path("resnet34", spec))
    assert TF._variant_for_config(tcfg) == "keras-preact"
    assert JF._variant_for_config(jcfg) == "keras-preact"
    built = TF.model_from_config(tcfg)
    assert type(built.encoder).__name__ == "PreactResNetEncoder"
    TP.load_into_model(built, "resnet34", "imagenet")
    assert_same(src["params"]["encoder"], tree_of(built)["params"]["encoder"])
    # the sidecar pins the plain graph although the .h5 is still there
    path = tcfg.weights_path(0, 0)
    TCK.save_checkpoint(path, {"b.bias": torch.zeros(1)},
                        {"encoder_variant": ""})
    assert TF.variant_from_checkpoint(tcfg, [path]) == ""
    assert JF.variant_from_checkpoint(jcfg, [path]) == ""
    os.remove(str(tmp_path / "resnet34.h5"))
    save_torch(tmp_path / "resnet34.pt", _resnet(
        tree_of(port_model("resnet34"))["params"]["encoder"], None))
    assert TP.resolve_pretrained_path("resnet34", "imagenet").endswith(".pt")
    assert TF._variant_for_config(tcfg) == ""


def test_missing_named_weights_warn_or_raise(tmp_path, monkeypatch):
    monkeypatch.setenv("STP_PRETRAINED_DIR", str(tmp_path))
    tree = tree_of(port_model("resnet18"))
    for mod in (TP, JP):
        with pytest.warns(UserWarning, match="training from scratch"):
            assert mod.load_encoder_weights("resnet18", "imagenet",
                                            tree) is None
    model = port_model("resnet18")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.warns(UserWarning):
        assert not TP.load_into_model(model, "resnet18", "imagenet")
    assert all(torch.equal(v, before[k])
               for k, v in model.state_dict().items())
    monkeypatch.setenv("STP_REQUIRE_PRETRAINED", "1")
    for mod in (TP, JP):
        with pytest.raises(mod.PretrainedWeightsError,
                           match="STP_REQUIRE_PRETRAINED"):
            mod.load_encoder_weights("resnet18", "imagenet", tree)


@pytest.mark.parametrize("case", ["shape", "missing-path", "extension",
                                  "aligned-pt", "h5-not-keras"])
def test_refusals_match_jax(case, tmp_path):
    tree = tree_of(port_model("resnet18"))
    backbone = "resnet18"
    if case == "shape":
        state = _resnet(tree["params"]["encoder"], tree["batch_stats"]
                        ["encoder"])
        state["layer2.1.conv1.weight"] = state["layer2.1.conv1.weight"][:, :5]
        path, match = save_torch(tmp_path / "r.pt", state), \
            "layer2.1.conv1.weight: shape"
    elif case == "missing-path":
        path, match = str(tmp_path / "nope.pt"), "not found"
    elif case == "extension":
        path, match = str(tmp_path / "w.ckpt"), "unsupported weights format"
        open(path, "wb").close()
    elif case == "aligned-pt":
        backbone = "xception_aligned"
        path, match = save_torch(tmp_path / "x.pt", {}), "bonlime"
    else:
        import h5py

        path, match = str(tmp_path / "x.h5"), "not a Keras weights file"
        with h5py.File(path, "w") as f:
            f.create_dataset("w", data=np.zeros(3))
    for mod in (TP, JP):
        with pytest.raises(mod.PretrainedWeightsError, match=match):
            mod.load_encoder_weights(backbone, path, tree)


# ---------------------------------------------------------------------------
# end to end: a forward, and a fit
# ---------------------------------------------------------------------------

def test_forward_after_loading_matches_jax(tmp_path):
    """Unet-resnet34 f32 at 64²: both packages load the same .pt into the
    same template and give the same logits."""
    from segmentation_training_pipeline_tpu.models.factory import (
        create_model as jcreate)

    model = port_model("resnet34")
    tree = tree_of(model)
    path = save_torch(tmp_path / "r34.pt", _resnet(
        tree["params"]["encoder"], tree["batch_stats"]["encoder"]))
    loaded = JP.load_encoder_weights("resnet34", path, tree)
    TP.load_into_model(model, "resnet34", path)
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32) * 2
    jm = jcreate("Unet", "resnet34", classes=1, dtype="float32")
    want = np.asarray(jm.apply(loaded, jax.numpy.asarray(x), train=False))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_fit_with_encoder_weights_matches_jax(tmp_path, monkeypatch):
    """One stage of Unet-resnet18 32² B4 f32 with the encoder frozen, no
    augmentation, from the same initial variables (the JAX ``init``,
    bridged into the port's ``init_model``) and the same
    ``encoder_weights`` file: the first epoch's train and validation losses
    agree within 1e-4 (the fit tests' first-epoch tolerance), and both
    best checkpoints hold the file's encoder parameters bit for bit.  A
    named spec with no file warns and trains from scratch."""
    from segmentation_training_pipeline_tpu import config as JC
    from segmentation_training_pipeline_tpu.data.datasets import (
        LambdaDataSet as JLambda)
    from segmentation_training_pipeline_tpu.models import factory as JFM
    from segmentation_training_pipeline_tpu.train import checkpoint as JCK
    from segmentation_training_pipeline_tpu_torch import config as TC
    from segmentation_training_pipeline_tpu_torch.data.datasets import (
        LambdaDataSet as TLambda)
    from segmentation_training_pipeline_tpu_torch.data.synthetic import (
        generate_shapes_dataset)
    from segmentation_training_pipeline_tpu_torch.train import checkpoint \
        as TCK
    from segmentation_training_pipeline_tpu_torch.train import stage as TS

    enc_path = str(tmp_path / "resnet18.pt")
    tree = tree_of(port_model("resnet18"))
    # a trained network's scales: kernels N(0, 1/fan_in), BN near identity
    state = {}
    for k, v in _resnet(tree["params"]["encoder"],
                        tree["batch_stats"]["encoder"]).items():
        if v.ndim == 4:
            v = v / np.sqrt(np.prod(v.shape[1:]))
        elif k.endswith("running_var"):
            v = 0.5 * np.abs(v) + 0.5
        elif k.endswith("weight"):
            v = 1.0 + 0.1 * v
        else:
            v = 0.1 * v
        state[k] = v.astype(np.float32)
    save_torch(enc_path, state)
    d = {"architecture": "Unet", "backbone": "resnet18", "shape": [32, 32, 3],
         "classes": 1, "activation": "sigmoid", "dtype": "float32",
         "batch": 4, "folds_count": 2, "random_state": 5,
         "loss": "binary_crossentropy", "optimizer": "Adam", "lr": 1e-3,
         "metrics": ["dice"], "primary_metric": "val_dice", "verbose": 0,
         "encoder_weights": enc_path,
         "stages": [{"epochs": 1, "freeze_encoder": True}]}
    ds = generate_shapes_dataset(12, 32, seed=11, p_empty=0.25)
    xs, ys = [ds[i].x for i in range(12)], [ds[i].y for i in range(12)]

    jcfg = JC.parse_dict(d, directory=str(tmp_path / "jax"))
    jcfg.fit(JLambda(xs, ys), foldsToExecute=[0])
    jm = JFM.create_model("Unet", "resnet18", classes=1, dtype="float32")

    def jax_init(model, seed=0, device="cuda"):
        var = jax.device_get(JFM.init_model(jm, (32, 32, 3), seed=seed))
        model.load_state_dict(bridge.state_dict_from_jax(var))
        return model.to(device)

    monkeypatch.setattr(TS, "init_model", jax_init)
    tcfg = TC.parse_dict(d, directory=str(tmp_path / "port"))
    tcfg.fit(TLambda(xs, ys), foldsToExecute=[0], device="cpu")

    def first_row(cfg):
        rows = open(cfg.metrics_path(0, 0)).read().splitlines()
        return dict(zip(rows[0].split(","), rows[1].split(",")))

    jr, tr = first_row(jcfg), first_row(tcfg)
    for key in ("loss", "val_loss"):
        assert abs(float(tr[key]) - float(jr[key])) <= 1e-4 * abs(
            float(jr[key])), (key, tr[key], jr[key])
    want = bridge.state_dict_from_jax(JP.load_encoder_weights(
        "resnet18", enc_path, tree))
    jvar = jax.tree.map(np.asarray, JCK.load_checkpoint(
        jcfg.weights_path(0, 0), jax.device_get(
            JFM.init_model(jm, (32, 32, 3), seed=0))))
    jsd = bridge.state_dict_from_jax(jvar)
    tsd = TCK.load_checkpoint(tcfg.weights_path(0, 0), TF.create_model(
        "Unet", "resnet18", 1, dtype="float32"))
    enc = [k for k in want if k.startswith("encoder.")
           and not k.endswith(("running_mean", "running_var"))]
    assert enc and all(torch.equal(tsd[k], want[k]) for k in enc)
    assert all(torch.equal(jsd[k], want[k]) for k in enc)
    assert json.load(open(tcfg.weights_path(0, 0) + ".json"))["done"]

    monkeypatch.setenv("STP_PRETRAINED_DIR", str(tmp_path / "empty"))
    with pytest.warns(UserWarning, match="training from scratch"):
        TC.parse_dict({**d, "encoder_weights": "imagenet"},
                      directory=str(tmp_path / "scratch")).fit(
            TLambda(xs, ys), foldsToExecute=[0], device="cpu")


def test_cli_fit_takes_encoder_weights(tmp_path, capsys, monkeypatch):
    """The CLI's ``fit`` passes ``encoder_weights`` through the config with
    no option of its own: ``imagenet`` under STP_PRETRAINED_DIR lands in
    the frozen encoder of the stage's checkpoint."""
    import yaml

    from segmentation_training_pipeline_tpu_torch import cli as TCLI
    from segmentation_training_pipeline_tpu_torch.data.synthetic import (
        write_shapes_dataset)
    from segmentation_training_pipeline_tpu_torch.train import checkpoint \
        as TCK

    tree = tree_of(port_model("resnet18"))
    (tmp_path / "weights").mkdir()
    path = save_torch(tmp_path / "weights" / "resnet18.pt", _resnet(
        tree["params"]["encoder"], tree["batch_stats"]["encoder"]))
    want = bridge.state_dict_from_jax(JP.load_encoder_weights(
        "resnet18", path, tree))
    images, masks = write_shapes_dataset(str(tmp_path / "data"), 8, 32,
                                         seed=2)
    yml = tmp_path / "exp" / "cfg.yaml"
    yml.parent.mkdir()
    yml.write_text(yaml.safe_dump({
        "architecture": "Unet", "backbone": "resnet18", "shape": [32, 32, 3],
        "dtype": "float32", "batch": 4, "folds_count": 2, "verbose": 0,
        "encoder_weights": "imagenet", "freeze_encoder": True,
        "stages": [{"epochs": 1}]}))
    monkeypatch.setenv("STP_PRETRAINED_DIR", str(tmp_path / "weights"))
    assert TCLI.main(["fit", str(yml), "--images", images, "--masks", masks,
                      "--folds", "0", "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out)
    sd = TCK.load_checkpoint(res["fold0.stage0"]["checkpoint"],
                             TF.create_model("Unet", "resnet18", 1,
                                             dtype="float32"))
    enc = [k for k in want if k.startswith("encoder.")
           and not k.endswith(("running_mean", "running_var"))]
    assert all(torch.equal(sd[k], want[k]) for k in enc)
