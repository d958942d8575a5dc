"""The port's boundaries: what it imports, where it runs, what it refuses,
and its small pure functions against the JAX package's.

  * the package, ``chip_smoke.py`` and ``compare_kernels.py`` import
    neither ``jax`` nor the JAX package, nor ``flax``, ``msgpack`` or
    ``h5py`` (the port reads checkpoints with its own codec and Keras
    ``.h5`` files with its own HDF5 reader), and ``cv2`` only inside the
    functions that decode, encode or resize (a subprocess import and an
    AST scan);
  * entry points default to the card and raise on a host without one;
  * the config parser takes the slice's experiment and refuses what the
    JAX config refuses; every augmenter name of the JAX registry parses
    and builds;
  * preprocessing, losses, metrics and the Adam rule match the JAX
    package's to 1e-6 (float32 elementwise work and small reductions).
"""

import ast
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import optax
import pytest
import torch

from segmentation_training_pipeline_tpu.ops import losses as JLo
from segmentation_training_pipeline_tpu.ops import metrics as JM
from segmentation_training_pipeline_tpu.ops import preprocess as JP
from segmentation_training_pipeline_tpu_torch import config as TC
from segmentation_training_pipeline_tpu_torch import infer as TI
from segmentation_training_pipeline_tpu_torch import kernels as K
from segmentation_training_pipeline_tpu_torch.data.datasets import (
    LambdaDataSet)
from segmentation_training_pipeline_tpu_torch.models import factory as TF
from segmentation_training_pipeline_tpu_torch.ops import losses as TLo
from segmentation_training_pipeline_tpu_torch.ops import metrics as TM
from segmentation_training_pipeline_tpu_torch.ops import preprocess as TP
from segmentation_training_pipeline_tpu_torch.train import checkpoint as TCK
from segmentation_training_pipeline_tpu_torch.train import optimizers as TO
from segmentation_training_pipeline_tpu_torch.train import step as TS

from torch_port_util import few_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "segmentation_training_pipeline_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "compare_kernels.py",
    ROOT / "examples" / "accuracy_evidence_torch.py",
    ROOT / "examples" / "accuracy_gap_torch.py",
    ROOT / "examples" / "photo_block_ab.py",
    ROOT / "examples" / "batchnorm_modes.py"]
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).replace(
        ".__init__", "") for p in PKG.rglob("*.py"))

EXPERIMENT = {
    "architecture": "Unet", "backbone": "resnet34", "shape": [512, 512, 3],
    "loss": "binary_crossentropy + 0.25*dice_loss", "optimizer": "Adam",
    "lr": 0.0005, "batch": 16, "metrics": ["dice", "iou"],
    "primary_metric": "val_dice",
    "augmentation": {
        "Fliplr": 0.5,
        "Affine": {"rotate": [-15, 15], "scale": [0.85, 1.15],
                   "translate_percent": {"x": [-0.1, 0.1],
                                         "y": [-0.1, 0.1]}},
        "ElasticTransformation": {"alpha": [0, 40], "sigma": 6},
        "Multiply": [0.9, 1.1]},
}


def test_port_imports_no_jax():
    code = ("import sys\n"
            f"for m in {PORT_MODULES!r}:\n"
            "    __import__(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'flax', 'optax')) or "
            "m.split('.')[0] in ('segmentation_training_pipeline_tpu', "
            "'msgpack', 'h5py', 'cv2')]\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def _imports(node, in_function=False):
    """(top-level package, imported inside a function?) of every import
    under ``node``."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, ast.Import):
            for a in child.names:
                yield a.name.split(".")[0], in_function
        elif isinstance(child, ast.ImportFrom) and child.level == 0:
            yield (child.module or "").split(".")[0], in_function
        yield from _imports(child, in_function or isinstance(
            child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    for top, in_function in _imports(ast.parse(path.read_text())):
        assert top not in ("jax", "jaxlib", "flax", "optax", "msgpack",
                           "h5py", "segmentation_training_pipeline_tpu"), top
        assert top != "cv2" or in_function, f"{path.name}: cv2 at import"


def test_entry_points_default_to_the_card(tmp_path):
    """On a host without CUDA the defaults raise; nothing continues on
    the CPU."""
    assert not torch.cuda.is_available()
    model = TF.create_model("Unet", "resnet34", 1, dtype="float32")
    cfg = TC.parse_dict({"shape": [64, 64, 3], "dtype": "float32"},
                        directory=str(tmp_path))
    TCK.save_checkpoint(cfg.weights_path(0, 0), model.state_dict())
    with pytest.raises((AssertionError, RuntimeError)):
        TI.InferenceBundle(cfg, [0], 0)
    with pytest.raises((AssertionError, RuntimeError)):
        cfg.load(0, 0)
    with pytest.raises((AssertionError, RuntimeError)):
        TF.init_model(model, seed=0)
    with pytest.raises((AssertionError, RuntimeError)):
        TS.create_train_state(model, TO.build_optimizer(cfg))
    ds = LambdaDataSet([np.zeros((64, 64, 3), np.uint8)] * 4,
                       [np.zeros((64, 64), np.uint8)] * 4)
    with pytest.raises((AssertionError, RuntimeError)):
        TC.parse_dict({"shape": [64, 64, 3], "dtype": "float32",
                       "folds_count": 2, "backbone": "resnet18"},
                      directory=str(tmp_path / "fit")).fit(ds)
    with pytest.raises(RuntimeError):
        torch.Generator(device="cuda")
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}
    assert set(K.KERNELS) == {"warp_x", "warp_y", "elastic", "shear",
                              "warp_ye", "bn_stats", "bn_apply",
                              "bn_grad_stats", "bn_grad_apply"}


def test_config_parses_the_slice_experiment():
    cfg = TC.parse_dict(EXPERIMENT)
    assert (cfg.architecture, cfg.backbone, cfg.optimizer) == (
        "Unet", "resnet34", "Adam")
    assert [a["name"] for a in cfg.augmentation] == [
        "Fliplr", "Affine", "ElasticTransformation", "Multiply"]
    assert cfg.shape == (512, 512, 3) and cfg.dtype == "bfloat16"


def test_config_parses_the_fpn_example():
    """BASELINE config 2 as written: FPN + efficientnetb0 with the
    config-2 block, its callbacks and its metric's mode."""
    cfg = TC.parse(str(ROOT / "examples" / "fpn_augmented_512.yaml"))
    assert (cfg.architecture, cfg.backbone, cfg.classes, cfg.batch) == (
        "FPN", "efficientnetb0", 1, 16)
    assert [a["name"] for a in cfg.augmentation] == [
        "Fliplr", "Affine", "ElasticTransformation", "Multiply"]
    assert [c["name"] for c in cfg.callbacks] == ["ReduceLROnPlateau",
                                                 "EarlyStopping"]
    assert cfg.primary_mode() == "max"
    for b in range(8):
        TC.parse_dict({**EXPERIMENT, "architecture": "FPN",
                       "backbone": f"efficientnetb{b}"})


@pytest.mark.parametrize("patch,exc,match", [
    ({"archtecture": "Unet"}, TC.ConfigError, "Did you mean 'architecture'"),
    ({"architecture": "FPN", "backbone": "senet154",
      "augmentation": {"Clouds": {}}}, None, "Clouds"),
    ({"backbone": "efficientnetb0", "architecture": "DeepLabV3",
      "augmentation": {"Rot90": {"k": [1, 3], "keep_sizes": True}}},
     TC.ConfigError, "Did you mean 'keep_size'"),
    ({"backbone": "resnet43"}, TC.ConfigError, "Did you mean"),
    ({"optimizer": "SGDD"}, TC.ConfigError, "Did you mean 'SGD'"),
    ({"augmentation": {"PiecewiseAffine": {"scale": 0.01,
                                           "absolute_scale": True}}},
     TC.ConfigError, "'absolute_scale' is a real imgaug parameter"),
    ({"loss": "dice_los"}, ValueError, "Did you mean 'dice_loss'"),
    ({"backbone": "vgg16", "augmentation": {"Superpixels":
                                            {"p_replace": 0.5}}},
     None, "Superpixels"),
    ({"augmentation": {"Fog": {"density": 0.2}}}, None, "Fog"),
    ({"augmentation": {"Fliplrr": 0.5}}, TC.ConfigError, "Did you mean"),
    ({"augmentation": {"Affine": {"rotat": 10}}}, TC.ConfigError,
     "Did you mean 'rotate'"),
], ids=["key", "fpn", "effnet", "backbone-typo", "sgd", "piecewise",
        "loss-typo", "vgg", "blur", "aug-typo", "arg-typo"])
def test_config_refuses_what_is_not_ported(patch, exc, match):
    """What the JAX config refuses, with a suggestion where it has one;
    the three augmenters the port refused before (``exc`` None: Clouds,
    Superpixels, Fog) now parse as in the JAX package and build."""
    if exc is not None:
        with pytest.raises(exc, match=match):
            TC.parse_dict({**EXPERIMENT, **patch})
        return
    from segmentation_training_pipeline_tpu import config as JC
    from segmentation_training_pipeline_tpu_torch.ops.aug import (
        lowering as TL)

    cfg = TC.parse_dict({**EXPERIMENT, **patch})
    assert cfg.to_dict() == JC.parse_dict({**EXPERIMENT, **patch}).to_dict()
    aug = TL.build_augmentation(cfg.augmentation)
    assert [s.name for s in aug.segments] == [match.lower()]


@pytest.mark.parametrize("patch", [
    {"architecture": "FPN", "backbone": "resnet50"},
    {"backbone": "efficientnetb0", "architecture": "Linknet"},
    {"loss": "jaccard_loss"},
    {"metrics": ["precision"], "primary_metric": "val_loss"}],
    ids=["fpn-resnet50", "linknet", "jaccard", "precision"])
def test_config_parses_what_was_refused_before_config3(patch):
    """Names this slice ported: the ResNet-50 family, Linknet and PSPNet,
    and every loss and metric of the reference's registries."""
    cfg = TC.parse_dict({**EXPERIMENT, **patch})
    for k, v in patch.items():
        assert getattr(cfg, k) == v


@pytest.mark.parametrize("mode", ["tf", "scale", "torch", "caffe"])
def test_preprocess_matches_jax(mode):
    x = (np.random.RandomState(0).rand(2, 5, 5, 3) * 255).astype(np.uint8)
    want = JP.preprocess(jnp.asarray(x), mode, jnp.float32)
    got = TP.preprocess(torch.from_numpy(x), mode, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


def _pred(seed=1):
    r = np.random.RandomState(seed)
    y = (r.rand(3, 8, 8, 1) > 0.5).astype(np.float32)
    logits = (r.randn(3, 8, 8, 1) * 3).astype(np.float32)
    return y, logits


@pytest.mark.parametrize("name", ["binary_crossentropy", "dice_loss",
                                  "binary_crossentropy + 0.25*dice_loss"])
def test_losses_match_jax(name):
    y, logits = _pred()
    want = JLo.build_loss(name, "sigmoid")(jnp.asarray(y), jnp.asarray(logits))
    loss = TLo.build_loss(name, "sigmoid")
    got = loss(torch.from_numpy(y), torch.from_numpy(logits))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    per = loss.per_example(torch.from_numpy(y), torch.from_numpy(logits))
    assert per.shape == (3,)
    np.testing.assert_allclose(float(per.mean()), float(want), rtol=1e-6)


@pytest.mark.parametrize("name", ["dice", "iou"])
def test_metrics_match_jax(name):
    y, logits = _pred(2)
    probs = 1.0 / (1.0 + np.exp(-logits))
    want = JM.get(name)(jnp.asarray(y), jnp.asarray(probs), "sigmoid")
    got = TM.get(name)(torch.from_numpy(y), torch.from_numpy(probs),
                       "sigmoid")
    assert got.shape == (3,)
    np.testing.assert_allclose(float(got.mean()), float(want), rtol=1e-6)


def test_adam_matches_optax_scale_by_adam():
    r = np.random.RandomState(3)
    params = {"a": r.randn(4, 3).astype(np.float32),
              "b": r.randn(5).astype(np.float32)}
    tx = optax.scale_by_adam()
    jstate = tx.init({k: jnp.asarray(v) for k, v in params.items()})
    adam = TO.build_optimizer(TC.parse_dict({"optimizer": "Adam"}))
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    tstate = adam.init(tparams)
    for step in range(3):
        g = {k: (r.randn(*v.shape) * 10.0 ** -step).astype(np.float32)
             for k, v in params.items()}
        ju, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               jstate)
        tu, tstate = adam.update({k: torch.from_numpy(g[k]) for k in params},
                                 tstate, tparams)
        for k, u in tu.items():
            np.testing.assert_allclose(u.numpy(), np.asarray(ju[k]),
                                       rtol=1e-6, atol=1e-7)
    assert tstate[0].count == 3 and len(tstate) == 1


def test_name_tables_match_the_jax_config():
    """The port keeps its own copies of the name tables; they list the
    same names and aliases as the JAX package's, ported or not."""
    from segmentation_training_pipeline_tpu import config as JC

    JC._populate_registries()
    for reg in ("ARCHITECTURES", "BACKBONES", "OPTIMIZERS", "AUGMENTERS",
                "CALLBACKS"):
        j, t = getattr(JC, reg), getattr(TC, reg)
        assert set(j.names()) == set(t.names()), reg
        assert set(j._canonical) == set(t._canonical), reg
    assert TC._TOP_LEVEL_KEYS == JC._TOP_LEVEL_KEYS
    assert TC._STAGE_KEYS == JC._STAGE_KEYS
    assert TC._TTA_VALUES == JC._TTA_VALUES
    assert TLo.KNOWN == set(JC.LOSSES._canonical)
    assert TM.KNOWN == set(JC.METRICS._canonical)


def test_geometric_tables_match_the_jax_lowering():
    """The port's copies of the lowering's geometric name tables and of
    the argument schemas of those names (the keys allowed and the imgaug
    keys refused) list what the JAX package's do."""
    from segmentation_training_pipeline_tpu.ops.aug import arg_schema as JA
    from segmentation_training_pipeline_tpu.ops.aug import lowering as JL
    from segmentation_training_pipeline_tpu_torch.ops.aug import (
        arg_schema as TA)
    from segmentation_training_pipeline_tpu_torch.ops.aug import (
        lowering as TL)

    assert TL._GEOMETRIC == JL._GEOMETRIC
    assert TL._CHEAP_GEO == JL._CHEAP_GEO
    assert TL._GEOMETRIC <= TL.PORTED_AUGMENTERS
    for name in TL._GEOMETRIC | {"multiply"}:
        key = JA._LOOKUP[name]
        assert TA._LOOKUP[name] == key, name
        (t_allowed, t_unsup), (j_allowed, j_unsup) = (TA._SCHEMA[key],
                                                      JA._SCHEMA[key])
        assert t_allowed == j_allowed and set(t_unsup) == set(j_unsup), name


def test_encoder_weights_names_match_the_jax_reader(tmp_path, monkeypatch):
    """The named ``encoder_weights`` specs and the extensions tried under
    $STP_PRETRAINED_DIR, pinned to the JAX reader's by behaviour: each
    name finds each extension's file, in the same order, on both sides,
    and any other spec is a path."""
    from segmentation_training_pipeline_tpu.models import pretrained as JP
    from segmentation_training_pipeline_tpu_torch.models import (
        pretrained as TP)

    monkeypatch.setenv("STP_PRETRAINED_DIR", str(tmp_path))
    for ext in reversed(TP.NAMED_EXTENSIONS):
        (tmp_path / f"resnet34{ext}").write_bytes(b"")
        for spec in TP.NAMED_SPECS:
            want = str(tmp_path / f"resnet34{ext}")
            assert TP.resolve_pretrained_path("resnet34", spec) == want
            assert JP.resolve_pretrained_path("resnet34", spec) == want
    for spec in ("imagenet22k", "noisy-student", str(tmp_path / "w.npz")):
        assert (TP.resolve_pretrained_path("resnet34", spec)
                == JP.resolve_pretrained_path("resnet34", spec) == spec)


def _head(msg: str) -> str:
    """A refusal's statement, before its reason: the port's reasons leave
    out the reference's words about XLA and its docs."""
    return re.split(r" \(| —", msg)[0]


VALUE_CHECKS = {
    "rot90-keep-size": {"Rot90": {"k": 1, "keep_size": False}},
    "crop-keep-size": {"Crop": {"px": [0, 4], "keep_size": False}},
    "perspective-keep-size": {"PerspectiveTransform": {
        "scale": 0.05, "keep_size": False}},
    "left-top": {"CropToFixedSize": {"width": 32, "height": 32,
                                     "position": "left-top"}},
    "right-bottom": {"PadToFixedSize": {"width": 80, "height": 80,
                                        "position": "right-bottom"}},
    "width-32.5": {"CropToFixedSize": {"width": 32.5, "height": 32}},
    "width-0": {"CenterCropToFixedSize": {"width": 0, "height": 32}},
    "width-true": {"PadToFixedSize": {"width": True, "height": 80}},
    "affine-reflect": {"Affine": {"rotate": 10, "mode": "reflect"}},
    "pad-4-tuple": {"Pad": {"px": [1, 2, 3, 4]}},
    "cutout-gaussian": {"Cutout": {"fill_mode": "gaussian"}},
    "cutout-not-squared": {"Cutout": {"size": 0.2, "squared": False}},
    "rotate-edge": {"Rotate": {"rotate": 5, "mode": "edge"}},
    "rotate-axis-typo": {"Rotate": {"rotate": 5, "scale": {"sx": 1.1}}},
    "child-keep-size": {"Sometimes": {"p": 0.5, "then": [
        {"Rot90": {"keep_size": False}}]}},
    "colorspace-lab": {"ChangeColorspace": {"to_colorspace": "Lab"}},
    "colorspace-list": {"ChangeColorspace": {"to_colorspace": ["HSV",
                                                               "HLS"]}},
    "canny-sobel-4": {"Canny": {"sobel_kernel_size": 4}},
    "canny-sobel-true": {"Canny": {"alpha": 0.5, "sobel_kernel_size": True}},
    "canny-iters-0": {"Canny": {"hysteresis_iters": 0}},
    "canny-iters-float": {"Canny": {"hysteresis_iters": 2.5}},
    "cartoon-blur-0": {"Cartoon": {"blur_ksize": 0}},
    "cartoon-blur-float": {"Cartoon": {"blur_ksize": 3.0}},
    "averagepooling-keep-size": {"AveragePooling": {"k": 2,
                                                    "keep_size": False}},
    "child-canny": {"OneOf": [{"Add": 3}, {"Canny": {
        "sobel_kernel_size": 9}}]},
    "jigsaw-rows-0": {"Jigsaw": {"nb_rows": 0}},
    "jigsaw-cols-float": {"Jigsaw": {"nb_rows": 3, "nb_cols": 2.5}},
    "superpixels-max-size-1": {"Superpixels": {"max_size": 1}},
    "voronoi-max-size-float": {"UniformVoronoi": {"max_size": 64.0}},
    "kmeans-max-size-true": {"KMeansColorQuantization": {"max_size": True}},
    "class-ids-negative": {"BlendAlphaSegMapClassIds": {
        "class_ids": [1, -2], "foreground": {"Add": 5}}},
}


@pytest.mark.parametrize("block", list(VALUE_CHECKS.values()),
                         ids=list(VALUE_CHECKS))
def test_value_checks_match_jax(block):
    """The reference's value checks refuse the same specs at parse, with
    the same statement; the port's parse refused none of them before."""
    from segmentation_training_pipeline_tpu import config as JC

    with pytest.raises(JC.ConfigError) as j:
        JC.parse_dict({"augmentation": block})
    with pytest.raises(TC.ConfigError) as t:
        TC.parse_dict({"augmentation": block})
    assert _head(str(t.value)) == _head(str(j.value))


def _known_unsupported():
    from segmentation_training_pipeline_tpu import config as JC

    return sorted(JC._KNOWN_UNSUPPORTED_AUGMENTERS) + [
        "pillike.Equalize", "imgcorruptlike.GaussianNoise"]


@pytest.mark.parametrize("name", _known_unsupported())
def test_known_unsupported_names_are_refused_as_jax(name):
    """A real imgaug name the reference does not lower gets its pointed
    refusal, at top level and as a combinator's child."""
    from segmentation_training_pipeline_tpu import config as JC

    assert TC._KNOWN_UNSUPPORTED_AUGMENTERS == \
        JC._KNOWN_UNSUPPORTED_AUGMENTERS
    assert TC._UNSUPPORTED_AUG_PREFIXES == JC._UNSUPPORTED_AUG_PREFIXES
    for block in ({name: None}, {"OneOf": [{name: None}, {"Add": 3}]}):
        with pytest.raises(JC.ConfigError) as j:
            JC.parse_dict({"augmentation": block})
        with pytest.raises(TC.ConfigError) as t:
            TC.parse_dict({"augmentation": block})
        assert str(t.value) == str(j.value)
        assert "intentionally does not lower" in str(t.value)


def test_slice_schemas_match_the_jax_schemas():
    """Every name the port accepts has the reference's argument schema:
    the keys allowed and the imgaug keys refused, under every alias."""
    from segmentation_training_pipeline_tpu.ops.aug import arg_schema as JA
    from segmentation_training_pipeline_tpu.ops.aug import lowering as JL
    from segmentation_training_pipeline_tpu_torch.ops.aug import (
        arg_schema as TA)
    from segmentation_training_pipeline_tpu_torch.ops.aug import (
        lowering as TL)

    # ``auto_contrast``: a spelling the reference's lowering takes and its
    # config does not know (no schema row on either side)
    assert TL.PORTED_AUGMENTERS - {"auto_contrast"} == set(TA._LOOKUP)
    assert TL._META == JL._META and TL._BLEND == JL._BLEND
    assert TL._BLEND_CANON == JL._BLEND_CANON
    assert TL._JOINT_PHOTO == JL._JOINT_PHOTO
    assert TL._RGB_ONLY_PHOTO == JL._RGB_ONLY_PHOTO
    for name in TL.PORTED_AUGMENTERS - {"auto_contrast"}:
        key = JA._LOOKUP[name]
        assert TA._LOOKUP[name] == key, name
        (t_allowed, t_unsup), (j_allowed, j_unsup) = (TA._SCHEMA[key],
                                                      JA._SCHEMA[key])
        assert t_allowed == j_allowed and set(t_unsup) == set(j_unsup), name


def test_every_registry_name_is_ported():
    """The registry is closed: the port lowers every name and alias of
    the JAX config's augmenter registry (109 names, 125 with aliases),
    and ``auto_contrast``, a spelling only the JAX lowering takes."""
    from segmentation_training_pipeline_tpu import config as JC
    from segmentation_training_pipeline_tpu_torch.ops.aug import (
        lowering as TL)

    JC._populate_registries()
    names = {n.lower() for n in JC.AUGMENTERS._canonical}
    assert len(JC.AUGMENTERS.names()) == 109 and len(names) == 125
    assert TL.PORTED_AUGMENTERS == names | {"auto_contrast"}


def test_package_root_matches_jax():
    """The reference's public surface: the same ``__all__``, each name
    bound at the package root."""
    import segmentation_training_pipeline_tpu as J
    import segmentation_training_pipeline_tpu_torch as T

    assert T.__all__ == J.__all__
    for name in T.__all__:
        assert getattr(T, name) is not None, name
    assert T.parse is TC.parse and T.PipelineConfig is TC.PipelineConfig
    assert T.losses is TLo and T.metrics is TM


@pytest.mark.parametrize("patch", [
    {"architecture": "unet"}, {"architecture": "deeplab"},
    {"architecture": "DeepLabV3+", "backbone": "xception_aligned"},
    {"optimizer": "adam"}, {"optimizer": "nadam"},
    {"architecture": "psp", "optimizer": "ADAM"}],
    ids=["unet", "deeplab", "deeplabv3+", "adam", "nadam", "psp-ADAM"])
def test_config_keeps_the_users_spelling(patch):
    """``to_dict()`` equals the reference's for alias spellings: the
    architecture and the optimizer are kept as written, and the model and
    the optimizer the spelling names are the canonical ones."""
    from segmentation_training_pipeline_tpu import config as JC

    d = {"shape": [64, 64, 3], **patch}
    cfg = TC.parse_dict(d)
    assert cfg.to_dict() == JC.parse_dict(d).to_dict()
    for k, v in patch.items():
        assert getattr(cfg, k) == v
    arch = TF.DECODERS[cfg.architecture.lower()]
    assert arch is TF.DECODERS[TC.ARCHITECTURES.get(
        cfg.architecture).lower()]
    TO.build_optimizer(cfg)
