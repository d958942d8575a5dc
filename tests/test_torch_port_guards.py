"""The port's boundaries: what it imports, where it runs, what it refuses,
and its small pure functions against the JAX package's.

  * the package and ``chip_smoke.py`` import neither ``jax`` nor the JAX
    package (a subprocess import and an AST scan);
  * entry points default to the card and raise on a host without one;
  * the config parser takes the slice's experiment and refuses what is
    not ported with a pointed ``NotImplementedError``;
  * preprocessing, losses, metrics and the Adam rule match the JAX
    package's to 1e-6 (float32 elementwise work and small reductions).
"""

import ast
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
from segmentation_training_pipeline_tpu_torch import kernels as K
from segmentation_training_pipeline_tpu_torch.models import factory as TF
from segmentation_training_pipeline_tpu_torch.ops import losses as TLo
from segmentation_training_pipeline_tpu_torch.ops import metrics as TM
from segmentation_training_pipeline_tpu_torch.ops import preprocess as TP
from segmentation_training_pipeline_tpu_torch.train import optimizers as TO
from segmentation_training_pipeline_tpu_torch.train import step as TS

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "segmentation_training_pipeline_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
            "m.split('.')[0] == 'segmentation_training_pipeline_tpu']\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax",
                               "segmentation_training_pipeline_tpu"), n


def test_entry_points_default_to_the_card():
    """On a host without CUDA the defaults raise; nothing continues on
    the CPU."""
    assert not torch.cuda.is_available()
    model = TF.create_model("Unet", "resnet34", 1, dtype="float32")
    with pytest.raises((AssertionError, RuntimeError)):
        TF.init_model(model, seed=0)
    with pytest.raises((AssertionError, RuntimeError)):
        TS.create_train_state(model, TO.build_optimizer("Adam"))
    with pytest.raises(RuntimeError):
        torch.Generator(device="cuda")
    assert K.launch_counts() == {"warp_x": 0, "warp_y": 0, "elastic": 0}


def test_config_parses_the_slice_experiment():
    cfg = TC.parse_dict(EXPERIMENT)
    assert (cfg.architecture, cfg.backbone, cfg.optimizer) == (
        "Unet", "resnet34", "Adam")
    assert [a["name"] for a in cfg.augmentation] == [
        "Fliplr", "Affine", "ElasticTransformation", "Multiply"]
    assert cfg.shape == (512, 512, 3) and cfg.dtype == "bfloat16"


@pytest.mark.parametrize("patch,exc,match", [
    ({"archtecture": "Unet"}, TC.ConfigError, "Did you mean 'architecture'"),
    ({"architecture": "FPN"}, NotImplementedError, "not yet ported"),
    ({"backbone": "efficientnetb0"}, NotImplementedError, "not yet ported"),
    ({"backbone": "resnet43"}, TC.ConfigError, "Did you mean"),
    ({"optimizer": "SGD"}, NotImplementedError, "not yet ported"),
    ({"loss": "jaccard_loss"}, NotImplementedError, "not yet ported"),
    ({"loss": "dice_los"}, ValueError, "Did you mean 'dice_loss'"),
    ({"metrics": ["precision"], "primary_metric": "val_loss"},
     NotImplementedError, "not yet ported"),
    ({"augmentation": {"GaussianBlur": {"sigma": 1}}}, NotImplementedError,
     "not yet ported"),
    ({"augmentation": {"Fliplrr": 0.5}}, TC.ConfigError, "Did you mean"),
    ({"augmentation": {"Affine": {"rotat": 10}}}, TC.ConfigError,
     "Did you mean 'rotate'"),
], ids=["key", "fpn", "effnet", "backbone-typo", "sgd", "jaccard",
        "loss-typo", "metric", "blur", "aug-typo", "arg-typo"])
def test_config_refuses_what_is_not_ported(patch, exc, match):
    with pytest.raises(exc, match=match):
        TC.parse_dict({**EXPERIMENT, **patch})


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
    adam = TO.build_optimizer("Adam")
    tstate = adam.init({k: torch.from_numpy(v) for k, v in params.items()})
    for step in range(3):
        g = {k: (r.randn(*v.shape) * 10.0 ** -step).astype(np.float32)
             for k, v in params.items()}
        ju, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               jstate)
        tu, tstate = adam.update([torch.from_numpy(g[k]) for k in params],
                                 tstate)
        for k, u in zip(params, tu):
            np.testing.assert_allclose(u.numpy(), np.asarray(ju[k]),
                                       rtol=1e-6, atol=1e-7)
    assert tstate.count == 3
    with pytest.raises(NotImplementedError, match="not yet ported"):
        TO.build_optimizer("Adam", clipnorm=1.0)


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
