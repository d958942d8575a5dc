"""YAML experiment schema → typed ``PipelineConfig`` (PyTorch port).

Counterpart of ``segmentation_training_pipeline_tpu/config.py``
(``PipelineConfig``, ``parse``, ``parse_dict``): the same YAML keys, the
same per-stage overrides, and unknown keys or names error out with a
suggestion.  Every architecture, backbone and augmenter of the reference
is ported.  ``fit`` trains folds × stages
(``train/stage.py``); ``load`` and the predict/evaluate methods serve
checkpoints from ``weights/`` (``infer.py``).  Each of them runs on the
card unless ``device`` names another.
"""

from __future__ import annotations

import dataclasses
import difflib
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import yaml

from .models.encoders import ENCODERS as _ENCODERS
from .ops import losses as _losses
from .ops import metrics as _metrics
from .ops.aug.arg_schema import validate_args
from .ops.aug.lowering import _BLEND, check_scope_children
from .utils.registry import Registry

ARCHITECTURES = Registry("architecture")
BACKBONES = Registry("backbone")
OPTIMIZERS = Registry("optimizer")
CALLBACKS = Registry("callback")
AUGMENTERS = Registry("augmenter")

# every name the reference accepts; the ported subset is checked on use
for _name, _aliases in [("Unet", ("unet",)), ("FPN", ("fpn",)),
                        ("Linknet", ("linknet",)),
                        ("PSPNet", ("pspnet", "psp")),
                        ("DeepLabV3", ("DeepLabV3+", "DeepLabV3Plus",
                                       "deeplab", "deeplabv3plus"))]:
    ARCHITECTURES.register(_name, _name, aliases=_aliases)
for _name in ("resnet18 resnet34 resnet50 resnet101 resnet152 seresnet18 "
              "seresnet34 seresnet50 seresnet101 seresnet152 resnext50 "
              "resnext101 seresnext50 seresnext101 senet154 vgg16 vgg19 "
              "mobilenet mobilenetv1 mobilenetv2 efficientnetb0 "
              "efficientnetb1 efficientnetb2 efficientnetb3 efficientnetb4 "
              "efficientnetb5 efficientnetb6 efficientnetb7 densenet121 "
              "densenet169 densenet201 xception inceptionv3 "
              "inceptionresnetv2").split():
    BACKBONES.register(_name, _name)
BACKBONES.register("xception_aligned", "xception_aligned",
                   aliases=("xception65", "xception_deeplab"))
for _name, _aliases in [("Adam", ()), ("AdamW", ("adamw",)),
                        ("SGD", ("sgd",)), ("RMSprop", ("rmsprop",)),
                        ("Nadam", ()), ("Adamax", ("adamax",)),
                        ("Adagrad", ()), ("Adadelta", ()), ("Lion", ()),
                        ("LAMB", ("lamb",))]:
    OPTIMIZERS.register(_name, _name, aliases=_aliases)
for _name in ("EarlyStopping ReduceLROnPlateau ModelCheckpoint CSVLogger "
              "TensorBoard CyclicLR LRVariator TerminateOnNaN "
              "LearningRateScheduler").split():
    CALLBACKS.register(_name, _name)
for _entry in (
        "Fliplr|HorizontalFlip Flipud|VerticalFlip Rot90 Affine "
        "ElasticTransformation|ElasticTransform|Elastic Crop CropAndPad Pad "
        "CropToFixedSize|RandomCrop PadToFixedSize CenterCropToFixedSize "
        "Multiply Add LinearContrast|ContrastNormalization GammaContrast "
        "SigmoidContrast LogContrast AdditiveGaussianNoise GaussianBlur "
        "AverageBlur AdditivePoissonNoise CoarseDropout Cutout Grayscale "
        "Invert Solarize Sharpen Emboss Dropout SaltAndPepper|SaltPepper Salt "
        "Pepper ImpulseNoise CoarseSaltAndPepper CoarseSalt CoarsePepper "
        "AdditiveLaplaceNoise DirectedEdgeDetect Canny ChangeColorspace "
        "MeanShiftBlur Cartoon AddToHue AddToSaturation MultiplyHue "
        "MultiplySaturation RemoveSaturation Dropout2d|ChannelDropout "
        "TotalDropout Noop|Identity EdgeDetect AveragePooling MaxPooling "
        "MinPooling PiecewiseAffine PerspectiveTransform "
        "AddToHueAndSaturation MultiplyHueAndSaturation Rotate Resize|Scale "
        "MotionBlur MedianBlur MedianPooling BilateralBlur FastSnowyLandscape "
        "HistogramEqualization|AllChannelsHistogramEqualization "
        "CLAHE|AllChannelsCLAHE JpegCompression Posterize ChannelShuffle "
        "TranslateX TranslateY ScaleX ScaleY ShearX ShearY AddElementwise "
        "MultiplyElementwise ReplaceElementwise Autocontrast|AutoContrast "
        "Clouds Fog Snowflakes Rain ChangeColorTemperature "
        "UniformColorQuantization Superpixels UniformVoronoi "
        "RegularGridVoronoi RelativeRegularGridVoronoi "
        "KMeansColorQuantization Jigsaw Sometimes SomeOf OneOf WithChannels "
        "WithHueAndSaturation WithBrightnessChannels WithColorspace "
        "BlendAlpha|Alpha BlendAlphaElementwise|AlphaElementwise "
        "BlendAlphaVerticalLinearGradient BlendAlphaHorizontalLinearGradient "
        "BlendAlphaRegularGrid BlendAlphaCheckerboard "
        "BlendAlphaSimplexNoise|SimplexNoiseAlpha "
        "BlendAlphaFrequencyNoise|FrequencyNoiseAlpha BlendAlphaSomeColors "
        "BlendAlphaSegMapClassIds").split():
    _name, *_aliases = _entry.split("|")
    AUGMENTERS.register(_name, _name, aliases=_aliases)

PORTED_ARCHITECTURES = set(ARCHITECTURES.names())
PORTED_BACKBONES = set(_ENCODERS)
PORTED_OPTIMIZERS = set(OPTIMIZERS.names())

_TOP_LEVEL_KEYS = {
    "architecture", "backbone", "encoder_weights", "shape", "classes",
    "activation", "dropout",
    "optimizer", "lr", "loss", "batch", "metrics", "primary_metric",
    "primary_metric_mode", "clipnorm", "clipvalue", "weight_decay",
    "momentum", "class_weights",
    "folds_count", "testSplit", "random_state", "stratified",
    "negatives", "validation_negatives",
    "augmentation", "transforms", "preprocessing",
    "crops",
    "flipPred", "testTimeAugmentation", "threshold",
    "stages", "callbacks", "freeze_encoder",
    "directory", "experiment_name", "verbose",
    "dtype", "mesh", "prefetch", "remat", "donate", "profile", "debug",
    "cache",
}
_STAGE_KEYS = {
    "epochs", "lr", "loss", "negatives", "validation_negatives",
    "initial_weights", "callbacks", "freeze_encoder", "unfreeze_encoder",
    "steps_per_epoch", "batch",
}
_TTA_VALUES = {"flip", "hflip", "flips", "d4_subset", "hvflip", "d4",
               "full"}


class ConfigError(ValueError):
    pass


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to the torch "
                               "package")


def _check_keys(d: Dict[str, Any], allowed: set, where: str):
    for k in d:
        if k not in allowed:
            m = difflib.get_close_matches(k, list(allowed), n=1)
            hint = f" Did you mean {m[0]!r}?" if m else ""
            raise ConfigError(f"unknown key {k!r} in {where}.{hint}")


def _resolve(registry: Registry, name: str, ported: set) -> str:
    """Canonical name; ConfigError (with suggestion) for an unknown one,
    NotImplementedError for a known one not ported yet.  The config keeps
    the user's spelling of the architecture and the optimizer, as the
    reference does; the backbone is stored canonical."""
    if name not in registry:
        hint = registry.suggest(name)
        extra = f" Did you mean {hint!r}?" if hint else ""
        raise ConfigError(f"unknown {registry.kind} {name!r}.{extra}")
    canon = registry.get(name)
    if canon not in ported:
        raise _not_ported(f"{registry.kind} {name!r}")
    return canon


def _opt_float(v):
    return None if v is None else float(v)


def _normalize_callbacks(spec) -> List[Dict[str, Any]]:
    """Mapping or list-of-mapping callback syntax →
    [{"name", "args"}], names validated (the fit loop that runs them is
    not ported yet)."""
    if spec is None:
        return []
    items: List[Tuple[str, Any]] = []
    if isinstance(spec, dict):
        items = list(spec.items())
    elif isinstance(spec, list):
        for entry in spec:
            if isinstance(entry, str):
                items.append((entry, {}))
            elif isinstance(entry, dict) and len(entry) == 1:
                items.append(next(iter(entry.items())))
            else:
                raise ConfigError(f"bad callback entry: {entry!r}")
    else:
        raise ConfigError(f"bad callbacks block: {spec!r}")
    out = []
    for name, args in items:
        if name not in CALLBACKS:
            hint = CALLBACKS.suggest(name)
            extra = f" Did you mean {hint!r}?" if hint else ""
            raise ConfigError(f"unknown callback {name!r}.{extra}")
        out.append({"name": name, "args": dict(args or {})})
    return out


# real imgaug names the reference intentionally does not lower: a
# migrating config that uses one gets a pointed answer, not a bare
# "unknown augmenter"
_KNOWN_UNSUPPORTED_AUGMENTERS = frozenset({
    "Voronoi", "AveragePool", "ElasticTransformationApprox",
    "Lambda", "AssertShape", "AssertLambda",
    "BlendAlphaMask", "BlendAlphaBoundingBoxes",
})
_UNSUPPORTED_AUG_PREFIXES = ("pillike", "imgcorruptlike")


def _normalize_augmentation(spec) -> List[Dict[str, Any]]:
    """``{Fliplr: 0.5, Affine: {...}}`` → [{"name", "args"}], names and
    argument keys validated; the combinators' and blends' child blocks are
    validated and normalised recursively, as the reference does, so a
    typo'd child name fails at parse.  A scope's children are held to the
    reference's scope refusals (``lowering.check_scope_children``), which
    its lowering raises when the block is built."""
    if spec is None:
        return []
    items: List[Tuple[str, Any]] = []
    if isinstance(spec, dict):
        items = list(spec.items())
    elif isinstance(spec, list):
        for entry in spec:
            if isinstance(entry, dict) and len(entry) == 1:
                items.append(next(iter(entry.items())))
            elif isinstance(entry, str):
                items.append((entry, {}))
            else:
                raise ConfigError(f"bad augmentation entry: {entry!r}")
    else:
        raise ConfigError(f"bad augmentation block: {spec!r}")
    out = []
    for name, args in items:
        if name not in AUGMENTERS:
            if name in _KNOWN_UNSUPPORTED_AUGMENTERS or any(
                    name.startswith(p) for p in _UNSUPPORTED_AUG_PREFIXES):
                raise ConfigError(
                    f"augmenter {name!r} is a real imgaug name this "
                    "pipeline intentionally does not lower (see the "
                    "'imgaug names we do not lower' list in "
                    "docs/schema.md for why and for the nearest "
                    "supported equivalent)")
            hint = AUGMENTERS.suggest(name)
            extra = f" Did you mean {hint!r}?" if hint else ""
            raise ConfigError(f"unknown augmenter {name!r}.{extra}")
        try:
            validate_args(name, args)
        except ValueError as e:
            raise ConfigError(str(e)) from None
        low = name.lower()
        if low == "sometimes":
            if not isinstance(args, dict):
                raise ConfigError(
                    f"Sometimes expects {{p: ..., then: {{...}}}}, got {args!r}")
            args = dict(args)
            child = (args.pop("then", None) or args.pop("then_list", None)
                     or args.pop("children", None))
            args["then"] = _normalize_augmentation(child)
            els = (args.pop("else", None) or args.pop("else_list", None)
                   or args.pop("otherwise", None))
            if els is not None:
                args["else"] = _normalize_augmentation(els)
            if not args["then"] and els is None:
                raise ConfigError(
                    "Sometimes has neither a then: nor an else: child "
                    "block — it would lower to a no-op")
        elif low == "oneof":
            if not isinstance(args, list) or not args:
                raise ConfigError(
                    f"OneOf expects a non-empty list of augmenters, got {args!r}")
            args = [_normalize_augmentation(e if isinstance(e, (dict, list))
                                            else [e]) for e in args]
        elif low == "someof":
            if not isinstance(args, dict) or "children" not in args:
                raise ConfigError(
                    f"SomeOf expects {{n: ..., children: [...]}}, got {args!r}")
            args = dict(args)
            args["children"] = [
                _normalize_augmentation(e if isinstance(e, (dict, list))
                                        else [e])
                for e in args["children"]]
        elif low == "withchannels":
            if not isinstance(args, dict) or "channels" not in args:
                raise ConfigError(
                    f"WithChannels expects {{channels: [...], children: "
                    f"{{...}}}}, got {args!r}")
            args = dict(args)
            child = args.pop("children", None) or args.pop("then", None)
            args["children"] = _scope_children(name, child)
        elif low in _COLOR_SCOPES:
            if not isinstance(args, dict):
                raise ConfigError(
                    f"{name} expects {{children: {{...}}}}, got {args!r}")
            args = dict(args)
            if low == "withcolorspace":
                cs = str(args.get("to_colorspace", "")).upper()
                if cs != "HSV":
                    raise ConfigError(
                        "WithColorspace lowers only {to_colorspace: HSV} "
                        f"here (got {args.get('to_colorspace')!r}) — see "
                        "docs/schema.md")
            child = args.pop("children", None) or args.pop("then", None)
            if not child:
                raise ConfigError(f"{name} needs a children: block")
            args["children"] = _scope_children(name, child)
        elif low in _BLEND:
            if not isinstance(args, dict):
                raise ConfigError(
                    f"{name} expects {{foreground: {{...}}, ...}}, got "
                    f"{args!r}")
            args = dict(args)
            fg = args.pop("foreground", None) or args.pop("first", None)
            bg = args.pop("background", None) or args.pop("second", None)
            if fg is None and bg is None:
                raise ConfigError(
                    f"{name} needs a foreground (or background) child "
                    "augmenter block")
            if fg is not None:
                args["foreground"] = _normalize_augmentation(fg)
            if bg is not None:
                args["background"] = _normalize_augmentation(bg)
        out.append({"name": name, "args": args})
    return out


_COLOR_SCOPES = ("withhueandsaturation", "withbrightnesschannels",
                 "withcolorspace")


def _scope_children(scope: str, child):
    """A scope's child block, normalised and held to the reference's
    refusals of its children (a ``ValueError``, raised at parse where the
    reference's lowering raises it)."""
    children = _normalize_augmentation(child)
    check_scope_children(scope, children)
    return children


@dataclass
class Stage:
    index: int = 0
    epochs: int = 1
    lr: Optional[float] = None
    loss: Optional[str] = None
    negatives: Optional[Any] = None
    validation_negatives: Optional[Any] = None
    initial_weights: Optional[str] = None
    callbacks: List[Dict[str, Any]] = field(default_factory=list)
    freeze_encoder: Optional[bool] = None
    unfreeze_encoder: bool = False
    steps_per_epoch: Optional[int] = None
    batch: Optional[int] = None

    @staticmethod
    def from_dict(d: Dict[str, Any], index: int) -> "Stage":
        _check_keys(d, _STAGE_KEYS, f"stages[{index}]")
        return Stage(
            index=index, epochs=int(d.get("epochs", 1)),
            lr=_opt_float(d.get("lr")), loss=d.get("loss"),
            negatives=d.get("negatives"),
            validation_negatives=d.get("validation_negatives"),
            initial_weights=d.get("initial_weights"),
            callbacks=_normalize_callbacks(d.get("callbacks")),
            freeze_encoder=d.get("freeze_encoder"),
            unfreeze_encoder=bool(d.get("unfreeze_encoder", False)),
            steps_per_epoch=d.get("steps_per_epoch"), batch=d.get("batch"))


def _check_tta(v, shape):
    if v is None or v is False:
        return None
    if v is True:
        return "flip"
    s = str(v).lower()
    if s not in _TTA_VALUES:
        raise ConfigError(f"testTimeAugmentation must be one of "
                          f"{sorted(_TTA_VALUES)}, got {v!r}")
    if s in ("d4", "full") and shape[0] != shape[1]:
        raise ConfigError(f"testTimeAugmentation: d4 needs a square shape, "
                          f"got {tuple(shape[:2])} — use 'flips'")
    return s


@dataclass
class PipelineConfig:
    """A parsed experiment (the fields of the JAX package's config)."""

    architecture: str = "Unet"
    backbone: str = "resnet34"
    encoder_weights: Optional[str] = None
    shape: Tuple[int, int, int] = (128, 128, 3)
    classes: int = 1
    activation: str = "sigmoid"
    dropout: float = 0.0
    optimizer: str = "Adam"
    lr: float = 1e-3
    loss: str = "binary_crossentropy"
    batch: int = 16
    metrics: List[str] = field(default_factory=list)
    primary_metric: str = "val_loss"
    primary_metric_mode: str = "auto"
    clipnorm: Optional[float] = None
    clipvalue: Optional[float] = None
    weight_decay: Optional[float] = None
    momentum: float = 0.0
    class_weights: Optional[List[float]] = None
    folds_count: int = 5
    testSplit: float = 0.0
    random_state: int = 33
    stratified: bool = False
    negatives: Optional[Any] = None
    validation_negatives: Optional[Any] = None
    augmentation: List[Dict[str, Any]] = field(default_factory=list)
    transforms: List[Dict[str, Any]] = field(default_factory=list)
    preprocessing: Optional[str] = None
    crops: Optional[int] = None
    flipPred: bool = False
    testTimeAugmentation: Optional[str] = None
    threshold: float = 0.5
    stages: List[Stage] = field(default_factory=lambda: [Stage()])
    callbacks: List[Dict[str, Any]] = field(default_factory=list)
    freeze_encoder: bool = False
    directory: str = "."
    experiment_name: str = "experiment"
    verbose: int = 1
    dtype: str = "bfloat16"
    mesh: Dict[str, int] = field(default_factory=dict)
    prefetch: int = 2
    remat: bool = False
    donate: bool = True
    profile: Any = False
    debug: Any = False
    cache: bool = False

    @staticmethod
    def from_dict(d: Dict[str, Any], directory: str = ".") -> "PipelineConfig":
        _check_keys(d, _TOP_LEVEL_KEYS, "config")
        shape = tuple(d.get("shape", (128, 128, 3)))
        if len(shape) == 2:
            shape = (*shape, 3)
        if len(shape) != 3:
            raise ConfigError(f"shape must be [H, W, C], got {shape!r}")
        arch = str(d.get("architecture", "Unet"))
        _resolve(ARCHITECTURES, arch, PORTED_ARCHITECTURES)
        backbone = _resolve(BACKBONES, str(d.get("backbone", "resnet34")),
                            PORTED_BACKBONES)
        opt = str(d.get("optimizer", "Adam"))
        _resolve(OPTIMIZERS, opt, PORTED_OPTIMIZERS)
        activation = str(d.get("activation", "sigmoid"))
        if activation not in ("sigmoid", "softmax", "linear", "none"):
            raise ConfigError(f"unknown activation {activation!r}")
        metrics_list = list(d.get("metrics", []) or [])
        for m in metrics_list:
            try:
                _metrics.get(m)
            except KeyError:
                hint = difflib.get_close_matches(m.lower(),
                                                 sorted(_metrics.KNOWN), n=1)
                extra = f" Did you mean {hint[0]!r}?" if hint else ""
                raise ConfigError(f"unknown metric {m!r}.{extra}") from None
        primary = str(d.get("primary_metric", "val_loss"))
        stripped = primary[4:] if primary.startswith("val_") else primary
        if stripped != "loss" and stripped not in metrics_list:
            raise ConfigError(
                f"primary_metric {primary!r} is not tracked: it must be "
                f"'loss'/'val_loss' or one of metrics={metrics_list} "
                "(optionally 'val_'-prefixed)")
        loss = str(d.get("loss", "binary_crossentropy"))
        _losses.parse_loss_expr(loss)
        stages = [Stage.from_dict(s or {}, i)
                  for i, s in enumerate(d.get("stages") or [{}])]
        for s in stages:
            if s.loss is not None:
                _losses.parse_loss_expr(s.loss)
        mode = str(d.get("primary_metric_mode", "auto"))
        if mode not in ("auto", "min", "max"):
            raise ConfigError(f"primary_metric_mode must be auto|min|max, "
                              f"got {mode!r}")
        dtype = str(d.get("dtype", "bfloat16"))
        if dtype not in ("bfloat16", "float32", "float16"):
            raise ConfigError(f"dtype must be bfloat16|float32|float16, got "
                              f"{dtype!r}")
        class_weights = d.get("class_weights")
        if class_weights is not None:
            class_weights = [float(v) for v in class_weights]
            if len(class_weights) != int(d.get("classes", 1)):
                raise ConfigError(
                    f"class_weights has {len(class_weights)} entries but "
                    f"classes={d.get('classes', 1)}")
        crops = d.get("crops")
        if crops is not None:
            crops = int(crops)
            if crops < 2:
                raise ConfigError("crops must be >= 2 (N×N tiling)")
        return PipelineConfig(
            architecture=arch, backbone=backbone,
            encoder_weights=d.get("encoder_weights"), shape=shape,
            classes=int(d.get("classes", 1)), activation=activation,
            dropout=float(d.get("dropout", 0.0)), optimizer=opt,
            lr=float(d.get("lr", 1e-3)), loss=loss,
            batch=int(d.get("batch", 16)), metrics=metrics_list,
            primary_metric=primary, primary_metric_mode=mode,
            clipnorm=_opt_float(d.get("clipnorm")),
            clipvalue=_opt_float(d.get("clipvalue")),
            weight_decay=_opt_float(d.get("weight_decay")),
            momentum=float(d.get("momentum", 0.0)),
            class_weights=class_weights,
            folds_count=int(d.get("folds_count", 5)),
            testSplit=float(d.get("testSplit", 0.0)),
            random_state=int(d.get("random_state", 33)),
            stratified=bool(d.get("stratified", False)),
            negatives=d.get("negatives"),
            validation_negatives=d.get("validation_negatives"),
            augmentation=_normalize_augmentation(d.get("augmentation")),
            transforms=_normalize_augmentation(d.get("transforms")),
            preprocessing=d.get("preprocessing"), crops=crops,
            flipPred=bool(d.get("flipPred", False)),
            testTimeAugmentation=_check_tta(d.get("testTimeAugmentation"),
                                            shape),
            threshold=float(d.get("threshold", 0.5)), stages=stages,
            callbacks=_normalize_callbacks(d.get("callbacks")),
            freeze_encoder=bool(d.get("freeze_encoder", False)),
            directory=str(d.get("directory", directory)),
            experiment_name=str(d.get("experiment_name", "experiment")),
            verbose=int(d.get("verbose", 1)), dtype=dtype,
            mesh=dict(d.get("mesh", {}) or {}),
            prefetch=int(d.get("prefetch", 2)),
            remat=bool(d.get("remat", False)),
            donate=bool(d.get("donate", True)),
            profile=d.get("profile", False),
            debug=("checks" if str(d.get("debug", "")).lower() == "checks"
                   else bool(d.get("debug", False))),
            cache=bool(d.get("cache", False)))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @property
    def weights_dir(self) -> str:
        return os.path.join(self.directory, "weights")

    @property
    def metrics_dir(self) -> str:
        return os.path.join(self.directory, "metrics")

    def weights_path(self, fold: int, stage: int) -> str:
        # reference contract: weights/best-{fold}.{stage}.weights
        return os.path.join(self.weights_dir, f"best-{fold}.{stage}.weights")

    def metrics_path(self, fold: int, stage: int) -> str:
        # reference contract: metrics/metrics-{fold}.{stage}.csv
        return os.path.join(self.metrics_dir, f"metrics-{fold}.{stage}.csv")

    def primary_mode(self) -> str:
        """Resolve ``auto`` mode from the metric name, Keras-style."""
        if self.primary_metric_mode != "auto":
            return self.primary_metric_mode
        name = self.primary_metric.replace("val_", "")
        return "min" if ("loss" in name or "error" in name) else "max"

    def kfold(self, dataset):
        from .data.datasets import KFoldedDataSet

        return KFoldedDataSet(dataset, folds_count=self.folds_count,
                              random_state=self.random_state,
                              test_split=self.testSplit,
                              stratified=self.stratified)

    def fit(self, dataset, foldsToExecute: Optional[Sequence[int]] = None,
            start_from_stage: int = 0, verbose: Optional[int] = None,
            device="cuda", aug_seed: Optional[int] = None,
            timings: Optional[list] = None):
        """Train all requested folds through all stages on ``device``.
        See ``train/stage.py`` (``aug_seed`` seeds the augmentation draws
        in place of ``random_state``; ``timings`` gets each epoch's)."""
        from .train.stage import fit_pipeline

        return fit_pipeline(self, dataset, foldsToExecute=foldsToExecute,
                            start_from_stage=start_from_stage,
                            verbose=verbose, device=device,
                            aug_seed=aug_seed, timings=timings)

    # the serving surface (``infer.py``); each takes ``device="cuda"``
    def load(self, fold=0, stage: int = -1, device="cuda"):
        """Load trained weights for (fold or folds, stage) → an
        ``InferenceBundle`` on ``device``."""
        from .infer import load_model

        return load_model(self, fold, stage, device)

    def predict_all_to_dir(self, src, dst, **kw):
        from .infer import predict_all_to_dir

        return predict_all_to_dir(self, src, dst, **kw)

    def predict_in_directory(self, src, dst, **kw):  # reference alias
        return self.predict_all_to_dir(src, dst, **kw)

    def predict_to_directory(self, src, dst, **kw):  # reference alias
        return self.predict_all_to_dir(src, dst, **kw)

    def predict_on_dataset(self, dataset, **kw):
        from .infer import predict_on_dataset

        return predict_on_dataset(self, dataset, **kw)

    def predict_to_csv(self, src, csv_path, **kw):
        from .infer import predict_to_csv

        return predict_to_csv(self, src, csv_path, **kw)

    def evaluate(self, dataset, **kw):
        from .infer import evaluate

        return evaluate(self, dataset, **kw)

    def evaluateAll(self, dataset, **kw):  # reference alias
        return self.evaluate(dataset, **kw)


def parse(path: str) -> PipelineConfig:
    """Parse a YAML experiment file; its directory is the experiment's."""
    with open(path, "r") as f:
        raw = yaml.safe_load(f) or {}
    if not isinstance(raw, dict):
        raise ConfigError(f"config root must be a mapping, got "
                          f"{type(raw).__name__}")
    return PipelineConfig.from_dict(
        raw, directory=os.path.dirname(os.path.abspath(path)))


def parse_dict(d: Dict[str, Any], directory: str = ".") -> PipelineConfig:
    return PipelineConfig.from_dict(dict(d), directory=directory)
