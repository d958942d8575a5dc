"""Per-augmenter argument schemas, checked at parse time.

Counterpart of ``segmentation_training_pipeline_tpu/ops/aug/arg_schema.py``
for the augmenters ported so far.  The reference's config loader reflects
YAML dicts into real imgaug constructors, which raise on an unknown kwarg;
this keeps that property, so a typo'd key errors at parse (with a
suggestion) instead of lowering to a silent no-op.
"""

from __future__ import annotations

import difflib
from typing import Any, Dict, Set, Tuple

_BOOKKEEPING = {
    "name": "imgaug bookkeeping arg (augmenter naming) — remove it",
    "seed": "per-augmenter seeds are not lowered; the pipeline derives all "
            "randomness from the training step's generator — remove it",
    "random_state": "per-augmenter seeds are not lowered; the pipeline "
                    "derives all randomness from the training step's "
                    "generator — remove it",
    "deterministic": "imgaug bookkeeping arg — remove it (use the "
                     "`transforms:` block for deterministic application)",
}
_FIXED_INTERP = ("interpolation is fixed here: bilinear for images, "
                 "nearest for masks (one fused warp) — remove it")

# canonical name → (allowed keys, {unsupported imgaug key: reason})
_SCHEMA: Dict[str, Tuple[Set[str], Dict[str, str]]] = {}
_LOOKUP: Dict[str, str] = {}


def _def(name: str, allowed: Set[str], unsupported: Dict[str, str] = None,
         aliases: Tuple[str, ...] = ()):
    key = name.lower()
    _SCHEMA[key] = (set(allowed), dict(unsupported or {}))
    for n in (name, *aliases):
        _LOOKUP[n.lower()] = key


_STATIC_SHAPE = ("output shapes are static; the lowered form always keeps "
                 "the input shape (resize-back) — remove it")

_def("Fliplr", {"p"}, aliases=("HorizontalFlip",))
_def("Flipud", {"p"}, aliases=("VerticalFlip",))
_def("Rot90", {"k", "keep_size"})
_def("Affine", {"scale", "translate_percent", "translate_px", "rotate",
                "shear", "cval", "mode"},
     {"order": _FIXED_INTERP,
      "backend": "there is no cv2/skimage backend choice — the warp is one "
                 "fused on-device kernel; remove it",
      "fit_output": _STATIC_SHAPE})
_def("Crop", {"px", "percent", "keep_size", "cval", "mode"},
     {"sample_independently": "sides always sample independently here — "
                              "remove it (it is the imgaug default)"})
_CAP_UNSUP = {"sample_independently": "sides always sample independently "
                                      "here — remove it"}
_def("CropAndPad", {"px", "percent", "pad_mode", "pad_cval", "keep_size",
                    "cval", "mode"}, _CAP_UNSUP)
_def("Pad", {"px", "percent", "pad_mode", "pad_cval", "keep_size", "cval",
             "mode"}, _CAP_UNSUP)
_def("CropToFixedSize", {"width", "height", "position"},
     aliases=("RandomCrop",))
_def("PadToFixedSize", {"width", "height", "position", "pad_mode",
                        "pad_cval", "cval", "mode"})
_def("CenterCropToFixedSize", {"width", "height"})
_def("ElasticTransformation", {"alpha", "sigma", "cval", "mode"},
     {"order": _FIXED_INTERP,
      "polygon_recoverer": "polygon targets are not part of this pipeline "
                           "(images + segmentation masks only)"},
     aliases=("ElasticTransform", "Elastic"))
_def("PiecewiseAffine", {"scale", "nb_rows", "nb_cols", "cval", "mode"},
     {"order": _FIXED_INTERP,
      "absolute_scale": "scale is always relative to the image dimension "
                        "here — convert to a fraction",
      "polygon_recoverer": "polygon targets are not part of this pipeline"})
_def("PerspectiveTransform", {"scale", "cval", "mode", "keep_size"},
     {"fit_output": _STATIC_SHAPE})
_def("Multiply", {"mul", "per_channel"})


def validate_args(name: str, args: Any) -> None:
    """Raise ValueError for unknown/unsupported argument keys of a dict
    ``args`` (bare scalars/ranges are validated by the lowering)."""
    if not isinstance(args, dict):
        return
    canon = _LOOKUP.get(name.lower())
    if canon is None:
        return
    allowed, unsupported = _SCHEMA[canon]
    for k in args:
        if k in allowed:
            continue
        if k in unsupported:
            raise ValueError(
                f"augmenter {name}: argument {k!r} is a real imgaug "
                f"parameter this pipeline does not lower — {unsupported[k]}")
        if k in _BOOKKEEPING:
            raise ValueError(
                f"augmenter {name}: argument {k!r} — {_BOOKKEEPING[k]}")
        m = difflib.get_close_matches(k, sorted(allowed | set(unsupported)),
                                      n=1)
        hint = f" Did you mean {m[0]!r}?" if m else ""
        raise ValueError(
            f"augmenter {name}: unknown argument {k!r} (allowed: "
            f"{', '.join(sorted(allowed))}).{hint}")
    if canon == "affine":
        # the per-axis dict forms take ONLY x/y — a typo'd axis key would
        # silently default both axes
        for pk in ("scale", "translate_percent", "translate_px", "shear"):
            pv = args.get(pk)
            if isinstance(pv, dict):
                bad = [k for k in pv if k not in ("x", "y")]
                if bad:
                    raise ValueError(
                        f"{name}: {pk} axis dict takes only 'x'/'y' keys, "
                        f"got {bad} (a typo here silently no-ops the axis)")
