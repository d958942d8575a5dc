"""Per-augmenter argument schemas, checked at parse time.

Counterpart of ``segmentation_training_pipeline_tpu/ops/aug/arg_schema.py``.
The reference's config loader reflects
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

# --- Affine sugar (rewritten to Affine by the lowering) ---------------------
_AFFINE_ALLOWED = _SCHEMA["affine"][0]
_AFFINE_UNSUP = _SCHEMA["affine"][1]
_def("Rotate", _AFFINE_ALLOWED | {"value"}, _AFFINE_UNSUP)
_def("TranslateX", {"px", "percent"})
_def("TranslateY", {"px", "percent"})
_def("ScaleX", {"scale", "value"})
_def("ScaleY", {"scale", "value"})
_def("ShearX", {"shear", "value"})
_def("ShearY", {"shear", "value"})

# --- pixelwise photometrics -------------------------------------------------
_def("Add", {"value", "per_channel"})
_def("LinearContrast", {"alpha", "per_channel"},
     aliases=("ContrastNormalization",))
_def("GammaContrast", {"gamma", "per_channel"})
_def("SigmoidContrast", {"gain", "cutoff", "per_channel"})
_def("LogContrast", {"gain", "per_channel"})
_def("AdditiveGaussianNoise", {"scale", "per_channel"},
     {"loc": "a non-zero noise mean is not lowered — compose with "
             "`Add: <loc>`"})
_def("AdditivePoissonNoise", {"lam", "per_channel"})
_def("CoarseDropout", {"p", "size_percent", "per_channel"},
     {"size_px": "grid sizes are static here — use `size_percent`",
      "min_size": "grid sizes are static here — use `size_percent`"})
_def("Cutout", {"nb_iterations", "size", "cval", "squared", "fill_mode"},
     {"position": "cutout rectangles land on a static grid here (uniform "
                  "positions) — remove it",
      "fill_per_channel": "fill is per-image constant `cval` here — "
                          "remove it"})
_def("Invert", {"p", "per_channel"},
     {"min_value": "only full-range 255−v inversion is lowered — use "
                   "Solarize for thresholded inversion",
      "max_value": "only full-range 255−v inversion is lowered — use "
                   "Solarize for thresholded inversion",
      "threshold": "use Solarize for thresholded inversion",
      "invert_above_threshold": "use Solarize for thresholded inversion"})
_def("Solarize", {"p", "threshold"})
_def("Dropout2d", {"p", "nb_keep_channels"}, aliases=("ChannelDropout",))
_def("TotalDropout", {"p"})
_def("Noop", set(), aliases=("Identity",))
_def("Dropout", {"p", "per_channel"})
_def("SaltAndPepper", {"p", "per_channel"}, aliases=("SaltPepper",))
_def("Salt", {"p", "per_channel"})
_def("Pepper", {"p", "per_channel"})
_def("ReplaceElementwise", {"mask", "replacement", "per_channel"})
_def("ImpulseNoise", {"p"})
_COARSE_SP_UNSUP = {
    "size_px": "grid sizes are static here — use `size_percent`",
    "min_size": "grid sizes are static here — use `size_percent`",
}
_def("CoarseSaltAndPepper", {"p", "size_percent", "per_channel"},
     _COARSE_SP_UNSUP)
_def("CoarseSalt", {"p", "size_percent", "per_channel"}, _COARSE_SP_UNSUP)
_def("CoarsePepper", {"p", "size_percent", "per_channel"}, _COARSE_SP_UNSUP)
_def("AdditiveLaplaceNoise", {"scale", "per_channel"},
     {"loc": "a non-zero noise mean is not lowered — compose with "
             "`Add: <loc>`"})
_def("Posterize", {"nb_bits"},
     {"to_colorspace": "posterize runs on RGB directly here",
      "from_colorspace": "posterize runs on RGB directly here",
      "max_size": _STATIC_SHAPE})
_def("ChannelShuffle", {"p"},
     {"channels": "always permutes all channels here — use WithChannels "
                  "to scope other photometrics"})
_def("AddElementwise", {"value", "per_channel"})
_def("MultiplyElementwise", {"mul", "per_channel"})
_def("Resize", {"size", "percent"},
     {"interpolation": _FIXED_INTERP}, aliases=("Scale",))

# --- colour -------------------------------------------------------------------
_def("Grayscale", {"alpha"})
_def("AddToHueAndSaturation",
     {"value", "value_hue", "value_saturation", "per_channel"})
_def("MultiplyHueAndSaturation",
     {"mul", "mul_hue", "mul_saturation", "per_channel"})
_def("AddToHue", {"value"})
_def("AddToSaturation", {"value"})
_def("MultiplyHue", {"mul"})
_def("MultiplySaturation", {"mul"})
_def("RemoveSaturation", {"mul"})
_def("ChangeColorTemperature", {"kelvin"},
     {"to_colorspace": "runs on RGB directly here",
      "from_colorspace": "runs on RGB directly here"})
_def("ChangeColorspace", {"to_colorspace", "alpha"},
     {"from_colorspace": "runs on RGB directly here",
      "children": "ChangeColorspace converts the OUTPUT image; use "
                  "WithColorspace for scoped child edits"})
_def("Autocontrast", {"cutoff", "per_channel"}, aliases=("AutoContrast",))
_def("HistogramEqualization", set(),
     {"to_colorspace": "equalization is per-channel here (the "
                       "AllChannels form)",
      "from_colorspace": "equalization is per-channel here (the "
                         "AllChannels form)"},
     aliases=("AllChannelsHistogramEqualization",))
_def("CLAHE", {"clip_limit", "tile_grid_size", "tile_grid_size_px"},
     {"tile_grid_size_px_min": "the tile grid is a static scalar here",
      "to_colorspace": "CLAHE runs per-channel here (the AllChannels form)",
      "from_colorspace": "CLAHE runs per-channel here (the AllChannels "
                         "form)"},
     aliases=("AllChannelsCLAHE",))

# --- filters ------------------------------------------------------------------
_def("GaussianBlur", {"sigma"})
_def("AverageBlur", {"k"})
_def("Sharpen", {"alpha", "lightness"})
_def("Emboss", {"alpha", "strength"})
_def("EdgeDetect", {"alpha"})
_def("DirectedEdgeDetect", {"alpha", "direction"})
_def("Canny",
     {"alpha", "hysteresis_thresholds", "sobel_kernel_size",
      "hysteresis_iters"},
     {"colorizer": "arbitrary colorizer OBJECTS cannot enter a jitted "
                   "pipeline; imgaug's default random-colors colorizer is "
                   "built in (one uniform edge color + one background "
                   "color per image)"})
_def("Cartoon",
     {"blur_ksize", "segmentation_size", "saturation", "edge_prevalence"},
     {"from_colorspace": "runs on RGB directly here"})
_def("MeanShiftBlur", {"spatial_radius", "color_radius"},
     {"spatial_window_radius": "the imgaug 0.4 name is `spatial_radius`",
      "color_window_radius": "the imgaug 0.4 name is `color_radius`"})
_def("AveragePooling", {"k", "keep_size"})
_def("MaxPooling", {"k", "keep_size"})
_def("MinPooling", {"k", "keep_size"})
_def("MotionBlur", {"k", "angle"},
     {"direction": "the blur line is always centered on the kernel — "
                   "remove it",
      "order": _FIXED_INTERP})
_def("MedianBlur", {"k"})
_def("MedianPooling", {"k", "keep_size"})
_def("BilateralBlur", {"d", "sigma_color", "sigma_space"})
_def("JpegCompression", {"compression"})

# --- weather, quantisation, the segment names and Jigsaw ----------------------
_def("FastSnowyLandscape", {"lightness_threshold", "lightness_multiplier"},
     {"from_colorspace": "runs on RGB directly here"})
_def("Clouds", {"coverage"})
_def("Fog", {"density"})
_def("Snowflakes", {"density", "speed"},
     {"flake_size": "flake geometry is fixed here — density/speed only",
      "flake_size_uniformity": "flake geometry is fixed here",
      "angle": "flake geometry is fixed here",
      "density_uniformity": "flake geometry is fixed here"})
_def("Rain", {"density", "speed"},
     {"drop_size": "drop geometry is fixed here — density/speed only"})
_def("UniformColorQuantization", {"n_colors"},
     {"to_colorspace": "runs on RGB directly here",
      "from_colorspace": "runs on RGB directly here",
      "max_size": _STATIC_SHAPE,
      "counts": "use `n_colors`"})
_SEG_INTERP = ("the segment maps are computed at the max_size downscale "
               "and nearest-upsampled; compositing is at full resolution "
               "(see docs/schema.md) — remove it")
_def("Superpixels", {"p_replace", "n_segments", "max_size"},
     {"interpolation": _SEG_INTERP})
_def("UniformVoronoi", {"n_points", "p_replace", "max_size"},
     {"interpolation": _SEG_INTERP})
_def("RegularGridVoronoi",
     {"n_rows", "n_cols", "p_drop_points", "p_replace", "max_size"},
     {"interpolation": _SEG_INTERP})
_def("RelativeRegularGridVoronoi",
     {"n_rows_frac", "n_cols_frac", "p_drop_points", "p_replace",
      "max_size"},
     {"interpolation": _SEG_INTERP})
_def("Jigsaw", {"nb_rows", "nb_cols", "max_steps"},
     {"allow_pad": "the image always pads bottom/right to a cell multiple "
                   "and crops back (static shapes) — remove it"})
_def("KMeansColorQuantization", {"n_colors", "max_size"},
     {"to_colorspace": "clusters in RGB directly here",
      "from_colorspace": "clusters in RGB directly here",
      "counts": "use `n_colors`",
      "interpolation": "the fitted palette is applied at full resolution "
                       "here (no quantized-image resize) — remove it"})

# --- choice combinators -----------------------------------------------------
_def("Sometimes",
     {"p", "then", "then_list", "children", "else", "else_list",
      "otherwise"})
_def("OneOf", set())  # args form is a list; config rejects dicts
_def("SomeOf", {"n", "children", "then"},
     {"random_order": "children apply in declaration order here — "
                      "remove it"})

# --- channel and colourspace scopes -------------------------------------------
_def("WithChannels", {"channels", "children", "then"})
_def("WithHueAndSaturation", {"children", "then"},
     {"from_colorspace": "runs on RGB directly here"})
_def("WithBrightnessChannels", {"children", "then"},
     {"to_colorspaces": "the brightness channel is always HSV-V here "
                        "(imgaug samples a colorspace per image) — see "
                        "docs/schema.md deviations",
      "from_colorspace": "runs on RGB directly here"})
_def("WithColorspace", {"to_colorspace", "children", "then"},
     {"from_colorspace": "runs on RGB directly here"})


# --- the BlendAlpha family ---------------------------------------------------
_BLEND_COMMON = {"foreground", "background", "first", "second",
                 "per_channel"}
_def("BlendAlpha", _BLEND_COMMON | {"factor", "alpha"}, aliases=("Alpha",))
_def("BlendAlphaElementwise", _BLEND_COMMON | {"factor", "alpha"},
     aliases=("AlphaElementwise",))
_def("BlendAlphaVerticalLinearGradient",
     _BLEND_COMMON | {"min_value", "max_value", "start_at", "end_at"})
_def("BlendAlphaHorizontalLinearGradient",
     _BLEND_COMMON | {"min_value", "max_value", "start_at", "end_at"})
_def("BlendAlphaRegularGrid", _BLEND_COMMON | {"nb_rows", "nb_cols",
                                               "alpha"})
_def("BlendAlphaCheckerboard", _BLEND_COMMON | {"nb_rows", "nb_cols"})
_NOISE_UNSUP = {
    "upscale_method": "the noise octaves use fixed bilinear upsampling",
    "size_px_max": "the noise octave sizes are fixed (2..16 px)",
    "iterations": "the noise octave count is fixed (4)",
}
_def("BlendAlphaSimplexNoise", _BLEND_COMMON | {"sigmoid", "sigmoid_thresh"},
     _NOISE_UNSUP, aliases=("SimplexNoiseAlpha",))
_def("BlendAlphaFrequencyNoise",
     _BLEND_COMMON | {"exponent", "sigmoid", "sigmoid_thresh"},
     _NOISE_UNSUP, aliases=("FrequencyNoiseAlpha",))
_def("BlendAlphaSomeColors",
     _BLEND_COMMON | {"nb_bins", "smoothness", "alpha", "rotation_deg"},
     {"from_colorspace": "hue is computed from the RGB input directly",
      "to_colorspace": "hue is computed from the RGB input directly"})
_def("BlendAlphaSegMapClassIds", _BLEND_COMMON | {"class_ids"},
     {"nb_sample_classes": "the class-id set is static here — list the "
                           "ids explicitly",
      "segmentation_maps": "the pipeline's OWN training mask is the "
                           "segmentation map (id 0 = background, i >= 1 = "
                           "mask channel i-1)"})


def _check_values(name: str, canon: str, args: Dict[str, Any]) -> None:
    """Value-shape checks for traps that would otherwise lower to
    something silently different from imgaug (the reference's)."""
    if not bool(args.get("keep_size", True)):
        raise ValueError(
            f"{name}: keep_size=false cannot lower — output shapes are "
            "static, the pipeline always resizes back to the input shape")
    for mk in ("mode", "pad_mode"):
        mv = args.get(mk)
        if mv not in (None, "constant"):
            raise ValueError(
                f"{name}: only {mk}='constant' fill is lowered (got "
                f"{mv!r}); edge/reflect/wrap border modes would need "
                "per-mode samplers in every warp path")
    if canon in ("crop", "cropandpad", "pad"):
        for pk in ("px", "percent"):
            pv = args.get(pk)
            if isinstance(pv, (list, tuple)) and len(pv) == 4:
                raise ValueError(
                    f"{name}: the imgaug 4-tuple per-side {pk} form "
                    "(top, right, bottom, left) is not lowered — each side "
                    "samples independently from a scalar or [lo, hi] range "
                    "here; give per-side control via separate Crop/Pad ops "
                    "or use the 2-range form")
    if canon == "cutout":
        if args.get("fill_mode") not in (None, "constant"):
            raise ValueError(
                f"{name}: only fill_mode='constant' is lowered (gaussian "
                "fill is not) — remove it or use AdditiveGaussianNoise "
                "inside a BlendAlpha mask instead")
        if "squared" in args and not bool(args["squared"]):
            raise ValueError(
                f"{name}: squared=false is not lowered — cutout cells are "
                "square grid cells here")
    if canon in ("croptofixedsize", "padtofixedsize"):
        pos = args.get("position")
        if pos not in (None, "uniform", "center"):
            raise ValueError(
                f"{name}: position must be 'uniform' or 'center' here "
                f"(got {pos!r}); imgaug's edge-anchored positions are not "
                "lowered")
    if canon in ("padtofixedsize", "centercroptofixedsize",
                 "croptofixedsize"):
        for dk in ("width", "height"):
            dv = args.get(dk)
            if dv is not None and (isinstance(dv, bool)
                                   or not isinstance(dv, int) or dv < 1):
                raise ValueError(
                    f"{name}: {dk} must be a static positive integer "
                    f"(output shapes are static), got {dv!r}")
    if canon == "jigsaw":
        for dk in ("nb_rows", "nb_cols"):
            dv = args.get(dk)
            if dv is not None and (isinstance(dv, bool)
                                   or not isinstance(dv, int) or dv < 1):
                raise ValueError(
                    f"{name}: {dk} must be a static integer >= 1 (the cell "
                    "grid sets static reshape shapes; imgaug's sampled "
                    f"grids can't lower), got {dv!r}")
    if canon in ("superpixels", "uniformvoronoi", "regulargridvoronoi",
                 "relativeregulargridvoronoi", "kmeanscolorquantization"):
        ms = args.get("max_size", 128)
        if ms is not None and (isinstance(ms, bool)
                               or not isinstance(ms, int) or ms < 2):
            raise ValueError(
                f"{name}: max_size must be a static integer >= 2 or null "
                f"(it sets a static compute shape), got {ms!r}")
    if canon == "canny":
        sk = args.get("sobel_kernel_size")
        if sk is not None and (isinstance(sk, bool) or sk not in (3, 5, 7)):
            raise ValueError(
                f"{name}: sobel_kernel_size must be a static 3, 5 or 7 "
                "(conv kernels are compile-time shapes; imgaug's sampled "
                f"sizes can't lower), got {sk!r} — see docs/schema.md")
        it = args.get("hysteresis_iters")
        if it is not None and (isinstance(it, bool)
                               or not isinstance(it, int) or it < 1):
            raise ValueError(
                f"{name}: hysteresis_iters must be a static integer >= 1 "
                f"(bounded edge-propagation rounds), got {it!r}")
    if canon == "cartoon":
        bk = args.get("blur_ksize")
        if bk is not None and (isinstance(bk, bool)
                               or not isinstance(bk, int) or bk < 1):
            raise ValueError(
                f"{name}: blur_ksize must be a static integer >= 1 "
                "(median windows are compile-time shapes; imgaug samples "
                f"it per image), got {bk!r} — see docs/schema.md")
    if canon == "changecolorspace":
        cs = args.get("to_colorspace")
        if cs is not None and (not isinstance(cs, str) or cs.upper()
                               not in ("RGB", "BGR", "GRAY", "HSV", "HLS",
                                       "YCRCB")):
            raise ValueError(
                f"{name}: to_colorspace must be one static name of "
                f"RGB/BGR/GRAY/HSV/HLS/YCrCb (got {cs!r}); imgaug's "
                "per-image colorspace lists and Lab/Luv/CIE are not "
                "lowered — see docs/schema.md")
    if canon == "blendalphasegmapclassids":
        ids = args.get("class_ids")
        if ids is not None:
            for i in (ids if isinstance(ids, (list, tuple)) else [ids]):
                if isinstance(i, bool) or not isinstance(i, int) or i < 0:
                    raise ValueError(
                        f"{name}: class_ids must be static non-negative "
                        f"integers (0 = background, i >= 1 = mask channel "
                        f"i-1), got {i!r}")
    if canon in ("affine", "rotate"):
        # the per-axis dict forms accept ONLY x/y — a typo'd axis key
        # ({sx: ...}) would silently default both axes
        for pk in ("scale", "translate_percent", "translate_px", "shear"):
            pv = args.get(pk)
            if isinstance(pv, dict):
                bad = [k for k in pv if k not in ("x", "y")]
                if bad:
                    raise ValueError(
                        f"{name}: {pk} axis dict takes only 'x'/'y' keys, "
                        f"got {bad} (a typo here silently no-ops the axis)")


def validate_args(name: str, args: Any) -> None:
    """Raise ValueError for unknown/unsupported argument keys and for the
    values ``_check_values`` refuses, of a dict ``args`` (bare
    scalars/ranges are validated by the lowering)."""
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
        allowed_desc = (", ".join(sorted(allowed)) if allowed
                        else "none — this augmenter takes a bare "
                             "scalar/range")
        raise ValueError(
            f"augmenter {name}: unknown argument {k!r} (allowed: "
            f"{allowed_desc}).{hint}")
    _check_values(name, canon, args)
