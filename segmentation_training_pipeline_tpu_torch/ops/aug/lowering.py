"""YAML ``augmentation:`` block → an augmentation with explicit draws.

Counterpart of ``segmentation_training_pipeline_tpu/ops/aug/lowering.py``
(``build_augmentation``).  The block compiles the same way: contiguous
runs of geometric augmenters fold into one per-image inverse affine (plus
a displacement field from ElasticTransformation, PiecewiseAffine and
PerspectiveTransform) applied by ONE warp of images (bilinear) and masks
(nearest); photometric augmenters apply elementwise after, in the user's
order.  Crop, CropAndPad, Pad and the fixed-size crops and pads keep the
frame's shape (the window is resized back, the reference's static-shape
deviation from imgaug), so they are affine factors too.

Randomness is explicit.  ``Augmentation.sample(gen, b, h, w)`` draws every
random value of the block from a ``torch.Generator`` (the distributions of
the JAX lowering), and ``Augmentation.apply(draws, images, masks)`` is
deterministic.  The tests make the draws with ``jax.random`` along the
reference's key schedule and hand the same values to both sides.
``Augmentation.take(draws, rows)`` cuts a batch's draws to some of its
images, with ``apply(take(d, rows), x[rows]) == apply(d, x)[rows]``: under
data parallelism every rank samples the global batch's draws from the same
generator and takes its rows.  Every segment kind cuts its own draws, all
of which are per image (batch first).

Paths (``_GeoRun.route``), chosen as the JAX lowering chooses them on the
TPU:
  * flips, and rot90 on a square frame → reverse + select;
  * affine only → ``fast_warp.warp_joint_multipass`` (kernels X and Y);
  * affine + a field bounded by K ≤ 64 → the multipass warp, then the
    elastic kernel on the residual field D' = A⁻¹·D clipped to ±K; with
    ``STP_FUSE_ELASTIC`` set (default off, read as the JAX lowering reads
    it) the field rides the multipass warp instead, and kernel YE replaces
    Y and the elastic kernel;
  * a field alone, K ≤ 64 → the elastic kernel on the raw field;
  * anything else (K > 64, a shear bound beyond the canvas, rot90 or
    rotations of 60° or more on non-square frames) → the exact footprint
    gather (``warp.warp_joint``), a PyTorch gather as the reference's is
    an XLA gather.
``STP_PALLAS_WARP=0`` sends the multipass warp down its unfused path (the
shear kernel twice around two f32 matmuls, see ``fast_warp``).  Neither
switch routes a CUDA tensor to a plain version: each picks between
hand-written kernels, as the JAX switches pick between Pallas kernels.
A ``cval``/``pad_cval`` fill is applied as warp(image − cval) + cval, exact
for a constant fill (the last one of a run wins: a warp has one fill).
The choice combinators (``_Meta``), the channel and colourspace scopes
(``_Scope``) and the BlendAlpha family (``_Blend``) hold child blocks; a
scope refuses, with the reference's ``ValueError``, a child that is
geometric, a combinator or blend or moves the mask (Jigsaw), and an
RGB-only child where its children see 1 or 2 channels.  Every name of the
reference's registry is lowered (``PORTED_AUGMENTERS``).

Parameter forms: scalar → fixed value (probability for flips); [lo, hi] →
uniform per image; [a, b, c, ...] → uniform choice per image;
{x: ..., y: ...} → independent per-axis values (Affine scale/translate).
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ...models.layers import resize_to
from . import elastic as EL
from . import fast_warp as FW
from . import jigsaw as JG
from . import photometric as ph
from . import segment as SG
from . import warp as W

Tensor = torch.Tensor
Draws = List[Any]

_GEOMETRIC = {"fliplr", "horizontalflip", "flipud", "verticalflip", "rot90",
              "affine", "crop", "cropandpad", "pad",
              "croptofixedsize", "randomcrop",
              "padtofixedsize", "centercroptofixedsize",
              "elastictransformation", "elastictransform", "elastic",
              "piecewiseaffine", "perspectivetransform"}
_FLIPS = {"fliplr", "horizontalflip", "flipud", "verticalflip"}
_CHEAP_GEO = _FLIPS | {"rot90"}
_CROPS = {"crop", "cropandpad", "pad"}
_FIXED_SIZE = {"croptofixedsize", "randomcrop", "padtofixedsize",
               "centercroptofixedsize"}
_ELASTIC_NAMES = {"elastictransformation", "elastictransform", "elastic"}
# ops that contribute a displacement FIELD, not an affine factor
_DISP_NAMES = _ELASTIC_NAMES | {"piecewiseaffine", "perspectivetransform"}


def _coerce_block(spec) -> List[Dict[str, Any]]:
    """Accept raw YAML aug blocks ({Name: args} / list) or config-normalised
    [{"name", "args"}] lists and return the normalised list form, the
    Affine sugar names rewritten (``_desugar``)."""
    if spec is None:
        return []
    if isinstance(spec, dict):
        if "name" in spec and "args" in spec and len(spec) == 2:
            spec = [spec]
        else:
            spec = [{"name": n, "args": a} for n, a in spec.items()]
    out: List[Dict[str, Any]] = []
    for entry in spec:
        if isinstance(entry, str):
            out.append({"name": entry, "args": None})
        elif isinstance(entry, dict) and "name" in entry and "args" in entry:
            out.append(entry)
        elif isinstance(entry, dict) and len(entry) == 1:
            n, a = next(iter(entry.items()))
            out.append({"name": n, "args": a})
        elif isinstance(entry, list):
            raise ValueError(
                "nested augmenter lists are only valid inside meta-augmenter "
                f"children, got {entry!r}")
        else:
            raise ValueError(f"bad augmentation entry {entry!r}")
    return [_desugar(e) for e in out]


def _desugar(e: Dict[str, Any]) -> Dict[str, Any]:
    """Rotate, TranslateX/Y, ScaleX/Y and ShearX/Y are sugar for Affine
    (imgaug 0.4 defines them so): the reference's rewrite, so that they
    fuse into a geometric run and reach the warp.  Returns a new entry;
    the caller's is left as it is."""
    nm, a = e["name"].lower(), e["args"]
    if nm == "rotate":
        if isinstance(a, dict) and "rotate" in a:
            args = a                   # already Affine-kwarg shaped
        else:
            if isinstance(a, dict):
                a = a.get("value", [-30, 30])
            args = {"rotate": a if a is not None else [-30, 30]}
    elif nm in ("translatex", "translatey"):
        ax = "x" if nm.endswith("x") else "y"
        if isinstance(a, dict) and "px" in a:
            args = {"translate_px": {ax: a["px"]}}
        elif isinstance(a, dict):
            args = {"translate_percent": {ax: a.get("percent",
                                                    [-0.25, 0.25])}}
        else:
            args = {"translate_percent":
                    {ax: a if a is not None else [-0.25, 0.25]}}
    elif nm in ("scalex", "scaley"):
        ax = "x" if nm.endswith("x") else "y"
        if isinstance(a, dict):
            a = a.get("scale", a.get("value"))
        args = {"scale": {ax: a if a is not None else [0.75, 1.25]}}
    elif nm in ("shearx", "sheary"):
        if isinstance(a, dict):
            a = a.get("shear", a.get("value"))
        sh = a if a is not None else [-30, 30]
        # the Affine shear dict samples x and y independently: pin the
        # other axis to 0
        args = {"shear": ({"x": sh, "y": 0} if nm == "shearx"
                          else {"x": 0, "y": sh})}
    else:
        return e
    return {"name": "Affine", "args": args}


def _bare(args: Any, key: str) -> Dict[str, Any]:
    """A dict passes through, a bare scalar/list means ``{key: args}``, a
    bare ``Name:`` (YAML null) means all defaults."""
    if isinstance(args, dict):
        return args
    if args is None:
        return {}
    return {key: args}


def _flip_p(args) -> float:
    if isinstance(args, (int, float)):
        return float(args)
    return float((args or {}).get("p", 0.5))


def _percent_arg(args: Any, default: Any) -> Any:
    """Crop/CropAndPad/Pad percent spec: dict {percent: ...}, bare scalar,
    or bare range list all mean the per-side fraction distribution."""
    if isinstance(args, dict):
        return args.get("percent", default)
    return default if args is None else args


def _as_list(v) -> List[Any]:
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _abs_values(v) -> List[float]:
    """|values| of a scalar, a range, a list or an {x, y} dict of them."""
    vals = list(v.values()) if isinstance(v, dict) else _as_list(v)
    return [abs(float(x)) for e in vals for x in _as_list(e)]


def _check_geo_args(spec: Dict[str, Any], name: str, cval_spec: Any) -> Any:
    """Refuse what the lowering cannot honour, as the JAX lowering does;
    returns the run's fill value spec (``cval``/``pad_cval``: the last one
    in the run wins, a warp has one fill region)."""
    a = spec.get("args")
    if name in _FIXED_SIZE and not (
            isinstance(a, dict) and (a.get("width") is not None
                                     or a.get("height") is not None)):
        raise ValueError(
            f"{spec['name']} needs {{width: ..., height: ...}} (imgaug "
            "requires them; omit one to leave that axis unchanged) — "
            "without them it would be a silent no-op")
    if not isinstance(a, dict):
        return cval_spec
    for key in ("mode", "pad_mode"):
        if a.get(key) not in (None, "constant"):
            raise ValueError(f"{spec['name']}: only {key}='constant' fill is "
                             f"supported (got {a.get(key)!r})")
    for key in ("px", "percent"):
        v = a.get(key)
        if isinstance(v, (list, tuple)) and len(v) == 4 and name in _CROPS:
            raise ValueError(
                f"{spec['name']}: the imgaug 4-tuple per-side {key} form "
                "(top, right, bottom, left) is not lowered — each side "
                "samples independently from a scalar or [lo, hi] range")
    cv = a.get("cval", a.get("pad_cval"))
    return cval_spec if cv is None else cv


def _static_bounds(spec, default) -> Tuple[float, float]:
    """Host-side min/max of a YAML parameter range (ragged nesting ok)."""
    if spec is None:
        spec = default
    if isinstance(spec, (int, float)):
        return float(spec), float(spec)

    def flat(v):
        if isinstance(v, (list, tuple)):
            return [x for e in v for x in flat(e)]
        return [float(v)]

    vals = flat(spec)
    return min(vals), max(vals)


# ---------------------------------------------------------------------------
# sampling (torch.Generator; the distributions of the JAX lowering)
# ---------------------------------------------------------------------------

def _take(tree: Any, rows: slice) -> Any:
    """``rows`` of every tensor of a segment's per-image draws (batch
    first, in dicts and lists); other values stay whole."""
    if isinstance(tree, dict):
        return {k: _take(v, rows) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_take(v, rows) for v in tree]
    return tree[rows] if isinstance(tree, torch.Tensor) else tree


def _rand(gen: torch.Generator, shape) -> Tensor:
    return torch.rand(shape, generator=gen, device=gen.device)


def _sample(gen: torch.Generator, spec: Any, b: int,
            default: float = 0.0) -> Tensor:
    """One parameter spec → a (B,) float32 sample."""
    if spec is None:
        return torch.full((b,), float(default), device=gen.device)
    if isinstance(spec, (int, float)):
        return torch.full((b,), float(spec), device=gen.device)
    if isinstance(spec, (list, tuple)):
        vals = [float(v) for v in spec]
        if len(vals) == 2:
            return _rand(gen, (b,)) * (vals[1] - vals[0]) + vals[0]
        idx = torch.randint(0, len(vals), (b,), generator=gen,
                            device=gen.device)
        return torch.tensor(vals, device=gen.device)[idx]
    raise ValueError(f"cannot lower augmentation parameter {spec!r}")


def _sample_xy(gen: torch.Generator, spec: Any, b: int,
               default: float) -> Tuple[Tensor, Tensor]:
    if isinstance(spec, dict):
        x = _sample(gen, spec.get("x"), b, default)
        return x, _sample(gen, spec.get("y"), b, default)
    v = _sample(gen, spec, b, default)
    return v, v


def _sample_k(gen: torch.Generator, args: Any, b: int) -> Tensor:
    """Rot90's k per image: [lo, hi] uniform over the integers, a longer
    list a choice, a scalar fixed; default [0, 3]."""
    spec = args if args is not None else [0, 3]
    spec = spec.get("k") if isinstance(spec, dict) else spec
    if isinstance(spec, (list, tuple)) and len(spec) == 2:
        return torch.randint(int(spec[0]), int(spec[1]) + 1, (b,),
                             generator=gen, device=gen.device)
    if isinstance(spec, (list, tuple)):
        idx = torch.randint(0, len(spec), (b,), generator=gen,
                            device=gen.device)
        return torch.tensor([int(v) for v in spec], device=gen.device)[idx]
    return torch.full((b,), int(spec), dtype=torch.long, device=gen.device)


# ---------------------------------------------------------------------------
# displacement fields of PiecewiseAffine and PerspectiveTransform
# ---------------------------------------------------------------------------

def solve_homography(dst: Tensor, src: Tensor) -> Tensor:
    """DLT: per-image 3×3 H with H·(dst, 1) ∝ (src, 1) from 4 point pairs;
    dst/src (B, 4, 2) as (x, y) → (B, 3, 3) with H[2, 2] = 1."""
    b = dst.shape[0]
    xd, yd = dst[..., 0], dst[..., 1]
    xs, ys = src[..., 0], src[..., 1]
    zeros, ones = torch.zeros_like(xd), torch.ones_like(xd)
    # rows for x': [xd, yd, 1, 0, 0, 0, -xd*xs, -yd*xs] · h = xs
    rx = torch.stack([xd, yd, ones, zeros, zeros, zeros, -xd * xs, -yd * xs],
                     dim=-1)
    ry = torch.stack([zeros, zeros, zeros, xd, yd, ones, -xd * ys, -yd * ys],
                     dim=-1)
    a = torch.cat([rx, ry], dim=1)                              # (B, 8, 8)
    rhs = torch.cat([xs, ys], dim=1)                            # (B, 8)
    hvec = torch.linalg.solve(a, rhs[..., None])[..., 0]
    return torch.cat([hvec, torch.ones((b, 1), dtype=hvec.dtype,
                                       device=hvec.device)], 1).reshape(b, 3, 3)


def perspective_field(offsets: Tensor, scale: Tensor, h: int,
                      w: int) -> Tuple[Tensor, Tensor]:
    """imgaug PerspectiveTransform as a displacement field: the corners
    move inward by |N(0, scale)|·dim (``offsets``: the (B, 4, 2) standard
    normal draws), the full frame maps onto the jittered quad by a
    homography, and ``src − dst`` is the field.  (imgaug crops to the
    quad's box and resizes back: the same up to its box rounding.)"""
    dev = offsets.device
    offs = torch.abs(offsets) * scale[:, None, None]
    offs = offs * torch.tensor([w, h], dtype=torch.float32, device=dev)
    # corner order: tl, tr, br, bl; inward signs per corner
    signs = torch.tensor([[1, 1], [-1, 1], [-1, -1], [1, -1]],
                         dtype=torch.float32, device=dev)
    dst = torch.tensor([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]],
                       dtype=torch.float32, device=dev)
    src = dst[None] + offs * signs[None]
    hm = solve_homography(dst.expand(offs.shape[0], 4, 2), src)
    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    gy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    hm = hm[:, None, None]                                   # (B,1,1,3,3)
    denom = hm[..., 2, 0] * gx + hm[..., 2, 1] * gy + hm[..., 2, 2]
    denom = torch.where(torch.abs(denom) < 1e-6,
                        torch.full_like(denom, 1e-6), denom)
    xs = (hm[..., 0, 0] * gx + hm[..., 0, 1] * gy + hm[..., 0, 2]) / denom
    ys = (hm[..., 1, 0] * gx + hm[..., 1, 1] * gy + hm[..., 1, 2]) / denom
    return xs - gx, ys - gy


def piecewise_field(coarse: Tensor, scale: Tensor, h: int,
                    w: int) -> Tuple[Tensor, Tensor]:
    """imgaug PiecewiseAffine as a smooth field: each of the rows × cols
    control points moves by N(0, scale·dim) px (``coarse``: the (B, 2,
    rows, cols) standard normal draws), upsampled bilinearly (half-pixel
    centres) instead of Delaunay patches — the reference's documented
    approximation."""
    dx = coarse[:, 0] * (scale * w)[:, None, None]
    dy = coarse[:, 1] * (scale * h)[:, None, None]
    up = F.interpolate(torch.stack([dx, dy], 1), size=(h, w),
                       mode="bilinear", align_corners=False)
    return up[:, 0], up[:, 1]


# ---------------------------------------------------------------------------
# geometric runs
# ---------------------------------------------------------------------------

class _GeoRun:
    """One contiguous run of geometric augmenters → one fused warp."""

    def __init__(self, geo: List[Dict[str, Any]], integer_input: bool = True):
        self.geo = geo
        self.names = [s["name"].lower() for s in geo]
        # uint8 gather taps only for the block's first segment (decoded
        # uint8 images); a warp after a photometric sees non-integers
        self.integer_input = integer_input
        self.cval_spec = None
        for s, name in zip(geo, self.names):
            self.cval_spec = _check_geo_args(s, name, self.cval_spec)
        self.nonelastic = [s for s, n in zip(geo, self.names)
                           if n not in _DISP_NAMES]
        self.mag_bound = self._static_magnification()
        self.shear_deg, self.shear_aniso = self._static_shear_tan()
        self.elastic = {}
        for i, (s, name) in enumerate(zip(geo, self.names)):
            if name in _ELASTIC_NAMES:
                a = s.get("args") or {}
                sig_min, sig_max = _static_bounds(a.get("sigma"), 5.0)
                # quarter-res field when the blur makes it lossless-ish
                self.elastic[i] = (W.elastic_radius(sig_max),
                                   4 if sig_min >= 2.0 else 1)

    def is_cheap(self, h: int, w: int) -> bool:
        """Flips, and rot90 on a square frame: reverse + select, no warp."""
        names = set(self.names)
        return names <= _CHEAP_GEO and (h == w or "rot90" not in names)

    def kbound(self, h: int, w: int) -> int:
        """K of the elastic kernel: the static 6-sigma bound of the run's
        displacement fields, scaled by the forward affine's static
        magnification (D' = A₂ₓ₂⁻¹·D grows with zoom-in), plus a
        margin."""
        bound = 0.0
        for s, name in zip(self.geo, self.names):
            if name in _ELASTIC_NAMES:
                a = s.get("args") or {}
                bound += W.displacement_bound(
                    _static_bounds(a.get("alpha"), 20.0)[1],
                    _static_bounds(a.get("sigma"), 5.0)[0])
            elif name in ("piecewiseaffine", "perspectivetransform"):
                a = _bare(s.get("args"), "scale")
                default = 0.05 if name == "piecewiseaffine" else 0.06
                bound += (6.0 * _static_bounds(a.get("scale"), default)[1]
                          * max(h, w) + 1.0)
        return int(math.ceil(bound * self.mag_bound * 1.15)) + 2

    def _static_magnification(self) -> float:
        """Static bound on how much the forward affine magnifies the
        displacement field: zoom from the scale and crop specs, plus a
        shear allowance."""
        mag = 1.0
        for s in self.nonelastic:
            name = s["name"].lower()
            a = s.get("args") or {}
            try:
                if name == "affine":
                    if a.get("scale") is not None:
                        mag *= max(max(_abs_values(a["scale"])), 1.0)
                    if a.get("shear") is not None:
                        smax = max(_abs_values(a["shear"]))
                        mag *= 1.0 + math.tan(math.radians(min(smax, 80.0)))
                elif name == "crop":
                    if isinstance(a, dict) and "px" in a:
                        mag *= 4.0   # px/dim unknown statically
                    else:
                        pct = _percent_arg(a, [0, 0.1])
                        pmax = max(float(v) for v in _as_list(pct))
                        mag *= 1.0 / max(1.0 - 2.0 * pmax, 0.1)
                elif name in ("cropandpad", "pad"):
                    if isinstance(a, dict) and "px" in a:
                        mag *= 4.0
                    else:
                        # negative percents crop: a zoom-in
                        pct = _percent_arg(a, [0, 0.1])
                        pmin = min(float(v) for v in _as_list(pct))
                        if pmin < 0:
                            mag *= 1.0 / max(1.0 + 2.0 * pmin, 0.1)
                elif name in ("croptofixedsize", "randomcrop",
                              "centercroptofixedsize"):
                    # the zoom depends on the input shape: a generous cap
                    # (PadToFixedSize zooms out: no contribution)
                    mag *= 4.0
            except (TypeError, ValueError):
                mag *= 4.0   # unparseable spec: be conservative
        return mag

    def _static_shear_tan(self) -> Tuple[float, float]:
        """(rotation + shear degrees, anisotropy) bounding the multipass
        shear factors s1 = tan(θ)·(sy/sx): anisotropy multiplies the
        shear, from Affine's {x, y} scale dicts, the per-side crop and pad
        fractions and the fixed-size windows."""
        rot = shear = 0.0
        aniso = 1.0
        try:
            for s in self.nonelastic:
                name = s["name"].lower()
                a = s.get("args") or {}
                if name == "affine":
                    if a.get("rotate") is not None:
                        rot += max(abs(v) for v in
                                   _static_bounds(a["rotate"], 0.0))
                    sh = a.get("shear")
                    if sh is not None:
                        spec = list(sh.values()) if isinstance(sh, dict) else sh
                        shear += max(abs(v) for v in _static_bounds(spec, 0.0))
                    sc = a.get("scale")
                    if isinstance(sc, dict):
                        los, his = zip(*(_static_bounds(sc.get(ax), 1.0)
                                         for ax in ("x", "y")))
                        lo, hi = min(los), max(his)
                        aniso = math.inf if lo <= 0 else aniso * hi / lo
                elif name in _CROPS:
                    if isinstance(a, dict) and "px" in a:
                        aniso *= 4.0
                        continue
                    lo, hi = _static_bounds(_percent_arg(a, [0, 0.1]), 0.0)
                    if name == "crop":
                        lo, hi = -hi, -lo      # crop percent p shrinks by 2p
                    if name == "pad":
                        lo = max(lo, 0.0)
                    aniso *= max(1.0 + 2.0 * hi, 0.1) / max(1.0 + 2.0 * lo,
                                                            0.1)
                elif name in _FIXED_SIZE:
                    wd, ht = a.get("width"), a.get("height")
                    if wd is not None or ht is not None:
                        r = (float(wd if wd is not None else ht)
                             / float(ht if ht is not None else wd))
                        aniso *= max(r, 1.0 / r)
        except (TypeError, ValueError, ZeroDivisionError):
            return 90.0, 2.0
        return rot + shear, aniso

    def _shear_tan_for(self, square: bool) -> float:
        cap = 45.0 if square else 60.0
        t = math.tan(math.radians(min(self.shear_deg, cap)))
        return t * self.shear_aniso if t > 0.0 else 0.0

    def pad_frac(self, h: int, w: int) -> float:
        """Canvas pad fraction: content excursion |s|·(dim/2) + margin,
        capped at a full-dim pad."""
        t = self._shear_tan_for(h == w)
        base = 0.5 if h != w else 0.0
        return min(1.0, max(base, t / 2.0 + 12.0 / max(min(h, w), 1)))

    def multipass_ok(self, h: int, w: int) -> bool:
        """The multipass warp extracts rot90s on square frames only, and
        its factorisation degenerates on non-square frames as the rotation
        nears 90°; a shear bound beyond the full-dim canvas would clip."""
        if self._shear_tan_for(h == w) > 2.0 - 24.0 / max(min(h, w), 13):
            return False
        if h == w:
            return True
        for s, name in zip(self.geo, self.names):
            if name == "rot90":
                return False
            if name != "affine":
                continue
            r = (s.get("args") or {}).get("rotate")
            if r is None:
                continue
            try:
                if max(abs(float(v)) for v in _as_list(r)) >= 60.0:
                    return False
            except (TypeError, ValueError):
                return False
        return True

    def route(self, h: int, w: int) -> str:
        """The path this run takes at an H×W frame, as the JAX lowering
        chooses it: "flips" (reverse + select), "multipass" (kernels X and
        Y), "multipass+elastic" (X, Y, then the elastic kernel; "multipass
        ye" under ``STP_FUSE_ELASTIC``: X and YE), "elastic" (a field
        alone), or "gather" (the exact footprint gather)."""
        if self.is_cheap(h, w):
            return "flips"
        has_disp = len(self.nonelastic) < len(self.geo)
        if not self.multipass_ok(h, w):
            return "gather"
        if not has_disp:
            return "multipass"
        if self.kbound(h, w) > 64:
            return "gather"
        if not self.nonelastic:
            return "elastic"
        if os.environ.get("STP_FUSE_ELASTIC", "0") not in ("0", "false"):
            return "multipass ye"
        return "multipass+elastic"

    def sample(self, gen: torch.Generator, b: int, h: int, w: int,
               c: int = 3) -> Draws:
        draws = []
        for i, (s, name) in enumerate(zip(self.geo, self.names)):
            args = s.get("args")
            if name in _FLIPS:
                draws.append({"flip": _rand(gen, (b,)) < _flip_p(args)})
            elif name == "rot90":
                draws.append({"k": _sample_k(gen, args, b)})
            elif name == "affine":
                a = args or {}
                sx, sy = _sample_xy(gen, a.get("scale"), b, 1.0)
                key = ("translate_percent" if "translate_percent" in a
                       else "translate_px")
                tx, ty = _sample_xy(gen, a.get(key), b, 0.0)
                rot = _sample(gen, a.get("rotate"), b, 0.0)
                shear = a.get("shear")
                shx, shy = _sample_xy(gen, shear, b, 0.0)
                if not isinstance(shear, dict):
                    shy = torch.zeros_like(shy)
                draws.append(dict(sx=sx, sy=sy, tx=tx, ty=ty, rot=rot,
                                  shx=shx, shy=shy))
            elif name in _CROPS:
                spec = (args["px"] if isinstance(args, dict) and "px" in args
                        else _percent_arg(args, [0, 0.1]))
                draws.append({side: _sample(gen, spec, b, 0.0)
                              for side in ("left", "right", "top", "bottom")})
            elif name in _FIXED_SIZE:
                draws.append({"ux": _rand(gen, (b,)), "uy": _rand(gen, (b,))})
            elif name == "piecewiseaffine":
                a = _bare(args, "scale")
                rows, cols = int(a.get("nb_rows", 4)), int(a.get("nb_cols", 4))
                draws.append({
                    "scale": _sample(gen, a.get("scale", [0.01, 0.05]), b),
                    "coarse": torch.randn((b, 2, rows, cols), generator=gen,
                                          device=gen.device)})
            elif name == "perspectivetransform":
                a = _bare(args, "scale")
                draws.append({
                    "scale": _sample(gen, a.get("scale", [0.0, 0.06]), b),
                    "offsets": torch.randn((b, 4, 2), generator=gen,
                                           device=gen.device)})
            else:
                a = args or {}
                radius, stride = self.elastic[i]
                shape = W.noise_shape(b, h, w, radius, stride)
                draws.append(dict(
                    alpha=_sample(gen, a.get("alpha", 20.0), b),
                    sigma=_sample(gen, a.get("sigma", 5.0), b),
                    noise_x=_rand(gen, shape) * 2.0 - 1.0,
                    noise_y=_rand(gen, shape) * 2.0 - 1.0))
        if self.cval_spec is not None:
            draws.append({"cval": _sample(gen, self.cval_spec, b, 0.0)})
        return draws

    def take(self, draws: Draws, rows: slice) -> Draws:
        """Every entry of a run's draws (the fill's too) is per image."""
        return _take(draws, rows)

    def _apply_cheap(self, draws: Draws, images: Tensor, masks: Tensor):
        """Flips and square rot90s as reverse + select — no warp."""
        for name, d in zip(self.names, draws):
            if name == "rot90":
                images = FW.rot90_select(images, d["k"])
                masks = FW.rot90_select(masks, d["k"])
                continue
            f = d["flip"][:, None, None, None]
            axis = 2 if name in ("fliplr", "horizontalflip") else 1
            images = torch.where(f, images.flip(axis), images)
            masks = torch.where(f, masks.flip(axis), masks)
        return images, masks

    def _matrix(self, name: str, a: Any, d: Dict[str, Tensor], b: int,
                h: int, w: int, device) -> Optional[Tensor]:
        """The inverse affine of one non-field op (None: the identity)."""
        cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
        if name in ("fliplr", "horizontalflip"):
            return W.hflip(w, d["flip"])
        if name in ("flipud", "verticalflip"):
            return W.vflip(h, d["flip"])
        if name == "rot90":
            return W.rot90s(h, w, d["k"])
        if name == "affine":
            a = a or {}
            m = W.scale_about(cx, cy, d["sx"], d["sy"])
            tx, ty = d["tx"], d["ty"]
            if "translate_percent" in a:
                tx, ty = tx * w, ty * h
            # inverse translation: src = dst − t
            m = W.compose(W.translation(-tx, -ty), m)
            m = W.compose(W.rotation_about(cx, cy,
                                           d["rot"] * (math.pi / 180.0)), m)
            return W.compose(W.shear_about(
                cx, cy, d["shx"] * (math.pi / 180.0),
                d["shy"] * (math.pi / 180.0)), m)
        if name in _CROPS:
            left, right, top, bot = (d["left"], d["right"], d["top"],
                                     d["bottom"])
            if isinstance(a, dict) and "px" in a:
                left, right, top, bot = left / w, right / w, top / h, bot / h
            if name == "crop":
                # keep the window [left, 1 − right] × [top, 1 − bottom]
                return W._mats(b, device, m00=1.0 - left - right,
                               m11=1.0 - top - bot, m02=left * w,
                               m12=top * h)
            if name == "pad":
                left, right = left.clamp(min=0.0), right.clamp(min=0.0)
                top, bot = top.clamp(min=0.0), bot.clamp(min=0.0)
            # imgaug CropAndPad (keep_size): a positive side pads, a
            # negative one crops; src = (1 + pl + pr)·x − pl·w
            return W._mats(b, device, m00=1.0 + left + right,
                           m11=1.0 + top + bot, m02=-left * w, m12=-top * h)
        a = a or {}
        if name in ("croptofixedsize", "randomcrop",
                    "centercroptofixedsize"):
            # imgaug never crops beyond the image: a larger target no-ops
            ch = min(float(a.get("height", h)) / h, 1.0)
            cw = min(float(a.get("width", w)) / w, 1.0)
            if name == "centercroptofixedsize":
                if cw >= 1.0 and ch >= 1.0:
                    return None
                # the offsets in double precision, as Python numbers
                return W._mats(b, device, m00=cw, m11=ch,
                               m02=(1.0 - cw) / 2.0 * w,
                               m12=(1.0 - ch) / 2.0 * h)
            if a.get("position") == "center":
                offx = torch.full((b,), (1.0 - cw) / 2.0, device=device)
                offy = torch.full((b,), (1.0 - ch) / 2.0, device=device)
            else:
                offx, offy = d["ux"] * (1.0 - cw), d["uy"] * (1.0 - ch)
            return W._mats(b, device, m00=cw, m11=ch, m02=offx * w,
                           m12=offy * h)
        # padtofixedsize: pad to at least (height, width), the image at a
        # random (default) or centred place of the canvas, resized back
        fh = max(float(a.get("height", h)) / h, 1.0)
        fw = max(float(a.get("width", w)) / w, 1.0)
        if fw <= 1.0 and fh <= 1.0:
            return None
        if a.get("position") == "center":
            offx = torch.full((b,), (fw - 1.0) / 2.0, device=device)
            offy = torch.full((b,), (fh - 1.0) / 2.0, device=device)
        else:
            offx, offy = d["ux"] * (fw - 1.0), d["uy"] * (fh - 1.0)
        return W._mats(b, device, m00=fw, m11=fh, m02=-offx * w,
                       m12=-offy * h)

    def _field(self, i: int, name: str, d: Dict[str, Tensor], h: int,
               w: int) -> Tuple[Tensor, Tensor]:
        """The displacement field (dx, dy) of one field op."""
        if name == "piecewiseaffine":
            return piecewise_field(d["coarse"], d["scale"], h, w)
        if name == "perspectivetransform":
            return perspective_field(d["offsets"], d["scale"], h, w)
        radius, stride = self.elastic[i]
        return W.elastic_field(d["noise_x"], d["noise_y"], h, w, d["alpha"],
                               d["sigma"], radius, stride)

    def geometry(self, draws: Draws, b: int, h: int, w: int, device
                 ) -> Tuple[Tensor, Optional[Tuple[Tensor, Tensor]]]:
        """The run's inverse affine (B, 3, 3) and its summed displacement
        field (dx, dy), None without a field op, on ``device``."""
        mats = W.identity_mats(b, device)
        disp: Optional[Tuple[Tensor, Tensor]] = None
        for i, (s, name, d) in enumerate(zip(self.geo, self.names, draws)):
            if name in _DISP_NAMES:
                dx, dy = self._field(i, name, d, h, w)
                disp = (dx, dy) if disp is None else (disp[0] + dx,
                                                      disp[1] + dy)
                continue
            m = self._matrix(name, s.get("args"), d, b, h, w, device)
            if m is not None:
                mats = W.compose(m, mats)
        return mats, disp

    def apply(self, draws: Draws, images: Tensor, masks: Tensor):
        b, h, w = images.shape[0], images.shape[1], images.shape[2]
        route = self.route(h, w)
        if route == "flips":
            return self._apply_cheap(draws, images, masks)
        images = images.float()
        mats, disp = self.geometry(draws, b, h, w, images.device)
        cv = None
        if self.cval_spec is not None:
            # one warp has one fill: warp(image − cval) + cval
            cv = draws[len(self.geo)]["cval"][:, None, None, None]
            images = images - cv
        images, masks = self._warp(route, images, masks, mats, disp, h, w,
                                   gather_u8=self.integer_input and cv is None)
        if cv is not None:
            images = images + cv
        return images, masks

    def _warp(self, route: str, images: Tensor, masks: Tensor, mats: Tensor,
              disp: Optional[Tuple[Tensor, Tensor]], h: int, w: int,
              gather_u8: bool):
        if route == "gather":
            return W.warp_joint(images, masks, mats, disp,
                                gather_u8=gather_u8)
        pad_frac = self.pad_frac(h, w)
        if route == "multipass":
            return FW.warp_joint_multipass(images, masks, mats,
                                           pad_frac=pad_frac)
        k = self.kbound(h, w)
        if route == "elastic":
            # a field alone: the affine is the identity — the raw field
            return EL.warp_elastic_joint(images, masks,
                                         disp[1].clamp(-k, k),
                                         disp[0].clamp(-k, k), k)
        # residual displacement after the affine pass: D' = A₂ₓ₂⁻¹ · D
        a00, a01 = mats[:, 0, 0, None, None], mats[:, 0, 1, None, None]
        a10, a11 = mats[:, 1, 0, None, None], mats[:, 1, 1, None, None]
        det = a00 * a11 - a01 * a10
        det = torch.where(torch.abs(det) < 1e-6, torch.full_like(det, 1e-6),
                          det)
        dxf, dyf = disp
        dxp = ((a11 * dxf - a01 * dyf) / det).clamp(-k, k)
        dyp = ((-a10 * dxf + a00 * dyf) / det).clamp(-k, k)
        if route == "multipass ye":
            return FW.warp_joint_multipass(images, masks, mats,
                                           pad_frac=pad_frac,
                                           disp=(dxp, dyp), disp_k=k)
        images, masks = FW.warp_joint_multipass(images, masks, mats,
                                                pad_frac=pad_frac)
        return EL.warp_elastic_joint(images, masks, dyp, dxp, k)


# ---------------------------------------------------------------------------
# photometric augmenters: one (sample, apply) pair per name
# ---------------------------------------------------------------------------
#
# Each pair mirrors one branch of the reference's ``_apply_photo``: the same
# defaults for a bare ``Name:``, the same ``per_channel`` and scalar / range /
# list semantics, the values it draws inside its photometric functions
# drawn here instead.  ``sample(seg, gen, b, h, w, c)`` → the draws;
# ``apply(seg, draws, images, masks)`` runs on float32 images.

def _sample_shape(gen: torch.Generator, spec: Any, shape,
                  default: float = 0.0) -> Tensor:
    """``_sample`` for any static shape (per pixel, per cell)."""
    if spec is None:
        return torch.full(shape, float(default), device=gen.device)
    if isinstance(spec, (int, float)):
        return torch.full(shape, float(spec), device=gen.device)
    vals = [float(v) for v in spec]
    if len(vals) == 2:
        return _rand(gen, shape) * (vals[1] - vals[0]) + vals[0]
    idx = torch.randint(0, len(vals), shape, generator=gen, device=gen.device)
    return torch.tensor(vals, device=gen.device)[idx]


def _sample_pc(gen: torch.Generator, spec: Any, b: int, c: int,
               per_channel: bool, default: float) -> Tensor:
    """(B,), or (B, C) under imgaug's ``per_channel=True``."""
    if not per_channel:
        return _sample(gen, spec, b, default)
    return _sample(gen, spec, b * c, default).reshape(b, c)


def _sample_elementwise(gen: torch.Generator, spec: Any, shape,
                        per_channel: bool, default) -> Tensor:
    """A value per pixel, (B, H, W, 1), or per pixel and channel."""
    b, h, w, c = shape
    return _sample_shape(gen, default if spec is None else spec,
                         (b, h, w, c if per_channel else 1))


def _bernoulli(gen: torch.Generator, p, shape) -> Tensor:
    return _rand(gen, shape) < p


def _single(a: Any, key: str, default: Any) -> Any:
    """The reference's ``args if not dict else args.get(key, default)``."""
    return a.get(key, default) if isinstance(a, dict) else a


def _single_or(a: Any, key: str, default: Any) -> Any:
    """``_single(a, key, None)``, ``default`` where that is None (the
    reference's ``a if a is not None else default``)."""
    v = _single(a, key, None)
    return default if v is None else v


def _coarse_args(a: Any, p_default: float = 0.05) -> Tuple[Any, float]:
    """CoarseDropout / Coarse*: (p spec, size_percent); a bare scalar or
    list is p at size 0.1."""
    a = a or {}
    if isinstance(a, (int, float, list, tuple)):
        return a, 0.1
    return a.get("p", p_default), float(a.get("size_percent", 0.1))


def _p_u(per_value: bool = False):
    """The sampler of a name that draws a per-image p (default 0.05) and a
    uniform per pixel, (B, H, W, 1), or per value with ``per_value``."""
    def sample(seg, gen, b, h, w, c):
        return {"p": _sample(gen, _single(seg.args, "p", 0.05), b, 0.05),
                "u": _rand(gen, (b, h, w, c if per_value else 1))}
    return sample


def _laplace(gen: torch.Generator, shape) -> Tensor:
    """Standard Laplace by the inverse CDF of a uniform on (−1, 1), |u|
    kept below 1 so every value is finite."""
    u = _rand(gen, shape) * 2.0 - 1.0
    return torch.sign(u) * torch.log1p(-u.abs().clamp(max=1.0 - 2.0 ** -24))


def _cutout_args(a: Any) -> Tuple[Dict[str, Any], int]:
    a = a or {}
    if isinstance(a, (int, float, list, tuple)):
        a = {"nb_iterations": a}
    size = min(max(float(a.get("size", 0.2)), 1e-3), 1.0)
    return a, max(1, int(round(1.0 / size)))


def _cutout_sample(seg, gen, b, h, w, c):
    a, g = _cutout_args(seg.args)
    return {"nb": _sample(gen, a.get("nb_iterations", 1), b, 1.0),
            "u": _rand(gen, (b, g, g, 1)),
            "cval": _sample(gen, a.get("cval", 128), b, 128.0)}


def _cutout_apply(seg, d, images, masks):
    """imgaug Cutout on the reference's static grid of round(1/size)²
    cells, each dropped with probability nb / cells, filled with cval."""
    g = d["u"].shape[1]
    p_cell = torch.clamp(d["nb"] / float(g * g), 0.0, 1.0)
    drop = (d["u"] < p_cell[:, None, None, None]).float()
    mask = ph.nearest_nhwc(drop, images.shape[1], images.shape[2])
    cv = d["cval"][:, None, None, None]
    return images * (1.0 - mask) + cv * mask, masks


def _replace_sample(seg, gen, b, h, w, c):
    a = _bare(seg.args, "mask")
    shape = (b, h, w, c if seg.per_channel else 1)
    return {"p": _sample(gen, a.get("mask", 0.05), b),
            "u": _rand(gen, shape),
            "replacement": _sample_shape(gen, a.get("replacement",
                                                    [0.0, 255.0]), shape)}


def _replace_apply(seg, d, images, masks):
    """imgaug ReplaceElementwise: values whose uniform falls below the
    per-image p take their drawn replacement."""
    sel = d["u"] < d["p"][:, None, None, None]
    return torch.where(sel, d["replacement"], images), masks


def _solarize_sample(seg, gen, b, h, w, c):
    """imgaug Solarize(p=1, threshold=128): a bare scalar is the
    probability; a list p compares a uniform with a sampled p."""
    a = _bare(seg.args, "p")
    th = _sample(gen, a.get("threshold", 128), b, 128.0)
    if isinstance(a.get("p"), (list, tuple)):
        apply = _rand(gen, (b,)) < _sample(gen, a.get("p"), b, 1.0)
    else:
        p = float(a.get("p", 1.0))
        apply = (torch.ones((b,), dtype=torch.bool, device=gen.device)
                 if p >= 1.0 else _bernoulli(gen, p, (b,)))
    return {"threshold": th, "apply": apply}


def resize_size(a: Any) -> Tuple[Optional[float], Optional[int]]:
    """Resize/Scale's static scalar → (factor, None) for a float, (None,
    side) for an int (absolute pixels); the reference's refusals."""
    if isinstance(a, dict):
        a = a.get("size", a.get("percent", 1.0))
    if not isinstance(a, (int, float)) or isinstance(a, bool):
        raise ValueError(
            "Resize/Scale takes a static scalar here (output shapes are "
            "static; stochastic sizes can't lower) — use Affine "
            "{scale: ...} for zoom jitter; see docs/schema.md")
    if isinstance(a, int):
        if a < 1:
            raise ValueError(
                f"Resize/Scale int means absolute pixels; got {a}")
        return None, int(a)
    if float(a) <= 0.0:
        raise ValueError(f"Resize/Scale factor must be > 0, got {float(a)}")
    return float(a), None


def _nhwc_bilinear(x: Tensor, h: int, w: int) -> Tensor:
    return resize_to(x.permute(0, 3, 1, 2), h, w,
                     "bilinear").permute(0, 2, 3, 1)


def _resize_apply(seg, d, images, masks):
    """Down (or up) to the size and back to the frame: images bilinear
    (antialiased when it shrinks, as ``jax.image.resize``), masks
    nearest.  The weight products run in full f32."""
    f, side = seg.resize
    if f == 1.0:
        return images, masks
    h, w = images.shape[1], images.shape[2]
    nh, nw = ((side, side) if f is None
              else (max(1, int(round(h * f))), max(1, int(round(w * f)))))
    with FW._exact_f32(images.device):
        images = _nhwc_bilinear(_nhwc_bilinear(images, nh, nw), h, w)
    m = ph.nearest_nhwc(masks.float(), nh, nw)
    return images, ph.nearest_nhwc(m, h, w).to(masks.dtype)


def _none(seg, gen, b, h, w, c):
    return {}


def _keep(seg, d, images, masks):
    return images, masks


def _image_only(fn):
    """An ``apply`` that passes the masks through."""
    def apply(seg, d, images, masks):
        return fn(seg, d, images), masks
    return apply


_PHOTO: Dict[str, Tuple[Any, Any]] = {}


def _photo(names: str, sample, apply) -> None:
    for n in names.split():
        _PHOTO[n] = (sample, apply)


_photo("multiply",
       lambda s, g, b, h, w, c: {"mul": _sample_pc(
           g, _bare(s.args, "mul").get("mul", [0.8, 1.2]), b, c,
           s.per_channel, 1.0)},
       _image_only(lambda s, d, x: ph.multiply(x, d["mul"])))
_photo("add",
       lambda s, g, b, h, w, c: {"value": _sample_pc(
           g, _bare(s.args, "value").get("value", [-20, 20]), b, c,
           s.per_channel, 0.0)},
       _image_only(lambda s, d, x: ph.add(x, d["value"])))
_photo("linearcontrast contrastnormalization",
       lambda s, g, b, h, w, c: {"alpha": _sample(
           g, _bare(s.args, "alpha").get("alpha", [0.6, 1.4]), b, 1.0)},
       _image_only(lambda s, d, x: ph.linear_contrast(x, d["alpha"])))
_photo("gammacontrast",
       lambda s, g, b, h, w, c: {"gamma": _sample_pc(
           g, _bare(s.args, "gamma").get("gamma", [0.7, 1.7]), b, c,
           s.per_channel, 1.0)},
       _image_only(lambda s, d, x: ph.gamma_contrast(x, d["gamma"])))
_photo("sigmoidcontrast",
       lambda s, g, b, h, w, c: {
           "gain": _sample(g, _bare(s.args, "gain").get("gain", 10.0), b,
                           10.0),
           "cutoff": _sample(g, _bare(s.args, "gain").get("cutoff", 0.5), b,
                             0.5)},
       _image_only(lambda s, d, x: ph.sigmoid_contrast(x, d["gain"],
                                                       d["cutoff"])))
_photo("logcontrast",
       lambda s, g, b, h, w, c: {"gain": _sample_pc(
           g, _bare(s.args, "gain").get("gain", [0.4, 1.6]), b, c,
           s.per_channel, 1.0)},
       _image_only(lambda s, d, x: ph.log_contrast(x, d["gain"])))
_photo("additivegaussiannoise",
       lambda s, g, b, h, w, c: {
           "scale": _sample(g, _bare(s.args, "scale").get("scale", [0, 15]),
                            b, 0.0),
           "noise": torch.randn((b, h, w, c), generator=g, device=g.device)},
       _image_only(lambda s, d, x: ph.additive_noise(x, d["noise"],
                                                     d["scale"])))
_photo("additivelaplacenoise",
       lambda s, g, b, h, w, c: {
           "scale": _sample(g, _bare(s.args, "scale").get("scale", [0, 15]),
                            b, 0.0),
           "noise": _laplace(g, (b, h, w, c))},
       _image_only(lambda s, d, x: ph.additive_noise(x, d["noise"],
                                                     d["scale"])))


def _poisson_sample(seg, gen, b, h, w, c):
    lam = _sample(gen, _bare(seg.args, "lam").get("lam", [0, 15]), b, 1.0)
    rates = lam.clamp(min=0.0)[:, None, None, None].expand(b, h, w, c)
    return {"counts": torch.poisson(rates.contiguous(), generator=gen)}


_photo("additivepoissonnoise", _poisson_sample,
       _image_only(lambda s, d, x: ph.additive_poisson_noise(x,
                                                             d["counts"])))
_photo("invert",
       lambda s, g, b, h, w, c: {"flip": _bernoulli(g, _sample(
           g, _bare(s.args, "p").get("p", 1.0), b, 1.0), (b,))},
       _image_only(lambda s, d, x: ph.invert(x, d["flip"])))
_photo("solarize", _solarize_sample,
       _image_only(lambda s, d, x: torch.where(
           d["apply"][:, None, None, None], ph.solarize(x, d["threshold"]),
           x)))
_photo("posterize",
       lambda s, g, b, h, w, c: {"nb_bits": _sample(
           g, _single(s.args, "nb_bits", [1, 8]), b, 4.0)},
       _image_only(lambda s, d, x: ph.posterize(x, d["nb_bits"])))
_photo("channelshuffle",
       lambda s, g, b, h, w, c: {
           "perm": torch.argsort(_rand(g, (b, c)), dim=1),
           "sel": _bernoulli(g, _sample(g, _single(s.args, "p", 1.0), b,
                                        1.0), (b,))},
       _image_only(lambda s, d, x: ph.channel_shuffle(x, d["perm"],
                                                      d["sel"])))
_photo("addelementwise",
       lambda s, g, b, h, w, c: {"value": _sample_elementwise(
           g, _single(s.args, "value", None), (b, h, w, c), s.per_channel,
           [-20, 20])},
       _image_only(lambda s, d, x: x + d["value"]))
_photo("multiplyelementwise",
       lambda s, g, b, h, w, c: {"mul": _sample_elementwise(
           g, _single(s.args, "mul", None), (b, h, w, c), s.per_channel,
           [0.8, 1.2])},
       _image_only(lambda s, d, x: x * d["mul"]))
_photo("dropout", _p_u(),
       _image_only(lambda s, d, x: ph.pixel_dropout(x, d["u"], d["p"])))
_photo("saltandpepper saltpepper", _p_u(),
       _image_only(lambda s, d, x: ph.salt_and_pepper(x, d["u"], d["p"])))
_photo("salt", _p_u(),
       _image_only(lambda s, d, x: ph.salt(x, d["u"], d["p"])))
_photo("pepper", _p_u(),
       _image_only(lambda s, d, x: ph.pepper(x, d["u"], d["p"])))
_photo("impulsenoise", _p_u(per_value=True),
       _image_only(lambda s, d, x: ph.impulse_noise(x, d["u"], d["p"])))


def _coarse_sample(seg, gen, b, h, w, c):
    p_spec, size = _coarse_args(seg.args)
    return {"p": _sample(gen, p_spec, b),
            "u": _rand(gen, (b, *ph.coarse_grid(h, w, size), 1))}


_COARSE_MODE = {"coarsesalt": "salt", "coarsepepper": "pepper",
                "coarsesaltandpepper": "both"}
_photo("coarsedropout", _coarse_sample,
       _image_only(lambda s, d, x: ph.coarse_dropout(x, d["u"], d["p"])))
_photo("coarsesaltandpepper coarsesalt coarsepepper", _coarse_sample,
       _image_only(lambda s, d, x: ph.coarse_salt_and_pepper(
           x, d["u"], d["p"], _COARSE_MODE[s.name])))


def _dropout2d_args(a: Any) -> Tuple[Any, int]:
    a = a or {}
    if isinstance(a, (int, float, list, tuple)):
        return a, 1
    return a.get("p", 0.1), int(a.get("nb_keep_channels", 1))


_photo("dropout2d channeldropout",
       lambda s, g, b, h, w, c: {
           "p": _sample(g, _dropout2d_args(s.args)[0], b, 0.1),
           "u": _rand(g, (b, c))},
       _image_only(lambda s, d, x: ph.dropout2d(
           x, d["u"], d["p"], _dropout2d_args(s.args)[1])))
_photo("totaldropout",
       lambda s, g, b, h, w, c: {
           "p": _sample(g, _single(s.args, "p", 1.0), b, 1.0),
           "u": _rand(g, (b,))},
       _image_only(lambda s, d, x: ph.total_dropout(x, d["u"], d["p"])))
_photo("cutout", _cutout_sample, _cutout_apply)
_photo("replaceelementwise", _replace_sample, _replace_apply)
_photo("noop identity", _none, _keep)
_photo("resize scale", _none, _resize_apply)

# --- colour ----------------------------------------------------------------
_photo("grayscale",
       lambda s, g, b, h, w, c: {"alpha": _sample(
           g, _single(s.args, "alpha", 1.0), b, 1.0)},
       _image_only(lambda s, d, x: ph.grayscale(x, d["alpha"])))


def _hue_sat(key: str, hue_default: Any, sat_default: Any):
    """The sampler of AddToHueAndSaturation (``key`` "value") or
    MultiplyHueAndSaturation ("mul"): hue then saturation, each from the
    ``{key}_hue`` / ``{key}_saturation`` spec or the shared ``key``."""
    def sample(seg, gen, b, h, w, c):
        a = _bare(seg.args, key)
        return {"hue": _sample(gen, a.get(f"{key}_hue",
                                          a.get(key, hue_default)), b),
                "sat": _sample(gen, a.get(f"{key}_saturation",
                                          a.get(key, sat_default)), b)}
    return sample


def _one_of_hue_sat(key: str, default: Any, which: str, rest: float):
    """AddToHue / AddToSaturation / MultiplyHue / MultiplySaturation: one
    drawn value, the other component fixed at ``rest``."""
    def sample(seg, gen, b, h, w, c):
        v = _sample(gen, _bare(seg.args, key).get(key, default), b)
        fixed = torch.full((b,), rest, device=gen.device)
        return {"hue": v, "sat": fixed} if which == "hue" else {
            "hue": fixed, "sat": v}
    return sample


_ADD_HS = _image_only(lambda s, d, x: ph.add_to_hue_and_saturation(
    x, d["hue"], d["sat"]))
_MUL_HS = _image_only(lambda s, d, x: ph.multiply_hue_and_saturation(
    x, d["hue"], d["sat"]))
_photo("addtohueandsaturation", _hue_sat("value", [-30, 30], [-30, 30]),
       _ADD_HS)
_photo("addtohue", _one_of_hue_sat("value", [-255, 255], "hue", 0.0),
       _ADD_HS)
_photo("addtosaturation", _one_of_hue_sat("value", [-75, 75], "sat", 0.0),
       _ADD_HS)
_photo("multiplyhueandsaturation", _hue_sat("mul", [0.8, 1.2], [0.8, 1.2]),
       _MUL_HS)
_photo("multiplyhue", _one_of_hue_sat("mul", [-3.0, 3.0], "hue", 1.0),
       _MUL_HS)
_photo("multiplysaturation", _one_of_hue_sat("mul", [0.0, 3.0], "sat", 1.0),
       _MUL_HS)
# imgaug RemoveSaturation(mul) == MultiplySaturation(1 - mul)
_photo("removesaturation",
       lambda s, g, b, h, w, c: {
           "hue": torch.ones((b,), device=g.device),
           "sat": 1.0 - _sample(g, _single(s.args, "mul", 1.0), b, 1.0)},
       _MUL_HS)


_photo("changecolortemperature",
       lambda s, g, b, h, w, c: {"kelvin": _sample(
           g, _single_or(s.args, "kelvin", [1000, 11000]), b, 6600.0)},
       _image_only(lambda s, d, x: ph.change_color_temperature(
           x, d["kelvin"])))

_COLORSPACES = ("RGB", "BGR", "GRAY", "HSV", "HLS", "YCRCB")


def colorspace_of(args: Any) -> str:
    """ChangeColorspace's static ``to_colorspace``; the reference's
    refusal of anything else."""
    cs = _bare(args, "to_colorspace").get("to_colorspace")
    if not isinstance(cs, str) or cs.upper() not in _COLORSPACES:
        raise ValueError(
            "ChangeColorspace to_colorspace must be one static name of "
            f"RGB/BGR/GRAY/HSV/HLS/YCrCb here (got {cs!r}); imgaug's "
            "per-image colorspace lists and Lab/Luv/CIE are not "
            "lowered — see docs/schema.md")
    return cs


_photo("changecolorspace",
       lambda s, g, b, h, w, c: {"alpha": _sample(
           g, _bare(s.args, "to_colorspace").get("alpha", 1.0), b, 1.0)},
       _image_only(lambda s, d, x: ph.change_colorspace(
           x, s.colorspace, d["alpha"])))
_photo("autocontrast auto_contrast", _none,
       _image_only(lambda s, d, x: ph.autocontrast(x, s.cutoff)))
_photo("histogramequalization allchannelshistogramequalization", _none,
       _image_only(lambda s, d, x: ph.histogram_equalization(x)))


def _clahe_grid(args: Any) -> int:
    # imgaug's kwarg is tile_grid_size_px; both spellings are taken
    a = _bare(args, "clip_limit")
    return int(a.get("tile_grid_size", a.get("tile_grid_size_px", 8)))


_photo("clahe allchannelsclahe",
       lambda s, g, b, h, w, c: {"clip_limit": _sample(
           g, _bare(s.args, "clip_limit").get("clip_limit", [1, 10]), b,
           40.0)},
       _image_only(lambda s, d, x: ph.clahe(x, d["clip_limit"],
                                            _clahe_grid(s.args))))


# --- filters -------------------------------------------------------------------
# Their static windows (a tap radius, a pooling or median width, Canny's
# aperture and rounds, Cartoon's median) come from the arguments when the
# block is built (``_STATIC``), with the reference's ValueErrors.

def _spec_max(spec: Any, fallback: float) -> float:
    """The largest value of a scalar or list spec; ``fallback`` for any
    other form (the reference's try/except)."""
    try:
        return (float(spec) if isinstance(spec, (int, float))
                else max(float(v) for v in spec))
    except (TypeError, ValueError):
        return fallback


def _box_radius(spec: Any) -> int:
    """AverageBlur's and MotionBlur's static radius from k's maximum."""
    return int(min(max(1, math.ceil((_spec_max(spec, 7.0) - 1) / 2)), 64))


def _pool_k(name: str):
    def check(args: Any) -> int:
        a = _single(args, "k", 2)
        ok = (isinstance(a, (int, float)) and not isinstance(a, bool)
              and float(a) == int(a) and int(a) >= 1)
        if not ok:
            what = "MedianPooling" if name == "medianpooling" else name
            raise ValueError(
                f"{what} k must be a static integer >= 1 here (pooling "
                "windows are compile-time shapes); got "
                f"{a!r} — see docs/schema.md deviations")
        return int(a)
    return check


def _median_k(args: Any) -> int:
    a = _single(args, "k", 3)
    if a is None:
        a = 3  # bare `MedianBlur: ~` → cv2's default window
    ok = (isinstance(a, (int, float)) and not isinstance(a, bool)
          and math.isfinite(float(a)) and float(a) == int(a)
          and int(a) >= 1 and int(a) % 2 == 1)
    if not ok:
        raise ValueError(
            "MedianBlur k must be a static ODD integer >= 1 here "
            "(even windows are off-center; per-image sampled widths "
            "would need data-dependent sort extents); "
            f"got {a!r} — see docs/schema.md deviations")
    return int(a)


def _canny_static(args: Any) -> Tuple[int, int]:
    a = _bare(args, "alpha")
    sk = a.get("sobel_kernel_size", 3)
    if isinstance(sk, bool) or sk not in (3, 5, 7):
        raise ValueError(
            "Canny sobel_kernel_size must be a static 3, 5 or 7 here "
            f"(conv kernels are compile-time shapes; imgaug's sampled "
            f"sizes can't lower), got {sk!r} — see docs/schema.md")
    it = a.get("hysteresis_iters", 16)
    if isinstance(it, bool) or not isinstance(it, int) or it < 1:
        raise ValueError(
            f"Canny hysteresis_iters must be a static integer >= 1 "
            f"(bounded edge propagation rounds), got {it!r}")
    return int(sk), it


def _cartoon_k(args: Any) -> int:
    bk = (args if isinstance(args, dict) else {}).get("blur_ksize", 3)
    if isinstance(bk, bool) or not isinstance(bk, int) or bk < 1:
        raise ValueError(
            "Cartoon blur_ksize must be a static integer >= 1 here "
            "(median windows are compile-time shapes; imgaug samples "
            f"it per image), got {bk!r} — see docs/schema.md")
    return bk


_STATIC = {
    "averageblur": lambda a: _box_radius(_bare(a, "k").get("k", [1, 7])),
    "gaussianblur": lambda a: int(min(max(3, math.ceil(2.5 * _spec_max(
        _bare(a, "sigma").get("sigma", [0.0, 3.0]), 3.0))), 64)),
    "motionblur": lambda a: _box_radius(_bare(a, "k").get("k", 5)),
    "averagepooling": _pool_k("averagepooling"),
    "maxpooling": _pool_k("maxpooling"),
    "minpooling": _pool_k("minpooling"),
    "medianpooling": _pool_k("medianpooling"),
    "medianblur": _median_k,
    # tap windows capped at radius 5 (121 taps)
    "bilateralblur": lambda a: int(min(max(0, int(_spec_max(
        _bare(a, "d").get("d", 3), 9.0)) // 2), 5)),
    "meanshiftblur": lambda a: int(min(max(1, int(_spec_max(
        _bare(a, "spatial_radius").get("spatial_radius", [5.0, 40.0]),
        5.0))), 5)),
    "canny": _canny_static,
    "cartoon": _cartoon_k,
}


def _alpha_and(key: str, default: Any):
    """Sharpen (``lightness``) and Emboss (``strength``): a dict gives
    both specs; any other form is alpha's spec, ``key`` at its default."""
    def sample(seg, gen, b, h, w, c):
        a = seg.args or {}
        is_dict = isinstance(a, dict)
        return {"alpha": _sample(gen, a.get("alpha", [0.0, 1.0])
                                 if is_dict else a, b),
                key: _sample(gen, a.get(key, default) if is_dict
                             else default, b)}
    return sample


_photo("averageblur",
       lambda s, g, b, h, w, c: {"k": _sample(
           g, _bare(s.args, "k").get("k", [1, 7]), b, 3.0)},
       _image_only(lambda s, d, x: ph.average_blur(x, d["k"], s.static)))
_photo("gaussianblur",
       lambda s, g, b, h, w, c: {"sigma": _sample(
           g, _bare(s.args, "sigma").get("sigma", [0.0, 3.0]), b, 0.0)},
       _image_only(lambda s, d, x: ph.gaussian_blur(x, d["sigma"],
                                                    s.static)))
_photo("sharpen", _alpha_and("lightness", [0.75, 1.5]),
       _image_only(lambda s, d, x: ph.sharpen(x, d["alpha"],
                                              d["lightness"])))
_photo("emboss", _alpha_and("strength", [0.5, 1.5]),
       _image_only(lambda s, d, x: ph.emboss(x, d["alpha"], d["strength"])))
_photo("edgedetect",
       lambda s, g, b, h, w, c: {"alpha": _sample(
           g, _bare(s.args, "alpha").get("alpha", [0.0, 0.75]), b)},
       _image_only(lambda s, d, x: ph.edge_detect(x, d["alpha"])))
_photo("directededgedetect",
       lambda s, g, b, h, w, c: {
           "alpha": _sample(g, _bare(s.args, "alpha").get(
               "alpha", [0.0, 0.75]), b),
           "direction": _sample(g, _bare(s.args, "alpha").get(
               "direction", [0.0, 1.0]), b)},
       _image_only(lambda s, d, x: ph.directed_edge_detect(
           x, d["alpha"], d["direction"])))
_photo("motionblur",
       lambda s, g, b, h, w, c: {
           "k": _sample(g, _bare(s.args, "k").get("k", 5), b, 5.0),
           "angle": _sample(g, _bare(s.args, "k").get("angle", [0, 360]),
                            b)},
       _image_only(lambda s, d, x: ph.motion_blur(x, d["k"], d["angle"],
                                                  s.static)))
for _name, _mode in (("averagepooling", "avg"), ("maxpooling", "max"),
                     ("minpooling", "min")):
    _photo(_name, _none, _image_only(
        lambda s, d, x, m=_mode: ph.keep_size_pooling(x, s.static, m)))
_photo("medianpooling", _none,
       _image_only(lambda s, d, x: ph.median_pooling(x, s.static)))
_photo("medianblur", _none,
       _image_only(lambda s, d, x: ph.median_blur(x, s.static)))
_photo("bilateralblur",
       lambda s, g, b, h, w, c: {
           "d": _sample(g, _bare(s.args, "d").get("d", 3), b, 3.0),
           "sigma_color": _sample(g, _bare(s.args, "d").get(
               "sigma_color", [10, 250]), b, 75.0),
           "sigma_space": _sample(g, _bare(s.args, "d").get(
               "sigma_space", [10, 250]), b, 75.0)},
       _image_only(lambda s, d, x: ph.bilateral_blur(
           x, d["d"], d["sigma_color"], d["sigma_space"], s.static)))
# imgaug maps compression c → codec quality 100 − c
_photo("jpegcompression",
       lambda s, g, b, h, w, c: {"compression": _sample(
           g, _bare(s.args, "compression").get("compression", [0, 100]), b,
           50.0)},
       _image_only(lambda s, d, x: ph.jpeg_compression(
           x, 100.0 - d["compression"])))


def _canny_sample(seg, gen, b, h, w, c):
    """Alpha, the two thresholds (one spec for both, or a pair of specs)
    and the two colours the reference draws inside ``canny``."""
    a = _bare(seg.args, "alpha")
    ht = a.get("hysteresis_thresholds")
    if ht is None:
        lo_spec, hi_spec = [60, 140], [160, 240]
    elif (isinstance(ht, (list, tuple)) and len(ht) == 2
          and all(isinstance(e, (list, tuple)) for e in ht)):
        lo_spec, hi_spec = ht[0], ht[1]
    else:
        lo_spec = hi_spec = ht
    return {"alpha": _sample(gen, a.get("alpha", [0.0, 1.0]), b),
            "lo": _sample(gen, lo_spec, b), "hi": _sample(gen, hi_spec, b),
            "col_t": _rand(gen, (b, 1, 1, 3)) * 256.0,
            "col_f": _rand(gen, (b, 1, 1, 3)) * 256.0}


_photo("canny", _canny_sample,
       _image_only(lambda s, d, x: ph.canny(
           x, d["alpha"], d["lo"], d["hi"], d["col_t"], d["col_f"],
           *s.static)))
_photo("cartoon",
       lambda s, g, b, h, w, c: {
           key: _sample(g, (s.args if isinstance(s.args, dict) else {}).get(
               key, spec), b, default)
           for key, spec, default in (
               ("segmentation_size", [0.8, 1.2], 1.0),
               ("saturation", [1.5, 2.5], 2.0),
               ("edge_prevalence", [0.9, 1.1], 1.0))},
       _image_only(lambda s, d, x: ph.cartoon(
           x, s.static, d["segmentation_size"], d["saturation"],
           d["edge_prevalence"])))
_photo("meanshiftblur",
       lambda s, g, b, h, w, c: {
           "spatial_radius": _sample(g, _bare(s.args, "spatial_radius").get(
               "spatial_radius", [5.0, 40.0]), b, 5.0),
           "color_radius": _sample(g, _bare(s.args, "spatial_radius").get(
               "color_radius", [5.0, 40.0]), b, 10.0)},
       _image_only(lambda s, d, x: ph.mean_shift_blur(
           x, torch.clamp(d["spatial_radius"], max=float(s.static)),
           d["color_radius"], max_radius=s.static)))

# --- weather and colour quantisation -------------------------------------------

def _grids(gen: torch.Generator, b: int, sizes) -> List[Tensor]:
    """The value noise's coarse uniform grids, (B, g, g) an octave."""
    return [_rand(gen, (b, g, g)) for g in sizes]


def _streaks(density, speed, turn):
    """Snowflakes (``turn`` 30) and Rain (20): density, speed, the streak
    angle uniform on ±turn degrees and the point uniforms."""
    def sample(seg, gen, b, h, w, c):
        a = seg.args if isinstance(seg.args, dict) else {}
        return {"density": _sample(gen, a.get("density", density), b),
                "speed": _sample(gen, a.get("speed", speed), b),
                "angle": _rand(gen, (b,)) * (2.0 * turn) - turn,
                "u": _rand(gen, (b, h, w, 1))}
    return sample


_photo("clouds",
       lambda s, g, b, h, w, c: {
           "coverage": _sample(g, _bare(s.args, "coverage").get(
               "coverage", [0.2, 0.5]), b),
           "grids": _grids(g, b, (4, 8, 16))},
       _image_only(lambda s, d, x: ph.clouds(x, d["grids"], d["coverage"])))
_photo("fog",
       lambda s, g, b, h, w, c: {
           "density": _sample(g, _bare(s.args, "density").get(
               "density", [0.1, 0.4]), b),
           "grids": _grids(g, b, (2, 4))},
       _image_only(lambda s, d, x: ph.fog(x, d["grids"], d["density"])))
_photo("snowflakes", _streaks([0.005, 0.05], [0.007, 0.03], 30.0),
       _image_only(lambda s, d, x: ph.snowflakes(
           x, d["u"], d["density"], d["speed"], d["angle"])))
_photo("rain", _streaks([0.01, 0.06], [0.04, 0.1], 20.0),
       _image_only(lambda s, d, x: ph.rain(
           x, d["u"], d["density"], d["speed"], d["angle"])))
_photo("fastsnowylandscape",
       lambda s, g, b, h, w, c: {
           "threshold": _sample(g, (s.args if isinstance(s.args, dict)
                                    else {}).get("lightness_threshold",
                                                 [100, 255]), b, 140.0),
           "multiplier": _sample(g, (s.args if isinstance(s.args, dict)
                                     else {}).get("lightness_multiplier",
                                                  [1.0, 4.0]), b, 2.5)},
       _image_only(lambda s, d, x: ph.fast_snowy_landscape(
           x, d["threshold"], d["multiplier"])))
_photo("uniformcolorquantization",
       lambda s, g, b, h, w, c: {"n_colors": _sample(
           g, _single_or(s.args, "n_colors", [2, 16]), b, 8.0)},
       _image_only(lambda s, d, x: ph.uniform_color_quantization(
           x, d["n_colors"])))


# --- the segment names and Jigsaw ------------------------------------------------
# Each has a static capacity (the most seeds, centres or swap steps its
# spec can draw) and Superpixels, the Voronoi family and k-means a static
# ``max_size``: ``_STATIC`` computes them when the block is built.

def _int_spec_max(spec: Any, default: int) -> int:
    """The static maximum of an integer spec (the reference's
    ``_sample_int``): a scalar itself, a range or a list its largest."""
    if spec is None:
        spec = default
    if isinstance(spec, (int, float)):
        return int(spec)
    return max(int(v) for v in spec)


def _sample_int(gen: torch.Generator, spec: Any, b: int,
                default: int) -> Tensor:
    """(B,) integers: a scalar fixed, [lo, hi] uniform on lo..hi, a longer
    list a uniform choice."""
    if spec is None:
        spec = default
    if isinstance(spec, (int, float)):
        return torch.full((b,), int(spec), dtype=torch.long,
                          device=gen.device)
    vals = [int(v) for v in spec]
    if len(vals) == 2:
        return torch.randint(min(vals), max(vals) + 1, (b,), generator=gen,
                             device=gen.device)
    idx = torch.randint(0, len(vals), (b,), generator=gen, device=gen.device)
    return torch.tensor(vals, device=gen.device)[idx]


def _max_size(args: Any, key: str, name: str) -> Optional[int]:
    """The static ``max_size`` (imgaug's default 128; null: no downscale)
    with the reference's refusal."""
    v = _bare(args, key).get("max_size", 128)
    if v is not None and (isinstance(v, bool) or not isinstance(v, int)
                          or v < 2):
        raise ValueError(
            f"{name}: max_size must be a static integer >= 2 or null "
            f"(it sets a compile-time compute shape), got {v!r}")
    return v


def _grid_args(args: Any) -> Dict[str, Any]:
    """RegularGridVoronoi's and RelativeRegularGridVoronoi's arguments: a
    bare value is both n_rows and n_cols."""
    return args if isinstance(args, dict) else {"n_rows": args,
                                                "n_cols": args}


def _jigsaw_static(args: Any) -> Tuple[int, int, int]:
    """(nb_rows, nb_cols, the most swap steps) with the reference's
    refusals."""
    a = args if isinstance(args, dict) else {}
    rows, cols = a.get("nb_rows", 5), a.get("nb_cols", 5)
    for label, v in (("nb_rows", rows), ("nb_cols", cols)):
        if isinstance(v, bool) or not isinstance(v, int) or v < 1:
            raise ValueError(
                f"Jigsaw {label} must be a static integer >= 1 here "
                "(the cell grid sets compile-time reshape shapes; "
                f"imgaug's sampled grids can't lower), got {v!r} "
                "— see docs/schema.md deviations")
    smax = _int_spec_max(a.get("max_steps", [1, 5]), 2)
    if smax > 64:
        raise ValueError(
            f"Jigsaw max_steps caps at 64 here (the swap chain unrolls "
            f"statically), got max {smax}")
    return rows, cols, max(1, smax)


def _relative_grid(seg, h: int, w: int) -> Tuple[Any, Any, int, int]:
    """RelativeRegularGridVoronoi's fraction specs and its static row and
    column capacities: fractions of the downscaled frame."""
    a = _grid_args(seg.args)
    hs, ws = SG.downscaled_size(h, w, seg.static)
    rf = a.get("n_rows_frac", [0.05, 0.15])
    cf = a.get("n_cols_frac", [0.05, 0.15])
    return (rf, cf, max(1, int(math.ceil(_static_bounds(rf, 0.1)[1] * hs))),
            max(1, int(math.ceil(_static_bounds(cf, 0.1)[1] * ws))))


def _voronoi_grid_sample(seg, gen, b, h, w, c):
    a = _grid_args(seg.args)
    if seg.name == "regulargridvoronoi":
        out = {"rows": _sample_int(gen, a.get("n_rows", [10, 30]), b, 20),
               "cols": _sample_int(gen, a.get("n_cols", [10, 30]), b, 20)}
        p = (max(1, _int_spec_max(a.get("n_rows", [10, 30]), 20))
             * max(1, _int_spec_max(a.get("n_cols", [10, 30]), 20)))
    else:
        rf, cf, rmax, cmax = _relative_grid(seg, h, w)
        out = {"rows_frac": _sample(gen, rf, b, 0.1),
               "cols_frac": _sample(gen, cf, b, 0.1)}
        p = rmax * cmax
    return {**out,
            "p_drop": _sample(gen, a.get("p_drop_points", 0.4), b, 0.4),
            "p_replace": _sample(gen, a.get("p_replace", [0.5, 1.0]), b,
                                 1.0),
            "u_drop": _rand(gen, (b, p)), "u_rep": _rand(gen, (b, p))}


def _voronoi_grid_apply(seg, d, x):
    a = _grid_args(seg.args)
    if seg.name == "regulargridvoronoi":
        rows, cols = d["rows"], d["cols"]
        rmax = max(1, _int_spec_max(a.get("n_rows", [10, 30]), 20))
        cmax = max(1, _int_spec_max(a.get("n_cols", [10, 30]), 20))
    else:
        _, _, rmax, cmax = _relative_grid(seg, x.shape[1], x.shape[2])
        hs, ws = SG.downscaled_size(x.shape[1], x.shape[2], seg.static)
        rows = torch.clamp(torch.round(d["rows_frac"] * hs), min=1.0).long()
        cols = torch.clamp(torch.round(d["cols_frac"] * ws), min=1.0).long()
    return SG.regular_grid_voronoi(x, rows, cols, rmax, cmax, d["u_drop"],
                                   d["u_rep"], d["p_drop"], d["p_replace"],
                                   seg.static)


def _kmeans_sample(seg, gen, b, h, w, c):
    ms, kk = seg.static
    hs, ws = SG.downscaled_size(h, w, ms)
    # Gumbel(0, 1) by the inverse CDF of a uniform kept above float32's
    # smallest normal (the reference's law)
    u = torch.clamp(_rand(gen, (b, kk - 1, hs * ws)),
                    min=torch.finfo(torch.float32).tiny)
    return {"n_colors": _sample_int(gen, _bare(seg.args, "n_colors").get(
                "n_colors", [2, 16]), b, 8),
            "idx0": torch.randint(0, hs * ws, (b, 1), generator=gen,
                                  device=gen.device),
            "gumbels": -torch.log(-torch.log(u))}


def _jigsaw_sample(seg, gen, b, h, w, c):
    rows, cols, smax = seg.static
    spec = (seg.args if isinstance(seg.args, dict) else {}).get(
        "max_steps", [1, 5])
    return {"steps": _sample_int(gen, spec, b, 2),
            "cells": torch.randint(0, rows * cols, (b, smax), generator=gen,
                                   device=gen.device),
            "dirs": torch.randint(0, 4, (b, smax), generator=gen,
                                  device=gen.device)}


_STATIC.update({
    "superpixels": lambda a: (
        _max_size(a, "p_replace", "Superpixels"),
        max(1, _int_spec_max(_bare(a, "p_replace").get("n_segments", 100),
                             100))),
    "uniformvoronoi": lambda a: (
        _max_size(a, "n_points", "UniformVoronoi"),
        max(1, _int_spec_max(_bare(a, "n_points").get("n_points",
                                                      [50, 500]), 100))),
    "regulargridvoronoi": lambda a: _max_size(_grid_args(a), "n_rows",
                                              "RegularGridVoronoi"),
    "relativeregulargridvoronoi": lambda a: _max_size(
        _grid_args(a), "n_rows", "RelativeRegularGridVoronoi"),
    "kmeanscolorquantization": lambda a: (
        _max_size(a, "n_colors", "KMeansColorQuantization"),
        max(2, _int_spec_max(_bare(a, "n_colors").get("n_colors", [2, 16]),
                             8))),
    "jigsaw": _jigsaw_static,
})
_photo("superpixels",
       lambda s, g, b, h, w, c: {
           "n_segments": _sample_int(g, _bare(s.args, "p_replace").get(
               "n_segments", 100), b, 100),
           "p_replace": _sample(g, _bare(s.args, "p_replace").get(
               "p_replace", [0.5, 1.0]), b, 1.0),
           "u_rep": _rand(g, (b, s.static[1]))},
       _image_only(lambda s, d, x: SG.superpixels(
           x, d["n_segments"], s.static[1], d["u_rep"], d["p_replace"],
           s.static[0])))
_photo("uniformvoronoi",
       lambda s, g, b, h, w, c: {
           "n_points": _sample_int(g, _bare(s.args, "n_points").get(
               "n_points", [50, 500]), b, 100),
           "p_replace": _sample(g, _bare(s.args, "n_points").get(
               "p_replace", [0.5, 1.0]), b, 1.0),
           "pos": _rand(g, (b, s.static[1], 2)),
           "u_rep": _rand(g, (b, s.static[1]))},
       _image_only(lambda s, d, x: SG.uniform_voronoi(
           x, d["n_points"], d["pos"], d["u_rep"], d["p_replace"],
           s.static[0])))
_photo("regulargridvoronoi relativeregulargridvoronoi", _voronoi_grid_sample,
       _image_only(_voronoi_grid_apply))
_photo("kmeanscolorquantization", _kmeans_sample,
       _image_only(lambda s, d, x: SG.kmeans_color_quantization(
           x, d["n_colors"], s.static[1], d["idx0"], d["gumbels"],
           s.static[0])))
_photo("jigsaw", _jigsaw_sample,
       lambda s, d, x, m: JG.jigsaw(x, m, s.static[0], s.static[1],
                                    d["steps"], d["cells"], d["dirs"]))

# names rewritten into Affine by ``_coerce_block``; the choice combinators
# and the channel / colourspace scopes
_SUGAR = {"rotate", "translatex", "translatey", "scalex", "scaley",
          "shearx", "sheary"}
_SCOPES = {"withchannels", "withhueandsaturation", "withbrightnesschannels",
           "withcolorspace"}
# the BlendAlpha family (imgaug 0.4's names and the pre-0.4 aliases Alpha,
# AlphaElementwise, SimplexNoiseAlpha and FrequencyNoiseAlpha)
_BLEND = {"blendalpha", "alpha",
          "blendalphaelementwise", "alphaelementwise",
          "blendalphaverticallineargradient",
          "blendalphahorizontallineargradient",
          "blendalpharegulargrid", "blendalphacheckerboard",
          "blendalphasimplexnoise", "simplexnoisealpha",
          "blendalphafrequencynoise", "frequencynoisealpha",
          "blendalphasomecolors", "blendalphasegmapclassids"}
_BLEND_CANON = {"alpha": "blendalpha",
                "alphaelementwise": "blendalphaelementwise",
                "simplexnoisealpha": "blendalphasimplexnoise",
                "frequencynoisealpha": "blendalphafrequencynoise"}
_META = {"sometimes", "oneof", "someof"} | _SCOPES | _BLEND
PORTED_AUGMENTERS = _GEOMETRIC | _SUGAR | set(_PHOTO) | _META
# photo-path names that move pixels and transform the mask jointly —
# refused under the scopes, which splice back only the child's image
_JOINT_PHOTO = {"jigsaw"}
# photometrics that assume a 3-channel RGB image — refused under the
# scopes whose children see 1 or 2 channels (H/S or a brightness plane)
_RGB_ONLY_PHOTO = {"grayscale", "addtohueandsaturation",
                   "multiplyhueandsaturation", "addtohue", "addtosaturation",
                   "multiplyhue", "multiplysaturation", "removesaturation",
                   "changecolortemperature", "fastsnowylandscape",
                   "jpegcompression", "bilateralblur",
                   "canny", "changecolorspace", "cartoon"}
# channels a scope's children see
_SCOPE_CHANNELS = {"withchannels": 3, "withhueandsaturation": 2,
                   "withbrightnesschannels": 1, "withcolorspace": 3}


def check_scope_children(scope: str, child_spec) -> List[Dict[str, Any]]:
    """The reference's refusals of a scope's children, in its order: a
    geometric, combinator (a blend among them) or joint image+mask child,
    then an RGB-only photometric under a 1- or 2-channel scope
    (``ValueError``, its text).  Returns the normalised children."""
    children = _coerce_block(child_spec)
    n_ch = _SCOPE_CHANNELS[scope.lower()]
    for e in children:
        nm = e["name"].lower()
        if nm in _GEOMETRIC or nm in _META or nm in _JOINT_PHOTO:
            what = "selected channels" if scope.lower() == "withchannels" \
                else "scoped channels"
            raise ValueError(
                f"{scope} child {e['name']!r}: only photometric "
                f"children are supported (geometric ones would warp "
                f"the {what} away from the mask)")
        if n_ch != 3 and nm in _RGB_ONLY_PHOTO:
            raise ValueError(
                f"{scope} child {e['name']!r} assumes an RGB "
                f"image, but {scope} children see {n_ch} "
                "channel(s)")
    return children


class _Photo:
    """One photometric augmenter (Resize among them: the reference lowers
    it on the photometric path)."""

    def __init__(self, spec: Dict[str, Any]):
        self.name = spec["name"].lower()
        if self.name not in _PHOTO:
            raise KeyError(f"augmenter {spec['name']!r} has no lowering")
        self.args = spec.get("args")
        self.per_channel = bool(isinstance(self.args, dict)
                                and self.args.get("per_channel"))
        self._sample, self._apply = _PHOTO[self.name]
        if self.name in ("resize", "scale"):
            self.resize = resize_size(self.args)
        elif self.name == "changecolorspace":
            self.colorspace = colorspace_of(self.args)
        elif self.name in ("autocontrast", "auto_contrast"):
            self.cutoff = float(_single(self.args, "cutoff", 0) or 0)
        elif self.name in _STATIC:
            self.static = _STATIC[self.name](self.args)

    def sample(self, gen: torch.Generator, b: int, h: int, w: int,
               c: int) -> Dict[str, Tensor]:
        return self._sample(self, gen, b, h, w, c)

    def take(self, draws: Dict[str, Tensor], rows: slice):
        """A photometric's draws are per image (batch first)."""
        return _take(draws, rows)

    def apply(self, draws: Dict[str, Tensor], images: Tensor, masks: Tensor):
        # photometrics run on 0..255 float32; the pipeline clips at its end
        return self._apply(self, draws, images.float(), masks)


# ---------------------------------------------------------------------------
# choice combinators
# ---------------------------------------------------------------------------

class _Meta:
    """Sometimes / OneOf / SomeOf: child blocks built recursively, each run
    on the whole batch in order on the running batch, then a per-image
    ``where`` selects (the reference's ``_make_meta``; the launch count of
    a step does not depend on the draws).  ``integer_input`` is the
    combinator's place in its block: it reaches the children's first
    geometric run."""

    def __init__(self, spec: Dict[str, Any], integer_input: bool = True):
        self.name = spec["name"].lower()
        args = spec.get("args")
        if self.name == "sometimes":
            a = args if isinstance(args, dict) else {}
            self.p = float(a.get("p", 0.5))
            then_spec = (a.get("then") or a.get("then_list")
                         or a.get("children"))
            else_spec = (a.get("else") or a.get("else_list")
                         or a.get("otherwise"))
            if not then_spec and not else_spec:
                raise ValueError(
                    "Sometimes needs a {then: {...}} (and/or else:) child "
                    "block — without one it would be a silent no-op")
            self.children = [Augmentation(then_spec, integer_input)]
            if else_spec:
                self.children.append(Augmentation(else_spec, integer_input))
            return
        if self.name == "oneof":
            entries = args if isinstance(args, list) else [args]
        else:
            if not isinstance(args, dict):
                raise ValueError("SomeOf expects {n: ..., children: [...]}, "
                                 f"got {args!r}")
            n_spec = args.get("n", 1)
            entries = args.get("children") or args.get("then") or []
            entries = entries if isinstance(entries, list) else [entries]
            if isinstance(n_spec, (list, tuple)):
                self.n_lo, n_hi = int(n_spec[0]), int(n_spec[1])
            else:
                self.n_lo = n_hi = int(n_spec)
            self.n_hi = min(n_hi, len(entries))
        self.children = [Augmentation(e if isinstance(e, list) else [e],
                                      integer_input) for e in entries]

    def sample(self, gen: torch.Generator, b: int, h: int, w: int,
               c: int) -> Dict[str, Any]:
        """The selector's draws and each child's draws."""
        dev = gen.device
        if self.name == "sometimes":
            sel = {"sel": _bernoulli(gen, self.p, (b,))}
        elif self.name == "oneof":
            sel = {"choice": torch.randint(0, len(self.children), (b,),
                                           generator=gen, device=dev)}
        else:
            n = (torch.full((b,), self.n_lo, dtype=torch.long, device=dev)
                 if self.n_lo >= self.n_hi else
                 torch.randint(self.n_lo, self.n_hi + 1, (b,),
                               generator=gen, device=dev))
            sel = {"n": n, "scores": _rand(gen, (b, len(self.children)))}
        return {**sel, "children": [ch.sample(gen, b, h, w, c)
                                    for ch in self.children]}

    def take(self, draws: Dict[str, Any], rows: slice) -> Dict[str, Any]:
        """The selector's draws are per image; each child cuts its own."""
        kids = draws["children"]
        return {**{k: v[rows] for k, v in draws.items() if k != "children"},
                "children": [ch.take(d, rows)
                             for ch, d in zip(self.children, kids)]}

    def include(self, draws: Dict[str, Any]) -> Tensor:
        """(B, children) bool: which children each image keeps."""
        if self.name == "oneof":
            return draws["choice"][:, None] == torch.arange(
                len(self.children), device=draws["choice"].device)
        # exactly n per image: rank the uniform scores, keep the top n
        order = torch.argsort(-draws["scores"], dim=1, stable=True)
        ranks = torch.argsort(order, dim=1, stable=True)
        return ranks < draws["n"][:, None]

    def apply(self, draws: Dict[str, Any], images: Tensor, masks: Tensor):
        kids = draws["children"]
        if self.name == "sometimes":
            out_i, out_m = self.children[0].apply(kids[0], images, masks)
            if len(self.children) > 1:
                images, masks = self.children[1].apply(kids[1], images,
                                                        masks)
            sel = draws["sel"][:, None, None, None]
            return (torch.where(sel, out_i, images),
                    torch.where(sel, out_m, masks))
        keep = self.include(draws)
        for i, (child, d) in enumerate(zip(self.children, kids)):
            out_i, out_m = child.apply(d, images, masks)
            sel = keep[:, i, None, None, None]
            images = torch.where(sel, out_i, images)
            masks = torch.where(sel, out_m, masks)
        return images, masks


# ---------------------------------------------------------------------------
# channel and colourspace scopes
# ---------------------------------------------------------------------------

class _Scope:
    """WithChannels / WithHueAndSaturation / WithBrightnessChannels /
    WithColorspace (the reference's ``_make_meta``).  The three colourspace
    scopes run their photometric children on the scoped channels (H and
    S; HSV-V; H, S and V) without the block's final clip, so hue can wrap
    (H − 50 at H = 20 reaches −30 before the mod 180), then re-encode: hue
    mod 180, S and V clipped to 0..255.  WithChannels runs its children as
    a block (clipped) on the whole image and splices the selected channels
    back.  The masks pass through."""

    def __init__(self, spec: Dict[str, Any]):
        self.name = spec["name"].lower()
        args = spec.get("args")
        a = args if isinstance(args, dict) else {}
        if self.name == "withchannels":
            chans = a.get("channels")
            if chans is None:
                raise ValueError("WithChannels needs {channels: [...], "
                                 "children: {...}}")
            self.channels = [int(c) for c in (
                chans if isinstance(chans, (list, tuple)) else [chans])]
            child_spec = check_scope_children(
                spec["name"], a.get("children") or a.get("then"))
            self.child = Augmentation(child_spec)
            return
        if self.name == "withcolorspace":
            cs = str(a.get("to_colorspace", "")).upper()
            if cs != "HSV":
                raise ValueError(
                    "WithColorspace lowers only {to_colorspace: HSV} here "
                    f"(got {a.get('to_colorspace')!r}) — other colorspaces "
                    "are not implemented; see docs/schema.md")
        child_spec = check_scope_children(
            spec["name"], a.get("children") or a.get("then"))
        if not child_spec:
            raise ValueError(
                f"{spec['name']} needs a {{children: {{...}}}} block")
        self.n_ch = _SCOPE_CHANNELS[self.name]
        self.children = [_Photo(e) for e in child_spec]

    def sample(self, gen: torch.Generator, b: int, h: int, w: int,
               c: int) -> Dict[str, Any]:
        """The children's draws, each child seeing the scoped channels."""
        if self.name == "withchannels":
            return {"children": self.child.sample(gen, b, h, w, c)}
        return {"children": [ch.sample(gen, b, h, w, self.n_ch)
                             for ch in self.children]}

    def take(self, draws: Dict[str, Any], rows: slice) -> Dict[str, Any]:
        if self.name == "withchannels":
            return {"children": self.child.take(draws["children"], rows)}
        return {"children": [ch.take(d, rows) for ch, d in
                             zip(self.children, draws["children"])]}

    def _run(self, draws, x: Tensor, masks: Tensor) -> Tensor:
        for ch, d in zip(self.children, draws["children"]):
            x, masks = ch.apply(d, x, masks)
        return x

    def apply(self, draws: Dict[str, Any], images: Tensor, masks: Tensor):
        base = torch.clamp(images.float(), 0.0, 255.0)
        if self.name == "withchannels":
            out, _ = self.child.apply(draws["children"], images, masks)
            sel = torch.zeros(images.shape[-1], dtype=torch.bool,
                              device=images.device)
            sel[self.channels] = True
            return torch.where(sel, out, base), masks
        if self.name == "withbrightnesschannels":
            v = base.amax(-1, keepdim=True)
            out = torch.clamp(self._run(draws, v, masks), 0.0, 255.0)
            # scaling V scales every channel (H and S invariant); black
            # (V = 0) brightens to gray
            return torch.where(v > 0,
                               base * (out / torch.clamp(v, min=1e-6)),
                               out.expand(base.shape)), masks
        h, s, v = ph.rgb_to_hsv(base)
        if self.name == "withhueandsaturation":
            out = self._run(draws, torch.stack([h, s], dim=-1), masks)
        else:
            out = self._run(draws, torch.stack([h, s, v], dim=-1), masks)
            v = torch.clamp(out[..., 2], 0.0, 255.0)
        return ph.hsv_to_rgb(torch.remainder(out[..., 0], 180.0),
                             torch.clamp(out[..., 1], 0.0, 255.0),
                             v), masks


# ---------------------------------------------------------------------------
# the BlendAlpha family
# ---------------------------------------------------------------------------

class _Blend:
    """BlendAlpha and its nine mask generators (the reference's
    ``_make_blend`` and ``_blend_alpha_map``): the foreground and
    background child blocks run on the input (a missing one is the
    input, clipped), and the images mix as ``alpha·fg + (1 − alpha)·bg``
    under an alpha map in [0, 1], broadcastable to (B, H, W, C); the masks
    take the foreground's where the alpha (its channel mean, per channel)
    is at least 0.5, else the background's (imgaug's segmentation-map
    rule).  The draws: each child's, and the alpha map's."""

    def __init__(self, spec: Dict[str, Any], integer_input: bool = True):
        low = spec["name"].lower()
        self.name = _BLEND_CANON.get(low, low)
        raw = spec.get("args")
        a = self.args = dict(raw) if isinstance(raw, dict) else {}
        fg, bg = (a.get("foreground") or a.get("first"),
                  a.get("background") or a.get("second"))
        if not fg and not bg:
            raise ValueError(f"{spec['name']} needs a foreground (or "
                             "background) child augmenter block")
        self.fg = Augmentation(fg, integer_input) if fg else None
        self.bg = Augmentation(bg, integer_input) if bg else None
        self.children = [ch for ch in (self.fg, self.bg) if ch is not None]
        self.per_channel = bool(a.get("per_channel", False))
        if self.name in ("blendalpharegulargrid", "blendalphacheckerboard"):
            self.rmax = _int_spec_max(a.get("nb_rows"), 4)
            self.cmax = _int_spec_max(a.get("nb_cols"), 4)
        elif self.name == "blendalphasomecolors":
            self.nbmax = min(max(_int_spec_max(a.get("nb_bins", [5, 15]), 10),
                                 1), 256)
        elif self.name == "blendalphasegmapclassids":
            ids = a.get("class_ids")
            if ids is None:
                raise ValueError("BlendAlphaSegMapClassIds needs "
                                 "{class_ids: int | [ints]}")
            self.class_ids = [int(i) for i in _as_list(ids)]

    def _factor_spec(self):
        spec = self.args.get("factor", self.args.get("alpha"))
        return [0.0, 1.0] if spec is None else spec

    def _alpha_sample(self, gen: torch.Generator, b: int, h: int, w: int,
                      c: int) -> Dict[str, Any]:
        a, name = self.args, self.name
        if name == "blendalpha":
            shape = (b, 1, 1, c) if self.per_channel else (b,)
            return {"factor": _sample_shape(gen, self._factor_spec(), shape)}
        if name == "blendalphaelementwise":
            return {"factor": _sample_shape(
                gen, self._factor_spec(),
                (b, h, w, c if self.per_channel else 1))}
        if "lineargradient" in name:
            return {"start": _sample(gen, a.get("start_at", [0.0, 1.0]), b),
                    "end": _sample(gen, a.get("end_at", [0.0, 1.0]), b)}
        if name in ("blendalpharegulargrid", "blendalphacheckerboard"):
            out = {"rows": _sample_int(gen, a.get("nb_rows"), b, 4),
                   "cols": _sample_int(gen, a.get("nb_cols"), b, 4)}
            if name == "blendalpharegulargrid":
                shape = (b, self.rmax, self.cmax)
                out["grid"] = (_bernoulli(gen, 0.5, shape).float()
                               if a.get("alpha") is None else
                               _sample_shape(gen, a["alpha"], shape))
            return out
        out = {}
        if name == "blendalphasimplexnoise":
            out["grids"] = _grids(gen, b, (2, 4, 8, 16))
        elif name == "blendalphafrequencynoise":
            out["exponent"] = _sample(gen, a.get("exponent", [-4.0, 4.0]), b)
            out["white"] = torch.randn((b, h, w), generator=gen,
                                       device=gen.device)
        elif name == "blendalphasomecolors":
            spec = a.get("alpha")
            shape = (b, self.nbmax)
            return {"rotation": _sample(gen, a.get("rotation_deg", [0, 360]),
                                        b),
                    "nb_bins": _sample_int(gen, a.get("nb_bins", [5, 15]), b,
                                           10),
                    "table": (_bernoulli(gen, 0.5, shape).float()
                              if spec is None
                              else _sample_shape(gen, spec, shape)),
                    "smoothness": _sample(gen, a.get("smoothness",
                                                     [0.1, 0.3]), b)}
        if name != "blendalphasegmapclassids" and a.get("sigmoid", True):
            out["thresh"] = _sample(gen, a.get("sigmoid_thresh", [0.4, 0.6]),
                                    b)
        return out

    def sample(self, gen: torch.Generator, b: int, h: int, w: int,
               c: int) -> Dict[str, Any]:
        return {"children": [ch.sample(gen, b, h, w, c)
                             for ch in self.children],
                "alpha": self._alpha_sample(gen, b, h, w, c)}

    def take(self, draws: Dict[str, Any], rows: slice) -> Dict[str, Any]:
        """Each child cuts its own draws; the alpha map's are per image
        (the simplex noise's grids a list of them)."""
        return {"children": [ch.take(d, rows) for ch, d in
                             zip(self.children, draws["children"])],
                "alpha": _take(draws["alpha"], rows)}

    def alpha(self, d: Dict[str, Any], base: Tensor,
              masks: Tensor) -> Tensor:
        """The alpha map from its draws ``d``, the input clipped to
        0..255 (SomeColors reads its hue) and the masks (SegMapClassIds
        reads its classes)."""
        b, h, w, c = base.shape
        name, dev = self.name, base.device
        if name == "blendalpha":
            f = d["factor"]
            return f if self.per_channel else f[:, None, None, None]
        if name == "blendalphaelementwise":
            return d["factor"]
        if "lineargradient" in name:
            vertical = "vertical" in name
            mn = float(self.args.get("min_value", 0.0))
            mx = float(self.args.get("max_value", 1.0))
            n = h if vertical else w
            pos = (torch.arange(n, dtype=torch.float32, device=dev)
                   / max(n - 1, 1))[None, :]
            s0, span = d["start"], d["end"] - d["start"]
            span = torch.where(span.abs() < 1e-6,
                               torch.where(span < 0, -1e-6, 1e-6), span)
            t = torch.clamp((pos - s0[:, None]) / span[:, None], 0.0, 1.0)
            al = mn + (mx - mn) * t
            return al[:, :, None, None] if vertical else al[:, None, :, None]
        if name in ("blendalpharegulargrid", "blendalphacheckerboard"):
            iy = torch.div(torch.arange(h, device=dev)[None, :]
                           * d["rows"][:, None], h, rounding_mode="floor")
            ix = torch.div(torch.arange(w, device=dev)[None, :]
                           * d["cols"][:, None], w, rounding_mode="floor")
            if name == "blendalphacheckerboard":
                return ((iy[:, :, None] + ix[:, None, :]) % 2 == 0
                        ).float()[..., None]
            # the cell's alpha, gathered (the reference's two one-hot
            # products at full precision give the same values)
            grid = d["grid"]
            rows_of = grid.gather(1, iy[:, :, None].expand(b, h,
                                                           grid.shape[2]))
            return rows_of.gather(2, ix[:, None, :].expand(b, h, w))[..., None]
        if name == "blendalphasimplexnoise":
            noise = torch.stack([resize_to(g[:, None], h, w, "bilinear")[:, 0]
                                 for g in d["grids"]]).amax(0)
            if "thresh" in d:
                noise = torch.sigmoid(10.0 * (noise - d["thresh"][:, None,
                                                                   None]))
            return noise[..., None]
        if name == "blendalphafrequencynoise":
            return self._frequency_noise(d, h, w)[..., None]
        if name == "blendalphasomecolors":
            return self._some_colors(d, base)
        return self._class_ids(masks)

    def _frequency_noise(self, d: Dict[str, Any], h: int, w: int) -> Tensor:
        """White noise shaped by f^exponent in the Fourier domain, min-max
        normalised per image, then sigmoid-sharpened."""
        dev = d["white"].device
        spec = torch.fft.rfft2(d["white"])
        fy = torch.fft.fftfreq(h, device=dev)[:, None]
        fx = torch.fft.rfftfreq(w, device=dev)[None, :]
        f = torch.sqrt(fy * fy + fx * fx)
        f = torch.where(f == 0, 1.0 / max(h, w), f)
        scale = f[None] ** d["exponent"][:, None, None]
        noise = torch.fft.irfft2(spec * scale, s=(h, w))
        lo = noise.amin((1, 2), keepdim=True)
        hi = noise.amax((1, 2), keepdim=True)
        al = (noise - lo) / torch.clamp(hi - lo, min=1e-6)
        if "thresh" in d:
            al = torch.sigmoid(10.0 * (al - d["thresh"][:, None, None]))
        return al

    def _some_colors(self, d: Dict[str, Any], base: Tensor) -> Tensor:
        """imgaug SomeColorsMaskGen: the hue (after a rotation) binned
        into nb_bins bins, one alpha a bin, the bin table smoothed
        circularly by a gaussian of sigma smoothness·nb_bins/3 (the
        reference's approximation of imgaug's kernel), each pixel's alpha
        its bin's."""
        b, h, w, _ = base.shape
        nbmax, dev = self.nbmax, base.device
        nbf = torch.clamp(d["nb_bins"], 1, nbmax).float()[:, None]   # (B, 1)
        rot = d["rotation"] * 0.5
        hue = ph.rgb_to_hsv(base)[0]
        hb = torch.remainder(hue + rot[:, None, None], 180.0)
        bins = torch.minimum(torch.floor(hb / 180.0 * nbf[..., None]),
                             nbf[..., None] - 1.0).long()
        ii = torch.arange(nbmax, dtype=torch.float32, device=dev)
        dist = torch.abs(ii[None, :, None] - ii[None, None, :])
        dist = torch.minimum(dist, nbf[..., None] - dist)          # circular
        sig = torch.clamp(d["smoothness"][:, None, None] * nbf[..., None]
                          / 3.0, min=1e-3)
        wgt = torch.exp(-0.5 * torch.square(dist / sig))
        valid = ((ii[None, :, None] < nbf[..., None])
                 & (ii[None, None, :] < nbf[..., None]))
        wgt = torch.where(valid, wgt, 0.0)
        wgt = wgt / torch.clamp(wgt.sum(2, keepdim=True), min=1e-6)
        # full f32: the smoothed alphas feed the masks' >= 0.5 routing
        with FW._exact_f32(dev):
            table = torch.bmm(wgt, d["table"][..., None])[..., 0]
        return table.gather(1, bins.reshape(b, -1)).reshape(b, h, w, 1)

    def _class_ids(self, masks: Tensor) -> Tensor:
        """1 where the mask carries one of the class ids (0: no channel
        set, i ≥ 1: mask channel i − 1)."""
        mc = masks.shape[-1]
        m = masks.float()
        sel = torch.zeros(m.shape[:3] + (1,), device=m.device)
        for i in self.class_ids:
            if i == 0:
                sel = torch.maximum(sel, 1.0 - torch.clamp(
                    m.sum(-1, keepdim=True), max=1.0))
            elif 1 <= i <= mc:
                sel = torch.maximum(sel, m[..., i - 1:i])
            else:
                raise ValueError(
                    f"BlendAlphaSegMapClassIds: class id {i} out of range "
                    f"for a {mc}-channel mask (0 = background, 1..{mc} = "
                    "mask channels)")
        return sel

    def apply(self, draws: Dict[str, Any], images: Tensor, masks: Tensor):
        base = torch.clamp(images.float(), 0.0, 255.0)
        outs = iter(ch.apply(d, images, masks)
                    for ch, d in zip(self.children, draws["children"]))
        fi, fm = next(outs) if self.fg is not None else (base, masks)
        bi, bm = next(outs) if self.bg is not None else (base, masks)
        al = self.alpha(draws["alpha"], base, masks)
        out_i = al * fi + (1.0 - al) * bi
        am = al.mean(-1, keepdim=True) if al.shape[-1] != 1 else al
        return out_i, torch.where(am >= 0.5, fm, bm)


class Augmentation:
    """A compiled augmentation block: ``sample`` draws, ``apply`` runs.

    ``integer_input=False`` marks a child block whose input may carry
    non-integer values (a combinator after another segment): its first
    geometric run then takes the float taps, not the uint8 gather."""

    def __init__(self, specs, integer_input: bool = True):
        self.specs = _coerce_block(specs)
        groups: List[Tuple[str, Any]] = []
        for s in self.specs:
            name = s["name"].lower()
            if name in _GEOMETRIC:
                if groups and groups[-1][0] == "geo":
                    groups[-1][1].append(s)
                else:
                    groups.append(("geo", [s]))
            else:
                groups.append(("meta" if name in _META else "photo", s))
        self.segments: List[Any] = []
        for i, (kind, item) in enumerate(groups):
            first = i == 0 and integer_input
            if kind == "geo":
                self.segments.append(_GeoRun(item, integer_input=first))
            elif kind == "meta" and item["name"].lower() in _SCOPES:
                self.segments.append(_Scope(item))
            elif kind == "meta" and item["name"].lower() in _BLEND:
                self.segments.append(_Blend(item, integer_input=first))
            elif kind == "meta":
                self.segments.append(_Meta(item, integer_input=first))
            else:
                self.segments.append(_Photo(item))

    def geo_runs(self) -> List[_GeoRun]:
        """Every geometric run of the block, children's included, in the
        order ``apply`` runs them."""
        out: List[_GeoRun] = []
        for seg in self.segments:
            if isinstance(seg, _GeoRun):
                out.append(seg)
            elif isinstance(seg, (_Meta, _Blend)):
                for child in seg.children:
                    out.extend(child.geo_runs())
        return out

    def sample(self, gen: torch.Generator, b: int, h: int, w: int,
               c: int = 3) -> Draws:
        """Every random value of the block, one entry per segment (a
        combinator's entry holds its children's), on the generator's
        device."""
        return [seg.sample(gen, b, h, w, c) for seg in self.segments]

    def take(self, draws: Draws, rows: slice) -> Draws:
        """The draws of the images ``rows`` of the batch ``draws`` were
        sampled for: ``apply(take(d, rows), x[rows])`` equals
        ``apply(d, x)[rows]``."""
        return [seg.take(d, rows) for seg, d in zip(self.segments, draws)]

    def apply(self, draws: Draws, images: Tensor, masks: Tensor):
        """images (B, H, W, C) uint8 or float on 0..255, masks
        (B, H, W, M) → (images float32 clipped to 0..255, masks)."""
        if len(draws) != len(self.segments):
            raise ValueError(f"expected draws for {len(self.segments)} "
                             f"segments, got {len(draws)}")
        imgs = images
        for seg, d in zip(self.segments, draws):
            imgs, masks = seg.apply(d, imgs, masks)
        return torch.clamp(imgs.float(), 0.0, 255.0), masks

    def __call__(self, gen: torch.Generator, images: Tensor, masks: Tensor):
        b, h, w, c = images.shape
        return self.apply(self.sample(gen, b, h, w, c), images, masks)


def build_augmentation(specs) -> Augmentation:
    """specs: [{"name": ..., "args": ...}] or a raw YAML block."""
    return Augmentation(specs)


def build_transform_fn(transforms, augmentation):
    """→ (augmentation, transform_fn) for the fit loop and the predict
    program; either is None when its block is empty.

    ``transforms:`` is preprocessing applied first, to every split (train,
    validation and predict): ``transform_fn(images, masks)`` draws its
    values from a ``torch.Generator`` seeded with 0, made anew on the
    images' device at every call, so a batch is always transformed the same
    way; ``transform_fn(images, masks, rows, batch)`` transforms the
    images ``rows`` of a batch of ``batch`` as the whole batch would be
    (it draws for the batch and takes their draws: a rank's share under
    data parallelism).  ``augmentation:`` runs after it at train time
    only, with the step's generator.  The JAX package draws its transforms from the fixed
    ``PRNGKey(0)``; the two packages agree only where the spec leaves no
    value random (probabilities 0 or 1, constant arguments)."""
    t_aug = build_augmentation(transforms) if transforms else None
    a_aug = build_augmentation(augmentation) if augmentation else None
    if t_aug is None:
        return a_aug, None

    def transform_fn(images: Tensor, masks: Tensor,
                     rows: Optional[slice] = None,
                     batch: Optional[int] = None):
        gen = torch.Generator(device=images.device).manual_seed(0)
        if rows is None:
            return t_aug(gen, images, masks)
        _, h, w, c = images.shape
        draws = t_aug.take(t_aug.sample(gen, batch, h, w, c), rows)
        return t_aug.apply(draws, images, masks)

    return a_aug, transform_fn
