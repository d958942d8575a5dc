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
Every augmenter not yet ported raises ``NotImplementedError``.

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

from . import elastic as EL
from . import fast_warp as FW
from . import photometric as ph
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
PORTED_AUGMENTERS = _GEOMETRIC | {"multiply"}


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to the torch "
                               "package")


def _coerce_block(spec) -> List[Dict[str, Any]]:
    """Accept raw YAML aug blocks ({Name: args} / list) or config-normalised
    [{"name", "args"}] lists and return the normalised list form."""
    if spec is None:
        return []
    if isinstance(spec, dict):
        if "name" in spec and "args" in spec and len(spec) == 2:
            return [spec]
        return [{"name": n, "args": a} for n, a in spec.items()]
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
    return out


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
            if name not in PORTED_AUGMENTERS:
                raise not_ported(f"augmenter {s['name']!r}")
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

    def sample(self, gen: torch.Generator, b: int, h: int, w: int) -> Draws:
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

    def apply(self, draws: Draws, images: Tensor, masks: Tensor):
        b, h, w = images.shape[0], images.shape[1], images.shape[2]
        route = self.route(h, w)
        if route == "flips":
            return self._apply_cheap(draws, images, masks)
        images = images.float()
        mats = W.identity_mats(b, images.device)
        disp: Optional[Tuple[Tensor, Tensor]] = None
        for i, (s, name, d) in enumerate(zip(self.geo, self.names, draws)):
            if name in _DISP_NAMES:
                dx, dy = self._field(i, name, d, h, w)
                disp = (dx, dy) if disp is None else (disp[0] + dx,
                                                      disp[1] + dy)
                continue
            m = self._matrix(name, s.get("args"), d, b, h, w, images.device)
            if m is not None:
                mats = W.compose(m, mats)
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
# photometric augmenters
# ---------------------------------------------------------------------------

class _Photo:
    def __init__(self, spec: Dict[str, Any]):
        self.name = spec["name"].lower()
        if self.name not in PORTED_AUGMENTERS:
            raise not_ported(f"augmenter {spec['name']!r}")
        args = spec.get("args")
        self.per_channel = bool(isinstance(args, dict)
                                and args.get("per_channel"))
        self.mul = _bare(args, "mul").get("mul", [0.8, 1.2])

    def sample(self, gen: torch.Generator, b: int, c: int) -> Dict[str, Tensor]:
        if self.per_channel:
            return {"mul": _sample(gen, self.mul, b * c, 1.0).reshape(b, c)}
        return {"mul": _sample(gen, self.mul, b, 1.0)}

    def apply(self, draws: Dict[str, Tensor], images: Tensor, masks: Tensor):
        return ph.multiply(images.float(), draws["mul"]), masks


class Augmentation:
    """A compiled augmentation block: ``sample`` draws, ``apply`` warps."""

    def __init__(self, specs):
        self.specs = _coerce_block(specs)
        self.segments: List[Any] = []
        for s in self.specs:
            name = s["name"].lower()
            if name in _GEOMETRIC:
                if self.segments and isinstance(self.segments[-1], list):
                    self.segments[-1].append(s)
                else:
                    self.segments.append([s])
            else:
                self.segments.append(s)
        # uint8 gather taps only in the first segment (decoded images)
        self.segments = [_GeoRun(g, integer_input=i == 0)
                         if isinstance(g, list) else _Photo(g)
                         for i, g in enumerate(self.segments)]

    def sample(self, gen: torch.Generator, b: int, h: int, w: int,
               c: int = 3) -> Draws:
        """Every random value of the block, one entry per segment, on the
        generator's device."""
        return [seg.sample(gen, b, h, w) if isinstance(seg, _GeoRun)
                else seg.sample(gen, b, c) for seg in self.segments]

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
    way.  ``augmentation:`` runs after it at train time only, with the
    step's generator.  The JAX package draws its transforms from the fixed
    ``PRNGKey(0)``; the two packages agree only where the spec leaves no
    value random (probabilities 0 or 1, constant arguments)."""
    t_aug = build_augmentation(transforms) if transforms else None
    a_aug = build_augmentation(augmentation) if augmentation else None
    if t_aug is None:
        return a_aug, None

    def transform_fn(images: Tensor, masks: Tensor):
        gen = torch.Generator(device=images.device).manual_seed(0)
        return t_aug(gen, images, masks)

    return a_aug, transform_fn
