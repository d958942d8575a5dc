"""YAML ``augmentation:`` block → an augmentation with explicit draws.

Counterpart of ``segmentation_training_pipeline_tpu/ops/aug/lowering.py``
(``build_augmentation``).  The block compiles the same way: contiguous
runs of geometric augmenters fold into one per-image inverse affine (plus
an elastic displacement field) applied by ONE warp of images (bilinear)
and masks (nearest); photometric augmenters apply elementwise after, in
the user's order.

Randomness is explicit.  ``Augmentation.sample(gen, b, h, w)`` draws every
random value of the block from a ``torch.Generator`` (the distributions of
the JAX lowering: bernoulli flips; uniform scale, translate, rotate and
alpha; uniform noise fields for the elastic field; the Multiply factor),
and ``Augmentation.apply(draws, images, masks)`` is deterministic.  The
tests make the draws with ``jax.random`` along the reference's key schedule
and hand the same values to both sides.

Paths, as on the TPU:
  * flips only → reverse + select (``_apply_cheap_geo``);
  * affine → ``fast_warp.warp_joint_multipass`` (kernels X and Y);
  * affine + elastic → the multipass warp, then the elastic kernel on the
    residual field D' = A⁻¹·D clipped to ±K;
  * elastic only → the elastic kernel on the raw field.
Configurations the JAX package sends to its exact footprint gather (K > 64,
a shear bound beyond the canvas, non-square frames with rotations of 60° or
more) raise ``NotImplementedError``, as does every augmenter not yet ported.

Parameter forms: scalar → fixed value (probability for flips); [lo, hi] →
uniform per image; [a, b, c, ...] → uniform choice per image;
{x: ..., y: ...} → independent per-axis values (Affine scale/translate).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

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
_ELASTIC_NAMES = {"elastictransformation", "elastictransform", "elastic"}
PORTED_AUGMENTERS = _FLIPS | {"affine", "multiply"} | _ELASTIC_NAMES


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


# ---------------------------------------------------------------------------
# geometric runs
# ---------------------------------------------------------------------------

class _GeoRun:
    """One contiguous run of geometric augmenters → one fused warp."""

    def __init__(self, geo: List[Dict[str, Any]]):
        self.geo = geo
        self.names = [s["name"].lower() for s in geo]
        for s, name in zip(geo, self.names):
            if name not in PORTED_AUGMENTERS:
                raise not_ported(f"augmenter {s['name']!r}")
            a = s.get("args")
            if isinstance(a, dict):
                if a.get("mode") not in (None, "constant"):
                    raise ValueError(
                        f"{s['name']}: only mode='constant' fill is "
                        f"supported (got {a.get('mode')!r})")
                if a.get("cval") is not None:
                    raise not_ported(f"{s['name']} cval (the fill shift)")
        self.cheap = set(self.names) <= _FLIPS
        self.nonelastic = [s for s, n in zip(geo, self.names)
                           if n not in _ELASTIC_NAMES]
        self.mag_bound = self._static_magnification()
        self.shear_deg, self.shear_aniso = self._static_shear_tan()
        self.disp_bound = 0.0
        self.elastic = {}
        for i, (s, name) in enumerate(zip(geo, self.names)):
            if name in _ELASTIC_NAMES:
                a = s.get("args") or {}
                _, a_max = _static_bounds(a.get("alpha"), 20.0)
                sig_min, sig_max = _static_bounds(a.get("sigma"), 5.0)
                self.disp_bound += W.displacement_bound(a_max, sig_min)
                # quarter-res field when the blur makes it lossless-ish
                self.elastic[i] = (W.elastic_radius(sig_max),
                                   4 if sig_min >= 2.0 else 1)
        # K bound of the elastic kernel: the static field bound scaled by
        # the forward affine's static magnification, plus a margin
        self.kbound = int(math.ceil(self.disp_bound * self.mag_bound
                                    * 1.15)) + 2

    @staticmethod
    def _affine_values(a: Dict[str, Any], key: str) -> List[float]:
        v = a.get(key)
        vals = (list(v.values()) if isinstance(v, dict)
                else v if isinstance(v, (list, tuple)) else [v])
        flat: List[float] = []
        for x in vals:
            flat += list(x) if isinstance(x, (list, tuple)) else [x]
        return [abs(float(x)) for x in flat]

    def _static_magnification(self) -> float:
        """Static bound on how much the forward affine magnifies the
        elastic displacement (zoom from scale, plus a shear allowance)."""
        mag = 1.0
        for s in self.nonelastic:
            a = s.get("args") or {}
            if s["name"].lower() != "affine":
                continue
            try:
                if a.get("scale") is not None:
                    mag *= max(max(self._affine_values(a, "scale")), 1.0)
                if a.get("shear") is not None:
                    smax = max(self._affine_values(a, "shear"))
                    mag *= 1.0 + math.tan(math.radians(min(smax, 80.0)))
            except (TypeError, ValueError):
                mag *= 4.0  # unparseable spec: be conservative
        return mag

    def _static_shear_tan(self) -> Tuple[float, float]:
        """(rotation + shear degrees, anisotropy) bounding the multipass
        shear factors: s1 = tan(θ)·(sy/sx)."""
        rot = shear = 0.0
        aniso = 1.0
        try:
            for s in self.nonelastic:
                a = s.get("args") or {}
                if s["name"].lower() != "affine":
                    continue
                if a.get("rotate") is not None:
                    rot += max(abs(v) for v in _static_bounds(a["rotate"], 0))
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
        if self._shear_tan_for(h == w) > 2.0 - 24.0 / max(min(h, w), 13):
            return False
        if h == w:
            return True
        for s in self.nonelastic:
            if s["name"].lower() != "affine":
                continue
            r = (s.get("args") or {}).get("rotate")
            if r is None:
                continue
            try:
                if max(abs(float(v)) for v in
                       (r if isinstance(r, (list, tuple)) else [r])) >= 60.0:
                    return False
            except (TypeError, ValueError):
                return False
        return True

    def sample(self, gen: torch.Generator, b: int, h: int, w: int) -> Draws:
        draws = []
        for i, (s, name) in enumerate(zip(self.geo, self.names)):
            args = s.get("args")
            if name in _FLIPS:
                draws.append({"flip": _rand(gen, (b,)) < _flip_p(args)})
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
            else:
                a = args or {}
                radius, stride = self.elastic[i]
                shape = W.noise_shape(b, h, w, radius, stride)
                draws.append(dict(
                    alpha=_sample(gen, a.get("alpha", 20.0), b),
                    sigma=_sample(gen, a.get("sigma", 5.0), b),
                    noise_x=_rand(gen, shape) * 2.0 - 1.0,
                    noise_y=_rand(gen, shape) * 2.0 - 1.0))
        return draws

    def _apply_cheap(self, draws: Draws, images: Tensor, masks: Tensor):
        """Flips as reverse + select — no warp."""
        for name, d in zip(self.names, draws):
            f = d["flip"][:, None, None, None]
            axis = 2 if name in ("fliplr", "horizontalflip") else 1
            images = torch.where(f, images.flip(axis), images)
            masks = torch.where(f, masks.flip(axis), masks)
        return images, masks

    def apply(self, draws: Draws, images: Tensor, masks: Tensor):
        if self.cheap:
            return self._apply_cheap(draws, images, masks)
        b, h, w = images.shape[0], images.shape[1], images.shape[2]
        cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
        images = images.float()
        mats = W.identity_mats(b, images.device)
        disp: Optional[Tuple[Tensor, Tensor]] = None
        for i, (s, name, d) in enumerate(zip(self.geo, self.names, draws)):
            if name in ("fliplr", "horizontalflip"):
                mats = W.compose(W.hflip(w, d["flip"]), mats)
            elif name in ("flipud", "verticalflip"):
                mats = W.compose(W.vflip(h, d["flip"]), mats)
            elif name == "affine":
                a = s.get("args") or {}
                mats = W.compose(W.scale_about(cx, cy, d["sx"], d["sy"]),
                                 mats)
                tx, ty = d["tx"], d["ty"]
                if "translate_percent" in a:
                    tx, ty = tx * w, ty * h
                # inverse translation: src = dst − t
                mats = W.compose(W.translation(-tx, -ty), mats)
                rot = d["rot"] * (math.pi / 180.0)
                mats = W.compose(W.rotation_about(cx, cy, rot), mats)
                mats = W.compose(W.shear_about(
                    cx, cy, d["shx"] * (math.pi / 180.0),
                    d["shy"] * (math.pi / 180.0)), mats)
            else:
                radius, stride = self.elastic[i]
                dx, dy = W.elastic_field(d["noise_x"], d["noise_y"], h, w,
                                         d["alpha"], d["sigma"], radius,
                                         stride)
                disp = (dx, dy) if disp is None else (disp[0] + dx,
                                                      disp[1] + dy)
        if not self.multipass_ok(h, w):
            raise not_ported("the exact footprint-gather warp (needed for "
                             f"this shear/rotation range at {h}x{w})")
        pad_frac = self.pad_frac(h, w)
        if disp is None:
            return FW.warp_joint_multipass(images, masks, mats,
                                           pad_frac=pad_frac)
        k = self.kbound
        if k > 64:
            raise not_ported(f"the exact footprint-gather warp (needed for "
                             f"displacement bound K={k} > 64)")
        if not self.nonelastic:
            # elastic only: the affine is the identity — raw field
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
        self.segments = [_GeoRun(g) if isinstance(g, list) else _Photo(g)
                         for g in self.segments]

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
