"""Keras optimizer names → unit-learning-rate gradient transforms (PyTorch).

Counterpart of ``segmentation_training_pipeline_tpu/train/optimizers.py``.
As there, the transform produces **unit-lr** updates (optax's
``scale_by_*`` without the final ``scale(-lr)``) and the train step
multiplies them by ``-lr``, a per-step runtime scalar, so a schedule
changes the rate without touching optimizer state.  The chain is optax's:
``clip_by_global_norm`` (``clipnorm``), ``clip`` (``clipvalue``), the
algorithm, then ``add_decayed_weights`` (decoupled decay, scaled by the lr
together with the update).  Each part follows the optax 0.2 formula of the
same name in float32; the state is a tuple with one entry per part, as
optax's ``chain`` state.

Freezing (``freeze_encoder``, a stage's ``unfreeze_encoder``) is optax's
``multi_transform`` with ``set_to_zero`` on the ``encoder`` subtree: the
whole chain, its global norm and its decay included, sees the trainable
parameters only (:meth:`Optimizer.trainable`, named through
``models.bridge``'s flax path), and a frozen parameter is never updated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from ..models.bridge import flax_path

Tensor = torch.Tensor
Tree = Dict[str, Tensor]

KNOWN = {"adam", "adamw", "sgd", "rmsprop", "nadam", "adamax", "adagrad",
         "adadelta", "lion", "lamb"}


def _bc(decay: float, count: int) -> float:
    """optax's bias correction ``1 − decay^count``, taken in float32."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def _zeros(params: Tree) -> Tree:
    return {k: torch.zeros_like(p) for k, p in params.items()}


def _get(tree: Tree, names: Sequence[str]) -> List[Tensor]:
    return [tree[n] for n in names]


def _ema(g: List[Tensor], t: List[Tensor], decay: float) -> List[Tensor]:
    """``(1 − decay)·g + decay·t``, optax's ``update_moment`` of order 1."""
    out = torch._foreach_mul(g, 1.0 - decay)
    torch._foreach_add_(out, torch._foreach_mul(t, decay))
    return out


@dataclass
class AdamState:
    mu: Tree
    nu: Tree
    count: int


@dataclass
class TraceState:
    trace: Tree


@dataclass
class RmsState:
    nu: Tree


@dataclass
class RssState:
    sum_of_squares: Tree


@dataclass
class AdadeltaState:
    e_g: Tree
    e_x: Tree


@dataclass
class LionState:
    mu: Tree
    count: int


class _Stateless:
    def init(self, params: Tree):
        return ()


class Identity(_Stateless):
    def update(self, names, g, state, p):
        return g, state


class ClipByGlobalNorm(_Stateless):
    """optax.clip_by_global_norm: unchanged below ``max_norm``, else
    ``t / ‖g‖ · max_norm`` (the norm over every leaf it sees)."""

    def __init__(self, max_norm: float):
        self.max_norm = float(max_norm)

    def update(self, names, g, state, p):
        norm = torch.sqrt(sum(torch.sum(t * t) for t in g))
        keep = norm < self.max_norm
        return [torch.where(keep, t, t / norm * self.max_norm)
                for t in g], state


class Clip(_Stateless):
    """optax.clip: each element into [−max_delta, max_delta]."""

    def __init__(self, max_delta: float):
        self.max_delta = float(max_delta)

    def update(self, names, g, state, p):
        return [t.clamp(-self.max_delta, self.max_delta) for t in g], state


class AddDecayedWeights(_Stateless):
    """optax.add_decayed_weights: ``g + wd·p``."""

    def __init__(self, weight_decay: float):
        self.weight_decay = float(weight_decay)

    def update(self, names, g, state, p):
        return torch._foreach_add(g, torch._foreach_mul(
            list(p), self.weight_decay)), state


class TrustRatio(_Stateless):
    """optax.scale_by_trust_ratio: ``u · ‖p‖ / ‖u‖`` per tensor, 1 where
    either norm is 0."""

    def update(self, names, g, state, p):
        out = []
        for u, w in zip(g, p):
            pn, un = torch.linalg.vector_norm(w), torch.linalg.vector_norm(u)
            ratio = torch.where((pn == 0.0) | (un == 0.0),
                                torch.ones_like(pn), pn / un)
            out.append(u * ratio)
        return out, state


class ScaleByAdam:
    """optax.scale_by_adam (``nesterov`` for Nadam): mu ← EMA(g, b1), nu ←
    EMA(g², b2), update = m̂ / (sqrt(n̂) + eps) with the bias corrections
    taken in float32."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 nesterov: bool = False):
        self.b1, self.b2, self.eps, self.nesterov = b1, b2, eps, nesterov

    def init(self, params: Tree) -> AdamState:
        return AdamState(_zeros(params), _zeros(params), 0)

    def update(self, names, g, state: AdamState, p):
        b1, b2 = self.b1, self.b2
        mu = _ema(g, _get(state.mu, names), b1)
        nu = _ema(torch._foreach_mul(g, g), _get(state.nu, names), b2)
        count = state.count + 1
        if self.nesterov:
            m_hat = torch._foreach_mul(
                torch._foreach_div(mu, _bc(b1, count + 1)), b1)
            torch._foreach_add_(m_hat, torch._foreach_mul(
                torch._foreach_div(g, _bc(b1, count)), 1.0 - b1))
        else:
            m_hat = torch._foreach_div(mu, _bc(b1, count))
        denom = torch._foreach_sqrt(torch._foreach_div(nu, _bc(b2, count)))
        torch._foreach_add_(denom, self.eps)
        return torch._foreach_div(m_hat, denom), AdamState(
            dict(zip(names, mu)), dict(zip(names, nu)), count)


class ScaleByAdamax:
    """optax.scale_by_adamax: nu ← max(|g| + eps, b2·nu), update =
    m̂ / nu."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Tree) -> AdamState:
        return AdamState(_zeros(params), _zeros(params), 0)

    def update(self, names, g, state: AdamState, p):
        count = state.count + 1
        mu = _ema(g, _get(state.mu, names), self.b1)
        nu = [torch.maximum(t.abs() + self.eps, self.b2 * n)
              for t, n in zip(g, _get(state.nu, names))]
        upd = torch._foreach_div(torch._foreach_div(mu, _bc(self.b1, count)),
                                 nu)
        return upd, AdamState(dict(zip(names, mu)), dict(zip(names, nu)),
                              count)


class Trace:
    """optax.trace (SGD momentum): ``t ← g + decay·t``, update = t."""

    def __init__(self, decay: float):
        self.decay = float(decay)

    def init(self, params: Tree) -> TraceState:
        return TraceState(_zeros(params))

    def update(self, names, g, state: TraceState, p):
        new = torch._foreach_add(g, torch._foreach_mul(
            _get(state.trace, names), self.decay))
        return new, TraceState(dict(zip(names, new)))


class ScaleByRms:
    """optax.scale_by_rms (RMSprop): nu ← EMA(g², decay), update =
    g·rsqrt(nu + eps)."""

    def __init__(self, decay: float = 0.9, eps: float = 1e-8):
        self.decay, self.eps = decay, eps

    def init(self, params: Tree) -> RmsState:
        return RmsState(_zeros(params))

    def update(self, names, g, state: RmsState, p):
        nu = _ema(torch._foreach_mul(g, g), _get(state.nu, names), self.decay)
        upd = [torch.rsqrt(n + self.eps) * t for n, t in zip(nu, g)]
        return upd, RmsState(dict(zip(names, nu)))


class ScaleByRss:
    """optax.scale_by_rss (Adagrad): s ← g² + s from 0.1, update =
    g·rsqrt(s + eps) where s > 0, else 0."""

    def __init__(self, initial: float = 0.1, eps: float = 1e-7):
        self.initial, self.eps = initial, eps

    def init(self, params: Tree) -> RssState:
        return RssState({k: torch.full_like(p, self.initial)
                         for k, p in params.items()})

    def update(self, names, g, state: RssState, p):
        sos = torch._foreach_add(torch._foreach_mul(g, g),
                                 _get(state.sum_of_squares, names))
        upd = [torch.where(s > 0, torch.rsqrt(s + self.eps),
                           torch.zeros_like(s)) * t for s, t in zip(sos, g)]
        return upd, RssState(dict(zip(names, sos)))


class ScaleByAdadelta:
    """optax.scale_by_adadelta: e_g ← EMA(g², rho), update =
    sqrt(e_x + eps) / sqrt(e_g + eps) · g, e_x ← EMA(update², rho)."""

    def __init__(self, rho: float = 0.9, eps: float = 1e-6):
        self.rho, self.eps = rho, eps

    def init(self, params: Tree) -> AdadeltaState:
        return AdadeltaState(_zeros(params), _zeros(params))

    def update(self, names, g, state: AdadeltaState, p):
        e_g = _ema(torch._foreach_mul(g, g), _get(state.e_g, names), self.rho)
        upd = [torch.sqrt(x + self.eps) / torch.sqrt(e + self.eps) * t
               for t, e, x in zip(g, e_g, _get(state.e_x, names))]
        e_x = _ema(torch._foreach_mul(upd, upd), _get(state.e_x, names),
                   self.rho)
        return upd, AdadeltaState(dict(zip(names, e_g)), dict(zip(names, e_x)))


class ScaleByLion:
    """optax.scale_by_lion: update = sign((1 − b1)·g + b1·mu), then
    mu ← EMA(g, b2)."""

    def __init__(self, b1: float = 0.9, b2: float = 0.99):
        self.b1, self.b2 = b1, b2

    def init(self, params: Tree) -> LionState:
        return LionState(_zeros(params), 0)

    def update(self, names, g, state: LionState, p):
        prev = _get(state.mu, names)
        upd = [torch.sign(t) for t in _ema(g, prev, self.b1)]
        mu = _ema(g, prev, self.b2)
        return upd, LionState(dict(zip(names, mu)), state.count + 1)


def _algo(name: str, momentum: float = 0.0) -> list:
    key = name.lower()
    if key in ("adam", "adamw"):          # AdamW's decay is added after
        return [ScaleByAdam()]
    if key == "nadam":
        return [ScaleByAdam(nesterov=True)]
    if key == "sgd":
        # Keras SGD defaults to momentum=0; the YAML `momentum:` key opts in
        return [Trace(momentum) if momentum else Identity()]
    if key == "rmsprop":
        return [ScaleByRms()]
    if key == "adagrad":
        return [ScaleByRss()]
    if key == "adadelta":
        return [ScaleByAdadelta()]
    if key == "adamax":
        return [ScaleByAdamax()]
    if key == "lion":
        return [ScaleByLion()]
    if key == "lamb":
        return [ScaleByAdam(), TrustRatio()]
    raise KeyError(f"unknown optimizer {name!r}")


def is_encoder(name: str, ndim: int) -> bool:
    """Whether state-dict entry ``name`` lies in the flax ``encoder``
    subtree, the one ``freeze_encoder`` routes to ``set_to_zero``."""
    return flax_path(name, ndim).split("/")[1] == "encoder"


class Optimizer:
    """A chain of unit-lr transforms over name → tensor dicts.

    ``init(params)`` and ``update(grads, state, params)`` see only the
    names :meth:`trainable` keeps; the train step leaves every other
    parameter as it is.  ``update`` returns (updates, new state) and does
    not change its arguments."""

    def __init__(self, parts: list, freeze_encoder: bool = False):
        self.parts = parts
        self.freeze_encoder = freeze_encoder

    def trainable(self, params: Mapping[str, Tensor]) -> List[str]:
        return [k for k, p in params.items()
                if not (self.freeze_encoder and is_encoder(k, p.dim()))]

    def init(self, params: Mapping[str, Tensor]) -> Tuple:
        sub = {k: params[k] for k in self.trainable(params)}
        return tuple(part.init(sub) for part in self.parts)

    def update(self, grads: Mapping[str, Tensor], state: Tuple,
               params: Mapping[str, Tensor]) -> Tuple[Tree, Tuple]:
        names = list(grads)
        g = list(grads.values())
        p = _get(params, names)
        new_state = []
        for part, s in zip(self.parts, state):
            g, s = part.update(names, g, s, p)
            new_state.append(s)
        return dict(zip(names, g)), tuple(new_state)


def build_optimizer(cfg, freeze_encoder: bool = False) -> Optimizer:
    """Unit-lr transform per config (+ clipping, weight decay, freezing)."""
    if cfg.optimizer.lower() not in KNOWN:
        raise KeyError(f"unknown optimizer {cfg.optimizer!r}")
    parts: list = []
    if cfg.clipnorm:
        parts.append(ClipByGlobalNorm(cfg.clipnorm))
    if cfg.clipvalue:
        parts.append(Clip(cfg.clipvalue))
    parts += _algo(cfg.optimizer, momentum=getattr(cfg, "momentum", 0.0))
    # explicit `weight_decay: 0.0` disables decay even for AdamW; only an
    # UNSET value falls back to AdamW's conventional 1e-4
    if cfg.weight_decay is None:
        wd = 1e-4 if cfg.optimizer.lower() == "adamw" else 0.0
    else:
        wd = float(cfg.weight_decay)
    if wd:
        parts.append(AddDecayedWeights(wd))
    return Optimizer(parts, freeze_encoder)
