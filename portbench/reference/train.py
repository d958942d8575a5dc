"""Plain float32 reference of one training step and of flip-TTA serving.

A step: the augmentation block (``aug.py``) → ``tf`` preprocessing (x/127.5
− 1) → the model in training mode (``models.py``) → the loss
``binary_crossentropy + 0.25*dice_loss`` per example (BCE with logits
averaged over pixels; dice = (2·Σp·t + 1)/(Σp + Σt + 1), loss 1 − dice),
its mean over the batch → gradients of every parameter → Adam (optax's
``scale_by_adam``: b1 0.9, b2 0.999, eps 1e-8, bias corrections) times
−lr → the new running statistics.  Serving: each fold's eval forward on
the image and on its horizontal flip (un-flipped after the sigmoid), the
two views' mean, then the folds' mean.

Everything runs in float32 with TF32 off (``exact``) unless a quantiser is
given, which rounds every convolution's operands (``lowp.py``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

import torch

from . import aug as A
from .models import Segmenter

Tensor = torch.Tensor


@contextlib.contextmanager
def exact():
    """float32 products and convolutions without TF32, restored after."""
    mm, conv = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = conv
        torch.set_float32_matmul_precision(prec)


def loss_per_example(masks: Tensor, logits: Tensor) -> Tensor:
    y, x = masks.float(), logits.float()
    bce = (torch.clamp(x, min=0.0) - x * y
           + torch.log1p(torch.exp(-x.abs()))).mean(dim=(1, 2, 3))
    p = torch.sigmoid(x)
    inter = (p * y).sum(dim=(1, 2))
    dice = (2.0 * inter + 1.0) / (p.sum(dim=(1, 2)) + y.sum(dim=(1, 2)) + 1.0)
    return bce + 0.25 * (1.0 - dice.mean(-1))


class Adam:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu: Dict[str, Tensor] = {}
        self.nu: Dict[str, Tensor] = {}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict[str, Tensor], grads: Dict[str, Tensor]):
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for k, g in grads.items():
            mu = self.mu.get(k, torch.zeros_like(g))
            nu = self.nu.get(k, torch.zeros_like(g))
            mu = self.b1 * mu + (1.0 - self.b1) * g
            nu = self.b2 * nu + (1.0 - self.b2) * g * g
            self.mu[k], self.nu[k] = mu, nu
            params[k] -= self.lr * (mu / c1) / (torch.sqrt(nu / c2)
                                                 + self.eps)


class TrainReference:
    """The reference model fed the benchmark's weights, and its steps."""

    def __init__(self, arch: str, weights: Dict[str, Tensor], lr: float,
                 block_args: dict, quant: Optional[Callable] = None):
        dev = next(iter(weights.values())).device
        self.model = Segmenter(arch).to(dev)
        self.model.load_state_dict(weights)
        self.model.remat = True
        self.quant = quant
        self.opt = Adam(lr)
        self.block_args = block_args
        self.params = dict(self.model.named_parameters())
        self.first_grads: Dict[str, Tensor] = {}
        self.losses: List[float] = []

    def step(self, images: Tensor, masks: Tensor, draws,
             keep_mask: Optional[Tensor] = None) -> None:
        h, w = images.shape[1], images.shape[2]
        st = A.BlockStatics(self.block_args, h, w)
        with torch.no_grad():
            imgs, msks = A.apply_block(draws, images, masks, st)
            x = imgs / 127.5 - 1.0
        if hasattr(self.model.decoder, "keep_mask"):
            self.model.decoder.keep_mask = keep_mask
        logits = self.model(x, train=True, quant=self.quant)
        loss = loss_per_example(msks, logits).mean()
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[k] for k in names])
        grads = dict(zip(names, grads))
        if not self.first_grads:
            self.first_grads = {k: g.detach().clone() for k, g in
                                grads.items()}
        self.losses.append(float(loss.detach()))
        self.opt.step({k: p.data for k, p in self.params.items()}, grads)
        with torch.no_grad():
            for k, v in self.model.new_stats.items():
                self.model.get_buffer(k).copy_(v)

    def state(self) -> Dict[str, Tensor]:
        return {k: v.detach() for k, v in self.model.state_dict().items()}


@torch.no_grad()
def serve_probs(arch: str, fold_weights: List[Dict[str, Tensor]],
                images: Tensor, quant: Optional[Callable] = None,
                chunk: int = 32) -> Tensor:
    """(B, H, W, 3) uint8 on the card → flip-TTA fold-ensembled sigmoid
    probabilities (B, H, W, 1) float32, ``chunk`` images at a time."""
    model = Segmenter(arch).to(images.device).eval()
    out = torch.zeros((*images.shape[:3], 1), device=images.device)
    for weights in fold_weights:
        model.load_state_dict(weights)
        for i in range(0, images.shape[0], chunk):
            x = images[i:i + chunk].float() / 127.5 - 1.0
            p = torch.sigmoid(model(x, quant=quant))
            p = p + torch.sigmoid(model(x.flip(2), quant=quant)).flip(2)
            out[i:i + chunk] += p / 2.0
    return out / len(fold_weights)


@torch.no_grad()
def batch_statistics(arch: str, weights: Dict[str, Tensor],
                     images: Tensor) -> Dict[str, Tensor]:
    """The running statistics a model's BatchNorms would hold after one
    training-mode forward over ``images`` with momentum 0: each layer's
    batch mean and biased variance, by name."""
    model = Segmenter(arch).to(images.device)
    model.load_state_dict(weights)
    for m in model.modules():
        if hasattr(m, "momentum"):
            m.momentum = 0.0
    model(images.float() / 127.5 - 1.0, train=True)
    return dict(model.new_stats)
