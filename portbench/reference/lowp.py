"""The control's precision: float8, the step below bfloat16.

``fp8`` rounds a tensor to float8 e4m3 under a per-tensor scale (its
largest magnitude mapped to e4m3's largest finite value, 448) and back to
float32; in the backward pass the incoming gradient is rounded the same
way to e5m2 (largest finite 57344), the usual split of an fp8 training
recipe.  Put on every convolution's input and weight, it gives the
reference the operands an fp8 program would multiply.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def round_to(t: Tensor, dtype: torch.dtype) -> Tensor:
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / _MAX[dtype], torch.ones_like(amax))
    return ((t / scale).to(dtype).to(t.dtype) * scale).to(t.dtype)


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return round_to(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, torch.float8_e5m2)


def fp8(t: Tensor) -> Tensor:
    return _FP8.apply(t)
