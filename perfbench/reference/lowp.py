"""The control: the reference with every matrix product in float8, the next
precision below the bfloat16 that the configurations state.

Each operand is scaled by its own absolute maximum into e4m3's range,
rounded to e4m3 and scaled back (per-tensor scaling, as an fp8 training
recipe does); the gradient flowing into each product is rounded the same
way to e5m2.  Everything else stays float32.
"""

from __future__ import annotations

import torch

from .decoder import Precision

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = torch.clamp(torch.amax(torch.abs(x)), min=1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Result(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


FP8 = Precision(_Operand.apply, _Result.apply)
