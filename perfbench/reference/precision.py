"""The control's arithmetic: products in fp8, the precision below the
configuration's bfloat16 that would tempt a faster step.

``fp8_matmul(a, b)`` rounds both operands to float8 e4m3 (each tensor
scaled so that its largest magnitude maps to e4m3's 448) and multiplies
the rounded values in float32; its backward rounds the incoming gradient
to e5m2 (scaled to 57344) and the saved operands as in the forward, as
fp8 training recipes do.
"""
from __future__ import annotations

import torch


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    s = amax / top
    return (x / s).to(dtype).to(torch.float32) * s


def e4m3(x: torch.Tensor) -> torch.Tensor:
    return _round(x, torch.float8_e4m3fn, 448.0)


def e5m2(x: torch.Tensor) -> torch.Tensor:
    return _round(x, torch.float8_e5m2, 57344.0)


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = e4m3(a), e4m3(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = e5m2(g)
        return torch.matmul(qg, qb.transpose(-1, -2)), torch.matmul(qa.transpose(-1, -2), qg)


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8Matmul.apply(a, b)
