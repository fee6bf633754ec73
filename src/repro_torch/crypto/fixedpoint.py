"""Fixed-point codec: f32 <-> uint32 ring elements, in PyTorch.

    encode(x) = round_half_even(x * 2**scale_bits)  as int32, bit-cast to uint32
    decode(u) = int32(u) / 2**scale_bits

Sums of up to ``n`` encoded values stay exact while
``|x_i| < 2**(31 - scale_bits) / n`` (``max_abs_value``). The cast to
int32 is exact only inside that bound: outside it PyTorch's cast is
undefined and the CUDA kernels' ``__float2int_rn`` saturates.

Ring addition and subtraction go through int32 views, whose two's-
complement wrap is addition mod 2^32. Divisions take a tensor divisor on
the operand's device: given a host scalar, PyTorch's CUDA ``div`` may
multiply by its reciprocal instead, which is not bit-identical to the
reference's division.
"""
from __future__ import annotations

import dataclasses

import torch

# 16 fractional bits: ~1.5e-5 resolution, |sum| < 32768.
DEFAULT_SCALE_BITS = 16


def ring_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """uint32 + uint32 mod 2^32."""
    return (a.view(torch.int32) + b.view(torch.int32)).view(torch.uint32)


def ring_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """uint32 - uint32 mod 2^32."""
    return (a.view(torch.int32) - b.view(torch.int32)).view(torch.uint32)


def device_scalar(d, like: torch.Tensor) -> torch.Tensor:
    """The number ``d`` as a 0-dim f32 tensor on ``like``'s device, made
    there (no host-to-device copy). As a divisor it keeps CUDA's ``div`` a
    true division (see the module docstring)."""
    return torch.full((), float(d), dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class FixedPointCodec:
    """f32 <-> uint32 fixed-point codec over Z/2^32Z."""

    scale_bits: int = DEFAULT_SCALE_BITS

    @property
    def scale(self) -> float:
        return float(2**self.scale_bits)

    def max_abs_value(self, n_addends: int = 1) -> float:
        """Largest |x| for which a sum of ``n_addends`` values cannot wrap."""
        return float(2 ** (31 - self.scale_bits)) / float(n_addends)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """f32 -> uint32 ring element (round half to even)."""
        scaled = torch.round(x.to(torch.float32) * self.scale)
        return scaled.to(torch.int32).view(torch.uint32)

    def decode(self, u: torch.Tensor) -> torch.Tensor:
        """uint32 ring element -> f32."""
        return u.view(torch.int32).to(torch.float32) / device_scalar(self.scale, u)

    def decode_mean(self, u: torch.Tensor, count) -> torch.Tensor:
        """Decode a ring sum and divide by the contributor count (a number,
        or an f32 tensor on ``u``'s device that broadcasts against it)."""
        if not isinstance(count, torch.Tensor):
            count = device_scalar(count, u)
        return self.decode(u) / count

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Ring addition (wrapping uint32 add)."""
        return ring_add(a, b)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Ring subtraction (wrapping uint32 sub)."""
        return ring_sub(a, b)
