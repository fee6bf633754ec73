"""The published value of a SAFE round, worked out without the protocol.

Every pad SAFE adds is taken off again, so a round publishes exactly the
fixed-point mean of the alive learners' vectors: each f32 word encoded as
round_half_even(x * 2^scale_bits) in int32, the alive learners' words
summed mod 2^32, the sum read back as int32, converted to f32, divided by
2^scale_bits and then by the number of alive learners. Each of those is
one correctly rounded f32 operation, so the mean is exact to the bit on
any device.
"""
from __future__ import annotations

from typing import Sequence

import torch


def fixed_point_mean(values: torch.Tensor, alive: Sequence[int], scale_bits: int = 16,
                     block_rows: int = 4, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """f32[V] mean of the rows ``alive`` (learner indices) of f32[n, V]
    ``values``, ``block_rows`` rows at a time. ``dtype`` is the precision
    the words are read in before they are encoded: float32 is the
    reference; a lower one is the control."""
    rows = [int(r) for r in alive]
    scale = float(2 ** scale_bits)
    acc = torch.zeros(values.shape[1], dtype=torch.int64, device=values.device)
    for i in range(0, len(rows), block_rows):
        x = values[rows[i:i + block_rows]].to(dtype).to(torch.float32)
        acc += torch.round(x * scale).to(torch.int64).sum(dim=0)
    # mod 2^32, read as a two's-complement int32
    total = ((acc + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)
    count = torch.full((), float(max(len(rows), 1)), dtype=torch.float32, device=values.device)
    return total.to(torch.float32) / torch.full((), scale, dtype=torch.float32,
                                                device=values.device) / count


def mismatched_words(published: torch.Tensor, expected: torch.Tensor) -> int:
    """Words whose bits differ (a NaN differs from everything but itself)."""
    if published.shape != expected.shape:
        return max(published.numel(), expected.numel())
    return int((published.contiguous().view(torch.int32)
                != expected.contiguous().view(torch.int32)).sum())
