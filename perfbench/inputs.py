"""Inputs made from ``--seed``: seeds, tensors on the device, samples.

The same seed gives the same inputs on every run. Tensors are drawn on
the device that runs the cell, by a ``torch.Generator`` there, in a few
large calls.
"""
from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np
import torch


def derive(seed: int, *tags: Any) -> int:
    """A 63-bit integer from the run's seed and the tags (strings or
    integers): the seed of one stream of inputs."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    for t in tags:
        if isinstance(t, str):
            words.extend(t.encode())
        else:
            words.extend([int(t) & 0xFFFFFFFF, (int(t) >> 32) & 0xFFFFFFFF])
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, *tags: Any, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(derive(seed, *tags))


def gaussian_pool(count: int, rows: int, words: int, std: float, seed: int,
                  device) -> List[torch.Tensor]:
    """``count`` distinct f32[rows, words] matrices of N(0, std^2) words."""
    g = generator(seed, "pool", device=device)
    out = []
    for _ in range(count):
        x = torch.randn((rows, words), generator=g, device=device, dtype=torch.float32)
        out.append(x.mul_(std))
    return out


def alive_bitmap(n: int, dead: Sequence[int]) -> np.ndarray:
    a = np.ones(n, np.float32)
    a[list(dead)] = 0.0
    return a


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length
    (Algorithm R), drawn from the seed: the same seed and stream keep the
    same items."""

    def __init__(self, k: int, seed: int, *tags: Any):
        self.k = int(k)
        self.rng = np.random.default_rng(derive(seed, "sample", *tags))
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        if self.seen < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1
