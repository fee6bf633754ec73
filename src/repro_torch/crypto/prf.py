"""Threefry-2x32 counter-mode PRF in plain PyTorch.

The same cipher, keystream schedules, key derivation and counter
allocator as the JAX package's ``crypto/prf.py``, word for word. These are
the plain versions the CUDA kernels in ``repro_torch.kernels`` are held
against, and the CPU path of the round.

PyTorch has no uint32 add, subtract or shift on the CPU, so the arithmetic
runs in int64 lanes masked to 32 bits (``& 0xFFFFFFFF`` after every add and
rotation). Inputs and outputs are ``torch.uint32``; counters wrap mod 2^32.
"""
from __future__ import annotations

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_MASK = 0xFFFFFFFF


def key_pair(key) -> tuple[int, int]:
    """(k0, k1) as Python ints from a uint32[2] key (tensor, array or list)."""
    if isinstance(key, torch.Tensor):
        key = key.cpu().numpy()
    k = np.asarray(key).astype(np.uint64).reshape(2)
    return int(k[0]) & _MASK, int(k[1]) & _MASK


def _as_lanes(x, device) -> torch.Tensor:
    """uint32 words (tensor, array or int) as int64 lanes in [0, 2^32)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64) & _MASK
    return torch.as_tensor(np.asarray(x).astype(np.int64) & _MASK, device=device)


def _rotl32(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def _threefry_lanes(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) on int64 lanes holding uint32 words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ((ks[(i + 2) % 3] + i + 1) & _MASK)) & _MASK
    return x0, x1


def threefry2x32(key, x0, x1):
    """Threefry-2x32, 20 rounds.

    Args:
      key: uint32[2] cipher key (host data: tensor, array or list).
      x0, x1: uint32 counter words (tensors, arrays or ints), broadcastable;
        the words are computed on ``x0``'s device (the CPU for an int).

    Returns:
      (y0, y1): torch.uint32 keystream words of the broadcast shape.
    """
    device = x0.device if isinstance(x0, torch.Tensor) else "cpu"
    k0, k1 = key_pair(key)
    a, b = torch.broadcast_tensors(_as_lanes(x0, device), _as_lanes(x1, device))
    y0, y1 = _threefry_lanes(k0, k1, a, b)
    return y0.to(torch.uint32), y1.to(torch.uint32)


def _counters(n: int, counter_base, device) -> torch.Tensor:
    base = int(counter_base) & _MASK
    return (torch.arange(n, dtype=torch.int64, device=device) + base) & _MASK


def keystream(key, n: int, counter_base=0, device="cuda") -> torch.Tensor:
    """uint32[n] keystream, one word per counter: word i is lane 0 of
    Threefry(key, (base + i, 0))."""
    k0, k1 = key_pair(key)
    ctr = _counters(n, counter_base, device)
    y0, _ = _threefry_lanes(k0, k1, ctr, torch.zeros_like(ctr))
    return y0.to(torch.uint32)


def keystream_pair_lanes(key, n: int, counter_base=0, device="cuda",
                         offset: int = 0) -> torch.Tensor:
    """uint32[n] keystream using both Threefry lanes: block ``b`` yields
    words ``(2b, 2b+1)`` — the schedule the CUDA kernels implement.

    ``offset`` starts the pad at word ``offset`` of that stream: word i is
    lane ``(offset + i) & 1`` of counter ``base + (offset + i) // 2``, so
    an odd offset begins on lane 1 of a block (``np_impl.
    keystream_slice_np`` on the host). Offset 0 is the stream itself."""
    k0, k1 = key_pair(key)
    lead = int(offset) & 1
    base = int(counter_base) + (int(offset) >> 1)
    ctr = _counters((n + lead + 1) // 2, base, device)
    y0, y1 = _threefry_lanes(k0, k1, ctr, torch.zeros_like(ctr))
    return torch.stack([y0, y1], dim=-1).reshape(-1)[lead:lead + n].to(torch.uint32)


def derive_key(master, *tags: int) -> torch.Tensor:
    """Derive a uint32[2] subkey from a uint32[2] master key and integer
    tags, folding each tag in with one Threefry application."""
    k = key_pair(master)
    for tag in tags:
        y0, y1 = _threefry_lanes(k[0], k[1], _as_lanes(tag, "cpu"),
                                 _as_lanes(0x9E3779B9, "cpu"))
        k = (int(y0), int(y1))
    return torch.tensor(k, dtype=torch.int64).to(torch.uint32)


def derive_pair_key(seed, i: int, j: int) -> torch.Tensor:
    """Pairwise key for the ring edge (i -> j): Threefry(seed, (i, j))."""
    y0, y1 = threefry2x32(seed, i, j)
    return torch.stack([y0, y1])


class RoundCounter:
    """Host-side monotone counter allocator.

    Guarantees keystream non-reuse across aggregation rounds: each round
    reserves its range of Threefry counters (``SecureAggregator.
    reserve_round`` asks for the counters a round of so many words draws,
    two words to a counter). Counters are uint32, so the usable space per
    key is exactly ``2**32`` of them. ``reserve`` refuses — *before*
    mutating any state — any reservation whose range would cross that
    boundary: a silent wrap would reuse one-time pads.
    After a refusal the allocator is still valid for smaller reservations;
    the remedy is a Round-0 key rotation.
    """

    #: usable counters per (key, purpose): the full uint32 range.
    LIMIT = 2**32

    def __init__(self) -> None:
        self._next = 0

    @property
    def remaining(self) -> int:
        """Counters still available before a key rotation is due."""
        return self.LIMIT - self._next

    def reserve(self, nwords: int) -> int:
        nwords = int(nwords)
        if nwords < 0:
            raise ValueError(f"nwords must be >= 0, got {nwords}")
        if nwords > self.remaining:
            raise OverflowError(
                f"counter space exhausted: {self._next} of 2**32 counters used, "
                f"{nwords} requested; rotate pair keys (Round 0) before reuse"
            )
        base = self._next
        self._next += nwords
        return base
