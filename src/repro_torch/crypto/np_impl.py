"""Vectorized numpy implementations of the crypto substrate.

The host control-plane simulation (``core/protocol.py``) does *real*
masking arithmetic on numpy arrays — these mirror ``crypto/prf.py`` /
``crypto/fixedpoint.py`` bit-for-bit (property-tested in
``tests/test_crypto.py``) but avoid JAX dispatch overhead for the
many small host-side operations the protocol sim performs.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl32(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32_np(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32, 20 rounds — numpy mirror of crypto.prf.threefry2x32."""
    old = np.seterr(over="ignore")
    try:
        key = np.asarray(key, np.uint32)
        x0 = np.asarray(x0, np.uint32).copy()
        x1 = np.asarray(x1, np.uint32).copy()
        ks0, ks1 = key[0], key[1]
        ks2 = ks0 ^ ks1 ^ _PARITY
        x0 = x0 + ks0
        x1 = x1 + ks1
        ks = (ks0, ks1, ks2)
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl32(x1, r)
                x1 = x1 ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
        return x0, x1
    finally:
        np.seterr(**old)


def keystream_np(key: np.ndarray, n: int, counter_base: int = 0) -> np.ndarray:
    """uint32[n] keystream, single-lane schedule (mirror of prf.keystream)."""
    old = np.seterr(over="ignore")
    try:
        idx = np.arange(n, dtype=np.uint32) + np.uint32(counter_base)
        y0, _ = threefry2x32_np(key, idx, np.zeros_like(idx))
        return y0
    finally:
        np.seterr(**old)


def keystream_pair_lanes_np(key: np.ndarray, n: int, counter_base: int = 0) -> np.ndarray:
    """uint32[n] keystream, two-lane schedule (mirror of
    prf.keystream_pair_lanes and of the Pallas kernel)."""
    old = np.seterr(over="ignore")
    try:
        nblk = (n + 1) // 2
        idx = np.arange(nblk, dtype=np.uint32) + np.uint32(counter_base)
        y0, y1 = threefry2x32_np(key, idx, np.zeros_like(idx))
        out = np.stack([y0, y1], axis=-1).reshape(-1)
        return out[:n]
    finally:
        np.seterr(**old)


def keystream_slice_np(key: np.ndarray, n: int, start: int,
                       counter_base: int = 0) -> np.ndarray:
    """Words ``[start, start + n)`` of the two-lane keystream based at
    ``counter_base`` — the seekable slab the streaming chunk-combine path
    runs on.

    Bit-identical to ``keystream_pair_lanes_np(key, total, counter_base)
    [start:start + n]`` for any ``total >= start + n``, computed without
    generating the prefix. ``counter_base`` is in two-word *blocks* (the
    Threefry counter schedule), so word ``start`` of the stream lives at
    global word ``2 * counter_base + start``; an odd ``start`` lands
    mid-block and costs one extra generated word. Property-tested in
    ``tests/test_crypto.py`` (arbitrary split points, chunk edges, empty
    slices).
    """
    if n < 0:
        raise ValueError(f"slice length must be >= 0, got {n}")
    if start < 0:
        raise ValueError(f"slice start must be >= 0, got {start}")
    if n == 0:
        return np.empty(0, np.uint32)
    word0 = 2 * int(counter_base) + int(start)
    block0, off = divmod(word0, 2)
    return keystream_pair_lanes_np(key, n + off, block0 % (1 << 32))[off:]


def derive_key_np(master: np.ndarray, *tags: int) -> np.ndarray:
    k = np.asarray(master, np.uint32)
    for tag in tags:
        y0, y1 = threefry2x32_np(k, np.uint32(tag), np.uint32(0x9E3779B9))
        k = np.stack([y0, y1])
    return k


def derive_pair_key_np(seed: np.ndarray, i: int, j: int) -> np.ndarray:
    y0, y1 = threefry2x32_np(np.asarray(seed, np.uint32), np.uint32(i), np.uint32(j))
    return np.stack([y0, y1])


class NpFixedPoint:
    """numpy mirror of crypto.fixedpoint.FixedPointCodec."""

    def __init__(self, scale_bits: int = 16):
        self.scale_bits = scale_bits
        self.scale = float(2**scale_bits)

    def encode(self, x: np.ndarray) -> np.ndarray:
        scaled = np.round(np.asarray(x, np.float32) * self.scale)
        return scaled.astype(np.int64).astype(np.int32).view(np.uint32)

    def decode(self, u: np.ndarray) -> np.ndarray:
        return u.view(np.int32).astype(np.float32) / self.scale

    @staticmethod
    def add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        old = np.seterr(over="ignore")
        try:
            return a + b
        finally:
            np.seterr(**old)

    @staticmethod
    def sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        old = np.seterr(over="ignore")
        try:
            return a - b
        finally:
            np.seterr(**old)
