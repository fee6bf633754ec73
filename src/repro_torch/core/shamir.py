"""Shamir t-of-n secret sharing over GF(p), p = 2^127 - 1.

Used by the BON baseline (Bonawitz et al. CCS'17): each learner shares
(a) the seed of its self-mask b_u and (b) its pairwise-mask secret key
s_u, so the server can reconstruct exactly one of the two per learner —
b_u for survivors, s_uv pads for dropouts — never both.

Pure-Python bignum arithmetic (secrets are 64-bit PRF seeds; n <= a few
hundred), deterministic given the rng.

The PyTorch port's copy of the JAX package's ``core/shamir.py``, with the same
semantics.
"""
from __future__ import annotations

import random
from typing import Iterable, Sequence

P = (1 << 127) - 1  # Mersenne prime


def _eval_poly(coeffs: Sequence[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def share(secret: int, t: int, n: int, rng: random.Random) -> list[tuple[int, int]]:
    """Split ``secret`` into n shares, any t of which reconstruct it."""
    if not 0 <= secret < P:
        raise ValueError("secret out of field range")
    if not 1 <= t <= n:
        raise ValueError("need 1 <= t <= n")
    coeffs = [secret] + [rng.randrange(P) for _ in range(t - 1)]
    return [(x, _eval_poly(coeffs, x)) for x in range(1, n + 1)]


def reconstruct(shares: Iterable[tuple[int, int]]) -> int:
    """Lagrange interpolation at 0."""
    pts = list(shares)
    xs = [x for x, _ in pts]
    if len(set(xs)) != len(xs):
        raise ValueError("duplicate share indices")
    acc = 0
    for i, (xi, yi) in enumerate(pts):
        num = den = 1
        for j, (xj, _) in enumerate(pts):
            if i == j:
                continue
            num = (num * (-xj)) % P
            den = (den * (xi - xj)) % P
        acc = (acc + yi * num * pow(den, P - 2, P)) % P
    return acc
