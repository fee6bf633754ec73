"""Plain PyTorch versions of the masking kernels.

Each function is the bit-exact specification its CUDA kernel is held
against (``torch.equal`` on the card), and what ``kernels.ops`` runs for a
tensor on the CPU. They mirror the JAX package's ``kernels/ref.py``.
Keys and counter bases are host data (arrays, lists or ints). ``offset``
(``starts`` for the batched hop) starts a pad at that word of its
keystream (``crypto.prf.keystream_pair_lanes``); 0 is the reference's pad.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.crypto.fixedpoint import FixedPointCodec, ring_add, ring_sub
from repro_torch.crypto.prf import keystream_pair_lanes


def _host(a, dtype) -> np.ndarray:
    """Host numpy copy of key-like data (tensor on any device, array, list)."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a).astype(dtype)


def mask_add_ref(x: torch.Tensor, key, counter_base, scale_bits: int = 16,
                 offset: int = 0) -> torch.Tensor:
    """out = encode(x) + PRF(key, base..)  (mod 2^32).

    The SAFE initiator step (add R, or the outgoing hop pad, to the local
    vector) and, with the hop key, the encrypt half of every chain hop.
    """
    codec = FixedPointCodec(scale_bits)
    pad = keystream_pair_lanes(key, x.shape[0], counter_base, device=x.device,
                               offset=offset)
    return ring_add(codec.encode(x), pad)


def chain_combine_ref(cipher: torch.Tensor, x: torch.Tensor, key_in, key_out,
                      counter_base, scale_bits: int = 16,
                      offset: int = 0) -> torch.Tensor:
    """out = cipher − PRF(key_in) + encode(x) + PRF(key_out)  (mod 2^32):
    the whole SAFE non-initiator hop (decrypt, add, re-encrypt)."""
    codec = FixedPointCodec(scale_bits)
    n = cipher.shape[0]
    pad_in = keystream_pair_lanes(key_in, n, counter_base, device=cipher.device,
                                  offset=offset)
    pad_out = keystream_pair_lanes(key_out, n, counter_base, device=cipher.device,
                                   offset=offset)
    return ring_add(ring_add(ring_sub(cipher, pad_in), codec.encode(x)), pad_out)


def chain_combine_batched_ref(cipher: torch.Tensor, x: torch.Tensor, keys_in,
                              keys_out, counter_bases, scale_bits: int = 16,
                              starts=None) -> torch.Tensor:
    """Session-batched chain hop: row s is ``chain_combine_ref`` under
    session s's keys and counter base, its pads starting at word
    ``starts[s]`` (default 0)."""
    S = cipher.shape[0]
    keys_in = _host(keys_in, np.uint32).reshape(-1, 2)
    keys_out = _host(keys_out, np.uint32).reshape(-1, 2)
    bases = _host(counter_bases, np.uint64).reshape(-1)
    starts = np.zeros(S, np.int64) if starts is None else _host(starts, np.int64).reshape(-1)
    rows = [chain_combine_ref(cipher[s], x[s], keys_in[s], keys_out[s],
                              int(bases[s]), scale_bits, int(starts[s]))
            for s in range(S)]
    if not rows:
        return torch.empty(cipher.shape, dtype=torch.uint32, device=cipher.device)
    return torch.stack(rows)


def bon_mask_ref(x: torch.Tensor, keys, signs, counter_base,
                 scale_bits: int = 16) -> torch.Tensor:
    """out = encode(x) + Σ_j signs[j]·PRF(keys[j])  (mod 2^32).

    The BON masking step: one self-mask plus n−1 pairwise pads per
    learner — the quadratic-work baseline. keys: uint32[m, 2]; signs:
    int[m], a pad added where its sign is > 0 and subtracted otherwise.
    """
    codec = FixedPointCodec(scale_bits)
    n = x.shape[0]
    keys = _host(keys, np.uint32).reshape(-1, 2)
    signs = _host(signs, np.int64).reshape(-1)
    if signs.shape[0] != keys.shape[0]:
        raise ValueError(f"{keys.shape[0]} keys but {signs.shape[0]} signs")
    acc = codec.encode(x)
    for key, sign in zip(keys, signs):
        pad = keystream_pair_lanes(key, n, counter_base, device=x.device)
        acc = ring_add(acc, pad) if sign > 0 else ring_sub(acc, pad)
    return acc
