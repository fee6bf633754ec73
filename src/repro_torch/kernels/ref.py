"""Plain PyTorch versions of the masking kernels.

Each function is the bit-exact specification its CUDA kernel is held
against (``torch.equal`` on the card), and what ``kernels.ops`` runs for a
tensor on the CPU. They mirror the JAX package's ``kernels/ref.py``.
Keys and counter bases are host data (arrays, lists or ints).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.crypto.fixedpoint import FixedPointCodec, ring_add, ring_sub
from repro_torch.crypto.prf import keystream_pair_lanes


def mask_add_ref(x: torch.Tensor, key, counter_base,
                 scale_bits: int = 16) -> torch.Tensor:
    """out = encode(x) + PRF(key, base..)  (mod 2^32).

    The SAFE initiator step (add R, or the outgoing hop pad, to the local
    vector) and, with the hop key, the encrypt half of every chain hop.
    """
    codec = FixedPointCodec(scale_bits)
    pad = keystream_pair_lanes(key, x.shape[0], counter_base, device=x.device)
    return ring_add(codec.encode(x), pad)


def chain_combine_ref(cipher: torch.Tensor, x: torch.Tensor, key_in, key_out,
                      counter_base, scale_bits: int = 16) -> torch.Tensor:
    """out = cipher − PRF(key_in) + encode(x) + PRF(key_out)  (mod 2^32):
    the whole SAFE non-initiator hop (decrypt, add, re-encrypt)."""
    codec = FixedPointCodec(scale_bits)
    n = cipher.shape[0]
    pad_in = keystream_pair_lanes(key_in, n, counter_base, device=cipher.device)
    pad_out = keystream_pair_lanes(key_out, n, counter_base, device=cipher.device)
    return ring_add(ring_add(ring_sub(cipher, pad_in), codec.encode(x)), pad_out)


def chain_combine_batched_ref(cipher: torch.Tensor, x: torch.Tensor, keys_in,
                              keys_out, counter_bases,
                              scale_bits: int = 16) -> torch.Tensor:
    """Session-batched chain hop: row s is ``chain_combine_ref`` under
    session s's keys and counter base."""
    keys_in = np.asarray(keys_in, np.uint32).reshape(-1, 2)
    keys_out = np.asarray(keys_out, np.uint32).reshape(-1, 2)
    bases = np.asarray(counter_bases).astype(np.uint64).reshape(-1)
    rows = [chain_combine_ref(cipher[s], x[s], keys_in[s], keys_out[s],
                              int(bases[s]), scale_bits)
            for s in range(cipher.shape[0])]
    if not rows:
        return torch.empty(cipher.shape, dtype=torch.uint32, device=cipher.device)
    return torch.stack(rows)
