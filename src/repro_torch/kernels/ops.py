"""Dispatch for the masking kernels.

A CUDA tensor launches the hand-written kernel (``csrc/``) or raises; a
CPU tensor takes the kernel's plain version (``kernels/ref.py``). There is
no fallback from one to the other and no third route.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import chain_combine as _cc
from repro_torch.kernels import ref
from repro_torch.kernels import threefry_mask_add as _tma


def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}: use cuda or cpu")


def mask_add(x, key, counter_base=0, *, scale_bits: int = 16):
    """Fused encode + pad: the SAFE initiator step / encrypt half of a hop."""
    if _on_cuda(x):
        return _tma.mask_add(x, key, counter_base, scale_bits=scale_bits)
    return ref.mask_add_ref(x, key, counter_base, scale_bits)


def chain_combine(cipher, x, key_in, key_out, counter_base=0, *,
                  scale_bits: int = 16):
    """Fused SAFE non-initiator hop (decrypt + add + re-encrypt)."""
    if _on_cuda(cipher):
        return _cc.chain_combine(cipher, x, key_in, key_out, counter_base,
                                 scale_bits=scale_bits)
    return ref.chain_combine_ref(cipher, x, key_in, key_out, counter_base,
                                 scale_bits)


def chain_combine_batched(cipher, x, keys_in, keys_out, counter_bases, *,
                          scale_bits: int = 16):
    """S sessions' hops in one launch, per-session keys and counter bases."""
    if _on_cuda(cipher):
        return _cc.chain_combine_batched(cipher, x, keys_in, keys_out,
                                         counter_bases, scale_bits=scale_bits)
    return ref.chain_combine_batched_ref(cipher, x, keys_in, keys_out,
                                         counter_bases, scale_bits)


__all__ = ["mask_add", "chain_combine", "chain_combine_batched"]
