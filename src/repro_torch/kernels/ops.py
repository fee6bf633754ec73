"""Dispatch for the masking kernels.

A CUDA tensor launches the hand-written kernel (``csrc/``) or raises; a
CPU tensor takes the kernel's plain version (``kernels/ref.py``). There is
no fallback from one to the other and no third route.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bon_mask as _bon
from repro_torch.kernels import chain_combine as _cc
from repro_torch.kernels import ref
from repro_torch.kernels import threefry_mask_add as _tma


def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}: use cuda or cpu")


def mask_add(x, key, counter_base=0, *, offset: int = 0, scale_bits: int = 16):
    """Fused encode + pad: the SAFE initiator step / encrypt half of a hop.
    ``offset`` starts the pad at that word of its keystream."""
    if _on_cuda(x):
        return _tma.mask_add(x, key, counter_base, offset=offset,
                             scale_bits=scale_bits)
    return ref.mask_add_ref(x, key, counter_base, scale_bits, offset)


def chain_combine(cipher, x, key_in, key_out, counter_base=0, *,
                  scale_bits: int = 16):
    """Fused SAFE non-initiator hop (decrypt + add + re-encrypt)."""
    if _on_cuda(cipher):
        return _cc.chain_combine(cipher, x, key_in, key_out, counter_base,
                                 scale_bits=scale_bits)
    return ref.chain_combine_ref(cipher, x, key_in, key_out, counter_base,
                                 scale_bits)


def chain_combine_batched(cipher, x, keys_in, keys_out, counter_bases, *,
                          starts=None, scale_bits: int = 16):
    """S hops in one launch, per-row keys, counter bases and (optionally)
    start words of the pads."""
    if _on_cuda(cipher):
        return _cc.chain_combine_batched(cipher, x, keys_in, keys_out,
                                         counter_bases, starts=starts,
                                         scale_bits=scale_bits)
    return ref.chain_combine_batched_ref(cipher, x, keys_in, keys_out,
                                         counter_bases, scale_bits, starts)


def bon_mask(x, keys, signs, counter_base=0, *, scale_bits: int = 16):
    """Fused BON masking: encode(x) plus or minus m pads, one per key."""
    if _on_cuda(x):
        return _bon.bon_mask(x, keys, signs, counter_base, scale_bits=scale_bits)
    return ref.bon_mask_ref(x, keys, signs, counter_base, scale_bits)


__all__ = ["mask_add", "chain_combine", "chain_combine_batched", "bon_mask"]
