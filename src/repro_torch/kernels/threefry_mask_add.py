"""Fused Threefry pad + fixed-point encode + add: the CUDA kernel's wrapper.

``out[i] = encode(x[i]) + PRF(key, base)[offset + i]  (mod 2^32)``, one
read of ``x`` and one write of ``out``; the pad never touches device
memory. ``offset`` starts the pad at that word of its stream (0 for the
reference's pad; the pipelined schedule's segments start later). The
kernel is ``csrc/mask_add.cu``; it replaces the JAX package's Pallas
kernel ``kernels/threefry_mask_add.py::mask_add``. Its plain version is
``kernels/ref.py::mask_add_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.crypto.prf import key_pair
from repro_torch.kernels import build


def mask_add(x: torch.Tensor, key, counter_base=0, *, offset: int = 0,
             scale_bits: int = 16) -> torch.Tensor:
    """Launch the mask_add kernel. x: f32[V] on the card; key: host
    uint32[2]; offset: the pad's first stream word (>= 0). Returns
    uint32[V] on x's device."""
    if x.dim() != 1:
        raise ValueError(f"x: expected a vector, got shape {tuple(x.shape)}")
    build.require_cuda(x, "x", torch.float32)
    if offset < 0:
        raise ValueError(f"offset must be >= 0, got {offset}")
    out = torch.empty(x.shape, dtype=torch.uint32, device=x.device)
    if x.numel() == 0:
        return out
    k0, k1 = key_pair(key)
    lib = build.library("mask_add")
    err = lib.safe_mask_add(x.data_ptr(), out.data_ptr(), x.numel(), k0, k1,
                            int(counter_base) & 0xFFFFFFFF, int(offset),
                            float(2**scale_bits), x.device.index, build.stream_of(x))
    build.check(lib, err, "mask_add")
    build.launches["mask_add"] += 1
    return out
