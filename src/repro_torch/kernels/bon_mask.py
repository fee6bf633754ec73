"""Fused BON pairwise masking: the CUDA kernel's wrapper.

``out = encode(x) + Σ_j sign_j · PRF(keys[j], base)  (mod 2^32)`` over m
keys, one read of ``x`` and one write of ``out``; no pad touches device
memory. The kernel is ``csrc/bon_mask.cu``; it replaces the JAX package's
Pallas kernel ``kernels/bon_mask.py::bon_mask``. Its plain version is
``kernels/ref.py::bon_mask_ref``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build


def key_table(keys, signs) -> np.ndarray:
    """The kernel's [m, 3] uint32 table: row j is (k0, k1, 1 if
    signs[j] > 0 else 0), the Pallas kernel's scalar layout."""
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    signs = np.asarray(signs).reshape(-1)
    if signs.shape[0] != keys.shape[0]:
        raise ValueError(f"{keys.shape[0]} keys but {signs.shape[0]} signs")
    return np.concatenate([keys, (signs > 0).astype(np.uint32).reshape(-1, 1)],
                          axis=1)


def bon_mask(x: torch.Tensor, keys, signs, counter_base=0, *,
             scale_bits: int = 16) -> torch.Tensor:
    """Launch the bon_mask kernel. x: f32[V] on the card; keys: host
    uint32[m, 2]; signs: host int[m] (+1 adds a pad, anything else
    subtracts it). Any m: the key table is uploaded to the card per call.
    Returns uint32[V] on x's device."""
    if x.dim() != 1:
        raise ValueError(f"x: expected a vector, got shape {tuple(x.shape)}")
    build.require_cuda(x, "x", torch.float32)
    table = key_table(keys, signs)
    out = torch.empty(x.shape, dtype=torch.uint32, device=x.device)
    if x.numel() == 0:
        return out
    table_d = build.upload(table, x.device)
    lib = build.library("bon_mask")
    err = lib.safe_bon_mask(x.data_ptr(), out.data_ptr(), x.numel(),
                            table_d.data_ptr(), table.shape[0],
                            int(counter_base) & 0xFFFFFFFF, float(2**scale_bits),
                            x.device.index, build.stream_of(x))
    build.check(lib, err, "bon_mask")
    build.launches["bon_mask"] += 1
    return out
