"""Fused SAFE chain hop (decrypt + add + re-encrypt): the CUDA kernels'
wrappers.

``out = cipher − PRF(k_in, base) + encode(x) + PRF(k_out, base)``: reads
``cipher`` and ``x`` once and writes ``out`` once; neither pad touches
device memory. ``chain_combine_batched`` runs S hops in one launch, row s
under its own keys, counter base and start word — the multi-session
engine's hop, and one step of the pipelined schedule. The kernels are
``csrc/chain_combine.cu``; they replace the JAX package's Pallas kernels
``kernels/chain_combine.py::chain_combine`` and ``::chain_combine_batched``.
Their plain versions are in ``kernels/ref.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.crypto.prf import key_pair
from repro_torch.kernels import build


def chain_combine(cipher: torch.Tensor, x: torch.Tensor, key_in, key_out,
                  counter_base=0, *, scale_bits: int = 16) -> torch.Tensor:
    """Launch one fused hop. cipher: uint32[V], x: f32[V] on the card;
    keys: host uint32[2]. Returns uint32[V]."""
    if cipher.dim() != 1:
        raise ValueError(f"cipher: expected a vector, got shape {tuple(cipher.shape)}")
    build.require_cuda(cipher, "cipher", torch.uint32)
    build.require_cuda(x, "x", torch.float32, cipher.shape)
    if x.device != cipher.device:
        raise ValueError(f"x on {x.device}, cipher on {cipher.device}")
    out = torch.empty_like(cipher)
    if cipher.numel() == 0:
        return out
    kin0, kin1 = key_pair(key_in)
    kout0, kout1 = key_pair(key_out)
    lib = build.library("chain_combine")
    err = lib.safe_chain_combine(
        cipher.data_ptr(), x.data_ptr(), out.data_ptr(), cipher.numel(),
        kin0, kin1, kout0, kout1, int(counter_base) & 0xFFFFFFFF,
        float(2**scale_bits), cipher.device.index, build.stream_of(cipher))
    build.check(lib, err, "chain_combine")
    build.launches["chain_combine"] += 1
    return out


#: sessions per launch of the batched kernel (``kMaxRows`` in the source).
MAX_ROWS = 128


def key_table(keys_in, keys_out, counter_bases, starts=None) -> np.ndarray:
    """The batched kernel's [S, 6] uint32 table: row s is (kin0, kin1,
    kout0, kout1, counter, lead) of row s, where the row's pads start at
    word ``starts[s]`` (default 0) of the stream based at
    ``counter_bases[s]``: counter = base + start // 2 (mod 2^32) is the
    row's first Threefry counter and lead = start & 1 says that its first
    word is lane 1 of that block."""
    kin = np.asarray(keys_in, np.uint32).reshape(-1, 2)
    kout = np.asarray(keys_out, np.uint32).reshape(-1, 2)
    bases = np.asarray(counter_bases).astype(np.uint64).reshape(-1)
    starts = (np.zeros(bases.shape, np.uint64) if starts is None
              else np.asarray(starts).astype(np.uint64).reshape(-1))
    if starts.shape != bases.shape:
        raise ValueError(f"{starts.shape[0]} start words for {bases.shape[0]} rows")
    ctr = (bases + (starts >> np.uint64(1))) & np.uint64(0xFFFFFFFF)
    lead = starts & np.uint64(1)
    return np.concatenate([kin, kout, ctr.astype(np.uint32).reshape(-1, 1),
                           lead.astype(np.uint32).reshape(-1, 1)], axis=1)


def chain_combine_batched(cipher: torch.Tensor, x: torch.Tensor, keys_in,
                          keys_out, counter_bases, *, starts=None,
                          scale_bits: int = 16) -> torch.Tensor:
    """Launch S fused hops, one per row. cipher: uint32[S, V], x: f32[S, V]
    on the card; keys_in/keys_out: host uint32[S, 2]; counter_bases: host
    uint32[S]; starts: optional host [S] start words of the rows' pads.
    Returns uint32[S, V]. The keys travel in the launch's parameters,
    ``MAX_ROWS`` rows a launch."""
    if cipher.dim() != 2:
        raise ValueError(f"cipher: expected [S, V], got shape {tuple(cipher.shape)}")
    build.require_cuda(cipher, "cipher", torch.uint32)
    build.require_cuda(x, "x", torch.float32, cipher.shape)
    if x.device != cipher.device:
        raise ValueError(f"x on {x.device}, cipher on {cipher.device}")
    S, V = cipher.shape
    table = key_table(keys_in, keys_out, counter_bases, starts)
    if table.shape[0] != S:
        raise ValueError(f"{table.shape[0]} key rows for {S} sessions")
    out = torch.empty_like(cipher)
    if out.numel() == 0:
        return out
    lib = build.library("chain_combine")
    for r0 in range(0, S, MAX_ROWS):
        rows = min(MAX_ROWS, S - r0)
        err = lib.safe_chain_combine_batched(
            cipher[r0].data_ptr(), x[r0].data_ptr(), out[r0].data_ptr(), rows, V,
            table[r0:].ctypes.data, float(2**scale_bits), cipher.device.index,
            build.stream_of(cipher))
        build.check(lib, err, "chain_combine_batched")
        build.launches["chain_combine_batched"] += 1
    return out
