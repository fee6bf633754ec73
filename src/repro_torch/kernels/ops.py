"""The masking kernels as ``torch.library`` custom ops.

Each kernel is one op in the ``repro_torch`` namespace (``torch.ops.
repro_torch.mask_add`` and so on), routed by the dispatcher on its
tensors' device: a CUDA tensor launches the hand-written kernel (``csrc/``)
or raises, a CPU tensor takes the kernel's plain version
(``kernels/ref.py``), and a fake or meta tensor takes the op's shape
function (``register_fake``), which returns an empty tensor of the
output's shape and dtype, builds nothing and launches nothing. There is no
fallback from one route to another. The shape function is what lets the
dry run (``launch/dryrun.py``) pass through the SAFE step on meta tensors,
as ``pallas_call``'s ``out_shape`` lets ``jax.eval_shape`` pass through
the JAX package's kernels; each of its calls adds to ``fake_calls[name]``
the call and the bytes the kernel would move (each input word read once,
each output word written once: PERF.md's bound).

Keys, counter bases and start words are host data; the ops take them as
Python ints (the batched hop's and BON's tables as flat int lists).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.compat import Library, register_fake
from repro_torch.crypto.prf import key_pair
from repro_torch.kernels import bon_mask as _bon
from repro_torch.kernels import chain_combine as _cc
from repro_torch.kernels import ref
from repro_torch.kernels import threefry_mask_add as _tma

_MASK = 0xFFFFFFFF

#: calls of each op's shape function and the bytes its kernel would move;
#: see ``reset_fake_calls``.
fake_calls = {name: {"calls": 0, "bytes": 0}
              for name in ("mask_add", "chain_combine", "chain_combine_batched", "bon_mask")}


def reset_fake_calls() -> None:
    for c in fake_calls.values():
        c["calls"] = c["bytes"] = 0


def _fake(name: str, out_like: torch.Tensor, words: int, bytes_per_word: int) -> torch.Tensor:
    fake_calls[name]["calls"] += 1
    fake_calls[name]["bytes"] += words * bytes_per_word
    return torch.empty(out_like.shape, dtype=torch.uint32, device=out_like.device)


#: the ops' library: each op is defined by its schema and implemented per
#: dispatch key (``Library.impl``), which dispatches in about a third of the
#: host time of ``torch.library.custom_op``'s wrapper (PERF.md §6)
_LIB = Library("repro_torch", "DEF")


def _define(schema: str, cpu, cuda, fake) -> None:
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    register_fake(f"repro_torch::{name}", fake, lib=_LIB)


# mask_add: read f32 x, write u32 out (8 bytes a word)
_define("mask_add(Tensor x, int k0, int k1, int counter_base, int offset, int scale_bits)"
        " -> Tensor",
        lambda x, k0, k1, base, offset, sb: ref.mask_add_ref(x, [k0, k1], base, sb, offset),
        lambda x, k0, k1, base, offset, sb: _tma.mask_add(x, (k0, k1), base, offset=offset,
                                                          scale_bits=sb),
        lambda x, k0, k1, base, offset, sb: _fake("mask_add", x, x.numel(), 8))

# chain_combine: read u32 cipher and f32 x, write u32 out (12 bytes a word)
_define("chain_combine(Tensor cipher, Tensor x, int[] key_in, int[] key_out, "
        "int counter_base, int scale_bits) -> Tensor",
        lambda c, x, kin, kout, base, sb: ref.chain_combine_ref(c, x, kin, kout, base, sb),
        lambda c, x, kin, kout, base, sb: _cc.chain_combine(c, x, kin, kout, base,
                                                            scale_bits=sb),
        lambda c, x, kin, kout, base, sb: _fake("chain_combine", c, c.numel(), 12))

# chain_combine_batched: S hops, per-row keys, bases and start words (12 bytes a word)
_define("chain_combine_batched(Tensor cipher, Tensor x, int[] keys_in, int[] keys_out, "
        "int[] counter_bases, int[] starts, int scale_bits) -> Tensor",
        lambda c, x, kin, kout, bases, starts, sb: ref.chain_combine_batched_ref(
            c, x, kin, kout, bases, sb, starts),
        lambda c, x, kin, kout, bases, starts, sb: _cc.chain_combine_batched(
            c, x, kin, kout, bases, starts=starts, scale_bits=sb),
        lambda c, x, kin, kout, bases, starts, sb: _fake("chain_combine_batched", c,
                                                         c.numel(), 12))

# bon_mask: m pads on one read of x and one write of out (8 bytes a word)
_define("bon_mask(Tensor x, int[] keys, int[] signs, int counter_base, int scale_bits)"
        " -> Tensor",
        lambda x, keys, signs, base, sb: ref.bon_mask_ref(
            x, np.asarray(keys, np.uint32).reshape(-1, 2), signs, base, sb),
        lambda x, keys, signs, base, sb: _bon.bon_mask(
            x, np.asarray(keys, np.uint32).reshape(-1, 2), signs, base, scale_bits=sb),
        lambda x, keys, signs, base, sb: _fake("bon_mask", x, x.numel(), 8))


# ---- the entry points -------------------------------------------------------------

def _ints(a) -> list:
    """Host data (tensor, array, list) as a flat list of Python ints."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return [int(v) for v in np.asarray(a).astype(np.int64).reshape(-1)]


def mask_add(x, key, counter_base=0, *, offset: int = 0, scale_bits: int = 16):
    """Fused encode + pad: the SAFE initiator step / encrypt half of a hop.
    ``offset`` starts the pad at that word of its keystream."""
    k0, k1 = key_pair(key)
    return torch.ops.repro_torch.mask_add(x, k0, k1, int(counter_base) & _MASK, int(offset),
                                          scale_bits)


def chain_combine(cipher, x, key_in, key_out, counter_base=0, *, scale_bits: int = 16):
    """Fused SAFE non-initiator hop (decrypt + add + re-encrypt)."""
    return torch.ops.repro_torch.chain_combine(cipher, x, list(key_pair(key_in)),
                                               list(key_pair(key_out)),
                                               int(counter_base) & _MASK, scale_bits)


def chain_combine_batched(cipher, x, keys_in, keys_out, counter_bases, *,
                          starts=None, scale_bits: int = 16):
    """S hops in one launch, per-row keys, counter bases and (optionally)
    start words of the pads."""
    bases = [b & _MASK for b in _ints(counter_bases)]
    starts = [0] * len(bases) if starts is None else _ints(starts)
    return torch.ops.repro_torch.chain_combine_batched(
        cipher, x, _ints(keys_in), _ints(keys_out), bases, starts, scale_bits)


def bon_mask(x, keys, signs, counter_base=0, *, scale_bits: int = 16):
    """Fused BON masking: encode(x) plus or minus m pads, one per key."""
    return torch.ops.repro_torch.bon_mask(x, _ints(keys), _ints(signs),
                                          int(counter_base) & _MASK, scale_bits)


__all__ = ["mask_add", "chain_combine", "chain_combine_batched", "bon_mask", "fake_calls",
           "reset_fake_calls"]
