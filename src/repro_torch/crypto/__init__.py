"""Cryptographic substrate of the PyTorch port.

Plain-PyTorch counterparts of the JAX package's ``repro.crypto``: the
Threefry-2x32 counter-mode PRF and key schedule (``prf``), the fixed-point
codec (``fixedpoint``), and a verbatim copy of the numpy mirror
(``np_impl``) that derives host key material.
"""
from repro_torch.crypto.fixedpoint import DEFAULT_SCALE_BITS, FixedPointCodec
from repro_torch.crypto.prf import (
    RoundCounter,
    derive_key,
    derive_pair_key,
    keystream,
    keystream_pair_lanes,
    threefry2x32,
)

__all__ = [
    "threefry2x32",
    "keystream",
    "keystream_pair_lanes",
    "derive_pair_key",
    "derive_key",
    "RoundCounter",
    "FixedPointCodec",
    "DEFAULT_SCALE_BITS",
]
