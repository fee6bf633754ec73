"""BON baseline — Practical Secure Aggregation (Bonawitz et al., CCS'17).

The port's counterpart of the JAX package's ``core/bon.py``, learner-major
on one device. Each live learner u masks its vector with

    y_u = x_u + b_u + Σ_{v>u} PRF(s_uv) − Σ_{v<u} PRF(s_uv)   (mod 2^32)

in one ``bon_mask`` launch over its n − 1 pairwise keys and its self-mask
key, where s_uv is the pairwise key of the unordered pair (derived from
the provisioning seed) and b_u a keystream of its private seed. Its share
of the unmasking round — b_u and the pads it shares with dead peers,
which survivors reveal in the real protocol — is one more launch with
x = 0. The server's sum of the y_u minus the sum of those corrections is
the sum of the live learners' encodings, exact in Z/2^32.

Every pairwise pad is computed, though the pads between live learners
cancel in the sum: those n − 1 keystreams over the whole vector per
learner (O(n²·V) in all) are the baseline's cost, against SAFE's two hop
pads per learner. A dead learner contributes nothing: its row is never
read, so a NaN there never reaches the sum. Like the reference, BON
ignores weights and subgroups. Keys are derived on the host with the
numpy mirror of the PRF.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.chain import host_alive, pod_rounds
from repro_torch.core.types import ChainConfig, RoundKeys
from repro_torch.crypto.fixedpoint import FixedPointCodec, ring_add, ring_sub
from repro_torch.crypto.np_impl import derive_key_np, threefry2x32_np
from repro_torch.dist import collectives
from repro_torch.kernels import ops

_TAG_PAIRWISE = 0x42  # 'B'
_TAG_SELFMASK = 0x62  # 'b'


def pair_keys(prov_seed, n: int) -> np.ndarray:
    """uint32[n, n, 2]: row [u, v] is s_uv = derive_pair_key(derive_key(
    prov, 'B'), min(u, v), max(u, v)), the key both ends derive."""
    seed = derive_key_np(prov_seed, _TAG_PAIRWISE)
    r = np.arange(n, dtype=np.uint32)
    y0, y1 = threefry2x32_np(seed, np.minimum.outer(r, r), np.maximum.outer(r, r))
    return np.stack([y0, y1], axis=-1)


def bon_aggregate(
    values: torch.Tensor,
    keys: RoundKeys,
    cfg: ChainConfig,
    alive=None,
) -> torch.Tensor:
    """BON secure mean over the learners of f32[n, V] (f32[P, n, V] with
    ``cfg.pod_axis``). ``alive`` is a 0/1 [n] host bitmap."""
    if cfg.pod_axis is not None:
        return pod_rounds(lambda v, c, _w: bon_aggregate(v, keys, c, alive),
                          values, cfg)
    n, sb = cfg.num_learners, cfg.scale_bits
    if values.dim() != 2 or values.shape[0] != n:
        raise ValueError(f"values: expected [{n}, V], got {tuple(values.shape)}")
    alive = host_alive(alive, n)
    codec = FixedPointCodec(sb)
    base = int(keys.counter_base) & 0xFFFFFFFF
    pair = pair_keys(keys.provisioning_seed, n)
    live = [u for u in range(n) if alive[u] > 0]
    dead = [v for v in range(n) if alive[v] <= 0]
    V = values.shape[1]
    zero = torch.zeros(V, dtype=torch.float32, device=values.device)
    total = torch.zeros(V, dtype=torch.int32, device=values.device).view(torch.uint32)
    for u in live:
        b_u = derive_key_np(keys.learner_seed[u], _TAG_SELFMASK)
        peers = [v for v in range(n) if v != u]
        y_u = ops.bon_mask(values[u], [pair[u, v] for v in peers] + [b_u],
                           [1 if u < v else -1 for v in peers] + [1], base,
                           scale_bits=sb)
        correction = ops.bon_mask(zero, [b_u] + [pair[u, v] for v in dead],
                                  [1] + [1 if u < v else -1 for v in dead], base,
                                  scale_bits=sb)
        total = ring_sub(ring_add(total, y_u), correction)
    return codec.decode_mean(total, max(np.float32(len(live)), np.float32(1.0)))


def bon_rank(values: torch.Tensor, keys: RoundKeys, cfg: ChainConfig, world,
             alive=None) -> torch.Tensor:
    """``bon_aggregate`` with one learner per rank: this rank's f32[V] row.
    A live rank masks with one ``bon_mask`` launch and computes its share
    of the unmasking with another; the two uint32 ``psum``s (mod 2^32, so
    in any order the one-card sum's words) give the server's sum and its
    correction. A dead rank sends zeros."""
    n, sb, u = cfg.num_learners, cfg.scale_bits, world.rank
    alive = host_alive(alive, n)
    codec = FixedPointCodec(sb)
    base = int(keys.counter_base) & 0xFFFFFFFF
    zero = torch.zeros(values.shape[0], dtype=torch.float32, device=values.device)
    if alive[u] > 0:
        pair = pair_keys(keys.provisioning_seed, n)
        dead = [v for v in range(n) if alive[v] <= 0]
        b_u = derive_key_np(keys.learner_seed[u], _TAG_SELFMASK)
        peers = [v for v in range(n) if v != u]
        y = ops.bon_mask(values, [pair[u, v] for v in peers] + [b_u],
                         [1 if u < v else -1 for v in peers] + [1], base, scale_bits=sb)
        correction = ops.bon_mask(zero, [b_u] + [pair[u, v] for v in dead],
                                  [1] + [1 if u < v else -1 for v in dead], base,
                                  scale_bits=sb)
    else:
        y = correction = torch.zeros(values.shape[0], dtype=torch.int32,
                                     device=values.device).view(torch.uint32)
    total = ring_sub(collectives.psum(y, world), collectives.psum(correction, world))
    live = int(np.sum(alive > 0))
    return codec.decode_mean(total, max(np.float32(live), np.float32(1.0)))
