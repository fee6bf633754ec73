"""SAFE chain aggregation on one device, learner-major.

The JAX package runs one learner per mesh rank inside ``shard_map`` and
moves the masked vector around a ``ppermute`` ring. Here the learners are
dim 0 of an [n, V] tensor on one card, and the round is the same ring
arithmetic walked in hop order. For each (sub)group ring with elected
initiator i0 and hop order r_1..r_{m-1}:

    c     = mask_add(x[i0], k_out(i0)) ⊕ R             initiator posts
    c     = chain_combine(c, x[r_t], k_in(r_t), k_out(r_t))   each hop
    total = c ⊖ pad(k_in(i0)) ⊖ R                      initiator unmasks

where R = mask_add(0, k_R(i0)) is the initiator's private mask (encode(0)
is 0). Every pad is made inside a kernel and every intermediate
ciphertext equals the reference's word for word; the published mean is
the reference's bit for bit. On a CUDA tensor each step is a kernel
launch; on a CPU tensor it is the kernel's plain version (``kernels.ops``).

Keys, the alive bitmap and the rotation are host data: keys are derived
with the numpy mirror of the PRF, and initiator election runs on the host.
A dead rank keeps its place on the ring, forwarding and re-padding with a
zero row in place of its vector (the reference multiplies its *encoded*
words by 0, so a NaN in a dead row never reaches the sum).

``chain_aggregate_batched`` runs S sessions — each with its own keys,
counter, alive bitmap, weights and rotation — with one
``chain_combine_batched`` launch per hop: the multi-session engine's
substrate.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.types import ChainConfig, RoundKeys
from repro_torch.crypto.fixedpoint import (FixedPointCodec, device_scalar,
                                           ring_add, ring_sub)
from repro_torch.crypto.np_impl import derive_key_np, threefry2x32_np
from repro_torch.kernels import ops
from repro_torch.kernels.build import upload

# Domain-separation tags for derive_key.
_TAG_INITIATOR_MASK = 0x52  # 'R'
_TAG_HOP_PAD = 0x50  # 'P'


def host_alive(alive, n: int) -> np.ndarray:
    """f32[n] 0/1 liveness bitmap on the host (None = all alive)."""
    if alive is None:
        return np.ones((n,), np.float32)
    if isinstance(alive, torch.Tensor):
        alive = alive.cpu().numpy()
    a = np.asarray(alive, np.float32).reshape(-1)
    if a.shape != (n,):
        raise ValueError(f"alive: expected {n} entries, got {a.shape[0]}")
    if not np.isin(a, (0.0, 1.0)).all():
        raise ValueError("alive must be a 0/1 bitmap")
    return a


def _hop_keys(prov_seed, cfg: ChainConfig):
    """(k_out, k_in): uint32[n, 2] ring-edge keys of every rank — the
    counterpart of the reference's ``_hop_pads``, whose pads the kernels
    generate from these keys. k_out[r] keys edge r -> successor(r) and
    k_in[r] edge predecessor(r) -> r, so both ends of an edge share it."""
    topo = cfg.topology
    seed = derive_key_np(prov_seed, _TAG_HOP_PAD)
    ranks = np.arange(cfg.num_learners, dtype=np.uint32)
    y0, y1 = threefry2x32_np(seed, ranks, topo.successor_map().astype(np.uint32))
    k_out = np.stack([y0, y1], axis=1)
    pred = np.array([topo.predecessor(r) for r in range(cfg.num_learners)])
    return k_out, k_out[pred]


def _initiator_mask(learner_seed, zero: torch.Tensor, counter_base: int,
                    scale_bits: int) -> torch.Tensor:
    """The single mask R (paper §5.2): a keystream from the initiator's
    private seed, as mask_add of a zero vector."""
    k = derive_key_np(learner_seed, _TAG_INITIATOR_MASK)
    return ops.mask_add(zero, k, counter_base, scale_bits=scale_bits)


def _payload(values: torch.Tensor, cfg: ChainConfig, weights) -> torch.Tensor:
    """[..., n, V] values, or [..., n, V+1] ``concat(values·w, w)`` when
    weighted (§5.6). ``weights`` is [..., n] (None = all ones)."""
    if not cfg.weighted:
        return values
    if weights is None:
        w = torch.ones(values.shape[:-1], dtype=torch.float32, device=values.device)
    else:
        if not isinstance(weights, torch.Tensor):
            weights = upload(np.asarray(weights, np.float32), values.device)
        w = weights.to(values.device, torch.float32).reshape(values.shape[:-1])
    return torch.cat([values * w[..., None], w[..., None]], dim=-1)


def _group_mean(codec: FixedPointCodec, total: torch.Tensor, count,
                weighted: bool) -> torch.Tensor:
    """Decode a ring sum ([V] or [S, V]) into the group's (weighted) mean.
    ``count`` is the survivor count: a number, or an [S, 1] tensor on the
    device already floored at 1."""
    if weighted:
        s = codec.decode(total)
        return s[..., :-1] / torch.clamp_min(s[..., -1:], 1e-12)
    if not isinstance(count, torch.Tensor):
        count = max(count, np.float32(1.0))
    return codec.decode_mean(total, count)


def _publish(group_avgs: Sequence[torch.Tensor], subgroups: int) -> torch.Tensor:
    """Cross-group publication (§5.5): the mean of the group initiators'
    averages. The reference's ``psum`` adds them in rank order with zeros
    from every other rank (hence the sum starts from +0), and its division
    by the constant g compiles to a multiply by f32(1/g), which differs
    from a true division in the last bit for g = 3."""
    avg = torch.zeros_like(group_avgs[0])
    for a in group_avgs:
        avg = avg + a
    return avg * device_scalar(np.float32(1.0) / np.float32(subgroups), avg)


def _group_count(cfg: ChainConfig, alive: np.ndarray, group: int) -> np.float32:
    return np.sum(cfg.topology.group_alive(alive, group), dtype=np.float32)


def chain_aggregate_sequential(
    values: torch.Tensor,
    keys: RoundKeys,
    cfg: ChainConfig,
    alive=None,
    weights=None,
    rotate: int = 0,
) -> torch.Tensor:
    """Paper-faithful SAFE Round 1 over every (sub)group ring.

    Args:
      values: f32[n, V] learner-major local vectors, on the device the
        round runs on.
      keys: RoundKeys (host numpy).
      cfg: ChainConfig; ``cfg.mode`` must be 'safe' or 'saf'.
      alive: optional 0/1 [n] liveness bitmap (host data).
      weights: optional f32[n] per-learner weights (read when weighted).
      rotate: per-round initiator rotation (§8).

    Returns:
      f32[V] — the (weighted) mean over alive learners.
    """
    if cfg.mode not in ("safe", "saf"):
        raise ValueError(f"chain modes are 'safe'/'saf', got {cfg.mode!r}")
    n, sb = cfg.num_learners, cfg.scale_bits
    if values.dim() != 2 or values.shape[0] != n:
        raise ValueError(f"values: expected [{n}, V], got {tuple(values.shape)}")
    alive = host_alive(alive, n)
    codec = FixedPointCodec(sb)
    payload = _payload(values, cfg, weights)
    zero = torch.zeros(payload.shape[1], dtype=torch.float32, device=payload.device)
    rows = [payload[r] if alive[r] > 0 else zero for r in range(n)]
    base = int(keys.counter_base) & 0xFFFFFFFF
    if cfg.mode == "safe":
        k_out, k_in = _hop_keys(keys.provisioning_seed, cfg)

    group_avgs = []
    for grp in range(cfg.subgroups):
        order = cfg.topology.hop_order(alive, rotate, grp)
        i0 = order[0]
        R = _initiator_mask(keys.learner_seed[i0], zero, base, sb)
        if cfg.mode == "safe":
            c = ring_add(ops.mask_add(rows[i0], k_out[i0], base, scale_bits=sb), R)
            for r in order[1:]:
                c = ops.chain_combine(c, rows[r], k_in[r], k_out[r], base,
                                      scale_bits=sb)
            pad_in = ops.mask_add(zero, k_in[i0], base, scale_bits=sb)
            total = ring_sub(ring_sub(c, pad_in), R)
        else:  # SAF: the initiator mask alone, no hop pads
            c = ring_add(codec.encode(rows[i0]), R)
            for r in order[1:]:
                c = ring_add(c, codec.encode(rows[r]))
            total = ring_sub(c, R)
        group_avgs.append(_group_mean(codec, total, _group_count(cfg, alive, grp),
                                      cfg.weighted))
    return _publish(group_avgs, cfg.subgroups)


def chain_aggregate_batched(
    values: torch.Tensor,
    prov_seeds,
    learner_seeds,
    counter_bases,
    cfg: ChainConfig,
    alive,
    weights=None,
    rotate: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """S independent SAFE rounds, one ``chain_combine_batched`` per hop.

    Session s runs the arithmetic of ``chain_aggregate_sequential`` under
    its own keys, counter, alive bitmap, weights and rotation, so its
    published mean is bit-identical to a single-session run. At hop t each
    session has its own active rank; the hop gathers those [S, V] rows.

    Args:
      values: f32[S, n, V].
      prov_seeds: uint32[S, 2] derived provisioning keys (host).
      learner_seeds: uint32[S, n, 2] private seeds (host).
      counter_bases: [S] counter bases (host).
      cfg: shared ChainConfig ('safe' or 'saf').
      alive: [S, n] 0/1 bitmaps (host).
      weights: optional f32[S, n] (read when weighted).
      rotate: optional [S] initiator rotations.

    Returns:
      f32[S, V] published (weighted) means.
    """
    if cfg.mode not in ("safe", "saf"):
        raise ValueError(f"chain modes are 'safe'/'saf', got {cfg.mode!r}")
    n, sb = cfg.num_learners, cfg.scale_bits
    if values.dim() != 3 or values.shape[1] != n:
        raise ValueError(f"values: expected [S, {n}, V], got {tuple(values.shape)}")
    S = values.shape[0]
    dev = values.device
    alive = [host_alive(a, n) for a in alive]
    rotate = [0] * S if rotate is None else [int(r) for r in rotate]
    bases = [int(b) & 0xFFFFFFFF for b in np.asarray(counter_bases).reshape(-1)]
    learner_seeds = np.asarray(learner_seeds, np.uint32).reshape(S, n, 2)
    codec = FixedPointCodec(sb)
    payload = _payload(values, cfg, weights)
    zero = torch.zeros(payload.shape[2], dtype=torch.float32, device=dev)
    sess = torch.arange(S, device=dev)
    if cfg.mode == "safe":
        hop = [_hop_keys(p, cfg) for p in np.asarray(prov_seeds).reshape(S, 2)]
        k_out = np.stack([h[0] for h in hop])  # [S, n, 2]
        k_in = np.stack([h[1] for h in hop])

    def row(s: int, r: int) -> torch.Tensor:
        return payload[s, r] if alive[s][r] > 0 else zero

    group_avgs = []
    for grp in range(cfg.subgroups):
        orders = [cfg.topology.hop_order(alive[s], rotate[s], grp) for s in range(S)]
        init = [o[0] for o in orders]
        # one upload per group: hop t gathers payload[s, order[t, s]]
        order = np.array(orders).T                       # [m, S]
        dead = np.array([a[o] == 0 for a, o in zip(alive, orders)]).T
        order_d, dead_d = upload(order, dev), upload(dead, dev)

        def rows_at(t: int) -> torch.Tensor:
            """[S, V] gather of each session's hop-t row, dead rows zeroed."""
            x = payload[sess, order_d[t]]
            if dead[t].any():
                x.masked_fill_(dead_d[t][:, None], 0.0)
            return x

        R = torch.stack([_initiator_mask(learner_seeds[s, init[s]], zero, bases[s], sb)
                         for s in range(S)])
        if cfg.mode == "safe":
            c = ring_add(torch.stack([
                ops.mask_add(row(s, init[s]), k_out[s, init[s]], bases[s], scale_bits=sb)
                for s in range(S)]), R)
            for t in range(1, cfg.group_size):
                c = ops.chain_combine_batched(
                    c, rows_at(t), k_in[np.arange(S), order[t]],
                    k_out[np.arange(S), order[t]], bases, scale_bits=sb)
            pad_in = torch.stack([
                ops.mask_add(zero, k_in[s, init[s]], bases[s], scale_bits=sb)
                for s in range(S)])
            total = ring_sub(ring_sub(c, pad_in), R)
        else:  # SAF: the initiator mask alone, no hop pads
            c = ring_add(codec.encode(rows_at(0)), R)
            for t in range(1, cfg.group_size):
                c = ring_add(c, codec.encode(rows_at(t)))
            total = ring_sub(c, R)
        counts = np.array([[_group_count(cfg, a, grp)] for a in alive], np.float32)
        counts = upload(np.maximum(counts, np.float32(1.0)), dev)
        group_avgs.append(_group_mean(codec, total, counts, cfg.weighted))
    return _publish(group_avgs, cfg.subgroups)
