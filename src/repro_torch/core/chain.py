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

``chain_aggregate_pipelined`` is the rotated-initiator segment pipeline:
the vector is cut into m segments, segment s is initiated and unmasked by
local rank s, and at step t it sits at local rank (s + t) mod m, so one
step is m hops over disjoint segments — one ``chain_combine_batched``
launch whose rows start their pads at word s·seg of each edge's stream.

``chain_aggregate_batched`` runs S sessions — each with its own keys,
counter, alive bitmap, weights and rotation — with one
``chain_combine_batched`` launch per hop: the multi-session engine's
substrate.

With one learner per rank (``repro_torch.dist``), ``chain_rank_sequential``,
``chain_rank_pipelined`` and ``chain_rank_batched`` are the reference's
per-rank rounds over a ``World``, and ``pod_mean_rank`` its ``pmean`` over
the pods across ranks.

With ``cfg.pod_axis`` set (hierarchical federation, §5.10) the values are
pod-major [P, n, V]: every pod runs the round on the same keys and alive
bitmap (the reference derives keys from the learner-axis rank) and the
published value is the mean over pods (``pod_mean``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.types import ChainConfig, RoundKeys
from repro_torch.crypto.fixedpoint import (FixedPointCodec, device_scalar,
                                           ring_add, ring_sub)
from repro_torch.crypto.np_impl import derive_key_np, threefry2x32_np
from repro_torch.dist import collectives
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
    # values·w straight into the payload: one [..., n, V+1] tensor at the
    # peak, not a product and its concatenation
    V = values.shape[-1]
    out = torch.empty(values.shape[:-1] + (V + 1,), dtype=torch.float32,
                      device=values.device)
    torch.mul(values, w[..., None], out=out[..., :V])
    out[..., V] = w
    return out


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


def pod_mean(pod_avgs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Cross-pod publication (§5.10): the reference's ``pmean`` over the
    pod axis, a psum of the pods' results in pod order divided by the
    constant P — which XLA compiles, as for ``_publish``'s g, to a
    multiply by f32(1/P)."""
    avg = pod_avgs[0]
    for a in pod_avgs[1:]:
        avg = avg + a
    return avg * device_scalar(np.float32(1.0) / np.float32(len(pod_avgs)), avg)


POD_CHUNK = 1 << 26  # words of a pod mean across ranks gathered at a time


def pod_mean_chunks(flat: torch.Tensor, pods_of: Callable, out=None) -> torch.Tensor:
    """``pod_mean`` of the pods' values of a vector, ``POD_CHUNK`` words at
    a time (an elementwise mean: the chunks change no bit):
    ``pods_of(part)`` gives the pods' values of a chunk of ``flat`` in pod
    order; the mean is written into ``out`` (``flat`` itself by default)."""
    flat = flat.view(-1)
    out = flat if out is None else out.view(-1)
    for lo in range(0, flat.numel(), POD_CHUNK):
        out[lo:lo + POD_CHUNK] = pod_mean(pods_of(flat[lo:lo + POD_CHUNK]))
    return out


def pod_mean_rank(avg: torch.Tensor, pod_world) -> torch.Tensor:
    """``pod_mean`` across ranks: this pod's result ``avg`` all-gathered
    over ``pod_world`` (one rank a pod, the same learner in each) in pod
    order and averaged as the one-card ``pod_mean``, so its words are the
    one-card pod mean's; written into ``avg``."""
    return pod_mean_chunks(avg, lambda part: list(
        collectives.all_gather(part, pod_world).unbind(0))).view(avg.shape)


def _pod_weights(weights, pods: int, n: int) -> list:
    """Per-pod rows of [P, n] weights, one per global rank in pod-major
    order as the reference shards them (None: every pod's None)."""
    if weights is None:
        return [None] * pods
    if not isinstance(weights, torch.Tensor):
        weights = torch.as_tensor(np.asarray(weights, np.float32))
    if weights.numel() != pods * n:
        raise ValueError(f"weights: expected {pods}x{n} entries, got {weights.numel()}")
    return list(weights.reshape(pods, n))


def pod_rounds(round_fn: Callable, values: torch.Tensor, cfg: ChainConfig,
               weights=None) -> torch.Tensor:
    """Run ``round_fn(values[p], flat_cfg, weights_p)`` for each pod p of
    pod-major f32[P, n, V] values (``flat_cfg`` is ``cfg`` without the pod
    axis) and publish the mean over pods."""
    n = cfg.num_learners
    if values.dim() != 3 or values.shape[1] != n:
        raise ValueError(f"values: with pod_axis={cfg.pod_axis!r} expected "
                         f"[P, {n}, V], got {tuple(values.shape)}")
    flat = dataclasses.replace(cfg, pod_axis=None)
    w = _pod_weights(weights, values.shape[0], n)
    return pod_mean([round_fn(values[p], flat, w[p]) for p in range(values.shape[0])])


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
    if cfg.pod_axis is not None:
        return pod_rounds(lambda v, c, w: chain_aggregate_sequential(
            v, keys, c, alive, w, rotate), values, cfg, weights)
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


def chain_aggregate_pipelined(
    values: torch.Tensor,
    keys: RoundKeys,
    cfg: ChainConfig,
    alive=None,
    weights=None,
) -> torch.Tensor:
    """Rotated-initiator segment pipeline (the reference's DESIGN.md §8).

    Each (sub)group's payload is padded to m·seg words (m = group size,
    seg = ceil(W / m)) and cut into m segments. Segment s of a group is
    initiated, masked with the private R of local rank s (words [0, seg)
    of its stream) and finally unmasked by local rank s; its hop pads are
    words [s·seg, (s+1)·seg) of each edge's stream. At step t segment s
    sits at local rank (s + t) mod m, so a step is one
    ``chain_combine_batched`` launch over every group's m segments. There
    is no election: a dead rank still forwards, re-pads, and masks and
    unmasks its own segment; only its encoded words are zero. No
    ``rotate``, as in the reference.

    Args:
      values: f32[n, V] learner-major (f32[P, n, V] with ``cfg.pod_axis``).
      keys: RoundKeys (host numpy).
      cfg: ChainConfig; ``cfg.mode`` must be 'safe' or 'saf'.
      alive: optional 0/1 [n] liveness bitmap (host data).
      weights: optional f32[n] per-learner weights (read when weighted).

    Returns:
      f32[V] — the (weighted) mean over alive learners.
    """
    if cfg.mode not in ("safe", "saf"):
        raise ValueError(f"chain modes are 'safe'/'saf', got {cfg.mode!r}")
    if cfg.pod_axis is not None:
        return pod_rounds(lambda v, c, w: chain_aggregate_pipelined(
            v, keys, c, alive, w), values, cfg, weights)
    n, m, sb = cfg.num_learners, cfg.group_size, cfg.scale_bits
    if values.dim() != 2 or values.shape[0] != n:
        raise ValueError(f"values: expected [{n}, V], got {tuple(values.shape)}")
    alive = host_alive(alive, n)
    codec = FixedPointCodec(sb)
    dev = values.device
    payload = _payload(values, cfg, weights)
    W = payload.shape[1]
    seg = -(-W // m)
    # [n, m, seg]: rank r's payload zero-padded to m·seg words, a dead
    # rank's row all zero (the reference multiplies its encoded words by
    # 0, so a NaN there never reaches the sum)
    x = payload.new_zeros((n, m * seg))
    x[:, :W] = payload
    dead = np.flatnonzero(alive == 0)
    if dead.size:
        x.index_fill_(0, upload(dead, dev), 0.0)
    x = x.view(n, m, seg)
    base = int(keys.counter_base) & 0xFFFFFFFF

    # Row q of every [n, seg] tensor below is segment local[q] of group
    # first[q]: the segment rank q initiates. At step t it is held by
    # rank holder[t, q] = first[q] + (local[q] + t) mod m.
    local = np.arange(n) % m
    first = np.arange(n) - local
    holder = first + (local + np.arange(m)[:, None]) % m          # [m, n]
    starts = local * seg
    holder_d, local_d = upload(holder, dev), upload(local, dev)

    def rows_at(t: int) -> torch.Tensor:
        """[n, seg]: each segment's words of the rank holding it at step t."""
        return x[holder_d[t], local_d]

    zero = torch.zeros(seg, dtype=torch.float32, device=dev)
    R = torch.stack([_initiator_mask(keys.learner_seed[q], zero, base, sb)
                     for q in range(n)])
    if cfg.mode == "safe":
        k_out, k_in = _hop_keys(keys.provisioning_seed, cfg)
        c = ring_add(torch.stack([
            ops.mask_add(x[q, local[q]], k_out[q], base, offset=int(starts[q]),
                         scale_bits=sb)
            for q in range(n)]), R)
        bases = np.full(n, base, np.uint32)
        for t in range(1, m):
            c = ops.chain_combine_batched(c, rows_at(t), k_in[holder[t]],
                                          k_out[holder[t]], bases, starts=starts,
                                          scale_bits=sb)
        pad_in = torch.stack([
            ops.mask_add(zero, k_in[q], base, offset=int(starts[q]), scale_bits=sb)
            for q in range(n)])
        total = ring_sub(ring_sub(c, pad_in), R)
    else:  # SAF: the initiator masks alone, no hop pads
        c = ring_add(codec.encode(rows_at(0)), R)
        for t in range(1, m):
            c = ring_add(c, codec.encode(rows_at(t)))
        total = ring_sub(c, R)

    # Each group's m unmasked segments, concatenated (the reference's
    # all_gather), are its ring sum.
    group_avgs = [
        _group_mean(codec, total[grp * m:(grp + 1) * m].reshape(-1)[:W],
                    _group_count(cfg, alive, grp), cfg.weighted)
        for grp in range(cfg.subgroups)]
    if cfg.subgroups == 1:  # every member already holds it: no psum
        return group_avgs[0]
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
    if cfg.pod_axis is not None:
        raise ValueError("batched sessions run one pod each: cfg.pod_axis must be None")
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


# ---- one learner per rank (torch.distributed) ---------------------------------------

def _rank_payload(values: torch.Tensor, cfg: ChainConfig, weight,
                  model_world=None) -> torch.Tensor:
    """This rank's payload: ``_payload`` of its [V] row and scalar weight;
    with model shards, chunks other than the last without the weight word
    (``_carries_weight``)."""
    if cfg.mode not in ("safe", "saf"):
        raise ValueError(f"chain modes are 'safe'/'saf', got {cfg.mode!r}")
    w = None if weight is None else torch.as_tensor(weight, dtype=torch.float32).reshape(1)
    payload = _payload(values[None], cfg, w)[0]
    return payload if _carries_weight(cfg, model_world) or not cfg.weighted else payload[:-1]


def _carries_weight(cfg: ChainConfig, model_world) -> bool:
    """Whether this rank's weighted payload ends in the weight word. With
    model shards (ring j rounds words [s_j, e_j) of the vector) only the
    last chunk's does: the weight word is word V of the whole payload,
    right after that chunk, so its pads are the one-card round's and no
    two rings pad one word."""
    return cfg.weighted and (model_world is None or model_world.rank == model_world.size - 1)


def _chunk_mean(codec: FixedPointCodec, total: torch.Tensor, count, cfg: ChainConfig,
                model_world) -> torch.Tensor:
    """``_group_mean`` of a ring's total; weighted with model shards, the
    last chunk's ring decodes the weight sum and broadcasts it over the
    model group (whose ranks hold the same learner, so the same role in
    their rings), and each chunk divides by it as the one-card mean does."""
    if not cfg.weighted or model_world is None:
        return _group_mean(codec, total, count, cfg.weighted)
    s = codec.decode(total)
    last = model_world.size - 1
    w = s[-1:] if model_world.rank == last else torch.empty_like(s[:1])
    w = collectives.broadcast(w.contiguous(), last, model_world)
    return (s[:-1] if model_world.rank == last else s) / torch.clamp_min(w, 1e-12)


def publish_rank(avg: Optional[torch.Tensor], posters: Sequence[int], like: torch.Tensor,
                 subgroups: int, world) -> torch.Tensor:
    """``_publish`` across ranks: rank ``posters[g]`` holds group g's average
    (``avg``; None on the other ranks), each poster broadcasts it, and every
    rank publishes the same f32 mean of the g averages as the one-card
    ``_publish``. ``like`` gives a non-poster's shape and dtype."""
    avgs = [collectives.broadcast(avg if world.rank == src else torch.empty_like(like),
                                  src, world) for src in posters]
    return _publish(avgs, subgroups)


def chain_rank_sequential(
    values: torch.Tensor,
    keys: RoundKeys,
    cfg: ChainConfig,
    world,
    alive=None,
    weight=None,
    rotate: int = 0,
    model_world=None,
) -> torch.Tensor:
    """``chain_aggregate_sequential`` with one learner per rank: this rank's
    f32[V] ``values`` (and scalar ``weight``), the published mean on every
    rank, bit for bit the one-card round's. With ``model_world`` the
    values are one chunk of the vector, the keys' counter base already the
    chunk's (``SecureAggregator.aggregate_rank``).

    The masked vector goes point to point along the group's hop order, one
    message a hop: the initiator posts ``mask_add`` ⊕ R to its successor,
    each later rank receives, runs ``chain_combine`` on its own row (a dead
    rank on a zero row) and sends on, and the last hop returns the vector
    to the initiator, which unmasks and decodes. The reference's lockstep
    ``ppermute`` also moves zeros through the idle ranks; the ciphertexts
    and the mean are the same. Each group's initiator then broadcasts its
    average (``publish_rank``)."""
    n, m, sb = cfg.num_learners, cfg.group_size, cfg.scale_bits
    rank, topo = world.rank, cfg.topology
    alive = host_alive(alive, n)
    codec = FixedPointCodec(sb)
    payload = _rank_payload(values, cfg, weight, model_world)
    zero = torch.zeros(payload.shape[0], dtype=torch.float32, device=payload.device)
    row = payload if alive[rank] > 0 else zero
    base = int(keys.counter_base) & 0xFFFFFFFF
    if cfg.mode == "safe":
        k_out, k_in = _hop_keys(keys.provisioning_seed, cfg)
    grp = topo.group_of(rank)
    order = topo.hop_order(alive, rotate, grp)
    pos = order.index(rank)
    prev, nxt = order[pos - 1], order[(pos + 1) % m]
    shape, avg = (payload.shape[0],), None
    if pos == 0:  # the initiator posts, then unmasks what comes back
        R = _initiator_mask(keys.learner_seed[rank], zero, base, sb)
        if cfg.mode == "safe":
            c = ring_add(ops.mask_add(row, k_out[rank], base, scale_bits=sb), R)
        else:
            c = ring_add(codec.encode(row), R)
        collectives.send(c, nxt, world)
        c = collectives.recv(shape, torch.uint32, prev, world)
        if cfg.mode == "safe":
            c = ring_sub(c, ops.mask_add(zero, k_in[rank], base, scale_bits=sb))
        avg = _chunk_mean(codec, ring_sub(c, R), _group_count(cfg, alive, grp), cfg,
                          model_world)
    else:
        c = collectives.recv(shape, torch.uint32, prev, world)
        if cfg.mode == "safe":
            c = ops.chain_combine(c, row, k_in[rank], k_out[rank], base, scale_bits=sb)
        else:
            c = ring_add(c, codec.encode(row))
        collectives.send(c, nxt, world)
    like = zero[:-1] if _carries_weight(cfg, model_world) else zero
    return publish_rank(avg, topo.elect_initiators(alive, rotate), like, cfg.subgroups,
                        world)


def chain_rank_pipelined(
    values: torch.Tensor,
    keys: RoundKeys,
    cfg: ChainConfig,
    world,
    alive=None,
    weight=None,
    model_world=None,
) -> torch.Tensor:
    """``chain_aggregate_pipelined`` with one learner per rank, bit for bit
    the one-card round's. With ``model_world`` the values are one chunk of
    the vector, pipelined in segments of its own, the keys' counter base
    already the chunk's (``SecureAggregator.aggregate_rank``).

    This rank (local index l) starts segment l, masked with its R and its
    outgoing pad from word l·seg; then m − 1 lockstep ``ppermute`` steps
    along the ring, at step t combining the segment (l − t) mod m it now
    holds — one ``chain_combine_batched`` row whose pads start at word
    ((l − t) mod m)·seg, which may be odd (mid Threefry block); then the
    last hop returns segment l, which it unmasks. A tiled ``all_gather``
    of the unmasked segments gives every rank its group's ring sum; with
    subgroups, each group's first rank broadcasts the group's average."""
    n, m, sb = cfg.num_learners, cfg.group_size, cfg.scale_bits
    rank, topo = world.rank, cfg.topology
    alive = host_alive(alive, n)
    codec = FixedPointCodec(sb)
    payload = _rank_payload(values, cfg, weight, model_world)
    W = payload.shape[0]
    seg = -(-W // m)
    x = payload.new_zeros(m * seg)
    if alive[rank] > 0:  # a dead rank's row is all zero, as on one card
        x[:W] = payload
    x = x.view(m, seg)
    base = int(keys.counter_base) & 0xFFFFFFFF
    lrank, g0 = topo.local_index(rank), topo.group_start(rank)
    perm = topo.ring_permutation()
    zero = torch.zeros(seg, dtype=torch.float32, device=x.device)
    R = _initiator_mask(keys.learner_seed[rank], zero, base, sb)
    if cfg.mode == "safe":
        k_out, k_in = _hop_keys(keys.provisioning_seed, cfg)
        c = ring_add(ops.mask_add(x[lrank], k_out[rank], base, offset=lrank * seg,
                                  scale_bits=sb), R)
        for t in range(1, m):
            c = collectives.ppermute(c, perm, world)
            s = (lrank - t) % m
            c = ops.chain_combine_batched(c[None], x[s][None], k_in[rank][None],
                                          k_out[rank][None], [base], starts=[s * seg],
                                          scale_bits=sb)[0]
        c = collectives.ppermute(c, perm, world)
        c = ring_sub(c, ops.mask_add(zero, k_in[rank], base, offset=lrank * seg,
                                     scale_bits=sb))
    else:  # SAF: the initiator masks alone, no hop pads
        c = ring_add(codec.encode(x[lrank]), R)
        for t in range(1, m):
            c = collectives.ppermute(c, perm, world)
            c = ring_add(c, codec.encode(x[(lrank - t) % m]))
        c = collectives.ppermute(c, perm, world)
    total = collectives.all_gather(ring_sub(c, R), world, tiled=True)
    avg = _chunk_mean(codec, total[g0 * seg:(g0 + m) * seg][:W],
                      _group_count(cfg, alive, topo.group_of(rank)), cfg, model_world)
    if cfg.subgroups == 1:  # every member already holds it: no psum
        return avg
    posters = [g * m for g in range(cfg.subgroups)]
    return publish_rank(avg if rank in posters else None, posters, avg, cfg.subgroups,
                        world)


def chain_rank_batched(
    values: torch.Tensor,
    prov_seeds,
    learner_seeds,
    counter_bases,
    cfg: ChainConfig,
    world,
    alive,
    weights=None,
    rotate: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """``chain_aggregate_batched`` with one learner per rank (the reference
    engine's ``per_rank`` program): this rank's f32[S, V] rows of S
    sessions, each session with its own keys, counter, alive bitmap,
    weights and rotation; every session's published mean on every rank,
    bit for bit the one-card batch's.

    The S ciphertexts move in lockstep around the ring: each session's
    initiator posts ``mask_add`` ⊕ R into its row; then m − 1 ``ppermute``
    steps of the [S, W] ciphertexts, after each of which this rank combines
    the rows of the sessions whose hop order puts it there with one
    ``chain_combine_batched`` launch (a row it does not hold at that hop
    passes through unchanged); a last ``ppermute`` returns each session to
    its initiator, which unmasks and decodes. The initiators' averages are
    all-gathered and published as the one-card ``_publish``.

    Args (host data the same on every rank): ``prov_seeds`` uint32[S, 2],
    ``learner_seeds`` uint32[S, n, 2], ``counter_bases`` [S], ``alive``
    [S, n], ``weights`` f32[S, n] (or this rank's f32[S]; read when
    weighted), ``rotate`` [S].
    """
    if cfg.mode not in ("safe", "saf"):
        raise ValueError(f"chain modes are 'safe'/'saf', got {cfg.mode!r}")
    if cfg.pod_axis is not None:
        raise ValueError("batched sessions run one pod each: cfg.pod_axis must be None")
    n, m, sb = cfg.num_learners, cfg.group_size, cfg.scale_bits
    rank, topo = world.rank, cfg.topology
    if values.dim() != 2:
        raise ValueError(f"values: expected this rank's [S, V], got {tuple(values.shape)}")
    S, dev = values.shape[0], values.device
    alive = [host_alive(a, n) for a in alive]
    rotate = [0] * S if rotate is None else [int(r) for r in rotate]
    bases = np.array([int(b) & 0xFFFFFFFF for b in np.asarray(counter_bases).reshape(-1)],
                     np.uint32)
    learner_seeds = np.asarray(learner_seeds, np.uint32).reshape(S, n, 2)
    codec = FixedPointCodec(sb)
    w = None
    if cfg.weighted and weights is not None:
        w = torch.as_tensor(weights if isinstance(weights, torch.Tensor)
                            else np.asarray(weights, np.float32)).reshape(S, -1)
        w = (w[:, rank] if w.shape[1] == n else w[:, 0]).reshape(S, 1)
    x = _payload(values[:, None], cfg, w)[:, 0]
    dead = [s for s in range(S) if alive[s][rank] <= 0]
    if dead:  # a dead rank forwards and re-pads a zero row
        x = x.clone()
        x[upload(np.array(dead), dev)] = 0.0
    W = x.shape[1]
    zero = torch.zeros(W, dtype=torch.float32, device=dev)
    if cfg.mode == "safe":
        hop = [_hop_keys(p, cfg) for p in np.asarray(prov_seeds).reshape(S, 2)]
        k_out = np.stack([h[0][rank] for h in hop])  # [S, 2]: this rank's edges
        k_in = np.stack([h[1][rank] for h in hop])
    grp = topo.group_of(rank)
    orders = [topo.hop_order(alive[s], rotate[s], grp) for s in range(S)]
    mine = [s for s in range(S) if orders[s][0] == rank]   # sessions this rank initiates
    perm = topo.ring_permutation()

    R = {s: _initiator_mask(learner_seeds[s, rank], zero, int(bases[s]), sb) for s in mine}
    # the ciphertexts kept as their int32 view: row gathers and scatters
    # of uint32 are not implemented for every device
    c = torch.zeros((S, W), dtype=torch.int32, device=dev)
    for s in mine:
        b = int(bases[s])
        posted = (ops.mask_add(x[s], k_out[s], b, scale_bits=sb) if cfg.mode == "safe"
                  else codec.encode(x[s]))
        c[s] = ring_add(posted, R[s]).view(torch.int32)
    for t in range(1, m):
        c = collectives.ppermute(c, perm, world)
        here = [s for s in range(S) if orders[s][t] == rank]
        if not here:
            continue
        idx = upload(np.array(here), dev)
        held = c[idx].view(torch.uint32)
        if cfg.mode == "safe":
            held = ops.chain_combine_batched(held, x[idx], k_in[here], k_out[here],
                                             bases[here], scale_bits=sb)
        else:
            held = ring_add(held, codec.encode(x[idx]))
        c[idx] = held.view(torch.int32)
    c = collectives.ppermute(c, perm, world).view(torch.uint32)

    # this rank's initiated sessions unmasked; every session's group
    # averages gathered from their initiators and published
    like = zero[:-1] if cfg.weighted else zero
    part = torch.zeros((S,) + like.shape, dtype=torch.float32, device=dev)
    if mine:
        totals = []
        for s in mine:
            b = int(bases[s])
            t = c[s]
            if cfg.mode == "safe":
                t = ring_sub(t, ops.mask_add(zero, k_in[s], b, scale_bits=sb))
            totals.append(ring_sub(t, R[s]))
        counts = np.array([[_group_count(cfg, alive[s], grp)] for s in mine], np.float32)
        counts = upload(np.maximum(counts, np.float32(1.0)), dev)
        part[upload(np.array(mine), dev)] = _group_mean(codec, torch.stack(totals), counts,
                                                        cfg.weighted)
    stack = collectives.all_gather(part, world)          # [n, S, V]
    sess = torch.arange(S, device=dev)
    group_avgs = []
    for g in range(cfg.subgroups):
        init = [topo.hop_order(alive[s], rotate[s], g)[0] for s in range(S)]
        group_avgs.append(stack[upload(np.array(init), dev), sess])
    return _publish(group_avgs, cfg.subgroups)
