"""BON control-plane simulation — Practical Secure Aggregation (CCS'17).

Round-synchronous simulation of the 4-round protocol the paper benchmarks
against (its footnote-1 framing, matching the reference implementation at
github.com/ammartahir24/SecureAggregation):

  Round 0  advertise keys        (2 msgs/node: post + fetch bundle)
  Round 1  share secrets         (each node posts n-1 Shamir share pairs,
                                  fetches its n-1 incoming shares)
  Round 2  masked input collection (post y_u; quadratic PRF work)
  Round 3/4 unmasking             (each survivor posts shares for every
                                  peer: b_u shares of survivors, s_uv
                                  shares of dropouts; server reconstructs)

Real arithmetic (threefry pads + Shamir over GF(2^127-1)); virtual time
from the same CostModel as the SAFE sim, with per-round barriers (the
protocol is server-synchronized). Message counting matches the structure
above — O(n^2) share traffic — which is what Figures 6/8/13 measure.

The PyTorch port's copy of the JAX package's ``core/bon_protocol.py``, with the same
semantics.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Optional

import numpy as np

from repro_torch.core.costs import CostModel, EDGE
from repro_torch.core.shamir import reconstruct, share
from repro_torch.crypto.np_impl import NpFixedPoint, keystream_pair_lanes_np

_MASK32 = 0xFFFFFFFF


def _seed_to_key(seed: int) -> np.ndarray:
    return np.array([seed & _MASK32, (seed >> 32) & _MASK32], np.uint32)


def bon_secrets(n: int, threshold: int, seed: int):
    """The round's secret material, in the canonical draw order.

    One ``random.Random(seed)`` stream drawn in a fixed global order —
    all b seeds, all s seeds, all b shares, all s shares — so *any*
    runtime (this sim, the wire learners of ``core/bon_machines.py``)
    that replays the same order derives identical secrets, and the
    published averages can be compared bit-for-bit.

    Returns ``(b_seed, s_seed, b_shares, s_shares)``; the share dicts
    map node -> the ``share()`` list for that node's secret (entry
    ``v - 1`` is the share addressed to node v).
    """
    rng = random.Random(seed)
    b_seed = {u: rng.getrandbits(64) for u in range(1, n + 1)}
    s_seed = {u: rng.getrandbits(64) for u in range(1, n + 1)}
    b_shares = {u: share(b_seed[u], threshold, n, rng)
                for u in range(1, n + 1)}
    s_shares = {u: share(s_seed[u], threshold, n, rng)
                for u in range(1, n + 1)}
    return b_seed, s_seed, b_shares, s_shares


def bon_pair_pad(s_u: int, s_v: int, u: int, v: int, V: int) -> np.ndarray:
    """Pairwise pad between nodes u and v (symmetric in the pair)."""
    lo, hi = (u, v) if u < v else (v, u)
    s_lo, s_hi = (s_u, s_v) if u < v else (s_v, s_u)
    k = _seed_to_key(
        s_lo ^ ((s_hi << 1) & ((1 << 64) - 1)) ^ (lo * 0x9E3779B9 + hi))
    return keystream_pair_lanes_np(k, V, 0)


def bon_self_pad(b_u: int, V: int) -> np.ndarray:
    """Node u's self-mask pad from its b seed."""
    return keystream_pair_lanes_np(_seed_to_key(b_u), V, 0)


def bon_expected_messages(n: int, f: int = 0) -> int:
    """Closed-form BON message count, f dropouts after Round 1.

    Per node: R0 advertise + key fetch (2), R1 share posts + fetches
    (2(n−1)); per survivor: masked post (1), roster/consistency fetch +
    unmask share posts (n), average fetch (1). With ℓ = n − f:

        M_BON(n, f) = 2n + 2n(n−1) + ℓ(n+2) = 2n² + ℓ(n+2)

    Asserted against both the sim's counters and the wire BonStats
    (tests/test_conformance.py) — the BON analogue of SAFE's §5 forms.
    """
    live = n - f
    return 2 * n + 2 * n * (n - 1) + live * (n + 2)


@dataclasses.dataclass
class BonResult:
    average: Optional[np.ndarray]
    virtual_time: float
    messages: int
    bytes_sent: int
    shares_created: int
    shares_reconstructed: int


def run_bon_round(
    values: np.ndarray,
    failed_nodes: tuple[int, ...] | list[int] = (),
    threshold: Optional[int] = None,
    cost: CostModel = EDGE,
    scale_bits: int = 16,
    seed: int = 7,
    global_timeout: float = 0.0,
) -> BonResult:
    """Simulate one BON aggregation over n learners (1-based ids).

    failed_nodes drop out after Round 1 (they shared secrets, then vanish
    — the worst case the protocol is designed for: survivors must reveal
    the dropouts' pairwise seeds so the server can cancel baked-in pads).
    ``global_timeout`` is added once when there are failures (the server's
    wait before declaring dropouts — the paper subtracts this in Fig. 14).
    """
    n, V = values.shape
    t = threshold if threshold is not None else (n // 2 + 1)
    failed = set(failed_nodes)
    live = [u for u in range(1, n + 1) if u not in failed]
    if len(live) < t:
        raise ValueError("not enough survivors to reach the threshold")
    codec = NpFixedPoint(scale_bits)

    msgs = 0
    nbytes = 0
    vtime = 0.0
    shares_created = 0
    shares_reconstructed = 0

    def barrier(per_node_compute: float, per_node_msgs: int, per_node_bytes: int,
                nodes: int) -> None:
        nonlocal msgs, nbytes, vtime
        msgs += per_node_msgs * nodes
        nbytes += per_node_bytes * nodes
        # server-synchronized round: everyone computes in parallel, then
        # the slowest node's messages land; requests serialize on the
        # controller (same resource model as the SAFE event kernel)
        vtime += (per_node_compute
                  + per_node_msgs * cost.message(per_node_bytes or 64)
                  + per_node_msgs * nodes * cost.t_ctrl)

    # ---- Round 0: advertise keys + pairwise agreement ---------------------
    # Unlike SAFE (whose Round 0 is amortized across many aggregations,
    # §5.2 footnote), BON re-runs key agreement every cycle so dropout
    # recovery stays possible — (n-1) agreements per node per round.
    barrier(cost.t_rsa_encrypt + cost.t_keyagree * (n - 1), 2, 128, n)

    # secrets: per-node self-mask seed b_u and pairwise secret s_u, plus
    # their Shamir shares — canonical draw order shared with the wire
    # learners (bon_secrets), so sim and wire derive identical material
    b_seed, s_seed, b_shares, s_shares = bon_secrets(n, t, seed)

    # ---- Round 1: Shamir-share b_u and s_u to all peers -------------------
    for u in range(1, n + 1):
        shares_created += 2 * (n - 1)
    # each node posts n-1 encrypted share pairs and fetches its n-1
    # incoming shares — individually relayed via the server (the O(n²)
    # message traffic the paper's §2 point 1 complains about)
    barrier(cost.t_share * 2 * (n - 1) + cost.encrypt(64, False) * (n - 1),
            2 * (n - 1), 64 * 2 * (n - 1), n)

    # ---- Round 2: masked input collection --------------------------------
    # pairwise pad between u,v: PRF(s_min XOR s_max tagged) — symmetric.
    def pair_pad(u: int, v: int) -> np.ndarray:
        return bon_pair_pad(s_seed[u], s_seed[v], u, v, V)

    y_sum = np.zeros(V, np.uint32)
    for u in live:
        yu = codec.encode(values[u - 1])
        yu = NpFixedPoint.add(yu, bon_self_pad(b_seed[u], V))
        for v in range(1, n + 1):
            if v == u:
                continue
            pad = pair_pad(u, v)
            yu = NpFixedPoint.add(yu, pad) if u < v else NpFixedPoint.sub(yu, pad)
        y_sum = NpFixedPoint.add(y_sum, yu)
    # per-node: n-1 pad expansions + self mask + encode/add; 1 post msg
    barrier(cost.t_prf_word * V * n + cost.t_add_elem * V * (n + 1) + cost.t_rng_word * V,
            1, 4 * V, len(live))
    if failed:
        vtime += global_timeout  # server waits out the dropouts

    # ---- Rounds 3/4: consistency + unmasking ------------------------------
    # Every survivor fetches the settled roster (the consistency check —
    # which peers made Round 2) and posts, per peer, one share: b_v
    # shares for live v, s_v shares for dead v — one message per share,
    # n messages per survivor in all (bon_expected_messages).
    barrier(cost.t_share * (n - 1), n, 64 * (n - 1) + 4 * n, len(live))

    correction = np.zeros(V, np.uint32)
    for v in live:  # reconstruct b_v from t shares, cancel it
        rec = reconstruct(b_shares[v][: t])
        shares_reconstructed += t
        assert rec == b_seed[v]
        correction = NpFixedPoint.add(
            correction, bon_self_pad(rec, V))
    for v in failed:  # reconstruct s_v, regenerate v's pads with survivors
        rec = reconstruct(s_shares[v][: t])
        shares_reconstructed += t
        assert rec == s_seed[v]
        for u in live:
            pad = pair_pad(u, v)
            # u applied sign(u<v ? + : -) of this pad; cancel it
            correction = NpFixedPoint.add(correction, pad) if u < v \
                else NpFixedPoint.sub(correction, pad)
    # server-side reconstruction compute
    vtime += cost.t_share * shares_reconstructed + \
        cost.t_prf_word * V * (len(live) + len(failed) * len(live))

    total = NpFixedPoint.sub(y_sum, correction)
    avg = codec.decode(total) / len(live)
    # distribute the average (1 get per survivor)
    barrier(0.0, 1, 4 * V, len(live))

    return BonResult(
        average=avg,
        virtual_time=vtime,
        messages=msgs,
        bytes_sent=nbytes,
        shares_created=shares_created,
        shares_reconstructed=shares_reconstructed,
    )
