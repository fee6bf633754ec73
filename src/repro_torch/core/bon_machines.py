"""BON learner state machines — generator twins of ``bon_protocol``.

Same yield protocol as :mod:`repro_torch.core.machines` (``("call", op,
kwargs, nbytes)`` / ``("wait", kind, kwargs, nbytes, timeout)``), so
:func:`repro_torch.net.client.drive_learner` runs them over the real broker
unchanged. Each learner replays :func:`bon_protocol.bon_secrets`'s
canonical draw order and uses only its own rows, so every runtime
derives identical secret material and the wire average is bit-identical
to ``run_bon_round`` with the same seed (the pads cancel exactly, so
the published bits are the fixed-point sum of the survivors' encoded
values either way — asserted, not assumed, in
tests/test_conformance.py).

Per-node message trace (the closed form of
``bon_protocol.bon_expected_messages``):

  Round 0   bon_advertise + bon_get_keys                   2
  Round 1   (n−1) bon_post_share + (n−1) bon_get_share     2(n−1)
  — dropouts stop here (``fail_after_round1``) —
  Round 2   bon_post_masked                                1
  Round 3   bon_get_roster + (n−1) bon_post_unmask         n
  Round 4   bon_get_average                                1

The PyTorch port's copy of the JAX package's ``core/bon_machines.py``, with the same
semantics.
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np

from repro_torch.core.bon_controller import seed_from_bytes, seed_to_bytes, \
    share_to_wire
from repro_torch.core.bon_protocol import bon_pair_pad, bon_secrets, bon_self_pad
from repro_torch.crypto.np_impl import NpFixedPoint

#: nominal wire sizes for the yield protocol's nbytes hints (the wire
#: runtime measures real frames; these only feed virtual accounting)
_SHARE_BYTES = 64
_KEY_BYTES = 128


def bon_learner(node: int, n: int, value_row: np.ndarray, *,
                threshold: int, seed: int, scale_bits: int = 16,
                fail_after_round1: bool = False):
    """One BON learner's full round as a generator state machine."""
    b_seed, s_seed, b_shares, s_shares = bon_secrets(n, threshold, seed)
    V = int(value_row.shape[0])
    codec = NpFixedPoint(scale_bits)

    # ---- Round 0: advertise + fetch everyone's advertisement ----------
    yield ("call", "bon_advertise",
           {"node": node, "s_pub": seed_to_bytes(s_seed[node])}, _KEY_BYTES)
    keys = yield ("wait", "bon_get_keys", {"node": node},
                  _KEY_BYTES * n, "aggregation")
    s_pub = {int(u): seed_from_bytes(raw)
             for u, raw in keys["s_pub"].items()}

    # ---- Round 1: post my share pair to each peer, fetch theirs -------
    peers = [v for v in range(1, n + 1) if v != node]
    for v in peers:
        yield ("call", "bon_post_share",
               {"node": node, "to_node": v,
                "b": share_to_wire(b_shares[node][v - 1]),
                "s": share_to_wire(s_shares[node][v - 1])}, _SHARE_BYTES)
    received: Dict[int, dict] = {}
    for v in peers:
        received[v] = yield ("wait", "bon_get_share",
                             {"node": node, "from_node": v},
                             _SHARE_BYTES, "aggregation")

    if fail_after_round1:
        # the worst-case dropout the protocol is designed for: secrets
        # are shared, then the node vanishes before masking its input
        return None

    # ---- Round 2: masked input ----------------------------------------
    yu = codec.encode(value_row)
    yu = NpFixedPoint.add(yu, bon_self_pad(b_seed[node], V))
    for v in peers:
        pad = bon_pair_pad(s_pub[node], s_pub[v], node, v, V)
        yu = (NpFixedPoint.add(yu, pad) if node < v
              else NpFixedPoint.sub(yu, pad))
    yield ("call", "bon_post_masked", {"node": node, "payload": yu}, 4 * V)

    # ---- Round 3: consistency roster + reveal one share per peer ------
    roster = yield ("wait", "bon_get_roster", {"node": node}, 4 * n,
                    "aggregation")
    failed = set(roster["failed"])
    for v in peers:
        # live peer: reveal its b share (cancel its self-mask); dead
        # peer: reveal its s share (server regenerates its pair pads)
        kind = "s" if v in failed else "b"
        xy = received[v][kind]
        yield ("call", "bon_post_unmask",
               {"node": node, "subject": v,
                "x": xy["x"], "y": xy["y"]}, _SHARE_BYTES)

    # ---- Round 4: fetch the published average -------------------------
    res = yield ("wait", "bon_get_average", {"node": node}, 4 * V,
                 "aggregation")
    return np.asarray(res["average"])


def build_bon_machines(values: np.ndarray, *,
                       failed_nodes: Iterable[int] = (),
                       threshold: int, seed: int,
                       scale_bits: int = 16) -> Dict[int, object]:
    """Generators for every node (1-based), dropouts included — unlike
    SAFE's ``build_round_machines``, BON's failed nodes *do* run Rounds
    0–1 (they advertise and share secrets, then vanish)."""
    values = np.asarray(values, np.float32)
    n = values.shape[0]
    failed = {int(x) for x in failed_nodes}
    return {
        u: bon_learner(u, n, values[u - 1], threshold=threshold, seed=seed,
                       scale_bits=scale_bits,
                       fail_after_round1=u in failed)
        for u in range(1, n + 1)
    }
