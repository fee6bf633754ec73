"""BON server state — the Bonawitz-style baseline's aggregator.

The transport-free twin of :class:`repro_torch.core.controller.Controller`,
but for the 4-round pairwise-masking protocol of
``core/bon_protocol.py``: where SAFE's broker is a *mere message
broker* (the paper's point), BON's server is a protocol participant —
it collects Shamir shares, settles the Round-2 roster, reconstructs
dropped-out nodes' secrets and computes the unmasked average itself.
Driving this controller through ``repro_torch/net/broker.py`` puts that
asymmetry on the same transport as SAFE so the two protocols can be
benchmarked head-to-head (benchmarks/bon_wire.py).

Op registry mirrors the SAFE one (``CALL_OPS``/``WAIT_KINDS``): call
ops apply immediately, wait kinds are probe/consume long-polls, and
every successful counted op increments :class:`BonStats` — one counter
per op, summing to the closed form ``bon_protocol.bon_expected_messages``
(the BON analogue of SAFE's §5 accounting, asserted in
tests/test_conformance.py).

Fidelity note: like the sim, this models BON's *traffic and cost*, not
its cryptographic soundness — the Round-0 "key advertisement" carries
the pairwise seed itself in place of a DH public key (the toy pad
derivation needs both endpoints' seeds), so the dropout-recovery path
reconstructs ``s_v`` from the posted Shamir shares and cross-checks it
against the advertisement. The live path's ``b_v`` recovery is
genuinely share-driven: b seeds are never advertised, so unmasking
cannot complete without the Round-1/Round-3 share traffic.

The PyTorch port's copy of the JAX package's ``core/bon_controller.py``, with the same
semantics.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.bon_protocol import bon_pair_pad, bon_self_pad
from repro_torch.core.shamir import P, reconstruct
from repro_torch.crypto.np_impl import NpFixedPoint

#: fire-and-forget client ops (the wire broker applies them under the
#: session condition and notifies waiters)
BON_CALL_OPS = ("bon_advertise", "bon_post_share", "bon_post_masked",
                "bon_post_unmask")

#: long-poll kinds (probe/consume discipline, like WAIT_KINDS)
BON_WAIT_KINDS = ("bon_get_keys", "bon_get_share", "bon_get_roster",
                  "bon_get_average")

BON_OPS = BON_CALL_OPS + BON_WAIT_KINDS

#: ops the broker stamps with its wall clock — the roster settles
#: ``roster_timeout`` after the first masked input when dropouts leave
#: the round short (the server-side dropout wait of bon_protocol's
#: ``global_timeout``)
BON_TIMED_OPS = ("bon_post_masked",)


def seed_to_bytes(seed: int) -> bytes:
    """64-bit seed as wire bytes (the int tag is signed 64-bit)."""
    return int(seed).to_bytes(8, "big")


def seed_from_bytes(raw: bytes) -> int:
    return int.from_bytes(raw, "big")


def share_to_wire(xy: Tuple[int, int]) -> dict:
    """One Shamir share as wire kwargs — y is a GF(2^127−1) element,
    beyond the signed-64-bit int tag, so it travels as 16 bytes."""
    x, y = xy
    return {"x": int(x), "y": int(y).to_bytes(16, "big")}

def share_from_wire(d: dict) -> Tuple[int, int]:
    y = int.from_bytes(d["y"], "big")
    if not 0 <= y < P:
        raise ValueError(f"share y {y} outside GF(2^127-1)")
    return int(d["x"]), y


@dataclasses.dataclass
class BonStats:
    """One counter per counted BON op (the §5-style accounting for the
    baseline; summed by ``total``). Field names are exactly ``BON_OPS``
    — the doc-sync test pins PROTOCOL.md's counted column to them."""

    bon_advertise: int = 0
    bon_post_share: int = 0
    bon_post_masked: int = 0
    bon_post_unmask: int = 0
    bon_get_keys: int = 0
    bon_get_share: int = 0
    bon_get_roster: int = 0
    bon_get_average: int = 0

    @property
    def total(self) -> int:
        return sum(getattr(self, f.name) for f in dataclasses.fields(self))


class BonController:
    """Server state for one BON aggregation round over ``nodes``.

    ``roster_timeout`` (wall seconds) is how long the server waits after
    the first masked input before declaring the missing nodes dropped —
    the roster settles immediately when all n arrive, so clean rounds
    never pay it. ``maybe_close_roster(now)`` is ticked by the broker's
    monitor loop (and by ``bon_post_masked`` itself) since nothing else
    wakes the parked roster waits when only time passes.
    """

    def __init__(self, nodes: List[int], threshold: Optional[int] = None,
                 roster_timeout: float = 1.0, scale_bits: int = 16):
        self.nodes = sorted(int(x) for x in nodes)
        if len(set(self.nodes)) != len(self.nodes) or not self.nodes:
            raise ValueError(f"bad BON node set {nodes!r}")
        n = len(self.nodes)
        self.threshold = int(threshold) if threshold else (n // 2 + 1)
        if not 1 <= self.threshold <= n:
            raise ValueError(
                f"threshold {self.threshold} outside [1, {n}]")
        self.roster_timeout = float(roster_timeout)
        self.scale_bits = int(scale_bits)
        self.stats = BonStats()
        # Round 0: node -> advertised s_pub (the toy pairwise seed)
        self.keys: Dict[int, bytes] = {}
        # Round 1: (src, dst) -> {"b": share, "s": share} wire dicts
        self.shares: Dict[Tuple[int, int], dict] = {}
        # Round 2: node -> masked uint32 vector
        self.masked: Dict[int, np.ndarray] = {}
        self.first_masked_at: Optional[float] = None
        # Round 3 input: settled {"live": [...], "failed": [...]}
        self.roster: Optional[dict] = None
        # (src, subject) -> (x, y) revealed share
        self.unmask: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self._unmask_counts: Dict[int, int] = {}
        self.average: Optional[np.ndarray] = None
        self.shares_reconstructed = 0

    # -- dispatch (same shape as Controller.call/probe/consume) ---------
    def call(self, op: str, **kwargs):
        if op not in BON_CALL_OPS:
            raise ValueError(f"unknown BON call op {op!r}")
        res = getattr(self, op)(**kwargs)
        setattr(self.stats, op, getattr(self.stats, op) + 1)
        return res

    def probe(self, kind: str, **kwargs):
        if kind not in BON_WAIT_KINDS:
            raise ValueError(f"unknown BON wait kind {kind!r}")
        return getattr(self, f"try_{kind}")(**kwargs)

    def consume(self, kind: str, **kwargs):
        res = self.probe(kind, **kwargs)
        if res is None:
            raise ValueError(f"consume {kind} with nothing to consume")
        setattr(self.stats, kind, getattr(self.stats, kind) + 1)
        return res

    def _check_node(self, node) -> int:
        node = int(node)
        if node not in self.nodes:
            raise ValueError(f"node {node} not in this BON round")
        return node

    # -- Round 0: key advertisement -------------------------------------
    def bon_advertise(self, node: int, s_pub: bytes) -> None:
        self.keys[self._check_node(node)] = bytes(s_pub)

    def try_bon_get_keys(self, node: int) -> Optional[dict]:
        self._check_node(node)
        if len(self.keys) < len(self.nodes):
            return None
        return {"s_pub": dict(self.keys)}

    # -- Round 1: share relay -------------------------------------------
    def bon_post_share(self, node: int, to_node: int, b: dict,
                       s: dict) -> None:
        src = self._check_node(node)
        dst = self._check_node(to_node)
        # validate at the boundary — a malformed share would otherwise
        # only blow up inside the final reconstruction
        share_from_wire(b), share_from_wire(s)
        self.shares[(src, dst)] = {"b": dict(b), "s": dict(s)}

    def try_bon_get_share(self, node: int, from_node: int) -> Optional[dict]:
        dst = self._check_node(node)
        src = self._check_node(from_node)
        entry = self.shares.get((src, dst))
        return None if entry is None else dict(entry)

    # -- Round 2: masked input collection -------------------------------
    def bon_post_masked(self, node: int, payload: np.ndarray,
                        now: float = 0.0) -> None:
        node = self._check_node(node)
        arr = np.asarray(payload)
        if arr.dtype != np.uint32 or arr.ndim != 1:
            raise ValueError("masked input must be a flat uint32 vector")
        if self.masked and arr.shape != next(iter(self.masked.values())).shape:
            raise ValueError("masked input length mismatch")
        self.masked[node] = arr
        if self.first_masked_at is None:
            self.first_masked_at = float(now)
        self.maybe_close_roster(float(now))

    def maybe_close_roster(self, now: float) -> bool:
        """Settle the Round-2 roster: immediately once every node posted,
        or ``roster_timeout`` after the first masked input when at least
        ``threshold`` survivors made it. Returns True when the roster
        transitioned (the broker then notifies parked waits)."""
        if self.roster is not None:
            return False
        if len(self.masked) == len(self.nodes):
            pass  # everyone made it — no dropout wait
        elif (self.first_masked_at is not None
              and len(self.masked) >= self.threshold
              and now >= self.first_masked_at + self.roster_timeout):
            pass  # dropouts declared after the server's wait
        else:
            return False
        live = sorted(self.masked)
        self.roster = {"live": live,
                       "failed": sorted(set(self.nodes) - set(live))}
        return True

    def try_bon_get_roster(self, node: int) -> Optional[dict]:
        self._check_node(node)
        if self.roster is None:
            return None
        return {"live": list(self.roster["live"]),
                "failed": list(self.roster["failed"])}

    # -- Rounds 3/4: unmask share reveal + server-side recovery ----------
    def bon_post_unmask(self, node: int, subject: int, x: int,
                        y: bytes) -> None:
        src = self._check_node(node)
        subject = self._check_node(subject)
        if self.roster is None:
            raise ValueError("unmask share before the roster settled")
        if src not in self.roster["live"]:
            raise ValueError(f"node {src} is not a survivor")
        xy = share_from_wire({"x": x, "y": y})
        if (src, subject) not in self.unmask:
            self._unmask_counts[src] = self._unmask_counts.get(src, 0) + 1
        self.unmask[(src, subject)] = xy
        n = len(self.nodes)
        done = all(self._unmask_counts.get(u, 0) >= n - 1
                   for u in self.roster["live"])
        if done and self.average is None:
            self._publish()

    def _subject_shares(self, subject: int) -> list:
        """The revealed shares for one subject, lowest x first — the
        deterministic ``[:threshold]`` slice the sim reconstructs from."""
        got = [xy for (src, subj), xy in self.unmask.items()
               if subj == subject]
        got.sort()
        if len(got) < self.threshold:
            raise ValueError(
                f"only {len(got)} shares for node {subject}, "
                f"threshold {self.threshold}")
        return got[: self.threshold]

    def _publish(self) -> None:
        """The server-side compute SAFE's broker never does: Shamir
        recovery per node, pad regeneration for dropouts, unmask, and
        average publication — bit-identical to ``run_bon_round``'s
        server loop given the same secrets."""
        live = self.roster["live"]
        failed = self.roster["failed"]
        V = next(iter(self.masked.values())).shape[0]
        y_sum = np.zeros(V, np.uint32)
        for u in live:
            y_sum = NpFixedPoint.add(y_sum, self.masked[u])
        correction = np.zeros(V, np.uint32)
        for v in live:  # b_v from its revealed shares; cancel self-mask
            b_v = reconstruct(self._subject_shares(v))
            self.shares_reconstructed += self.threshold
            correction = NpFixedPoint.add(correction, bon_self_pad(b_v, V))
        s_pub = {u: seed_from_bytes(raw) for u, raw in self.keys.items()}
        for v in failed:  # s_v back from shares; regenerate v's pads
            s_v = reconstruct(self._subject_shares(v))
            self.shares_reconstructed += self.threshold
            if s_v != s_pub[v]:
                raise ValueError(
                    f"reconstructed s for node {v} contradicts its "
                    f"Round-0 advertisement (inconsistent shares)")
            for u in live:
                pad = bon_pair_pad(s_pub[u], s_v, u, v, V)
                correction = (NpFixedPoint.add(correction, pad) if u < v
                              else NpFixedPoint.sub(correction, pad))
        total = NpFixedPoint.sub(y_sum, correction)
        codec = NpFixedPoint(self.scale_bits)
        self.average = codec.decode(total) / len(live)

    def try_bon_get_average(self, node: int) -> Optional[dict]:
        self._check_node(node)
        if self.average is None:
            return None
        return {"average": self.average}

    # -- observability ---------------------------------------------------
    def stats_dict(self) -> dict:
        out = dataclasses.asdict(self.stats)
        out["total"] = self.stats.total
        out["shares_reconstructed"] = self.shares_reconstructed
        out["protocol"] = "bon"
        return out
