"""Pluggable transport faults for the wire runtime.

Interceptors sit inside :class:`repro_torch.net.client.WireClient` around each
request/response and perturb the transport the way the paper's
evaluation perturbs its testbed: latency (the deep-edge profiles of
§7), request loss, and learner crash/churn schedules (§5.3–5.4). They
never touch protocol state — failover is exercised end-to-end through
the *real* monitor/repost/re-election machinery on the broker.

Hook contract (all coroutines, called by the client):

  ``on_request(node, op, nbytes)``  before a request frame is sent.
    May sleep (latency), raise :class:`DropPacket` (the frame never
    leaves the host; the client backs off and retries — safe because
    the broker never saw it), or raise :class:`LearnerCrashed` (the
    learner runtime stops driving this node's state machine mid-round).
    Chunked transfers (docs/PROTOCOL.md §6) pass through the same hook
    one frame at a time (``op`` is ``post_chunk``/``get_chunk``), so a
    drop loses a single chunk (retried) and a churn schedule can kill a
    learner mid-upload — both exercised in tests/test_net.py.
  ``on_response(node, op, nbytes)`` after a response frame is read.
    May sleep. Drops are deliberately *not* supported here: the broker
    has already executed the (possibly consuming) op, so retrying would
    need request dedup — out of scope, and the paper's failure model
    (node crashes, not byzantine links) doesn't need it.

Fault draws use a seeded ``numpy`` RNG keyed by (seed, node), so within
one round runtime a learner's fault plan is reproducible regardless of
asyncio interleaving. One interceptor instance covers one tenant's
round: sharing an instance across concurrent tenants whose learners
reuse node ids would interleave draws from the shared per-node streams
in scheduler order — give each tenant its own instance (seeded per
tenant) when reproducibility across tenants matters, e.g. via the
factory form ``interceptor=lambda t: ...`` of the JAX package's load
harness (``loadgen``, not ported yet).

The PyTorch port's copy of the JAX package's ``net/faults.py``, with the same
semantics.
"""
from __future__ import annotations

import asyncio
from typing import Dict, Iterable, Optional, Tuple

import numpy as np


class DropPacket(Exception):
    """Raised by an interceptor: this request frame is lost in transit."""


class LearnerCrashed(Exception):
    """Raised by an interceptor: this learner dies now (churn schedule)."""

    def __init__(self, node: int, after_ops: int):
        super().__init__(f"learner {node} crashed after {after_ops} ops")
        self.node = node
        self.after_ops = after_ops


class Interceptor:
    """Base: a transparent transport."""

    async def on_request(self, node: int, op: str, nbytes: int) -> None:
        return None

    async def on_response(self, node: int, op: str, nbytes: int) -> None:
        return None


class Chain(Interceptor):
    """Compose interceptors; hooks run in order."""

    def __init__(self, *parts: Interceptor):
        self.parts = parts

    async def on_request(self, node, op, nbytes):
        for p in self.parts:
            await p.on_request(node, op, nbytes)

    async def on_response(self, node, op, nbytes):
        for p in self.parts:
            await p.on_response(node, op, nbytes)


def _node_rng(seed: int, node: int) -> np.random.RandomState:
    return np.random.RandomState((seed * 1_000_003 + node) % 2**31)


class LatencyInterceptor(Interceptor):
    """Per-packet delay: ``floor + Exp(mean)`` seconds, independently on
    the request and response path (so one RPC pays two draws, like a
    real RTT). Deterministic per node for a given seed."""

    def __init__(self, mean: float = 0.002, floor: float = 0.0,
                 seed: int = 0):
        self.mean = mean
        self.floor = floor
        self.seed = seed
        self._rngs: Dict[int, np.random.RandomState] = {}

    def _draw(self, node: int) -> float:
        rng = self._rngs.get(node)
        if rng is None:
            rng = self._rngs[node] = _node_rng(self.seed, node)
        return self.floor + float(rng.exponential(self.mean))

    async def on_request(self, node, op, nbytes):
        await asyncio.sleep(self._draw(node))

    async def on_response(self, node, op, nbytes):
        await asyncio.sleep(self._draw(node))


class DropInterceptor(Interceptor):
    """Drop request frames with probability ``p`` (client retries after
    backoff). Only the request path — see module docstring."""

    def __init__(self, p: float = 0.05, seed: int = 0):
        if not 0.0 <= p < 1.0:
            raise ValueError(f"drop probability must be in [0, 1), got {p}")
        self.p = p
        self.seed = seed
        self._rngs: Dict[int, np.random.RandomState] = {}
        self.dropped = 0

    async def on_request(self, node, op, nbytes):
        rng = self._rngs.get(node)
        if rng is None:
            rng = self._rngs[node] = _node_rng(self.seed, node)
        if rng.uniform() < self.p:
            self.dropped += 1
            raise DropPacket(f"request {op} from node {node} dropped")


class ChurnInterceptor(Interceptor):
    """Crash schedule: node ``i`` dies just before issuing its
    ``crash_after[i] + 1``-th request (ops counted per node across its
    whole round, long-polls included). A crashed learner simply stops —
    its unconsumed postings and silent long-poll targets are what drive
    the broker's §5.3 repost / §5.4 re-election machinery."""

    def __init__(self, crash_after: Dict[int, int]):
        self.crash_after = dict(crash_after)
        self._ops: Dict[int, int] = {}
        self.crashed: set = set()

    async def on_request(self, node, op, nbytes):
        limit = self.crash_after.get(node)
        if limit is None:
            return
        done = self._ops.get(node, 0)
        if done >= limit:
            self.crashed.add(node)
            raise LearnerCrashed(node, done)
        self._ops[node] = done + 1


class HeavyTailLatencyInterceptor(Interceptor):
    """Per-packet delay ``floor + LogNormal(median, sigma)`` seconds —
    the heavy-tailed WAN regime (bufferbloat, cellular links) whose p99
    an exponential model badly understates. Parameterized by the
    *median* one-way delay: for ``X = median · exp(sigma·Z)`` with
    standard-normal Z, the declared analytic percentiles are

        p50 = median,   p(q) = median · exp(sigma · z_q)

    (z_90 ≈ 1.2816, z_99 ≈ 2.3263) — pinned within sampling tolerance
    by the property tests in tests/test_faults.py, so WAN benchmark
    rows annotate a distribution the code actually draws from.
    Deterministic per (seed, node), like :class:`LatencyInterceptor`.
    """

    #: standard-normal quantiles for the declared-percentile contract
    Z90 = 1.2816
    Z99 = 2.3263

    def __init__(self, median: float = 0.05, sigma: float = 0.8,
                 floor: float = 0.0, seed: int = 0):
        if median <= 0 or sigma <= 0:
            raise ValueError("median and sigma must be positive")
        self.median = median
        self.sigma = sigma
        self.floor = floor
        self.seed = seed
        self._rngs: Dict[int, np.random.RandomState] = {}

    def declared_percentile(self, q: float) -> float:
        """Analytic one-way-delay percentile (seconds), floor included.
        Only p50/p90/p99 are declared — a full inverse normal CDF is
        more precision than the contract needs."""
        z = {50.0: 0.0, 90.0: self.Z90, 99.0: self.Z99}.get(float(q))
        if z is None:
            raise ValueError(f"declared percentiles are 50/90/99, not {q}")
        return self.floor + self.median * float(np.exp(self.sigma * z))

    def _draw(self, node: int) -> float:
        rng = self._rngs.get(node)
        if rng is None:
            rng = self._rngs[node] = _node_rng(self.seed, node)
        return self.floor + float(
            self.median * np.exp(self.sigma * rng.standard_normal()))

    async def on_request(self, node, op, nbytes):
        await asyncio.sleep(self._draw(node))

    async def on_response(self, node, op, nbytes):
        await asyncio.sleep(self._draw(node))


#: WAN calibration profiles: named link regimes spanning the
#: paper-relevant 10–200 ms RTT range, with loss and tail shape. Each
#: value is metadata — ``make_wan_interceptor`` turns a profile into a
#: fresh interceptor chain (one per tenant; see module docstring), and
#: benchmark rows annotate these declared numbers next to measured
#: wall-clock (an honest-measurement convention). ``rtt_ms`` is the nominal
#: round-trip: one RPC pays two one-way draws of rtt/2 each.
WAN_PROFILES: Dict[str, dict] = {
    # clean metro fiber: low RTT, no loss, light exponential jitter
    "metro": {"kind": "exp", "rtt_ms": 10.0, "loss": 0.0},
    # cross-continent: moderate RTT, occasional loss
    "continental": {"kind": "exp", "rtt_ms": 50.0, "loss": 0.01},
    # intercontinental + bufferbloat: 200 ms RTT, lossy, lognormal tail
    # (sigma 0.8: declared p99 ≈ 6.4x the median one-way delay)
    "intercontinental_tail": {"kind": "lognormal", "rtt_ms": 200.0,
                              "loss": 0.02, "sigma": 0.8},
}


def make_wan_interceptor(profile: str, seed: int = 0) -> Interceptor:
    """Instantiate one WAN profile as an interceptor chain.

    ``exp`` profiles draw ``floor + Exp(mean)`` per direction with
    ``floor = mean = rtt/4`` (so the *mean* one-way delay is rtt/2 and
    the nominal RTT is paid per RPC on average); ``lognormal`` profiles
    put the one-way *median* at rtt/2 — the tail runs far beyond the
    nominal RTT, which is the point. Loss applies on the request path
    (client retries behind deterministic backoff).
    """
    meta = WAN_PROFILES.get(profile)
    if meta is None:
        raise ValueError(
            f"unknown WAN profile {profile!r} (have {sorted(WAN_PROFILES)})")
    one_way = meta["rtt_ms"] / 2e3  # seconds
    if meta["kind"] == "exp":
        lat: Interceptor = LatencyInterceptor(
            mean=one_way / 2, floor=one_way / 2, seed=seed)
    else:
        lat = HeavyTailLatencyInterceptor(
            median=one_way, sigma=meta["sigma"], seed=seed)
    if meta["loss"] > 0:
        return Chain(lat, DropInterceptor(p=meta["loss"], seed=seed + 1))
    return lat


def deep_edge_faults(seed: int = 0, mean_latency: float = 0.02,
                     drop_p: float = 0.02,
                     crash_after: Optional[Dict[int, int]] = None
                     ) -> Interceptor:
    """Convenience preset: lossy high-latency edge links plus an
    optional churn schedule — the §7 constrained-platform flavour."""
    parts: Tuple[Interceptor, ...] = (
        LatencyInterceptor(mean=mean_latency, seed=seed),
        DropInterceptor(p=drop_p, seed=seed + 1),
    )
    if crash_after:
        parts = parts + (ChurnInterceptor(crash_after),)
    return Chain(*parts)
