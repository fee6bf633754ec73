"""Dependency-free metrics primitives for the wire plane.

Three series types, all safe to update from the asyncio hot path
without locks — the broker's event loop is single-threaded, every
update is a couple of int/float ops, and nothing here ever awaits:

  * :class:`Counter` — monotonic; ``inc`` only.
  * :class:`Gauge` — settable point-in-time value.
  * :class:`Histogram` — fixed log-spaced buckets with cumulative
    counts; p50/p99 (any percentile) extracted by walking the
    cumulative distribution and interpolating inside the bucket.
    Fixed buckets keep ``observe`` O(len(buckets)) with zero
    allocation — no reservoir, no quantile sketch, no numpy on the
    hot path.

:class:`MetricsRegistry` is the per-broker namespace: get-or-create by
name, a picklable :meth:`~MetricsRegistry.snapshot` for the wire
``get_metrics`` op, and :meth:`~MetricsRegistry.render_prometheus` for
the optional plaintext HTTP exporter (Prometheus text exposition
format, stdlib only).

Observability observes: nothing in this module touches frames,
payloads, or the §5 message counters.

The PyTorch port's copy of the JAX package's ``obs/metrics.py``, with the same
semantics.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS",
]

# Upper bounds (seconds) for round/transfer latency histograms:
# ~log-spaced from 1ms to 60s, +Inf implicit. Chosen to resolve both
# localhost microbenchmark rounds (single-digit ms) and WAN-profile
# rounds under LatencyInterceptor (seconds).
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Counter:
    """Monotonic counter. ``inc`` only — resets don't exist (rates are
    the consumer's job, deltas are :class:`~repro_torch.net.client
    .PersistentNetSession`-style subtraction)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value (active sessions, backlog bytes)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Fixed-bucket histogram with percentile extraction.

    ``bounds`` are inclusive upper bounds; an implicit +Inf bucket
    catches the tail. ``counts[i]`` is the number of observations with
    ``v <= bounds[i]`` (non-cumulative storage; cumulated on read).
    """

    __slots__ = ("name", "bounds", "counts", "count", "sum")

    def __init__(self, name: str,
                 bounds: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        self.name = name
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError(f"histogram bounds must be sorted: {bounds}")
        self.counts = [0] * (len(self.bounds) + 1)  # +1: the +Inf bucket
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def percentile(self, p: float) -> float:
        """Approximate percentile (0..100) by linear interpolation
        inside the containing bucket. Empty histogram -> 0.0; tail
        (+Inf) bucket -> the largest finite bound (a floor, reported
        rather than inventing an upper edge)."""
        if self.count == 0:
            return 0.0
        rank = (p / 100.0) * self.count
        seen = 0
        lo = 0.0
        for i, b in enumerate(self.bounds):
            c = self.counts[i]
            if seen + c >= rank and c > 0:
                frac = (rank - seen) / c
                return lo + frac * (b - lo)
            seen += c
            lo = b
        return self.bounds[-1] if self.bounds else 0.0

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "p50": self.percentile(50.0),
            "p99": self.percentile(99.0),
            "buckets": [[b, c] for b, c in zip(self.bounds, self.counts)]
                       + [[float("inf"), self.counts[-1]]],
        }


class MetricsRegistry:
    """Per-broker namespace of series, get-or-create by name.

    One registry per :class:`~repro_torch.net.broker.SafeBroker` (so each
    ``ShardBroker`` worker process reports its own shard's series —
    ``get_metrics`` without a ``session`` kwarg is answered by
    whichever worker the socket reaches, and the response names its
    shard).
    """

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(
                name, bounds if bounds is not None
                else DEFAULT_LATENCY_BUCKETS)
        return h

    def snapshot(self) -> dict:
        """Wire-safe snapshot: plain dicts of plain scalars/lists —
        exactly what the codec's value tags can carry."""
        return {
            "counters": {n: c.value for n, c in self._counters.items()},
            "gauges": {n: float(g.value) for n, g in self._gauges.items()},
            "histograms": {n: h.to_dict()
                           for n, h in self._histograms.items()},
        }

    def render_prometheus(self, prefix: str = "",
                          labels: str = "") -> str:
        """Prometheus text exposition format (0.0.4), stdlib only.

        ``labels`` is a pre-rendered label body like
        ``shard="2"`` applied to every series.
        """
        lab = "{%s}" % labels if labels else ""
        lines: List[str] = []
        for n, c in sorted(self._counters.items()):
            lines.append(f"# TYPE {prefix}{n} counter")
            lines.append(f"{prefix}{n}{lab} {c.value}")
        for n, g in sorted(self._gauges.items()):
            lines.append(f"# TYPE {prefix}{n} gauge")
            lines.append(f"{prefix}{n}{lab} {float(g.value)}")
        for n, h in sorted(self._histograms.items()):
            lines.append(f"# TYPE {prefix}{n} histogram")
            cum = 0
            for b, c in zip(h.bounds, h.counts):
                cum += c
                le = f'le="{b}"'
                body = f"{labels},{le}" if labels else le
                lines.append(f"{prefix}{n}_bucket{{{body}}} {cum}")
            cum += h.counts[-1]
            le = 'le="+Inf"'
            body = f"{labels},{le}" if labels else le
            lines.append(f"{prefix}{n}_bucket{{{body}}} {cum}")
            lines.append(f"{prefix}{n}_sum{lab} {h.sum}")
            lines.append(f"{prefix}{n}_count{lab} {h.count}")
        return "\n".join(lines) + "\n"
