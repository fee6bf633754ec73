"""Span tracing for round/transfer/chunk lifecycle events.

A :class:`Tracer` is a fixed-capacity ring buffer of :class:`Span`
records — **off by default** so the zero-copy hot path pays exactly one
``if tracer.enabled`` branch per site. Spans carry only small scalars
(names, node/session ids, chunk sequence numbers, monotonic
timestamps): never payload arrays, never buffer references — so the
tracer cannot pin the zero-copy frame views the broker relays
(PROTOCOL.md §12) or alter their lifetime.

The ring buffer bounds memory by construction: a long-lived broker
under heavy load keeps the most recent ``capacity`` spans and silently
drops the oldest (``dropped`` counts them, so an exporter can tell a
quiet broker from a wrapped one).

The PyTorch port's copy of the JAX package's ``obs/trace.py``, with the same
semantics.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional

__all__ = ["Span", "Tracer"]


class Span:
    """One lifecycle event: ``[t0, t1]`` on the broker's monotonic
    clock (``SafeBroker.now()``), plus small scalar attributes."""

    __slots__ = ("name", "t0", "t1", "attrs")

    def __init__(self, name: str, t0: float, t1: float, attrs: dict):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        return {"name": self.name, "t0": self.t0, "t1": self.t1,
                "duration": self.duration, **self.attrs}


class Tracer:
    """Ring-buffer span recorder, disabled unless asked for.

    ``record`` is the only hot-path entry point; callers guard it with
    ``if tracer.enabled`` so a disabled tracer costs one attribute
    load. Attributes must be small scalars (ints/floats/short strings)
    — the tracer asserts nothing at runtime to stay off the hot path,
    the contract is documented here and enforced by the test suite.
    """

    def __init__(self, capacity: int = 2048, enabled: bool = False):
        if capacity <= 0:
            raise ValueError("tracer capacity must be positive")
        self.capacity = capacity
        self.enabled = enabled
        self.dropped = 0
        self._spans: Deque[Span] = deque()

    def record(self, name: str, t0: float, t1: float, **attrs) -> None:
        if not self.enabled:
            return
        if len(self._spans) >= self.capacity:
            self._spans.popleft()
            self.dropped += 1
        self._spans.append(Span(name, t0, t1, attrs))

    def spans(self, name: Optional[str] = None) -> List[Span]:
        if name is None:
            return list(self._spans)
        return [s for s in self._spans if s.name == name]

    def export(self) -> List[dict]:
        """Wire-safe export: plain dicts of plain scalars."""
        return [s.to_dict() for s in self._spans]

    def clear(self) -> None:
        self._spans.clear()
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._spans)
