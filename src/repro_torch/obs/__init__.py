"""Observability plane: dependency-free metrics + tracing.

``repro_torch.obs`` deliberately imports nothing from ``repro_torch.net`` or
``repro_torch.core`` — it is the leaf layer both instrument. See
ARCHITECTURE.md §Observability.

The PyTorch port's copy of the JAX package's ``obs/__init__.py``, with the same
semantics.
"""
from repro_torch.obs.metrics import (
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.trace import Span, Tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS",
    "Span",
    "Tracer",
]
