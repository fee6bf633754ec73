"""The 95th percentile of every round's latency in the window (agg-n36-round)."""
from perfbench.readings import round_p95_ms as read  # noqa: F401
