"""The 95th percentile of every session-round's latency, submission to published mean (the engine's cells)."""
from perfbench.readings import round_p95_ms as read  # noqa: F401
