"""Session-rounds published per second over the window (agg-n36-round)."""
from perfbench.readings import rounds_per_s as read  # noqa: F401
