"""Session-rounds published per second over the window (the engine's cells)."""
from perfbench.readings import rounds_per_s as read  # noqa: F401
