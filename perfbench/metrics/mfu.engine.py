"""The window's session-rounds' least time over the window (the engine's cells)."""
from perfbench.readings import round_least_share as read  # noqa: F401
