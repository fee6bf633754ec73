"""Share of the traced window with no device op (train cells)."""
from perfbench.readings import idle_share as read  # noqa: F401
