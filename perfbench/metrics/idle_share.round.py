"""Share of the traced window with no device op (single-session rounds)."""
from perfbench.readings import idle_share as read  # noqa: F401
