"""The window's rounds' least time over the window (single-session rounds)."""
from perfbench.readings import round_least_share as read  # noqa: F401
