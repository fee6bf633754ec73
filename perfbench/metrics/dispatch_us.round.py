"""Host us a repro_torch custom-op call takes (single-session rounds)."""
from perfbench.readings import dispatch_us as read  # noqa: F401
