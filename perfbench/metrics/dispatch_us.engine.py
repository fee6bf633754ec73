"""Host us a repro_torch custom-op call takes (the engine's cells)."""
from perfbench.readings import dispatch_us as read  # noqa: F401
