"""Device ms a session-round outside the SAFE kernels (the engine's cells)."""
from perfbench.readings import glue_device_ms as read  # noqa: F401
