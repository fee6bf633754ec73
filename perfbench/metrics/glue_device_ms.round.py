"""Device ms a round outside the SAFE kernels (single-session rounds)."""
from perfbench.readings import glue_device_ms as read  # noqa: F401
