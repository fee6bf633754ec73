"""The allocator's peak over the measured window (max_memory_allocated,
reset at the window's start), in GB."""


def read(run):
    return run.window_peak_bytes / 1e9 if run.window_peak_bytes else None
