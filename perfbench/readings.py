"""What the metric readers of more than one cell share (each reader in
``metrics/<name>.py`` names one of these as its ``read``). Each takes the
run's ``harness.Run`` and returns None where the run has nothing to read.
"""
from __future__ import annotations

import numpy as np

from perfbench.work import KERNEL_SYMBOLS


def rounds_per_s(run):
    """Session-rounds published per second over the whole measured window."""
    return run.units / run.window_s if run.units and run.window_s > 0 else None


def round_p95_ms(run):
    """The 95th percentile of every session-round's latency in the window,
    from all of the run's own samples (linear between order statistics)."""
    return float(np.percentile(run.latencies_s, 95) * 1e3) if run.latencies_s else None


def glue_device_ms(run):
    """Device milliseconds a session-round spends outside the SAFE kernels:
    ring adds and subtractions, decode and divide, row gathers, stacks and
    copies (every device op in the traced window but the four kernels)."""
    tr = run.trace
    if tr is None or not run.units or tr.device_total_s() <= 0:
        return None
    kernels = sum(tr.kernel(sym)[1] for sym in KERNEL_SYMBOLS.values())
    return (tr.device_total_s() - kernels) / run.units * 1e3


def dispatch_us(run):
    """Host microseconds a call of a ``repro_torch::*`` custom op takes from
    the dispatcher's entry to its return (profiler host op events)."""
    tr = run.trace
    if tr is None:
        return None
    t = [d for name, ds in tr.host_s.items() if name.startswith("repro_torch::") for d in ds]
    return sum(t) / len(t) * 1e6 if t else None


def round_least_share(run):
    """The whole round's share of the card's peaks: the least time of the
    window's session-rounds (work.round_work: bytes at HBM bandwidth or
    operations at the issue rate, whichever is longer) over the window."""
    if run.trace is None or run.window_s <= 0 or run.least_s <= 0:
        return None
    return run.least_s / run.window_s * 100


def idle_share(run):
    """Share of the traced window in which no operation ran on the device."""
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return (1 - tr.busy_s / tr.window_s) * 100
