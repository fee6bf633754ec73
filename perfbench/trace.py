"""Reading a ``torch.profiler`` trace of the measured window.

The raw events (``kineto_results.events()``) are read once into a
``TraceSummary``: device work by name, the union of the device's busy
intervals, host operations' times by name, and the idle gaps with what
the host was doing in each. The metric readers take their numbers from
it. Nothing is written to disk.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import re
from typing import Dict, List, Tuple


@dataclasses.dataclass
class TraceSummary:
    """What the traced window held. Times in seconds."""

    window_s: float
    busy_s: float                                   # union of device activity
    device_s: Dict[str, float]                      # device time by op name
    device_n: Dict[str, int]                        # device launches by op name
    host_s: Dict[str, List[float]]                  # host op durations by name
    idle_by_host: Dict[str, float]                  # idle seconds by host op

    def kernel(self, symbol: str) -> Tuple[int, float]:
        """(launches, device seconds) of the device kernels whose name holds
        the function ``symbol`` (demangled or mangled)."""
        pat = re.compile(rf"(?<![A-Za-z_]){re.escape(symbol)}(?![A-Za-z0-9_])")
        n, s = 0, 0.0
        for name, t in self.device_s.items():
            if pat.search(name):
                n += self.device_n[name]
                s += t
        return n, s

    def device_total_s(self) -> float:
        return sum(self.device_s.values())

    def breakdown(self) -> dict:
        """The ten device ops that took most time and the ten host ops
        during which the device idled longest, as [name, seconds] pairs."""
        top = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[_short(k), v] for k, v in top],
                "idle_gaps": [[_short(k), v] for k, v in gaps]}


def _short(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."


def _has_annotation_flag(ev) -> bool:
    return hasattr(ev, "activity_type") or hasattr(ev, "is_user_annotation")


def _is_annotation(ev, host_names) -> bool:
    """A ``record_function`` range mirrored on the device's timeline, which
    spans the kernels inside it and is no device work of its own."""
    if hasattr(ev, "activity_type"):
        return "annotation" in str(ev.activity_type())
    if hasattr(ev, "is_user_annotation"):
        return bool(ev.is_user_annotation())
    return ev.name() in host_names


WINDOW = "perfbench.window"  # the record_function range around the measured window


def summarize(prof) -> TraceSummary:
    """Summarize a finished ``torch.profiler.profile`` whose measured window
    is the host range named ``WINDOW`` (all of the trace where there is
    none)."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    host_names = ({ev.name() for ev in events if ev.device_type() == DeviceType.CPU}
                  if events and not _has_annotation_flag(events[0]) else set())
    dev: List[Tuple[int, int]] = []
    device_s: Dict[str, float] = collections.defaultdict(float)
    device_n: Dict[str, int] = collections.defaultdict(int)
    host: List[Tuple[int, int, str]] = []
    host_s: Dict[str, List[float]] = collections.defaultdict(list)
    window = None
    for ev in events:
        start, dur = ev.start_ns(), ev.duration_ns()
        kind = ev.device_type()
        if kind == DeviceType.CUDA:
            if _is_annotation(ev, host_names):
                continue
            dev.append((start, start + dur))
            device_s[ev.name()] += dur * 1e-9
            device_n[ev.name()] += 1
        elif kind == DeviceType.CPU:
            if ev.name() == WINDOW:
                window = (start, start + dur)
                continue
            host.append((start, start + dur, ev.name()))
            host_s[ev.name()].append(dur * 1e-9)
    lo, hi = window if window else (
        min([a for a, _ in dev] + [a for a, _, _ in host], default=0),
        max([b for _, b in dev] + [b for _, b, _ in host], default=0))
    merged = _union(dev, lo, hi)
    busy = sum(b - a for a, b in merged) * 1e-9
    gaps = _gaps(merged, lo, hi)
    return TraceSummary(window_s=(hi - lo) * 1e-9,
                        busy_s=busy, device_s=dict(device_s), device_n=dict(device_n),
                        host_s=dict(host_s), idle_by_host=_attribute(gaps, host))


def _union(intervals: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of intervals clipped to [lo, hi], as sorted disjoint ones."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _gaps(merged: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    gaps, t = [], lo
    for a, b in merged:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def _attribute(gaps: List[Tuple[int, int]], host: List[Tuple[int, int, str]]) -> Dict[str, float]:
    """Idle seconds by the innermost host op running at each gap's middle
    ("host: no op traced" where none ran)."""
    host = sorted(host)
    starts = [h[0] for h in host]
    out: Dict[str, float] = collections.defaultdict(float)
    for a, b in gaps:
        mid = (a + b) // 2
        # innermost: the latest-starting op that still runs at mid; ops nest
        # on a thread, so walking back from the last start before mid finds it
        i = bisect.bisect_right(starts, mid) - 1
        name = "host: no op traced"
        for j in range(i, max(i - 4096, -1), -1):
            s, e, nm = host[j]
            if e >= mid:
                name = nm
                break
        out[name] += (b - a) * 1e-9
    return dict(out)
