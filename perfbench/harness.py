"""The benchmark's harness: one run of one cell, driven by data.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix. Everything that belongs to one of them sits in files of its
own, found by name:

- ``BENCHMARK.json``'s ``configs`` entry gives the configuration's file
  (``perfbench/configs/<config>.json``);
- ``perfbench/traffic/<traffic>.json`` holds the mix's parameters; its
  ``kind`` names the general driver that reads it
  (``perfbench/drivers/<kind>.py``);
- ``perfbench/metrics/<metric>.py`` reads one metric, end-to-end or
  per-layer, from the run (``read(run)``; None where it finds nothing);
- ``perfbench/reference/`` holds the plain references the drivers hold
  the outputs against;
- ``perfbench/limits/<cell>.json`` holds the limit of each number the
  cell's check compares, set from that cell's own readings.

A run: the driver builds the inputs from ``--seed`` on the device and the
system under test, warms up the cell's shapes (set-up, timed from the
process's start), runs the closed loop for ``--seconds`` (under
``torch.profiler`` with ``--trace 1``), reads the memory peak, frees the
program's state, checks the outputs against the reference, and the
harness prints one JSON line: ``correct``, ``attempted``, ``failed``,
``metrics`` (the end-to-end ones, or with ``--trace 1`` the per-layer
ones), ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``:
each number compared, with its limit.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "perfbench"

#: Top-level module names no run may hold: JAX and the JAX package of SAFE.
#: Compared whole, so the port (``repro_torch``) passes.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


# ---- finding things by name --------------------------------------------------------

def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(have {[c['name'] for c in spec['workloads']]})")


def load_config(spec: dict, name: str, root: Path = ROOT) -> dict:
    for entry in spec["configs"]:
        if entry["name"] == name:
            return json.loads((root / entry["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def load_limits(cell: str) -> dict:
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())["limits"]


def load_reader(metric: str) -> Callable[["Run"], Optional[float]]:
    """``read`` of ``perfbench/metrics/<metric>.py`` (loaded by path: a
    metric's name may hold dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench.metrics._{len(metric)}_"
                                                  + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_driver(kind: str):
    return importlib.import_module(f"perfbench.drivers.{kind}")


def metrics_of(spec: dict, cell: str, section: str) -> List[dict]:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that this
    cell reports: those that list it, and those that list no cells."""
    return [m for m in spec[section] if cell in m.get("workloads", [cell])]


# ---- what a run hands the metric readers -------------------------------------------

@dataclasses.dataclass
class Run:
    """One run's readings. Times in seconds unless named otherwise."""

    traffic: dict
    setup_s: float = 0.0
    window_s: float = 0.0          # the measured window: first call to last result
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    units: int = 0                 # session-rounds or steps completed in the window
    tokens: int = 0                # training tokens of the window's steps
    least_s: float = 0.0           # the window's work at the card's peaks (work.py)
    flops: float = 0.0             # model FLOPs of the window's steps
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    parts: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    window_peak_bytes: int = 0
    trace: Any = None              # trace.TraceSummary with --trace 1


class Spans:
    """Host-clock spans the harness records around calls into the program,
    by name; under the profiler also as ``record_function`` ranges."""

    def __init__(self, profiling: bool = False):
        self.times: Dict[str, List[float]] = {}
        self.profiling = profiling

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = (torch.profiler.record_function(f"perfbench.{name}") if self.profiling
              else contextlib.nullcontext())
        t = time.perf_counter()
        with rf:
            yield
        self.times.setdefault(name, []).append(time.perf_counter() - t)


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit (pass: at or
    under it)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit  # NaN fails


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ---- one run ----------------------------------------------------------------------

def run_cell(cell: dict, config: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, device, t0: float, spec: dict) -> dict:
    """Run ``cell`` once on ``device`` and return its result line (a dict,
    ``checks`` last). ``t0`` is the ``time.perf_counter()`` reading the
    set-up is timed from."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    run = Run(traffic=traffic)
    drv = load_driver(traffic["kind"]).Driver(config, traffic, seed, device)
    drv.warmup()
    sync(device)
    run.setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    spans = Spans(profiling=trace)
    prof = contextlib.nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if on_card else []))
    from perfbench.trace import WINDOW, summarize
    with prof:
        with (torch.profiler.record_function(WINDOW) if trace else contextlib.nullcontext()):
            drv.window(seconds, spans, run, marks=trace)
            sync(device)
        t = time.perf_counter()
    if trace:
        t_stop = time.perf_counter() - t
        run.trace = summarize(prof)
        print(f"perfbench: traced window {run.trace.window_s:.3f} s, profiler stop "
              f"{t_stop:.1f} s, summary {time.perf_counter() - t - t_stop:.1f} s",
              file=sys.stderr)
        del prof
    run.spans = spans.times
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    run.window_peak_bytes = window_peak

    drv.release()
    limits = load_limits(cell["name"])
    checks: List[Check] = drv.check(limits)
    if {c.name for c in checks} != set(limits):
        raise KeyError(f"{cell['name']}: the check compares {sorted(c.name for c in checks)}, "
                       f"limits/{cell['name']}.json limits {sorted(limits)}")
    correct = bool(checks) and all(c.ok for c in checks)

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(spec, cell["name"], section):
        value = load_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": int(cell.get("chips", 1)),
           "memory_peak_bytes": int(max(setup_peak, window_peak))}
    result = {"correct": correct, "attempted": int(drv.attempted),
              "failed": int(drv.failed),
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def main(argv: List[str], t0: float) -> int:
    p = argparse.ArgumentParser(prog="perfbench/run.py", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec = load_spec()
    cell = find_cell(spec, args.workload)
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); torch sees {have}",
              file=sys.stderr)
        return 2
    config = load_config(spec, cell["config"])
    traffic = load_traffic(cell["traffic"])
    result = run_cell(cell, config, traffic, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", t0, spec)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)} (JAX or the JAX package); "
              "no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"perfbench check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
