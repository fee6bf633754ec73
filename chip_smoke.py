#!/usr/bin/env python3
"""Run the PyTorch/CUDA port of SAFE on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one line of output each (any failure exits non-zero, and there is
no CPU fallback):

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. the build of every kernel from ``src/repro_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, exactly
   (``torch.equal``), at V in {1, 5, 129, 100_001, 2^24}, counter bases 0
   and 2^32 - 5, aligned and misaligned rows, and S in {1, 8} sessions;
4. the main path — one SAFE round, ``make_aggregator("safe", 36)
   .aggregate(values)`` on f32[36, 2^24], and the multi-session engine at
   n = 36, S = 8, V = 2^20 — with every kernel's launch count reset just
   before and read just after;
5. the round's answers: clean, failover (dead ranks including the elected
   initiator), weighted and rotated, each within the fixed-point bound of
   a float64 mean of the survivors and bit-identical to the port's CPU path
   on [36, 2^16]; every engine session-round bit-identical to a
   single-session round on the card;
6. timings at the main path's shapes: each kernel (CUDA events) beside its
   plain version, its least possible time on the card and what bounds it;
   wall time per round and per engine step, and the device's busy time in
   one of each under torch.profiler.

The second-to-last line is a JSON object with one entry per kernel; the
last is ``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
N = 36                      # learners: the paper's headline size
V_MAIN = 1 << 24            # words per learner in the round (64 MiB f32)
S_ENGINE, V_ENGINE = 8, 1 << 20
V_CPU = 1 << 16             # the CPU-path cross-check's width
STEP = 2.0 ** -16           # one fixed-point step at scale_bits = 16

# H100 SXM peaks (NVIDIA data sheet, 700 W): 3.35 TB/s of HBM3, and 67
# TFLOP/s of FP32 = 132 SMs x 128 lanes x 2 (FMA) x 1.98 GHz. An SM issues
# at most one instruction per lane per clock on its 128 lanes (4 schedulers
# x 32); integer adds issue on the FMA pipe (as IMAD) as well as on the 64
# INT32 lanes, so the issue rate, not the INT32 pipe alone, bounds integer
# work.
HBM_BYTES_PER_S = 3.35e12
ISSUE_OPS_PER_S = 132 * 128 * 1.98e9
# Operations per output word: a 20-round Threefry-2x32 evaluation is 72
# (20 x add/rotate/xor + 12 key-injection adds) and yields 2 words; the
# encode is a multiply and a conversion. mask_add adds one ring add; a hop
# evaluates two pads and does three ring adds.
OPS = {"mask_add": 36 + 2 + 1, "chain_combine": 72 + 2 + 3,
       "chain_combine_batched": 72 + 2 + 3}
REPLACES = {
    "mask_add": ("src/repro_torch/csrc/mask_add.cu",
                 "src/repro/kernels/threefry_mask_add.py:93"),
    "chain_combine": ("src/repro_torch/csrc/chain_combine.cu",
                      "src/repro/kernels/chain_combine.py:49"),
    "chain_combine_batched": ("src/repro_torch/csrc/chain_combine.cu",
                              "src/repro/kernels/chain_combine.py:110"),
}


def say(*parts):
    print(*parts, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def sync():
    torch.cuda.synchronize()


def u32_diff(a, b):
    """Largest |a - b| of two uint32 tensors, as integers."""
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


SPIN_CYCLES = 50_000_000    # ~25 ms at 1.98 GHz: longer than queueing 50 launches


def cuda_ms(fn, iters, warmup=3, queued=True):
    """Mean time of ``fn`` over ``iters`` back-to-back calls, from CUDA
    events. With ``queued`` the calls wait behind a spin kernel while the
    host queues them, so the device runs them back to back and the time is
    the device's alone; without it the host's launch cost shows too."""
    for _ in range(warmup):
        fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def wall_ms(fn, iters, warmup=1):
    for _ in range(warmup):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / iters


# ---- phase 3: kernels vs plain versions ---------------------------------------

def check_kernels(dev, ops_cuda, ref):
    tma, cc = ops_cuda
    g = torch.Generator(device=dev).manual_seed(SEED)
    err = {k: 0 for k in OPS}
    checks = 0
    for V in (1, 5, 129, 100_001, V_MAIN):
        x = torch.rand(V + 1, generator=g, device=dev) * 200 - 100
        c = torch.randint(-2**31, 2**31, (V + 1,), generator=g, device=dev,
                          dtype=torch.int32).view(torch.uint32)
        for base in (0, 2**32 - 5):
            key, kin, kout = [V, 0xDEADBEEF], [3, base], [base, 7]
            # an 8-byte aligned vector, then views that start on an odd word
            for xs, cs in ((x[:V], c[:V]), (x[1:], c[1:])):
                got, want = tma.mask_add(xs, key, base), ref.mask_add_ref(xs, key, base)
                err["mask_add"] = max(err["mask_add"], u32_diff(got, want))
                got = cc.chain_combine(cs, xs, kin, kout, base)
                want = ref.chain_combine_ref(cs, xs, kin, kout, base)
                err["chain_combine"] = max(err["chain_combine"], u32_diff(got, want))
                checks += 2
    rng = np.random.RandomState(SEED)
    for S in (1, 8):
        for V in (1, 5, 129, 100_001, V_MAIN):
            cipher = torch.randint(-2**31, 2**31, (S, V), generator=g, device=dev,
                                   dtype=torch.int32).view(torch.uint32)
            x = torch.rand((S, V), generator=g, device=dev) * 100 - 50
            kin = rng.randint(0, 2**32, (S, 2), dtype=np.uint64).astype(np.uint32)
            kout = rng.randint(0, 2**32, (S, 2), dtype=np.uint64).astype(np.uint32)
            for bases in (np.zeros(S, np.uint32),
                          np.full(S, 2**32 - 5, np.uint32) - np.arange(S, dtype=np.uint32)):
                got = cc.chain_combine_batched(cipher, x, kin, kout, bases)
                want = ref.chain_combine_batched_ref(cipher, x, kin, kout, bases)
                e = u32_diff(got, want)
                for s in range(S):  # row s is a standalone hop
                    e = max(e, u32_diff(got[s], cc.chain_combine(
                        cipher[s].contiguous(), x[s].contiguous(), kin[s], kout[s],
                        int(bases[s]))))
                err["chain_combine_batched"] = max(err["chain_combine_batched"], e)
                checks += 1
    sync()
    if any(err.values()):
        fail(f"kernel differs from its plain version: {err}")
    return err, checks


# ---- phase 5: answers ---------------------------------------------------------

def survivor_mean64(values, alive, weights=None):
    acc = torch.zeros(values.shape[1], dtype=torch.float64, device=values.device)
    den = 0.0
    for r in range(values.shape[0]):
        if alive[r] > 0:
            w = 1.0 if weights is None else float(weights[r])
            acc += values[r].double() * w
            den += w
    return acc / den


def round_cases(rng):
    alive = np.ones(N, np.float32)
    alive[[0, 13, 35]] = 0.0          # rank 0 is the elected initiator at rotate 0
    w = rng.uniform(1, 10, N).astype(np.float32)
    return {
        "clean": (dict(), dict()),
        "failover": (dict(), dict(alive=alive)),
        "weighted": (dict(weighted=True), dict(weights=w)),
        "rotate7": (dict(), dict(rotate=7)),
        "rotate7-failover": (dict(), dict(rotate=7, alive=np.where(
            np.arange(N) == 7, 0.0, 1.0).astype(np.float32))),
    }


def check_rounds(values, make_aggregator, clean_out):
    rng = np.random.RandomState(SEED + 1)
    xmax = float(values.abs().max())
    lines = []
    for name, (akw, kw) in round_cases(rng).items():
        out = clean_out if name == "clean" else make_aggregator("safe", N, **akw).aggregate(values, **kw)
        if out.shape != (V_MAIN,) or out.dtype != torch.float32 or not bool(torch.isfinite(out).all()):
            fail(f"round {name}: bad output {out.shape} {out.dtype}")
        alive = kw.get("alive", np.ones(N, np.float32))
        want = survivor_mean64(values, alive, kw.get("weights"))
        err = float((out.double() - want).abs().max())
        if "weights" in kw:  # N encode roundings (plus the f32 product) over sum(w)
            w = kw["weights"]
            tol = N * (0.5 * STEP + 2.0 ** -20) * (1 + xmax) / float(w[alive > 0].sum()) + STEP
        else:                # the mean of encode roundings, plus the f32 result's
            tol = STEP
        if err > tol:
            fail(f"round {name}: max |err| {err} > {tol}")
        cpu_agg = make_aggregator("safe", N, device="cpu", **akw)
        narrow = values[:, :V_CPU]
        got = make_aggregator("safe", N, **akw).aggregate(narrow.contiguous(), **kw)
        if not torch.equal(got.cpu(), cpu_agg.aggregate(narrow.cpu(), **kw)):
            fail(f"round {name}: card and CPU path differ at [36, {V_CPU}]")
        lines.append(f"{name} err={err:.3e} tol={tol:.3e}")
    return lines


# ---- phase 4/5: the engine -----------------------------------------------------

def engine_sessions(dev):
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    out = []
    for s in range(10):  # ten sessions through eight slots
        alive = np.ones(N, np.float32)
        if s == 2:
            alive[[0, 5]] = 0.0            # the default initiator is dead
        if s == 5:
            alive[[9, 10, 30]] = 0.0
        vals = torch.rand((N, V_ENGINE), generator=g, device=dev) * 4 - 2
        out.append(dict(values=vals, rounds=3 if s == 0 else 1,
                        provisioning_seed=0xC0FFEE + s, learner_master=0x5EED + 17 * s,
                        alive=alive, rotate0=7 * s))
    return out


def check_engine(sessions, make_aggregator):
    for spec, sess in sessions:
        single = make_aggregator("safe", N, provisioning_seed=spec["provisioning_seed"],
                                 learner_master=spec["learner_master"])
        if len(sess.results) != spec["rounds"]:
            fail(f"session {sess.sid}: {len(sess.results)} rounds of {spec['rounds']}")
        for r, got in enumerate(sess.results):
            want = single.aggregate(spec["values"], r * V_ENGINE, alive=spec["alive"],
                                    rotate=spec["rotate0"] + r)
            if not torch.equal(got, want):
                fail(f"engine session {sess.sid} round {r} differs from a single run")
        mean = survivor_mean64(spec["values"], spec["alive"])
        if float((sess.results[0].double() - mean).abs().max()) > STEP:
            fail(f"engine session {sess.sid}: mean off by more than {STEP}")


# ---- phase 6: timings -----------------------------------------------------------

def time_kernels(dev, values, tma, cc, ref):
    rng = np.random.RandomState(SEED + 3)
    x = values[1]
    cipher = tma.mask_add(values[0], [1, 2], 0)
    xb = values[:S_ENGINE, :V_ENGINE].contiguous()
    cb = torch.stack([tma.mask_add(xb[s], [s, 9], 0) for s in range(S_ENGINE)])
    kin = rng.randint(0, 2**32, (S_ENGINE, 2), dtype=np.uint64).astype(np.uint32)
    kout = rng.randint(0, 2**32, (S_ENGINE, 2), dtype=np.uint64).astype(np.uint32)
    bases = np.arange(S_ENGINE, dtype=np.uint32) * V_ENGINE
    runs = {
        "mask_add": (lambda: tma.mask_add(x, [5, 6], 0),
                     lambda: ref.mask_add_ref(x, [5, 6], 0), V_MAIN, 8 * V_MAIN),
        "chain_combine": (lambda: cc.chain_combine(cipher, x, [3, 4], [5, 6], 0),
                          lambda: ref.chain_combine_ref(cipher, x, [3, 4], [5, 6], 0),
                          V_MAIN, 12 * V_MAIN),
        "chain_combine_batched": (
            lambda: cc.chain_combine_batched(cb, xb, kin, kout, bases),
            lambda: ref.chain_combine_batched_ref(cb, xb, kin, kout, bases),
            S_ENGINE * V_ENGINE, 12 * S_ENGINE * V_ENGINE + 20 * S_ENGINE),
    }
    out = {}
    for name, (kern, plain, words, nbytes) in runs.items():
        ms = cuda_ms(kern, iters=50)
        issue_ms = cuda_ms(kern, iters=50, queued=False)
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = OPS[name] * words / ISSUE_OPS_PER_S * 1e3
        out[name] = dict(ms=ms, issue_ms=issue_ms, plain_ms=plain_ms,
                         bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                         bytes_ms=bytes_ms, ops_ms=ops_ms,
                         gbytes_per_s=nbytes / ms / 1e6, words=words)
    return out


def profile_ms(fn):
    """(wall ms, device busy ms, top kernels) of one call of ``fn`` under
    torch.profiler, after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side entries only: a CPU op's entry repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
    return wall, busy, ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms"
                                 f" x{e.count}" for e in top)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device; this script runs only on a GPU")
    dev = torch.device("cuda")

    from repro_torch.core import make_aggregator
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import chain_combine as cc
    from repro_torch.kernels import threefry_mask_add as tma
    from repro_torch.serve import AggregationEngine

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    say(smi)
    say(f"phase 1 card: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    reports = build.build()
    say(f"phase 2 build: {time.perf_counter() - t0:.1f} s, libraries {sorted(reports) or 'cached'}")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")

    t0 = time.perf_counter()
    err, checks = check_kernels(dev, (tma, cc), ref)
    say(f"phase 3 kernels == plain: {checks} comparisons, max |err| {err} "
        f"({time.perf_counter() - t0:.1f} s)")

    g = torch.Generator(device=dev).manual_seed(SEED)
    values = torch.rand((N, V_MAIN), generator=g, device=dev) * 4 - 2
    specs = engine_sessions(dev)
    agg = make_aggregator("safe", N)
    engine = AggregationEngine(agg.cfg, slots=S_ENGINE, payload_words=V_ENGINE)
    sync()
    build.reset_launches()
    t0 = time.perf_counter()
    clean = agg.aggregate(values)
    sessions = [(spec, engine.submit(**spec)) for spec in specs]
    engine.run_until_done()
    sync()
    launches = dict(build.launches)
    say(f"phase 4 main path: round [{N}, {V_MAIN}] + engine {len(specs)} sessions "
        f"({engine.rounds_completed} session-rounds, {engine.steps} steps) in "
        f"{time.perf_counter() - t0:.2f} s; launches {launches}")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path never launched: {launches}")

    for line in check_rounds(values, make_aggregator, clean):
        say(f"phase 5 round {line}")
    check_engine(sessions, make_aggregator)
    say(f"phase 5 engine: {engine.rounds_completed} session-rounds bit-identical to single runs")

    times = time_kernels(dev, values, tma, cc, ref)
    for name, t in times.items():
        say(f"phase 6 {name}: {t['ms']:.4f} ms on the device ({t['gbytes_per_s']:.0f} GB/s), "
            f"{t['issue_ms']:.4f} ms a call back to back from the host, plain "
            f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms by {t['bound_by']} "
            f"(bytes {t['bytes_ms']:.4f} ms, ops {t['ops_ms']:.4f} ms)")
    round_ms = wall_ms(lambda: agg.aggregate(values), iters=5)
    wengine = AggregationEngine(agg.cfg, slots=S_ENGINE, payload_words=V_ENGINE)

    def engine_step():
        for spec in specs[:S_ENGINE]:
            wengine.submit(spec["values"], alive=spec["alive"], rotate0=spec["rotate0"])
        wengine.step()
    step_ms = wall_ms(engine_step, iters=3)
    say(f"phase 6 wall: round [{N}, {V_MAIN}] {round_ms:.2f} ms "
        f"({3 + N - 1} launches: 3 mask_add + {N - 1} chain_combine); engine step "
        f"S={S_ENGINE} [{N}, {V_ENGINE}] {step_ms:.2f} ms ({3 * S_ENGINE} mask_add + "
        f"{N - 1} chain_combine_batched)")
    for label, fn in (("round", lambda: agg.aggregate(values)), ("engine step", engine_step)):
        wall, busy, top = profile_ms(fn)
        seen = (f"device busy {busy:.2f} ms (idle {1 - busy / wall:.0%}); top: {top}"
                if busy > 0 else "device time not measured (the profiler saw none)")
        say(f"phase 6 profile {label}: wall {wall:.2f} ms under the profiler, {seen}")
    say(f"launches {json.dumps(launches)}")

    kernels = []
    for name, (source, replaces) in REPLACES.items():
        t = times[name]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name], max_abs_err=err[name],
                            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                            bound_by=t["bound_by"], library_ms=None))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
