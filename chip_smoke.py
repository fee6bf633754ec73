#!/usr/bin/env python3
"""Run the PyTorch/CUDA port of SAFE on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one line of output each (any failure exits non-zero, and there is
no CPU fallback):

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. the build of every kernel from ``src/repro_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, exactly
   (``torch.equal``), at V in {1, 5, 129, 100_001, 2^24}, counter bases 0
   and 2^32 - 5, aligned and misaligned rows, pads that start at odd and
   even stream words, S in {1, 8, 36} rows, and m in {1, 2, 36, 300} BON
   keys with mixed signs;
4. the main paths, through the entry points a user calls, each with every
   kernel's launch count reset just before and read just after: one SAFE
   round (``make_aggregator("safe", 36).aggregate``) on f32[36, 2^24]; the
   multi-session engine at n = 36, S = 8, V = 2^20; the BON round
   (``make_aggregator("bon", 36)``) and the pipelined round
   (``pipelined=True``) on the same values; a hierarchical round
   (``pod_axis="pod"``) on f32[2, 36, 2^24];
5. the answers: sequential clean, failover (dead ranks including the
   elected initiator, NaN in their rows), weighted and rotated; BON clean
   and failover; pipelined clean, failover, weighted and two subgroups;
   hierarchical — each within the fixed-point bound of a float64 mean of
   the survivors and bit-identical to the port's CPU path on [36, 2^16];
   every engine session-round bit-identical to a single-session round;
6. timings at the main paths' shapes: each kernel (CUDA events) beside its
   plain version, its least possible time on the card and what bounds it;
   wall time per round of every path and per engine step, the device's
   busy time in the SAFE, BON and pipelined rounds and an engine step
   under torch.profiler, and the BON/SAFE ratio of the round.

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
PODS = 2                    # pods of the hierarchical round
DEAD = [0, 13, 35]          # failover: rank 0 is the elected initiator at rotate 0

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
# evaluates two pads and does three ring adds; bon_mask evaluates m pads
# and adds or subtracts each.
OPS = {"mask_add": lambda m: 36 + 2 + 1, "chain_combine": lambda m: 72 + 2 + 3,
       "chain_combine_batched": lambda m: 72 + 2 + 3,
       "bon_mask": lambda m: 36 * m + m + 2}
M_BON = N                   # keys per BON masking launch: n - 1 pairs + the self-mask
REPLACES = {
    "mask_add": ("src/repro_torch/csrc/mask_add.cu",
                 "src/repro/kernels/threefry_mask_add.py:93"),
    "chain_combine": ("src/repro_torch/csrc/chain_combine.cu",
                      "src/repro/kernels/chain_combine.py:49"),
    "chain_combine_batched": ("src/repro_torch/csrc/chain_combine.cu",
                              "src/repro/kernels/chain_combine.py:110"),
    "bon_mask": ("src/repro_torch/csrc/bon_mask.cu", "src/repro/kernels/bon_mask.py:49"),
}
# The kernels each main path must launch.
PATH_KERNELS = {"round": {"mask_add", "chain_combine"},
                "engine": {"mask_add", "chain_combine_batched"},
                "bon": {"bon_mask"},
                "pipelined": {"mask_add", "chain_combine_batched"},
                "hierarchical": {"mask_add", "chain_combine"}}


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
    tma, cc, bm = ops_cuda
    g = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.RandomState(SEED)
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
                # pads from stream word 0, then mid-block and on a block
                for offset in (0, 1, 466_034, 466_035):
                    got = tma.mask_add(xs, key, base, offset=offset)
                    want = ref.mask_add_ref(xs, key, base, offset=offset)
                    err["mask_add"] = max(err["mask_add"], u32_diff(got, want))
                got = cc.chain_combine(cs, xs, kin, kout, base)
                want = ref.chain_combine_ref(cs, xs, kin, kout, base)
                err["chain_combine"] = max(err["chain_combine"], u32_diff(got, want))
                for m in (1, 2, 36, 300):
                    keys = rng.randint(0, 2**32, (m, 2), dtype=np.uint64).astype(np.uint32)
                    signs = rng.choice([-1, 1], m)
                    got = bm.bon_mask(xs, keys, signs, base)
                    want = ref.bon_mask_ref(xs, keys, signs, base)
                    err["bon_mask"] = max(err["bon_mask"], u32_diff(got, want))
                checks += 6 + 4
    for S in (1, 8, N):
        for V in (1, 5, 129, 100_001, V_MAIN):
            if S == N and V == V_MAIN:
                continue  # 36 rows are checked below at the pipelined step's width
            cipher = torch.randint(-2**31, 2**31, (S, V), generator=g, device=dev,
                                   dtype=torch.int32).view(torch.uint32)
            x = torch.rand((S, V), generator=g, device=dev) * 100 - 50
            kin = rng.randint(0, 2**32, (S, 2), dtype=np.uint64).astype(np.uint32)
            kout = rng.randint(0, 2**32, (S, 2), dtype=np.uint64).astype(np.uint32)
            # start words s * (2V + 1): every other row starts mid-block
            for bases, starts in (
                    (np.zeros(S, np.uint32), None),
                    (np.full(S, 2**32 - 5, np.uint32) - np.arange(S, dtype=np.uint32), None),
                    (np.full(S, 2**32 - 5, np.uint32), np.arange(S) * (2 * V + 1))):
                got = cc.chain_combine_batched(cipher, x, kin, kout, bases, starts=starts)
                want = ref.chain_combine_batched_ref(cipher, x, kin, kout, bases,
                                                     starts=starts)
                e = u32_diff(got, want)
                if starts is None:
                    for s in range(S):  # row s is a standalone hop
                        e = max(e, u32_diff(got[s], cc.chain_combine(
                            cipher[s].contiguous(), x[s].contiguous(), kin[s], kout[s],
                            int(bases[s]))))
                err["chain_combine_batched"] = max(err["chain_combine_batched"], e)
                checks += 1
    # the pipelined step at the main path's shape: 36 rows of seg words,
    # row s's pads from word s * seg (seg odd)
    seg = -(-V_MAIN // N)
    cipher = torch.randint(-2**31, 2**31, (N, seg), generator=g, device=dev,
                           dtype=torch.int32).view(torch.uint32)
    x = torch.rand((N, seg), generator=g, device=dev) * 100 - 50
    kin = rng.randint(0, 2**32, (N, 2), dtype=np.uint64).astype(np.uint32)
    kout = rng.randint(0, 2**32, (N, 2), dtype=np.uint64).astype(np.uint32)
    bases, starts = np.full(N, 2**32 - 5, np.uint32), np.arange(N) * seg
    got = cc.chain_combine_batched(cipher, x, kin, kout, bases, starts=starts)
    want = ref.chain_combine_batched_ref(cipher, x, kin, kout, bases, starts=starts)
    err["chain_combine_batched"] = max(err["chain_combine_batched"], u32_diff(got, want))
    checks += 1
    sync()
    if any(err.values()):
        fail(f"kernel differs from its plain version: {err}")
    return err, checks


# ---- phase 5: answers ---------------------------------------------------------

def survivor_mean64(values, alive, weights=None, subgroups=1):
    """float64 mean of the survivors' rows of [n, V], per subgroup ring and
    then over the rings; of [P, n, V], the mean over pods of each pod's."""
    if values.dim() == 3:
        return sum(survivor_mean64(v, alive, weights, subgroups)
                   for v in values) / values.shape[0]
    m = values.shape[0] // subgroups
    means = []
    for grp in range(subgroups):
        acc = torch.zeros(values.shape[1], dtype=torch.float64, device=values.device)
        den = 0.0
        for r in range(grp * m, (grp + 1) * m):
            if alive[r] > 0:
                w = 1.0 if weights is None else float(weights[r])
                acc += values[r].double() * w
                den += w
        means.append(acc / den)
    return sum(means) / subgroups


def round_cases(rng):
    """name -> (mode, aggregator kwargs, aggregate kwargs)."""
    alive = np.ones(N, np.float32)
    alive[DEAD] = 0.0
    w = rng.uniform(1, 10, N).astype(np.float32)
    pipe = dict(pipelined=True)
    return {
        "clean": ("safe", dict(), dict()),
        "failover": ("safe", dict(), dict(alive=alive)),
        "weighted": ("safe", dict(weighted=True), dict(weights=w)),
        "rotate7": ("safe", dict(), dict(rotate=7)),
        "rotate7-failover": ("safe", dict(), dict(rotate=7, alive=np.where(
            np.arange(N) == 7, 0.0, 1.0).astype(np.float32))),
        "bon": ("bon", dict(), dict()),
        "bon-failover": ("bon", dict(), dict(alive=alive)),
        "pipelined": ("safe", pipe, dict()),
        "pipelined-failover": ("safe", pipe, dict(alive=alive)),
        "pipelined-weighted": ("safe", dict(pipe, weighted=True), dict(weights=w)),
        "pipelined-subgroups2": ("safe", dict(pipe, subgroups=2), dict()),
        "hierarchical": ("safe", dict(pod_axis="pod"), dict()),
    }


def check_rounds(values, hvalues, make_aggregator, outs):
    """Each case on the card against a float64 mean of the survivors, and
    bit-identical to the port's CPU path at width V_CPU. ``outs`` holds
    the main paths' outputs of the clean cases."""
    rng = np.random.RandomState(SEED + 1)
    xmax = float(values.abs().max())
    lines = []
    for name, (mode, akw, kw) in round_cases(rng).items():
        vals = hvalues if "pod_axis" in akw else values
        if "alive" in kw:  # a dead rank's NaN must never reach the sum
            vals = vals.clone()
            vals[..., np.flatnonzero(kw["alive"] == 0).tolist(), :] = float("nan")
        out = outs.get(name)
        if out is None:
            out = make_aggregator(mode, N, **akw).aggregate(vals, **kw)
        if out.shape != (V_MAIN,) or out.dtype != torch.float32 or not bool(torch.isfinite(out).all()):
            fail(f"round {name}: bad output {out.shape} {out.dtype}")
        alive = kw.get("alive", np.ones(N, np.float32))
        weights = kw.get("weights") if akw.get("weighted") else None
        want = survivor_mean64(vals, alive, weights, akw.get("subgroups", 1))
        err = float((out.double() - want).abs().max())
        if weights is not None:  # N encode roundings (plus the f32 product) over sum(w)
            tol = N * (0.5 * STEP + 2.0 ** -20) * (1 + xmax) / float(weights[alive > 0].sum()) + STEP
        else:                    # the mean of encode roundings, plus the f32 result's
            tol = STEP
        if err > tol:
            fail(f"round {name}: max |err| {err} > {tol}")
        narrow = vals[..., :V_CPU].contiguous()
        got = make_aggregator(mode, N, **akw).aggregate(narrow, **kw)
        cpu = make_aggregator(mode, N, device="cpu", **akw).aggregate(narrow.cpu(), **kw)
        if not torch.equal(got.cpu(), cpu):
            fail(f"round {name}: card and CPU path differ at [{N}, {V_CPU}]")
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

def time_kernels(dev, values, tma, cc, bm, ref):
    rng = np.random.RandomState(SEED + 3)
    x = values[1]
    cipher = tma.mask_add(values[0], [1, 2], 0)
    xb = values[:S_ENGINE, :V_ENGINE].contiguous()
    cb = torch.stack([tma.mask_add(xb[s], [s, 9], 0) for s in range(S_ENGINE)])
    kin = rng.randint(0, 2**32, (S_ENGINE, 2), dtype=np.uint64).astype(np.uint32)
    kout = rng.randint(0, 2**32, (S_ENGINE, 2), dtype=np.uint64).astype(np.uint32)
    bases = np.arange(S_ENGINE, dtype=np.uint32) * V_ENGINE
    bkeys = rng.randint(0, 2**32, (M_BON, 2), dtype=np.uint64).astype(np.uint32)
    bsigns = np.where(np.arange(M_BON) < M_BON // 2, -1, 1)  # learner 18's signs
    runs = {
        "mask_add": (lambda: tma.mask_add(x, [5, 6], 0),
                     lambda: ref.mask_add_ref(x, [5, 6], 0), V_MAIN, 8 * V_MAIN, 1),
        "chain_combine": (lambda: cc.chain_combine(cipher, x, [3, 4], [5, 6], 0),
                          lambda: ref.chain_combine_ref(cipher, x, [3, 4], [5, 6], 0),
                          V_MAIN, 12 * V_MAIN, 1),
        "chain_combine_batched": (
            lambda: cc.chain_combine_batched(cb, xb, kin, kout, bases),
            lambda: ref.chain_combine_batched_ref(cb, xb, kin, kout, bases),
            S_ENGINE * V_ENGINE, 12 * S_ENGINE * V_ENGINE + 24 * S_ENGINE, 1),
        "bon_mask": (lambda: bm.bon_mask(x, bkeys, bsigns, 0),
                     lambda: ref.bon_mask_ref(x, bkeys, bsigns, 0),
                     V_MAIN, 8 * V_MAIN + 12 * M_BON, M_BON),
    }
    out = {}
    for name, (kern, plain, words, nbytes, m) in runs.items():
        ms = cuda_ms(kern, iters=50 if name != "bon_mask" else 20)
        issue_ms = cuda_ms(kern, iters=50 if name != "bon_mask" else 20, queued=False)
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = OPS[name](m) * words / ISSUE_OPS_PER_S * 1e3
        out[name] = dict(ms=ms, issue_ms=issue_ms, plain_ms=plain_ms,
                         bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                         bytes_ms=bytes_ms, ops_ms=ops_ms,
                         gbytes_per_s=nbytes / ms / 1e6, words=words, m=m)
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
    from repro_torch.kernels import bon_mask as bm
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
    err, checks = check_kernels(dev, (tma, cc, bm), ref)
    say(f"phase 3 kernels == plain: {checks} comparisons, max |err| {err} "
        f"({time.perf_counter() - t0:.1f} s)")

    g = torch.Generator(device=dev).manual_seed(SEED)
    values = torch.rand((N, V_MAIN), generator=g, device=dev) * 4 - 2
    hvalues = torch.rand((PODS, N, V_MAIN), generator=g, device=dev) * 4 - 2
    specs = engine_sessions(dev)
    agg = make_aggregator("safe", N)
    bon = make_aggregator("bon", N)
    pipe = make_aggregator("safe", N, pipelined=True)
    hier = make_aggregator("safe", N, pod_axis="pod")
    engine = AggregationEngine(agg.cfg, slots=S_ENGINE, payload_words=V_ENGINE)
    outs, launches = {}, {k: 0 for k in build.launches}

    def run_engine():
        sessions = [(spec, engine.submit(**spec)) for spec in specs]
        engine.run_until_done()
        return sessions

    paths = {"round": ("clean", lambda: agg.aggregate(values)),
             "engine": ("sessions", run_engine),
             "bon": ("bon", lambda: bon.aggregate(values)),
             "pipelined": ("pipelined", lambda: pipe.aggregate(values)),
             "hierarchical": ("hierarchical", lambda: hier.aggregate(hvalues))}
    for path, (key, fn) in paths.items():
        sync()
        build.reset_launches()
        t0 = time.perf_counter()
        outs[key] = fn()
        sync()
        counts = dict(build.launches)
        say(f"phase 4 main path {path}: {time.perf_counter() - t0:.2f} s; launches {counts}")
        missing = sorted(k for k in PATH_KERNELS[path] if counts[k] <= 0)
        if missing:
            fail(f"path {path} never launched {missing}: {counts}")
        for k, c in counts.items():
            launches[k] += c
    sessions = outs.pop("sessions")
    say(f"phase 4 engine: {len(specs)} sessions, {engine.rounds_completed} session-rounds "
        f"in {engine.steps} steps; launches over all paths {launches}")

    for line in check_rounds(values, hvalues, make_aggregator, outs):
        say(f"phase 5 round {line}")
    check_engine(sessions, make_aggregator)
    say(f"phase 5 engine: {engine.rounds_completed} session-rounds bit-identical to single runs")

    times = time_kernels(dev, values, tma, cc, bm, ref)
    for name, t in times.items():
        say(f"phase 6 {name}: {t['ms']:.4f} ms on the device ({t['gbytes_per_s']:.0f} GB/s), "
            f"{t['issue_ms']:.4f} ms a call back to back from the host, plain "
            f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms by {t['bound_by']} "
            f"(bytes {t['bytes_ms']:.4f} ms, ops {t['ops_ms']:.4f} ms; V={t['words']}, m={t['m']})")
    walls = {"round": wall_ms(lambda: agg.aggregate(values), iters=5),
             "bon": wall_ms(lambda: bon.aggregate(values), iters=3),
             "pipelined": wall_ms(lambda: pipe.aggregate(values), iters=5),
             "hierarchical": wall_ms(lambda: hier.aggregate(hvalues), iters=3)}
    wengine = AggregationEngine(agg.cfg, slots=S_ENGINE, payload_words=V_ENGINE)

    def engine_step():
        for spec in specs[:S_ENGINE]:
            wengine.submit(spec["values"], alive=spec["alive"], rotate0=spec["rotate0"])
        wengine.step()
    step_ms = wall_ms(engine_step, iters=3)
    say(f"phase 6 wall: round [{N}, {V_MAIN}] {walls['round']:.2f} ms "
        f"({3 + N - 1} launches: 3 mask_add + {N - 1} chain_combine); engine step "
        f"S={S_ENGINE} [{N}, {V_ENGINE}] {step_ms:.2f} ms ({3 * S_ENGINE} mask_add + "
        f"{N - 1} chain_combine_batched)")
    say(f"phase 6 wall: bon [{N}, {V_MAIN}] {walls['bon']:.2f} ms ({2 * N} bon_mask); "
        f"pipelined {walls['pipelined']:.2f} ms ({3 * N} mask_add + {N - 1} "
        f"chain_combine_batched); hierarchical [{PODS}, {N}, {V_MAIN}] "
        f"{walls['hierarchical']:.2f} ms ({PODS} sequential rounds)")
    busy = {}
    for label, fn in (("round", lambda: agg.aggregate(values)),
                      ("bon", lambda: bon.aggregate(values)),
                      ("pipelined", lambda: pipe.aggregate(values)),
                      ("engine step", engine_step)):
        wall, busy[label], top = profile_ms(fn)
        seen = (f"device busy {busy[label]:.2f} ms (idle {1 - busy[label] / wall:.0%}); top: {top}"
                if busy[label] > 0 else "device time not measured (the profiler saw none)")
        say(f"phase 6 profile {label}: wall {wall:.2f} ms under the profiler, {seen}")
    ratio_busy = (f"{busy['bon'] / busy['round']:.2f}" if busy["round"] > 0
                  else "not measured")
    say(f"phase 6 BON/SAFE at n={N}, V={V_MAIN}: wall {walls['bon'] / walls['round']:.2f}x, "
        f"device busy {ratio_busy}x (information, not a claim)")
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
