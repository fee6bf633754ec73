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
   (``pod_axis="pod"``) on f32[2, 36, 2^24]; and, after those paths' tensors
   are freed, the FedAvg path: three rounds of
   ``make_federated_round`` on internlm2-1.8b at full width (12 of its 24
   layers), n = 4 learners of 4 local AdamW steps on 2 x 256 tokens each,
   the deltas (P = 944,556,032 words) averaged by weighted SAFE;
5. the answers: sequential clean, failover (dead ranks including the
   elected initiator, NaN in their rows), weighted and rotated; BON clean
   and failover; pipelined clean, failover, weighted and two subgroups;
   hierarchical — each within the fixed-point bound of a float64 mean of
   the survivors and bit-identical to the port's CPU path on [36, 2^16];
   every engine session-round bit-identical to a single-session round;
   FedAvg: the loss falls over the three rounds; each round's published
   delta, as ``round_fn`` returns it, and that of a failover round (one
   learner dead, its row NaN) are within the weighted fixed-point bound of
   a float64 weighted mean of the survivors' rows of the deltas the round
   aggregated, and bit-identical to the CPU path on [4, 2^16]; mask_add
   and chain_combine at the path's own V = P + 1, on an aligned and an
   odd-word row of the real weighted payload, ``torch.equal`` to their
   plain versions (compared 2^26 words at a time);
6. timings at the main paths' shapes: each kernel (CUDA events) beside its
   plain version, its least possible time on the card and what bounds it;
   wall time per round of every path and per engine step, the device's
   busy time in the SAFE, BON and pipelined rounds and an engine step
   under torch.profiler, and the BON/SAFE ratio of the round; the last
   FedAvg round's wall time split into local steps, aggregation and apply
   by CUDA events inside that ``round_fn`` call, one local step's tokens
   per second and model-FLOPs share, and the aggregation against its
   bytes bound.

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
                "hierarchical": {"mask_add", "chain_combine"},
                "fedavg": {"mask_add", "chain_combine"}}

# The FedAvg path: internlm2-1.8b at full width, cut to 12 of its 24 layers
# (at 24 the learners' f32 deltas, the weighted payload and the chain's
# ciphertexts need more than the card's 80 GB), with the reference
# launcher's traffic (src/repro/launch/train.py: 4 learners, batch 2 of 256
# tokens, 4 local steps, lr 1e-3).
FED_ARCH, FED_LAYERS = "internlm2-1.8b", 12
FED_N, FED_B, FED_S, FED_K, FED_LR, FED_ROUNDS = 4, 2, 256, 4, 1e-3, 3
FED_DEAD = 1                # the failover check's dead learner
CHUNK = 1 << 26             # words per pass of the float64 reference mean
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 peak (NVIDIA data sheet)


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


def weighted_tol(n, xmax, wsum):
    """The weighted round's fixed-point bound: n encode roundings (plus the
    f32 product value * weight) of values up to ``xmax`` over the
    survivors' sum of weights, plus the f32 result's rounding."""
    return n * (0.5 * STEP + 2.0 ** -20) * (1 + xmax) / wsum + STEP


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
        if weights is not None:
            tol = weighted_tol(N, xmax, float(weights[alive > 0].sum()))
        else:  # the mean of encode roundings, plus the f32 result's
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


PROFILE_TOP = 8             # device entries listed per profiled call


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
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:PROFILE_TOP]
    return wall, busy, ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms"
                                 f" x{e.count}" for e in top)


# ---- the FedAvg path: phases 4, 5 and 6 ------------------------------------------

class WatchedAggregator:
    """The FedAvg round's aggregator, watched from outside: each call of
    ``aggregate`` keeps what ``round_fn`` handed it (``seen``) so that the
    round's own published delta can be checked against the deltas it
    aggregated, and CUDA events mark the call's start and end so that the
    round that is checked is the round that is timed. ``nan_rows`` are set
    to NaN on the way in: a dead learner's row must never reach the sum."""

    def __init__(self, agg):
        self.agg, self.cfg = agg, agg.cfg
        self.nan_rows, self.seen = [], None
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)

    def aggregate(self, values, counter_base=0, alive=None, weights=None):
        self.seen = None  # the last call's values may go before this call's peak
        values[self.nan_rows] = float("nan")
        self.start.record()
        out = self.agg.aggregate(values, counter_base, alive=alive, weights=weights)
        self.end.record()
        self.seen = dict(values=values, counter=counter_base, alive=alive, weights=weights)
        return out


def fed_setup(dev, cfg):
    """(model, watched aggregator, bundle, tokens [n, k, B, S] on dev,
    weights) of the FedAvg path. Every round trains on the same tokens, as
    the reference's FedAvg test does; the weights are the stream's sample
    counts (1000, 1500, 2000, 2500)."""
    from repro_torch.core import make_aggregator
    from repro_torch.data import make_federated_batches
    from repro_torch.models import Model
    from repro_torch.train import make_federated_round
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    stream = make_federated_batches(cfg, FED_N, FED_B, FED_S, seed=SEED)
    toks = np.stack([np.stack([stream.learner_batch(l, k)["tokens"] for k in range(FED_K)])
                     for l in range(FED_N)])
    agg = WatchedAggregator(make_aggregator("safe", FED_N, weighted=True, device=dev))
    bundle = make_federated_round(model, agg, local_steps=FED_K, local_lr=FED_LR,
                                  return_delta=True)
    return model, agg, bundle, torch.from_numpy(toks).to(dev), stream.global_batch(0)["weights"]


def check_published(name, m, agg, weights, alive, counter):
    """round_fn's own published delta (``m["avg_delta"]``) against a
    float64 weighted mean of the survivors' rows of the deltas it
    aggregated, CHUNK words at a time (a float64 [n, P] would not fit),
    within the weighted fixed-point bound; ``weights`` and ``alive`` are
    the caller's, not what round_fn passed on. Returns a report line."""
    seen, avg = agg.seen, m["avg_delta"]
    deltas = seen["values"]
    if int(seen["counter"]) != counter:
        fail(f"fedavg {name}: round_fn passed counter {seen['counter']}, not {counter}")
    if avg.shape != (deltas.shape[1],) or not bool(torch.isfinite(avg).all()):
        fail(f"fedavg {name}: bad published delta {avg.shape} {avg.dtype}")
    w = [float(weights[r]) if alive[r] > 0 else 0.0 for r in range(FED_N)]
    err, xmax = 0.0, 0.0
    for s in range(0, deltas.shape[1], CHUNK):
        e = min(deltas.shape[1], s + CHUNK)
        acc = torch.zeros(e - s, dtype=torch.float64, device=deltas.device)
        for r, wr in enumerate(w):
            if wr > 0:
                acc += deltas[r, s:e].double() * wr
                xmax = max(xmax, float(deltas[r, s:e].abs().max()))
        err = max(err, float((avg[s:e].double() - acc / sum(w)).abs().max()))
    tol = weighted_tol(FED_N, xmax, sum(w))
    if err > tol:
        fail(f"fedavg {name}: max |err| {err} > {tol}")
    return f"{name}: round_fn's avg_delta err={err:.3e} tol={tol:.3e} (float64 weighted mean)"


def check_cpu_path(name, agg, alive, weights, counter):
    """The aggregation of the seen deltas' first V_CPU words on the card is
    bit-identical to the port's CPU path."""
    from repro_torch.core import make_aggregator
    cpu = make_aggregator("safe", FED_N, weighted=True, device="cpu")
    narrow = agg.seen["values"][:, :V_CPU].contiguous()
    got = agg.agg.aggregate(narrow, counter, alive=alive, weights=weights)
    if not torch.equal(got.cpu(), cpu.aggregate(narrow.cpu(), counter, alive=alive,
                                               weights=weights)):
        fail(f"fedavg {name}: card and CPU path differ at [{FED_N}, {V_CPU}]")


def check_full_length(agg, weights, base, err):
    """mask_add and chain_combine at the FedAvg path's own length, V = P + 1
    words, on rows of the real weighted payload built from the seen deltas:
    row 0 starts on an aligned word, row 1 on an odd one (P + 1 is odd).
    Each output is held ``torch.equal`` to the plain version, CHUNK words
    at a time (the plain pads start at the chunk's word). Folds the
    differences into ``err``; the seen deltas are freed."""
    from repro_torch.core.chain import _payload
    from repro_torch.kernels import chain_combine as cc
    from repro_torch.kernels import ref
    from repro_torch.kernels import threefry_mask_add as tma
    payload = _payload(agg.seen["values"], agg.cfg, weights)
    agg.seen = None
    V = payload.shape[1]
    key, kin, kout = [0x5EED, 13], [3, 0xC0FFEE], [0xDEADBEEF, 7]
    full = {"mask_add": 0, "chain_combine": 0}
    for row in (0, 1):
        x = payload[row]
        masked = tma.mask_add(x, key, base)
        hop = cc.chain_combine(masked, x, kin, kout, base)
        for s in range(0, V, CHUNK):
            e = min(V, s + CHUNK)
            want = ref.mask_add_ref(x[s:e], key, base, offset=s)
            full["mask_add"] = max(full["mask_add"], u32_diff(masked[s:e], want))
            want = ref.chain_combine_ref(masked[s:e], x[s:e], kin, kout, base, offset=s)
            full["chain_combine"] = max(full["chain_combine"], u32_diff(hop[s:e], want))
        del masked, hop
    sync()
    for k, v in full.items():
        err[k] = max(err[k], v)
    if any(full.values()):
        fail(f"fedavg: a kernel differs from its plain version at V = {V}: {full}")
    return (f"kernels at V = {V}: mask_add and chain_combine on payload rows 0 (aligned) "
            f"and 1 (odd word), counter base {base}, == plain in "
            f"{-(-V // CHUNK)} chunks a row: max |err| {full}")


def fedavg_paths(dev, launches, err, smi):
    """Phases 4-6 of the FedAvg path; adds its launches to ``launches`` and
    its full-length kernel checks to ``err``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.train import tree_size

    cfg = dataclasses.replace(get_config(FED_ARCH), n_layers=FED_LAYERS)
    model, agg, bundle, tokens, weights = fed_setup(dev, cfg)
    params = bundle.init_state_fn(model.tree())
    P = tree_size(params)
    words = P + 1  # counter words a weighted round consumes: the stride between rounds
    everyone = np.ones(FED_N, np.float32)
    begin, done = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    sync()
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, walls, checks = [], [], [], []
    for r in range(FED_ROUNDS):
        t0 = time.perf_counter()
        begin.record()
        params, m = bundle.round_fn(params, tokens, weights=weights, counter=r * words)
        done.record()
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
        # the round's parts: deltas_fn, the aggregation, apply and metrics
        split = (begin.elapsed_time(agg.start), agg.start.elapsed_time(agg.end),
                 agg.end.elapsed_time(done))
        losses.append(float(m["local_loss"]))
        norms.append(float(m["delta_norm"]))
        checks.append(check_published(f"round {r + 1}", m, agg, weights, everyone, r * words))
        if r + 1 < FED_ROUNDS:
            agg.seen = None
        del m
    counts = dict(build.launches)
    peak = torch.cuda.max_memory_allocated()
    say(f"phase 4 main path fedavg: {sum(walls) / 1e3:.2f} s for {FED_ROUNDS} rounds of "
        f"round_fn; {FED_ARCH} at full width, {FED_LAYERS} of 24 layers, P={P}, n={FED_N}, "
        f"k={FED_K}, tokens [{FED_B}, {FED_S}]; peak memory {peak / 1e9:.2f} GB; "
        f"local_loss {[round(x, 4) for x in losses]}; launches {counts}")
    missing = sorted(k for k in PATH_KERNELS["fedavg"] if counts[k] <= 0)
    if missing:
        fail(f"path fedavg never launched {missing}: {counts}")
    for k, c in counts.items():
        launches[k] += c

    if not losses[-1] < losses[0]:
        fail(f"fedavg: the loss did not fall over {FED_ROUNDS} rounds: {losses}")
    if not min(norms) > 0:
        fail(f"fedavg: a published delta is zero: norms {norms}")
    say(f"phase 5 fedavg: local_loss round 1 {losses[0]:.4f} > round {FED_ROUNDS} "
        f"{losses[-1]:.4f}; delta_norm {[round(x, 5) for x in norms]}; every avg_delta finite")
    for line in checks:
        say(f"phase 5 fedavg {line}")
    last = (FED_ROUNDS - 1) * words
    check_cpu_path(f"round {FED_ROUNDS}", agg, everyone, weights, last)
    say(f"phase 5 fedavg {check_full_length(agg, weights, last, err)}")
    torch.cuda.empty_cache()

    # a failover round: learner FED_DEAD dead, its row NaN
    dead = everyone.copy()
    dead[FED_DEAD] = 0.0
    agg.nan_rows = [FED_DEAD]
    _, m = bundle.round_fn(params, tokens, weights=weights, counter=FED_ROUNDS * words,
                           alive=dead)
    agg.nan_rows = []
    say(f"phase 5 fedavg {check_published('failover', m, agg, weights, dead, FED_ROUNDS * words)}")
    check_cpu_path("failover", agg, dead, weights, FED_ROUNDS * words)
    say(f"phase 5 fedavg: card == CPU path on [{FED_N}, {V_CPU}], clean and failover")
    agg.seen = None
    del m

    local_ms, agg_ms, apply_ms = split  # round FED_ROUNDS, from its own events
    round_ms = walls[-1]
    step_ms = local_ms / (FED_N * FED_K)
    tokens_per_step = FED_B * FED_S
    mfu = 6 * P * tokens_per_step / (step_ms / 1e3) / BF16_FLOPS_PER_S
    # 3 mask_add (8 bytes a word) and 3 chain_combine (12) at V = P + 1; the
    # payload build reads [n, P] and writes [n, P + 1] f32
    kern_ms = (3 * 8 + 3 * 12) * words / HBM_BYTES_PER_S * 1e3
    payload_ms = 2 * 4 * FED_N * words / HBM_BYTES_PER_S * 1e3
    say(f"phase 6 fedavg round {FED_ROUNDS}: {round_ms:.1f} ms wall = local steps "
        f"{local_ms:.1f} + SAFE aggregation {agg_ms:.2f} + apply {apply_ms:.2f} ms "
        f"(device events inside round_fn); SAFE share "
        f"{agg_ms / (local_ms + agg_ms + apply_ms):.2%} | {smi}")
    say(f"phase 6 fedavg local step: {step_ms:.2f} ms ({FED_N * FED_K} steps, each "
        f"learner's copy and delta included), {tokens_per_step / step_ms * 1e3:.0f} tokens/s, "
        f"model-FLOPs share 6PT/t = {mfu:.2%} of 989 TFLOP/s (mfu, information) | {smi}")
    say(f"phase 6 fedavg aggregation: {agg_ms:.2f} ms on [{FED_N}, {words}] against a bytes "
        f"bound of {kern_ms:.2f} ms for the 6 kernels + {payload_ms:.2f} ms for the "
        f"payload build = {kern_ms + payload_ms:.2f} ms ({(kern_ms + payload_ms) / agg_ms:.0%}) | {smi}")
    # the profiled calls reuse counter 0: their outputs are dropped
    say_profile("fedavg round", lambda: bundle.round_fn(params, tokens, weights=weights,
                                                        counter=0))
    agg.seen = None
    deltas, _ = bundle.deltas_fn(params, tokens)  # only now: 15 GB beside a round's peak
    say_profile("fedavg aggregation", lambda: agg.aggregate(deltas, 0, weights=weights))


def say_profile(label, fn):
    """Print one profiled call of ``fn``; returns its device busy ms."""
    wall, busy, top = profile_ms(fn)
    seen = (f"device busy {busy:.2f} ms (idle {1 - busy / wall:.0%}); top: {top}"
            if busy > 0 else "device time not measured (the profiler saw none)")
    say(f"phase 6 profile {label}: wall {wall:.2f} ms under the profiler, {seen}")
    return busy


def aggregation_paths(dev):
    """Phases 4-6 of the aggregation paths; returns the launches over
    them and the kernels' timings. Their tensors are freed on return."""
    from repro_torch.core import make_aggregator
    from repro_torch.kernels import bon_mask as bm
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import chain_combine as cc
    from repro_torch.kernels import threefry_mask_add as tma
    from repro_torch.serve import AggregationEngine

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
    busy = {label: say_profile(label, fn)
            for label, fn in (("round", lambda: agg.aggregate(values)),
                              ("bon", lambda: bon.aggregate(values)),
                              ("pipelined", lambda: pipe.aggregate(values)),
                              ("engine step", engine_step))}
    ratio_busy = (f"{busy['bon'] / busy['round']:.2f}" if busy["round"] > 0
                  else "not measured")
    say(f"phase 6 BON/SAFE at n={N}, V={V_MAIN}: wall {walls['bon'] / walls['round']:.2f}x, "
        f"device busy {ratio_busy}x (information, not a claim)")
    return launches, times


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device; this script runs only on a GPU")
    dev = torch.device("cuda")

    from repro_torch.kernels import bon_mask as bm
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import chain_combine as cc
    from repro_torch.kernels import threefry_mask_add as tma

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

    launches, times = aggregation_paths(dev)
    torch.cuda.empty_cache()
    fedavg_paths(dev, launches, err, smi)
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
