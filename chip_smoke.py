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
   (``pod_axis="pod"``) on f32[2, 36, 2^24]; after those paths' tensors are
   freed, the wire paths: ``wire engine``, the port's ``net.SafeBroker`` in
   this process's event loop in front of an ``AggregationEngine`` on the
   card (n = 36, S = 8, V = 2^20), with ten ``WireClient`` tenants that
   upload the engine path's ten sessions (144 MiB each) with
   ``submit_session_chunked`` and collect them with ``wait_session``; and
   ``wire round``, host only: ``run_safe_round_net`` at n = 36, V = 10,000
   clean and with ranks {13} and {0} dead, and ``run_bon_round_net`` clean;
   then the FedAvg path: three rounds of
   ``make_federated_round`` on internlm2-1.8b at full width (12 of its 24
   layers), n = 4 learners of 4 local AdamW steps on 2 x 256 tokens each,
   the deltas (P = 944,556,032 words) averaged by weighted SAFE; then the
   train-step path: three steps of ``make_train_step`` on the same model
   (n = 4, 2 x 256 tokens a learner, one repeated batch), each learner's
   gradient a row of f32[4, padded_size] averaged by SAFE, then FlatAdamW
   on the f32 master vector, counters from ``reserve_round``; then
   ``python -m repro_torch.launch.train --smoke`` as subprocesses on the
   card (two uninterrupted runs, one resumed from its checkpoint,
   ``--federated``); then ``net.run_engine_load`` against the port's broker
   in front of an engine on the card (n = 36, V = 2^20, 4 tenants);
5. the answers: sequential clean, failover (dead ranks including the
   elected initiator, NaN in their rows), weighted and rotated; BON clean
   and failover; pipelined clean, failover, weighted and two subgroups;
   hierarchical — each within the fixed-point bound of a float64 mean of
   the survivors and bit-identical to the port's CPU path on [36, 2^16];
   every engine session-round bit-identical to a single-session round;
   every wire-engine result bit-identical to the in-process engine path's,
   no engine step failed and no wait timed out; each wire round's average
   bit-identical to the port's simulation, its messages at the closed form;
   FedAvg: the loss falls over the three rounds; each round's published
   delta, as ``round_fn`` returns it, and that of a failover round (one
   learner dead, its row NaN) are within the weighted fixed-point bound of
   a float64 weighted mean of the survivors' rows of the deltas the round
   aggregated, and bit-identical to the CPU path on [4, 2^16]; mask_add
   and chain_combine at the path's own V = P + 1, on an aligned and an
   odd-word row of the real weighted payload, ``torch.equal`` to their
   plain versions (compared 2^26 words at a time); the train step: the
   loss falls over three steps; each step's published gradient mean, as
   the aggregator handed it back to ``step_fn``, within the fixed-point
   bound of a float64 mean of the rows it aggregated, with the step's
   counter and rotation; the card against the CPU path on [4, 2^16];
   mask_add and chain_combine at V = padded_size against their plain
   versions; a step with learner 1 dead (its row NaN), then
   ``reserve_round`` refusing the fifth step of the key set and a step
   with rank 0 dead on rotated keys; a SAFE and an INSEC step from one
   state at 2 layers; the launcher's losses finite (falling for the
   train step), its resumed run against an uninterrupted one beside two
   uninterrupted runs; every ``run_engine_load`` session bit-identical to
   a single round;
6. timings at the main paths' shapes: each kernel (CUDA events) beside its
   plain version, its least possible time on the card and what bounds it;
   wall time per round of every path and per engine step, the device's
   busy time in the SAFE, BON and pipelined rounds and an engine step
   under torch.profiler, and the BON/SAFE ratio of the round; the wire
   engine path's wall split into upload, engine steps and download, its
   socket rates and, in a second run under torch.profiler, its device busy
   time; the wire rounds' walls; the host's numpy keystream rate; the last
   FedAvg round's wall time split into local steps, aggregation and apply
   by CUDA events inside that ``round_fn`` call, one local step's tokens
   per second and model-FLOPs share, and the aggregation against its
   bytes bound; the last train step's wall split by CUDA events inside
   ``step_fn`` into the learners' forward and backward, flatten and pad,
   SAFE aggregation, FlatAdamW and rebuild, each against its bytes bound,
   the SAFE share, tokens per second, peak memory and, under
   torch.profiler, the device's idle share; ``run_engine_load``'s
   ``LoadReport``.

The second-to-last line is a JSON object with one entry per kernel; the
last is ``{"ok": true, "device": {...}}``.
"""
import asyncio
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
                "wire_engine": {"mask_add", "chain_combine_batched"},
                "fedavg": {"mask_add", "chain_combine"},
                "train_step": {"mask_add", "chain_combine"},
                "engine_load": {"mask_add", "chain_combine_batched"}}

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

# The train-step path: the same model and cut as FedAvg's, with the reference
# launcher's train-step traffic (src/repro/launch/train.py: 4 learners, batch 2
# of 256 tokens, lr 1e-3) on one repeated batch, as tests/test_train.py trains;
# the SAFE-against-INSEC comparison runs at TS_CMP_LAYERS layers, so that its
# two states fit beside each other.
TS_ARCH, TS_LAYERS, TS_CMP_LAYERS = FED_ARCH, FED_LAYERS, 2
TS_N, TS_B, TS_S, TS_LR, TS_STEPS = 4, 2, 256, 1e-3, 3
# The launcher at the smoke size (subprocesses), and run_engine_load.
LAUNCH_STEPS, LAUNCH_TIMEOUT_S = 4, 300
LOAD_TENANTS, LOAD_ROUNDS = 4, 2

# The wire paths. The engine's tenants upload over 127.0.0.1 in chunks of
# the codec's default width (a session is 144 MiB, over one 64 MiB frame).
# The wire rounds run at the paper's largest feature count
# (benchmarks/feature_scalability.py:16); learner ids on the wire are
# rank + 1, so the dead sets are ranks {13} and {0}, the elected initiator.
WIRE_CHUNK = 1 << 20
WIRE_WAIT_S = 300.0         # a tenant's wait_session timeout
WIRE_V = 10_000
WIRE_DEAD = {"clean": (), "rank 13 dead": (14,), "rank 0 dead": (1,)}
WIRE_AGG_TIMEOUT = 3.0      # the §5.4 re-election timeout of the wire rounds
KEYSTREAM_WORDS = 1 << 22   # the host keystream rate's pad


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
    """The FedAvg round's or the train step's aggregator, watched from
    outside: each call of ``aggregate`` keeps what the caller handed it and
    what it published (``seen``) so that the round's own published mean can
    be checked against the rows it aggregated, and CUDA events mark the
    call's start and end so that the round that is checked is the round
    that is timed. ``nan_rows`` are set to NaN on the way in: a dead
    learner's row must never reach the sum."""

    def __init__(self, agg):
        self.agg, self.cfg = agg, agg.cfg
        self.nan_rows, self.seen = [], None
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)

    def reserve_round(self, nwords):
        return self.agg.reserve_round(nwords)

    def aggregate(self, values, counter_base=0, alive=None, weights=None, domain=0, rotate=0):
        self.seen = None  # the last call's values may go before this call's peak
        values[self.nan_rows] = float("nan")
        self.start.record()
        out = self.agg.aggregate(values, counter_base, alive=alive, weights=weights,
                                 domain=domain, rotate=rotate)
        self.end.record()
        self.seen = dict(values=values, counter=counter_base, alive=alive, weights=weights,
                         rotate=rotate, out=out)
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


def check_cpu_path(name, agg, alive, weights, counter, rotate=0, path="fedavg"):
    """The aggregation of the seen rows' first V_CPU words on the card is
    bit-identical to the port's CPU path (the same mode, keys, counter,
    alive, weights and rotation)."""
    from repro_torch.core import SecureAggregator
    inner = agg.agg
    cpu = SecureAggregator(inner.cfg, inner.provisioning_seed, inner.learner_master, "cpu")
    narrow = agg.seen["values"][:, :V_CPU].contiguous()
    got = inner.aggregate(narrow, counter, alive=alive, weights=weights, rotate=rotate)
    if not torch.equal(got.cpu(), cpu.aggregate(narrow.cpu(), counter, alive=alive,
                                               weights=weights, rotate=rotate)):
        fail(f"{path} {name}: card and CPU path differ at [{narrow.shape[0]}, {V_CPU}]")


def check_full_length(agg, weights, base, err):
    """mask_add and chain_combine at a path's own length — FedAvg's V = P + 1
    words, the train step's V = padded_size — on rows of the real payload
    built from the seen rows: row 0 starts on an aligned word, row 1 on an
    odd one when V is odd (P + 1 is).
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
        fail(f"a kernel differs from its plain version at V = {V}: {full}")
    return (f"kernels at V = {V}: mask_add and chain_combine on payload rows 0 (aligned) "
            f"and 1 ({'aligned' if V % 2 == 0 else 'odd word'}), counter base {base}, "
            f"== plain in {-(-V // CHUNK)} chunks a row: max |err| {full}")


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


# ---- the train-step path: phases 4, 5 and 6 ---------------------------------------

class StepMarks:
    """``step_fn``'s ``mark``: a CUDA event at the end of each part of a step,
    so the step's device time splits into its parts."""

    def __init__(self):
        self.begin = torch.cuda.Event(enable_timing=True)
        self.events = []

    def start(self):
        self.events = []
        self.begin.record()

    def __call__(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((name, ev))

    def parts(self, done):
        """ms per part name (summed over learners), to the ``done`` event."""
        out, prev = {}, self.begin
        for name, ev in self.events + [("metrics", done)]:
            out[name] = out.get(name, 0.0) + prev.elapsed_time(ev)
            prev = ev
        return out


def check_step_mean(name, agg, alive, counter):
    """The step's own published gradient mean (what the aggregator handed
    back to ``step_fn``) against a float64 mean of the survivors' rows of
    the [n, padded_size] matrix it aggregated, CHUNK words at a time,
    within the fixed-point bound STEP; and the counter and rotation the
    step passed. Returns a report line."""
    seen = agg.seen
    vals, out = seen["values"], seen["out"]
    n = vals.shape[0]
    if int(seen["counter"]) != counter or int(seen["rotate"]) != counter % (2 * n + 1):
        fail(f"train step {name}: step_fn passed counter {seen['counter']} and rotate "
             f"{seen['rotate']}, not {counter} and {counter % (2 * n + 1)}")
    if out.shape != (vals.shape[1],) or not bool(torch.isfinite(out).all()):
        fail(f"train step {name}: bad published mean {out.shape} {out.dtype}")
    live = [r for r in range(n) if alive[r] > 0]
    err = 0.0
    for s in range(0, vals.shape[1], CHUNK):
        e = min(vals.shape[1], s + CHUNK)
        acc = torch.zeros(e - s, dtype=torch.float64, device=vals.device)
        for r in live:
            acc += vals[r, s:e].double()
        err = max(err, float((out[s:e].double() - acc / len(live)).abs().max()))
    if err > STEP:
        fail(f"train step {name}: max |err| {err} > {STEP}")
    return (f"{name}: step_fn's published mean err={err:.3e} tol={STEP:.3e} (float64 mean "
            f"of survivors {live}), counter {counter}, rotate {counter % (2 * n + 1)}")


def train_step_setup(dev, cfg):
    """(model, watched SAFE aggregator, bundle, tokens [n, B, S] on dev) of
    the train-step path: the reference launcher's first global batch,
    repeated every step as the reference's training test does."""
    from repro_torch.core import make_aggregator
    from repro_torch.data import make_federated_batches
    from repro_torch.models import Model
    from repro_torch.train import make_train_step
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    stream = make_federated_batches(cfg, TS_N, TS_B, TS_S, seed=SEED)
    tokens = torch.from_numpy(stream.global_batch(0)["tokens"]).to(dev)
    agg = WatchedAggregator(make_aggregator("safe", TS_N, device=dev))
    return model, agg, make_train_step(model, agg, lr=TS_LR), tokens


def train_step_paths(dev, launches, err, smi):
    """Phases 4-6 of the train-step path; adds its launches to ``launches``
    and its full-length kernel checks to ``err``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import make_aggregator
    from repro_torch.kernels import build
    from repro_torch.train import make_train_step

    cfg = dataclasses.replace(get_config(TS_ARCH), n_layers=TS_LAYERS)
    model, agg, bundle, tokens = train_step_setup(dev, cfg)
    W = bundle.padded_size + 2  # counter words of one step
    state = bundle.init_state_fn(model.tree())
    everyone = np.ones(TS_N, np.float32)
    marks, done = StepMarks(), torch.cuda.Event(enable_timing=True)

    sync()
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, scales, walls, checks, counters = [], [], [], [], []
    for i in range(TS_STEPS):
        counters.append(agg.reserve_round(W))
        t0 = time.perf_counter()
        marks.start()
        state, m = bundle.step_fn(state, tokens, counter=counters[-1], mark=marks)
        done.record()
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
        parts = marks.parts(done)
        losses.append(float(m["loss"]))
        scales.append(float(m["grad_scale"]))
        checks.append(check_step_mean(f"step {i + 1}", agg, everyone, counters[-1]))
        if i + 1 < TS_STEPS:
            agg.seen = None
        del m
    counts = dict(build.launches)
    peak = torch.cuda.max_memory_allocated()
    say(f"phase 4 main path train step: {sum(walls) / 1e3:.2f} s for {TS_STEPS} steps of "
        f"step_fn; {TS_ARCH} at full width, {TS_LAYERS} of 24 layers, sec_size "
        f"{bundle.sec_size}, padded_size {bundle.padded_size}, n={TS_N}, tokens [{TS_B}, "
        f"{TS_S}] a learner, counters {counters} (reserve_round({W})); peak memory "
        f"{peak / 1e9:.2f} GB; loss {[round(x, 4) for x in losses]}; launches {counts}")
    missing = sorted(k for k in PATH_KERNELS["train_step"] if counts[k] <= 0)
    if missing:
        fail(f"path train step never launched {missing}: {counts}")
    for k, c in counts.items():
        launches[k] += c

    if not losses[-1] < losses[0]:
        fail(f"train step: the loss did not fall over {TS_STEPS} steps: {losses}")
    say(f"phase 5 train step: loss step 1 {losses[0]:.4f} > step {TS_STEPS} {losses[-1]:.4f}; "
        f"grad_scale {[round(x, 5) for x in scales]}")
    for line in checks:
        say(f"phase 5 train step {line}")
    last = counters[-1]
    check_cpu_path(f"step {TS_STEPS}", agg, everyone, None, last, rotate=last % (2 * TS_N + 1),
                   path="train step")
    say(f"phase 5 train step {check_full_length(agg, None, last, err)}")
    torch.cuda.empty_cache()

    # one key set's counter space holds 2^32 // W steps (4 at full width): the
    # learner-1-dead step takes the next; once the set's ranges are spent,
    # reserve_round refuses and the keys rotate
    fit = 2**32 // W
    failover = []
    for name, dead, who in (("learner 1 dead", 1, agg), ("rank 0 dead", 0, None)):
        if who is None:
            for _ in range(fit - TS_STEPS - 1):  # none at full width
                agg.reserve_round(W)
            try:
                agg.reserve_round(W)
            except OverflowError as e:
                refusal = str(e)
            else:
                fail(f"train step: reserve_round did not refuse step {fit + 1} of a key set")
            # a Round-0 key rotation: fresh keys, fresh counter space
            who = WatchedAggregator(make_aggregator("safe", TS_N, device=dev,
                                                    provisioning_seed=0xC0FFEE + 1,
                                                    learner_master=0x5EED + 1))
            rekeyed = make_train_step(model, who, lr=TS_LR)
            say(f"phase 5 train step: key set 1 refused step {fit + 1} ({refusal}); keys "
                f"rotated")
        alive = everyone.copy()
        alive[dead] = 0.0
        who.nan_rows = [dead]
        counter = who.reserve_round(W)
        step_fn = bundle.step_fn if who is agg else rekeyed.step_fn
        state, m = step_fn(state, tokens, counter=counter, alive=alive)
        who.nan_rows = []
        if not np.isfinite(float(m["loss"])):
            fail(f"train step {name}: loss {float(m['loss'])}")
        failover.append(f"{check_step_mean(name, who, alive, counter)}; loss {float(m['loss']):.4f}")
        check_cpu_path(name, who, alive, None, counter, rotate=counter % (2 * TS_N + 1),
                       path="train step")
        who.seen = None
        del m
    for line in failover:
        say(f"phase 5 train step {line}; card == CPU path on [{TS_N}, {V_CPU}]")

    # phase 6: step TS_STEPS, split by its own CUDA events
    P, V = bundle.sec_size, bundle.padded_size
    step_ms = walls[-1]
    dev_ms = sum(parts.values())
    fb, flat, agg_ms = parts["forward_backward"], parts["flatten"], parts["aggregate"]
    opt_ms, rebuild_ms = parts["optimizer"], parts["rebuild"]
    tokens_per_step = TS_N * TS_B * TS_S
    mfu = 6 * P * tokens_per_step / (fb / 1e3) / BF16_FLOPS_PER_S
    opt_bound = 7 * 4 * V / HBM_BYTES_PER_S * 1e3      # read g, m, v, p; write m, v, p
    agg_bound = (3 * 8 + 3 * 12) * V / HBM_BYTES_PER_S * 1e3  # 3 mask_add, 3 chain_combine
    flat_bound = TS_N * (2 + 4) * P / HBM_BYTES_PER_S * 1e3   # bf16 grads in, f32 rows out
    rebuild_bound = (4 + 2) * P / HBM_BYTES_PER_S * 1e3
    say(f"phase 6 train step {TS_STEPS} ({smi}): {step_ms:.1f} ms wall, {dev_ms:.1f} ms from "
        f"its CUDA events = learners' forward and backward {fb:.1f} + flatten and pad "
        f"{flat:.2f} + SAFE aggregation {agg_ms:.2f} + FlatAdamW {opt_ms:.2f} + rebuild "
        f"{rebuild_ms:.2f} + metrics {parts['metrics']:.2f} ms; SAFE share "
        f"{agg_ms / dev_ms:.2%}; {tokens_per_step / step_ms * 1e3:.0f} tokens/s; peak memory "
        f"{peak / 1e9:.2f} GB")
    say(f"phase 6 train step bounds ({smi}): SAFE aggregation {agg_ms:.2f} ms against "
        f"{agg_bound:.2f} ms for its 6 kernels' bytes ({agg_bound / agg_ms:.0%}); FlatAdamW "
        f"{opt_ms:.2f} ms against a bytes bound of {opt_bound:.2f} ms ({opt_bound / opt_ms:.0%}) "
        f"on {V} words; flatten {flat:.2f} ms against {flat_bound:.2f} ms; rebuild "
        f"{rebuild_ms:.2f} ms against {rebuild_bound:.2f} ms; forward and backward "
        f"{fb / TS_N:.1f} ms a learner, model-FLOPs share 6PT/t = {mfu:.2%} of 989 TFLOP/s "
        f"(information)")

    holder = {"state": state}

    def one_step():
        holder["state"], _ = rekeyed.step_fn(holder["state"], tokens,
                                              counter=who.reserve_round(W))
        who.seen = None
    busy = say_profile("train step", one_step)
    if busy > 0:
        say(f"phase 6 train step idle share ({smi}): device busy {busy:.2f} ms of the "
            f"unprofiled step {TS_STEPS}'s {step_ms:.1f} ms wall: idle {1 - busy / step_ms:.0%}")
    # the peak of a step whose aggregator is not watched (the watcher keeps
    # the gradient matrix alive through the optimizer), part by part: the
    # allocator's peak since the last mark (host-side counters, no sync);
    # the key set's last range
    plain = make_train_step(model, who.agg, lr=TS_LR)
    peaks = {}

    def peak_mark(name):
        peaks[name] = max(peaks.get(name, 0), torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
    sync()
    torch.cuda.reset_peak_memory_stats()
    holder["state"], _ = plain.step_fn(holder["state"], tokens, counter=who.reserve_round(W),
                                       mark=peak_mark)
    sync()
    say(f"phase 6 train step peak memory ({smi}): {max(peaks.values()) / 1e9:.2f} GB in a step "
        f"with its aggregator unwatched ({peak / 1e9:.2f} GB watched); peak by part: "
        + ", ".join(f"{k} {v / 1e9:.2f} GB" for k, v in peaks.items()))
    del holder, state, model, bundle, rekeyed, plain, agg, who, tokens
    torch.cuda.empty_cache()
    safe_vs_insec(dev, cfg)


def safe_vs_insec(dev, cfg):
    """A SAFE step and an INSEC step from one state, at TS_CMP_LAYERS
    layers (full width): the same loss, published gradients within the
    fixed-point bound, parameters within the first AdamW step's 2·lr of
    each other, and the next forward's losses within 5e-3
    (tests/test_train.py's bound)."""
    import dataclasses

    from repro_torch.core import make_aggregator
    from repro_torch.train import make_train_step

    cfg = dataclasses.replace(cfg, n_layers=TS_CMP_LAYERS)
    model, safe, _, tokens = train_step_setup(dev, cfg)
    insec = WatchedAggregator(make_aggregator("insec", TS_N, device=dev))
    bs = make_train_step(model, safe, lr=TS_LR, donate=False)
    bi = make_train_step(model, insec, lr=TS_LR, donate=False)
    state = bs.init_state_fn(model.tree())
    W = bs.padded_size + 2
    s_safe, m_safe = bs.step_fn(state, tokens, counter=safe.reserve_round(W))
    s_insec, m_insec = bi.step_fn(state, tokens, counter=insec.reserve_round(W))
    gerr = float((safe.seen["out"] - insec.seen["out"]).abs().max())
    dtheta = (s_safe["master"] - s_insec["master"]).abs()
    dmax, moved = float(dtheta.max()), float((dtheta > 0).float().mean())
    l_safe, l_insec = float(m_safe["loss"]), float(m_insec["loss"])
    safe.seen = insec.seen = None
    _, n_safe = bs.step_fn(s_safe, tokens, counter=safe.reserve_round(W))
    _, n_insec = bi.step_fn(s_insec, tokens, counter=insec.reserve_round(W))
    nxt = abs(float(n_safe["loss"]) - float(n_insec["loss"]))
    bound = 2 * TS_LR + 1e-6
    if abs(l_safe - l_insec) > 1e-6 * abs(l_insec) or gerr > STEP or dmax > bound or nxt > 5e-3:
        fail(f"train step SAFE vs INSEC: loss {l_safe} vs {l_insec}, published gradients "
             f"{gerr} apart (bound {STEP}), parameters {dmax} apart (bound {bound}), next "
             f"losses {nxt} apart (bound 5e-3)")
    say(f"phase 5 train step SAFE vs INSEC at {TS_CMP_LAYERS} layers (full width), one step "
        f"from one state: loss {l_safe:.6f} and {l_insec:.6f}; published gradients max "
        f"|diff| {gerr:.3e} <= {STEP:.3e}; parameters max |diff| {dmax:.3e} <= 2 lr "
        f"({moved:.3%} of {bs.padded_size} words differ); next losses {nxt:.2e} apart "
        f"(<= 5e-3)")
    del model, state, s_safe, s_insec, tokens
    torch.cuda.empty_cache()


# ---- the launcher and the load harness, on the card ----------------------------------

def launcher_paths(smi):
    """``python -m repro_torch.launch.train`` at the smoke size on the card,
    as subprocesses: two uninterrupted runs of LAUNCH_STEPS steps, a run
    of half as many resumed from its checkpoint, and a FedAvg run. Reports
    how far the resumed run's final state is from an uninterrupted run's
    beside how far the two uninterrupted runs are from each other."""
    import tempfile

    from repro_torch.ckpt import latest_step, restore_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import make_aggregator
    from repro_torch.models import Model
    from repro_torch.train import make_train_step

    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", TS_ARCH, "--smoke",
            "--learners", str(TS_N)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    half = str(LAUNCH_STEPS // 2)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_launch_") as tmp:
        def launch(name, *extra):
            return subprocess.Popen(base + ["--metrics", f"{tmp}/{name}.jsonl", *extra],
                                    env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)

        def finish(procs):
            out = {}
            for name, p in procs.items():
                try:
                    stdout, stderr = p.communicate(timeout=LAUNCH_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.communicate()
                    fail(f"launcher {name}: no end within {LAUNCH_TIMEOUT_S} s")
                if p.returncode != 0:
                    fail(f"launcher {name}: exit {p.returncode}: {stderr[-2000:]}")
                out[name] = stdout.splitlines()
            return out

        def losses(name, key):
            with open(f"{tmp}/{name}.jsonl") as f:
                return [json.loads(line)[key] for line in f if line.strip()]

        steps = str(LAUNCH_STEPS)
        t0 = time.perf_counter()
        out = finish({
            "whole_a": launch("whole_a", "--steps", steps, "--ckpt-dir", f"{tmp}/a",
                              "--ckpt-every", steps),
            "whole_b": launch("whole_b", "--steps", steps, "--ckpt-dir", f"{tmp}/b",
                              "--ckpt-every", steps),
            "half": launch("half", "--steps", half, "--ckpt-dir", f"{tmp}/r",
                           "--ckpt-every", half)})
        out.update(finish({
            "resumed": launch("resumed", "--steps", steps, "--ckpt-dir", f"{tmp}/r",
                              "--ckpt-every", half),
            "federated": launch("federated", "--steps", steps, "--federated")}))
        wall = time.perf_counter() - t0
        for name, lines in out.items():
            if "model axis is 1 on one card" not in lines[0] or "on cuda" not in lines[0]:
                fail(f"launcher {name}: first line {lines[0]!r}")
        if f"resumed from step {half}" not in out["resumed"]:
            fail(f"launcher resumed: did not resume: {out['resumed']}")
        run_losses = {k: losses(k, "loss") for k in ("whole_a", "whole_b", "half", "resumed")}
        fed = losses("federated", "local_loss")
        joined = run_losses["half"] + run_losses["resumed"]
        # each step and round trains on the stream's next batch, so only the
        # train step's losses (lr 1e-3 from random weights) must fall
        for name, ls in (("whole_a", run_losses["whole_a"]), ("whole_b", run_losses["whole_b"]),
                         ("resumed", joined), ("federated", fed)):
            if len(ls) != LAUNCH_STEPS or not np.isfinite(ls).all() or (
                    name != "federated" and not ls[-1] < ls[0]):
                fail(f"launcher {name}: losses {ls}")

        cfg = get_smoke_config(TS_ARCH)
        model = Model(cfg, device="cpu")
        skel = make_train_step(model, make_aggregator("safe", TS_N, device="cpu")
                               ).init_state_fn(model.tree())
        final = {}
        for name in ("a", "b", "r"):
            d = f"{tmp}/{name}"
            if latest_step(d) != LAUNCH_STEPS:
                fail(f"launcher: no checkpoint at step {LAUNCH_STEPS} in run {name}")
            final[name], _ = restore_checkpoint(d, LAUNCH_STEPS, skel)

    def apart(x, y):
        a, b = x["master"], y["master"]
        return float((a - b).abs().max()), int((a != b).sum())

    ra, ab = apart(final["r"], final["a"]), apart(final["a"], final["b"])
    la = max(abs(x - y) for x, y in zip(joined, run_losses["whole_a"]))
    lb = max(abs(x - y) for x, y in zip(run_losses["whole_b"], run_losses["whole_a"]))
    say(f"phase 4 launcher ({smi}): 5 runs of repro_torch.launch.train --smoke on the card "
        f"in {wall:.1f} s; train-step losses {[round(x, 4) for x in run_losses['whole_a']]}, "
        f"federated {[round(x, 4) for x in fed]}")
    say(f"phase 5 launcher: resumed ({half} + {half} steps) against uninterrupted: losses "
        f"max |diff| {la:.3e}, final master vector max |diff| {ra[0]:.3e} on {ra[1]} words; "
        f"two uninterrupted runs: losses {lb:.3e}, master {ab[0]:.3e} on {ab[1]} words "
        f"(of {final['a']['master'].numel()})")


def engine_load_path(dev, launches, smi):
    """``net.run_engine_load`` against the port's broker in front of an
    ``AggregationEngine`` on the card, at the engine path's shape (n = 36,
    V = 2^20, chunked uploads and downloads); every session's answer
    bit-identical to a single round on the card."""
    from repro_torch.core import make_aggregator
    from repro_torch.kernels import build
    from repro_torch.net import SafeBroker, run_engine_load
    from repro_torch.serve import AggregationEngine

    sessions = []

    class Recording(AggregationEngine):  # the broker owns the completion hook
        def submit(self, values, **kw):
            sessions.append(super().submit(values, **kw))
            return sessions[-1]

    engine = Recording(make_aggregator("safe", N).cfg, slots=S_ENGINE, payload_words=V_ENGINE)

    async def go():
        broker = SafeBroker(engine=engine)
        addr = await broker.start()
        try:
            rep = await run_engine_load(addr, tenants=LOAD_TENANTS, rounds_per_tenant=LOAD_ROUNDS,
                                        n=N, V=V_ENGINE, seed=SEED, timeout=WIRE_WAIT_S,
                                        chunk_words=WIRE_CHUNK)
            return rep, broker.engine_errors
        finally:
            await broker.stop()

    sync()
    build.reset_launches()
    t0 = time.perf_counter()
    rep, errors = asyncio.run(go())
    wall = time.perf_counter() - t0
    counts = dict(build.launches)
    say(f"phase 4 main path engine load: {wall:.2f} s; launches {counts}")
    missing = sorted(k for k in PATH_KERNELS["engine_load"] if counts[k] <= 0)
    if missing:
        fail(f"path engine load never launched {missing}: {counts}")
    for k, c in counts.items():
        launches[k] += c
    if errors:
        fail(f"engine load: {errors} engine steps raised")
    if rep.rounds != LOAD_TENANTS * LOAD_ROUNDS or len(sessions) != rep.rounds + 1:
        fail(f"engine load: {rep.rounds} rounds, {len(sessions)} sessions")
    for sess in sessions:
        want = make_aggregator("safe", N, provisioning_seed=sess.provisioning_seed,
                               learner_master=sess.learner_master).aggregate(
            sess.values, 0, rotate=sess.rotate0)
        if not torch.equal(sess.results[0], want):
            fail(f"engine load session {sess.sid} differs from a single round")
    say(f"phase 5 engine load: {len(sessions)} sessions (the warm-up's too) bit-identical to "
        f"single rounds on the card; every tenant's check inside run_engine_load passed")
    say(f"phase 6 engine load ({smi}): LoadReport {json.dumps(rep.row())}")
    del engine, sessions
    torch.cuda.empty_cache()


def say_profile(label, fn):
    """Print one profiled call of ``fn``; returns its device busy ms."""
    wall, busy, top = profile_ms(fn)
    seen = (f"device busy {busy:.2f} ms (idle {1 - busy / wall:.0%}); top: {top}"
            if busy > 0 else "device time not measured (the profiler saw none)")
    say(f"phase 6 profile {label}: wall {wall:.2f} ms under the profiler, {seen}")
    return busy


def aggregation_paths(dev):
    """Phases 4-6 of the aggregation paths; returns the launches over
    them, the kernels' timings and, on the host, what the engine path
    published for each of ``engine_sessions``. Their tensors are freed on
    return."""
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
    published = [[r.cpu().numpy() for r in sess.results] for _, sess in sessions]

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
    return launches, times, published


# ---- the wire paths: phases 4, 5 and 6 ---------------------------------------------

async def serve_engine_tenants(engine, specs):
    """One broker in this event loop in front of ``engine``; one client per
    spec uploads it chunked (all at once), then all wait for their results.
    Returns the responses, the clock at start, at the last upload's ack and
    at the last result, the bytes the clients sent, and the broker."""
    from repro_torch.net import SafeBroker, WireClient

    broker = SafeBroker(engine=engine)
    addr = await broker.start()
    try:
        clients = [await WireClient(*addr, node=t).connect() for t in range(len(specs))]
        t0 = time.perf_counter()
        subs = await asyncio.gather(*(
            c.submit_session_chunked(spec, chunk_words=WIRE_CHUNK)
            for c, spec in zip(clients, specs)))
        t_up = time.perf_counter()
        sent = sum(c.bytes_sent for c in clients)
        res = await asyncio.gather(*(
            c.request("wait_session", {"sid": sub["sid"], "timeout": WIRE_WAIT_S})
            for c, sub in zip(clients, subs)))
        t_end = time.perf_counter()
        for c in clients:
            await c.close()
        return res, (t0, t_up, t_end), sent, broker
    finally:
        await broker.stop()


def overlap(spans, lo, hi):
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in spans)


async def wire_round(run, values, **kw):
    from repro_torch.net import SafeBroker

    broker = SafeBroker(progress_timeout=1.0, monitor_interval=0.25,
                        aggregation_timeout=WIRE_AGG_TIMEOUT)
    addr = await broker.start()
    try:
        return await run(values, addr, **kw)
    finally:
        await broker.stop()


def wire_paths(dev, launches, published, smi):
    """Phases 4-6 of the wire plane. ``wire engine``: the port's broker in
    front of the port's engine on the card, ten networked tenants (the
    engine path's sessions, values copied to the host) uploading chunked
    and collecting their results; each must equal what the in-process
    engine path ``published``. ``wire round``: SAFE and BON rounds over
    127.0.0.1 at n = 36, V = 10,000, held to the port's simulation and the
    closed forms; host only. Launches of the engine path go into
    ``launches``."""
    from repro_torch.core import make_aggregator
    from repro_torch.core.bon_protocol import bon_expected_messages, run_bon_round
    from repro_torch.core.protocol import run_safe_round
    from repro_torch.crypto.np_impl import keystream_pair_lanes_np
    from repro_torch.kernels import build
    from repro_torch.net import run_bon_round_net, run_safe_round_net
    from repro_torch.serve import AggregationEngine

    class TimedEngine(AggregationEngine):
        """Each step timed on the host clock up to a synchronise, so the
        path's wall splits into its parts."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.step_spans = []

        def step(self):
            t0 = time.perf_counter()
            done = super().step()
            sync()
            self.step_spans.append((t0, time.perf_counter()))
            return done

    specs = [dict(spec, values=spec["values"].cpu().numpy()) for spec in engine_sessions(dev)]
    torch.cuda.empty_cache()
    cfg = make_aggregator("safe", N).cfg

    sync()
    build.reset_launches()
    engine = TimedEngine(cfg, slots=S_ENGINE, payload_words=V_ENGINE)
    res, (t0, t_up, t_end), sent, broker = asyncio.run(serve_engine_tenants(engine, specs))
    counts = dict(build.launches)
    say(f"phase 4 main path wire engine: {t_end - t0:.2f} s; launches {counts}")
    missing = sorted(k for k in PATH_KERNELS["wire_engine"] if counts[k] <= 0)
    if missing:
        fail(f"path wire engine never launched {missing}: {counts}")
    for k, c in counts.items():
        launches[k] += c
    say(f"phase 4 wire engine: {len(specs)} tenants, {engine.rounds_completed} session-rounds "
        f"in {engine.steps} steps, {broker.engine_chunk_frames_in} upload chunks")

    if broker.engine_errors:
        fail(f"wire engine: {broker.engine_errors} engine steps raised")
    down = 0
    for i, (spec, r) in enumerate(zip(specs, res)):
        if r.get("status") != "done" or r["rounds"] != spec["rounds"]:
            fail(f"wire engine tenant {i}: {r.get('status')} after "
                 f"{r.get('rounds')} of {spec['rounds']} rounds")
        for k, (got, want) in enumerate(zip(r["results"], published[i])):
            if not (got.dtype == np.float32 and np.array_equal(got.view(np.uint32),
                                                               want.view(np.uint32))):
                fail(f"wire engine tenant {i} round {k} differs from the in-process engine")
            down += got.nbytes
    say(f"phase 5 wire engine: {engine.rounds_completed} session-rounds bit-identical to the "
        f"in-process engine path, engine_errors 0, no wait timed out")

    spans = engine.step_spans
    steps = sum(b - a for a, b in spans)
    up = (t_up - t0) - overlap(spans, t0, t_up)
    dl = (t_end - t_up) - overlap(spans, t_up, t_end)
    say(f"phase 6 wire engine ({smi}): wall {t_end - t0:.3f} s = upload {up:.3f} s "
        f"({sent / up / 1e9:.3f} GB/s of {sent / 1e9:.3f} GB sent) + engine steps "
        f"{steps:.3f} s ({len(spans)} steps, each to a synchronise) + download {dl:.3f} s "
        f"({down / dl / 1e9:.3f} GB/s of {down / 1e6:.1f} MB of results)")
    del engine, broker, res

    def profiled():
        return asyncio.run(serve_engine_tenants(
            TimedEngine(cfg, slots=S_ENGINE, payload_words=V_ENGINE), specs))
    say_profile("wire engine", profiled)
    torch.cuda.empty_cache()

    sync()
    build.reset_launches()
    rng = np.random.RandomState(SEED + 5)
    values = rng.uniform(-1, 1, (N, WIRE_V)).astype(np.float32)
    walls, rounds = {}, {}
    for name, dead in WIRE_DEAD.items():
        t = time.perf_counter()
        rounds[name] = asyncio.run(wire_round(run_safe_round_net, values, failed_nodes=dead,
                                              aggregation_timeout=WIRE_AGG_TIMEOUT))
        walls[name] = time.perf_counter() - t
    t = time.perf_counter()
    bon = asyncio.run(wire_round(run_bon_round_net, values))
    walls["bon"] = time.perf_counter() - t
    counts = dict(build.launches)
    say(f"phase 4 main path wire round: {sum(walls.values()):.2f} s; launches {counts}")
    if any(counts.values()):
        fail(f"the wire rounds are host code but launched kernels: {counts}")

    for name, dead in WIRE_DEAD.items():
        got = rounds[name]
        sim = run_safe_round(values, failed_nodes=list(dead),
                             aggregation_timeout=WIRE_AGG_TIMEOUT)
        f = len(dead)
        # §5.3: 4(n - f) + 2f; a dead initiator adds one should_initiate
        # per survivor before the §5.4 election
        closed = 4 * (N - f) + 2 * f + (N - f if 1 in dead else 0)
        ops = ("post_aggregate", "check_aggregate", "get_aggregate", "post_average",
               "get_average", "should_initiate")
        if not np.array_equal(got.average.view(np.uint32), sim.average.view(np.uint32)):
            fail(f"wire round {name}: average differs from the simulation")
        if (got.stats["aggregation_total"] != closed or sim.stats.aggregation_total != closed
                or any(got.stats[op] != getattr(sim.stats, op) for op in ops)):
            fail(f"wire round {name}: messages {got.stats} against the closed form {closed} "
                 f"and the simulation's {sim.stats}")
        say(f"phase 5 wire round {name}: average bit-identical to the simulation, "
            f"{closed} messages (closed form), reposts {got.monitor_reposts}, "
            f"elections {got.initiator_elections}")
    sim = run_bon_round(values)
    if not np.array_equal(bon.average.view(np.uint32), sim.average.view(np.uint32)):
        fail("wire round bon: average differs from the simulation")
    if not bon.messages == bon.expected_messages == sim.messages == bon_expected_messages(N):
        fail(f"wire round bon: {bon.messages} messages, closed form {bon_expected_messages(N)}")
    say(f"phase 5 wire round bon: average bit-identical to the simulation, "
        f"{bon.messages} messages (closed form)")
    say(f"phase 6 wire rounds ({smi}): n={N}, V={WIRE_V}: " + ", ".join(
        f"{name} {w:.3f} s" for name, w in walls.items()))

    key = np.array([0x9E3779B9, 0x7F4A7C15], np.uint32)
    best = min(wall_ms(lambda: keystream_pair_lanes_np(key, KEYSTREAM_WORDS), iters=1)
               for _ in range(3))
    say(f"phase 6 host keystream ({smi}): keystream_pair_lanes_np on {KEYSTREAM_WORDS} words "
        f"{best:.1f} ms, {KEYSTREAM_WORDS / best / 1e3:.2f} M words/s on one host core "
        f"(os.cpu_count() {os.cpu_count()})")


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

    launches, times, published = aggregation_paths(dev)
    torch.cuda.empty_cache()
    wire_paths(dev, launches, published, smi)
    torch.cuda.empty_cache()
    fedavg_paths(dev, launches, err, smi)
    torch.cuda.empty_cache()
    train_step_paths(dev, launches, err, smi)
    launcher_paths(smi)
    engine_load_path(dev, launches, smi)
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
