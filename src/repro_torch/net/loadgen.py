"""Load harness for the wire plane: S concurrent tenants, one broker.

A copy of the JAX package's ``net/loadgen.py`` with its imports pointed at
the port: the same load shapes, checks and reports, driving the port's
broker, learners and (through the engine plane) the port's
``AggregationEngine`` on its device.

Three load shapes, matching the broker's planes:

  * :func:`run_engine_load` — tenants submit whole aggregation sessions
    (``submit_session``/``wait_session``); the broker batches them
    through one :class:`~repro_torch.serve.agg_engine.AggregationEngine`
    step. This is the ROADMAP's many-tenants story: wire concurrency in
    front, one batched device step behind.
  * :func:`run_protocol_load` — tenants each run a *full* n-learner
    SAFE round over TCP (n connections, 4n RPCs, real long-polls), i.e.
    the paper's distributed system under concurrent sessions.
  * :func:`run_paper_scale` — ONE round at the paper's headline scale
    (n=36, §6.1: where SAFE beats Bonawitz-style masking by 70x/56x
    with/without failover) and beyond it (n=128/512), with
    the §5 closed-form message counts AND sim↔wire bit-identity
    asserted inside the harness — optionally against a sharded broker
    fleet, and optionally under mid-round churn instead of pre-round
    death. ``benchmarks/paper_scale.py`` pairs it with the
    ``core/bon_protocol.py`` baseline at the same n
    (EXPERIMENTS.md §Paper-scale).

:func:`run_slo_load` closes the observability loop: heavy-
tailed multi-tenant profiles driven against a live ``get_metrics``
poller, with the SLOs — p99 round latency, zero dropped sessions,
bounded chunk backlog — evaluated in-harness into a pass/fail the CI
smoke gate asserts (``benchmarks/slo.py``).

For scale-out measurements ``run_protocol_load`` can spread its tenants
over spawned worker processes (``client_procs``) so a sharded broker
(``repro_torch.net.shard``) is measured against a client that can actually
saturate it; :func:`ensure_fd_headroom` lifts RLIMIT_NOFILE for the
thousands of sockets an n=512 round opens.

The JAX package's benchmarks (``benchmarks/net_load.py``,
``benchmarks/paper_scale.py``) drive the reference's copy of this module.
"""
from __future__ import annotations

import asyncio
import dataclasses
import multiprocessing
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.net.broker import SafeBroker
from repro_torch.net.client import (
    PersistentNetSession,
    WireClient,
    run_bon_round_net,
    run_safe_round_net,
)
from repro_torch.net.shard import ShardedBroker

Addr = Tuple[str, int]


def ensure_fd_headroom(need: int) -> None:
    """Raise the soft RLIMIT_NOFILE toward the hard limit if ``need``
    descriptors would not fit; fail with a clear message otherwise.

    Paper-scale runs open O(n) learner connections on each side of the
    broker — at n=512 that is thousands of sockets, and the default
    soft limit of 1024 dies mid-round with a cryptic EMFILE."""
    try:
        import resource
    except ImportError:  # non-POSIX: nothing to tune, let the OS decide
        return
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft >= need:
        return
    want = min(max(need, soft), hard if hard > 0 else need)
    try:
        resource.setrlimit(resource.RLIMIT_NOFILE, (want, hard))
        soft = want
    except (ValueError, OSError):
        pass
    if soft < need:
        raise RuntimeError(
            f"RLIMIT_NOFILE soft limit {soft} < {need} descriptors this "
            f"run needs (hard limit {hard}); raise it with `ulimit -n`")


@dataclasses.dataclass
class LoadReport:
    plane: str
    tenants: int
    rounds: int          # total rounds completed across tenants
    wall_s: float
    rounds_per_s: float
    p50_s: float
    p99_s: float
    latencies_s: List[float]

    def row(self) -> dict:
        return {
            "plane": self.plane,
            "tenants": self.tenants,
            "rounds": self.rounds,
            "wall_s": self.wall_s,
            "rounds_per_s": self.rounds_per_s,
            "p50_s": self.p50_s,
            "p99_s": self.p99_s,
        }


def _report(plane: str, tenants: int, lats: List[float],
            wall: float) -> LoadReport:
    arr = np.asarray(lats, np.float64)
    return LoadReport(
        plane=plane, tenants=tenants, rounds=len(lats), wall_s=wall,
        rounds_per_s=len(lats) / wall if wall > 0 else float("inf"),
        p50_s=float(np.percentile(arr, 50)),
        p99_s=float(np.percentile(arr, 99)),
        latencies_s=lats)


@dataclasses.dataclass
class SLOReport:
    """One SLO-gated load run: client-observed latencies plus
    the broker's own metrics plane, with the service-level objectives
    evaluated in-harness so a regression fails the bench, not just
    drifts a JSON number."""

    profile: str
    tenants: int
    heavy_tenants: int
    rounds: int
    wall_s: float
    rounds_per_s: float
    p50_s: float
    p99_s: float
    dropped_sessions: int
    busy_rejections: int      # broker-side admissions refused (total)
    shed_tenants: int         # tenants busy'd >= once that still finished
    backlog_peak_bytes: int   # max chunk_backlog_bytes seen while polling
    metrics_samples: int      # live get_metrics polls during the run
    broker_rounds_completed: int
    slo_p99_s: float
    slo_backlog_bytes: int
    passed: bool
    error: Optional[str] = None
    wan_profile: str = "none"

    def row(self) -> dict:
        return {k: getattr(self, k) for k in (
            "profile", "tenants", "heavy_tenants", "rounds", "wall_s",
            "rounds_per_s", "p50_s", "p99_s", "dropped_sessions",
            "busy_rejections", "shed_tenants", "backlog_peak_bytes",
            "metrics_samples", "broker_rounds_completed", "slo_p99_s",
            "slo_backlog_bytes", "passed", "wan_profile")}


async def run_slo_load(
    *,
    profile: str = "steady",
    tenants: int = 4,
    rounds_per_tenant: int = 3,
    n: int = 6,
    V: int = 256,
    heavy_tenants: int = 1,
    heavy_factor: int = 8,
    heavy_subgroups: int = 2,
    chunk_words: Optional[int] = None,
    heavy_chunk_words: Optional[int] = None,
    chunk_budget_bytes: Optional[int] = "default",  # sentinel, see below
    seed: int = 0,
    shards: int = 1,
    slo_p99_s: float = 60.0,
    slo_backlog_bytes: Optional[int] = None,
    metrics_poll_s: float = 0.02,
    bit_identical: bool = True,
    progress_timeout: float = 2.0,
    monitor_interval: float = 0.5,
    aggregation_timeout: float = 120.0,
    wan_profile: Optional[str] = None,
    wan_seed: int = 0,
    timeout_scale: float = 1.0,
) -> SLOReport:
    """Heavy-tailed multi-tenant load with asserted SLOs.

    Starts its own broker (sharded when ``shards > 1``), drives
    ``tenants`` concurrent tenants — each running full n-learner SAFE
    rounds — and polls the live ``get_metrics`` plane the whole time.
    Three traffic profiles:

      * ``"steady"`` — every tenant ships the same V-word vector; the
        uniform baseline (no admission pressure expected).
      * ``"heavy_tail"`` — the first ``heavy_tenants`` tenants ship
        ``heavy_factor``× larger vectors over the chunk plane while the
        rest stay small: the many-small/few-huge shape real federations
        have, under the default (ample) chunk budget.
      * ``"busy_shed"`` — heavy tail against a deliberately small
        per-session chunk budget (one chunk), so the flooding tenants'
        concurrent transfers get ``busy``-shed and must retry-after
        their way through (the §13 admission loop) while small tenants
        never see a rejection.

    Heavy tenants run ``heavy_subgroups`` parallel §5.5 group chains
    (default 2 — the minimum n is then 6, two rings of 3 for the
    privacy bound): the two chains post concurrently into ONE session,
    which is what makes admission pressure *deterministic* — with a
    single chain the SAFE hops are strictly sequential and the backlog
    drains between transfers, so nothing would ever be refused.

    SLOs evaluated into ``passed``: client-observed p99 round latency
    ``<= slo_p99_s``; **zero** dropped sessions (every tenant finished
    every round with the §5 closed-form message count and — when
    ``bit_identical`` — an average ``np.array_equal`` to the sim's);
    peak chunk backlog ``<= slo_backlog_bytes`` (default: 2× tenants ×
    (budget + one full payload) — an admitted transfer's continuations
    may legitimately overrun the budget, §13, so "bounded" means
    bounded by that, not by the budget alone). A tenant that was
    busy'd at least once and still
    finished all its rounds counts into ``shed_tenants`` — the
    shed-and-recovered signal CI gates on.

    ``wan_profile`` (a ``repro_torch.net.faults.WAN_PROFILES`` name) runs
    every tenant behind that WAN emulation — each tenant gets its own
    interceptor seeded ``wan_seed + tenant`` so fault draws are
    reproducible per tenant, not interleaved in scheduler order. This
    is the SLO *calibration* path: a declared p99 under a 50
    ms-RTT profile is only honest if the harness can actually hold it,
    so ``benchmarks/slo.py`` carries a ``wan_continental`` row whose
    ``slo_p99_s`` is derived from RTT × the §5 chain depth. Pair with
    ``timeout_scale``/``progress_timeout`` generous enough that a slow
    WAN hop does not read as a dead node.
    """
    from repro_torch.core.protocol import run_safe_round
    from repro_torch.net.broker import DEFAULT_CHUNK_BUDGET_BYTES
    from repro_torch.net.faults import make_wan_interceptor

    if profile not in ("steady", "heavy_tail", "busy_shed"):
        raise ValueError(f"unknown SLO profile {profile!r}")
    heavy = set(range(heavy_tenants)) if profile != "steady" else set()
    heavy_V = V * heavy_factor
    if heavy_chunk_words is None:
        # chunk the heavy tenants' traffic so the transfer plane (and
        # its budget) is actually exercised: ~16 chunks per payload
        heavy_chunk_words = max(1, heavy_V // 16)
    if chunk_budget_bytes == "default":
        if profile == "busy_shed":
            # ONE chunk of budget: the first in-flight transfer claims
            # the whole session (its continuations are always admitted —
            # §13 keeps streams deadlock-free, and an empty backlog
            # always admits), so the OTHER group chain's first chunk is
            # refused until it drains — guaranteed shedding
            chunk_budget_bytes = heavy_chunk_words * 4
        else:
            chunk_budget_bytes = DEFAULT_CHUNK_BUDGET_BYTES
    budget = (DEFAULT_CHUNK_BUDGET_BYTES if chunk_budget_bytes is None
              else int(chunk_budget_bytes))
    if slo_backlog_bytes is None:
        # "bounded" per §13 means: at most ~one over-budget transfer's
        # continuations per concurrently-admitted chain per session
        # (continuations are never refused), plus the budget itself —
        # NOT that backlog never exceeds the budget
        max_payload = 4 * ((heavy_V if heavy else V) + 1)
        slo_backlog_bytes = 2 * tenants * (budget + max_payload)

    rng = np.random.RandomState(seed)
    tenant_vals = [
        rng.uniform(-1, 1, (n, heavy_V if t in heavy else V))
        .astype(np.float32) for t in range(tenants)]
    ensure_fd_headroom(4 * n * tenants + 128)

    broker_kw = dict(progress_timeout=progress_timeout,
                     monitor_interval=monitor_interval,
                     aggregation_timeout=aggregation_timeout,
                     chunk_budget_bytes=chunk_budget_bytes)
    if shards > 1:
        broker = ShardedBroker(shards, **broker_kw)
    else:
        broker = SafeBroker(**broker_kw)
    addr = await broker.start()
    metric_ports = (list(broker.shard_ports) if shards > 1
                    else [addr[1]])

    peak = {"backlog": 0, "samples": 0}
    stop_polling = asyncio.Event()

    async def poll_metrics() -> None:
        clients = [await WireClient(addr[0], p).connect()
                   for p in metric_ports]
        try:
            while not stop_polling.is_set():
                backlog = 0
                for c in clients:
                    m = await c.request("get_metrics", {})
                    backlog += int(m["chunk_backlog_bytes"])
                peak["backlog"] = max(peak["backlog"], backlog)
                peak["samples"] += 1
                await asyncio.sleep(metrics_poll_s)
        finally:
            for c in clients:
                await c.close()

    async def tenant(t: int) -> Tuple[List[float], int]:
        vals = tenant_vals[t]
        tV = vals.shape[1]
        cw = heavy_chunk_words if t in heavy else chunk_words
        sg = heavy_subgroups if t in heavy else 1
        lats: List[float] = []
        busy = 0
        icpt = (make_wan_interceptor(wan_profile, seed=wan_seed + t)
                if wan_profile else None)
        for r in range(rounds_per_tenant):
            t0 = time.perf_counter()
            # stream=False pins chunked tenants to the buffered chunk
            # plane: these profiles exist to put admission control
            # under chunk-frame pressure, and the small-payload
            # fast path (auto stream=None) would otherwise skip the
            # chunk plane wholesale for frame-sized payloads
            res = await run_safe_round_net(
                vals, addr, subgroups=sg,
                provisioning_seed=0xC0FFEE + t,
                learner_master=0x5EED + 17 * t, counter=r * (tV + 1),
                chunk_words=cw,
                stream=False if cw is not None else None,
                interceptor=icpt, timeout_scale=timeout_scale)
            lats.append(time.perf_counter() - t0)
            busy += int(res.stats.get("busy_rejections", 0))
            got = res.stats["aggregation_total"]
            expected = 4 * n + (sg if sg > 1 else 0)  # §5/§5.5 forms
            if got != expected:
                raise RuntimeError(
                    f"tenant {t} round {r}: {got} aggregation messages, "
                    f"§5 closed form says {expected}")
            _check_round(t, r, res, vals)
            if bit_identical:
                sim = run_safe_round(
                    vals, subgroups=sg, provisioning_seed=0xC0FFEE + t,
                    learner_master=0x5EED + 17 * t, counter=r * (tV + 1))
                if not np.array_equal(sim.average, res.average):
                    raise RuntimeError(
                        f"tenant {t} round {r}: wire average not "
                        f"bit-identical to the sim")
        return lats, busy

    poller = asyncio.create_task(poll_metrics())
    error: Optional[str] = None
    dropped = 0
    shed = 0
    lats: List[float] = []
    busy_total = 0
    broker_rounds = 0
    try:
        t0 = time.perf_counter()
        settled = await asyncio.gather(
            *(tenant(t) for t in range(tenants)), return_exceptions=True)
        wall = time.perf_counter() - t0
        for t, res in enumerate(settled):
            if isinstance(res, BaseException):
                dropped += 1
                if error is None:
                    error = f"tenant {t}: {type(res).__name__}: {res}"
                continue
            t_lats, t_busy = res
            lats.extend(t_lats)
            busy_total += t_busy
            if t_busy > 0:
                shed += 1  # busy'd at least once, still finished
        # one deterministic post-run snapshot (the poller races rounds)
        mc = await WireClient(*addr).connect()
        try:
            if shards > 1:
                for p in metric_ports:
                    await mc.redirect(p)
                    m = await mc.request("get_metrics", {})
                    broker_rounds += int(m["rounds_completed"])
            else:
                m = await mc.request("get_metrics", {})
                broker_rounds = int(m["rounds_completed"])
        finally:
            await mc.close()
    finally:
        stop_polling.set()
        try:
            await poller
        except Exception:  # noqa: BLE001 — a poll race never fails a run
            pass
        await broker.stop()

    if profile == "steady" and busy_total:
        error = error or (f"steady profile saw {busy_total} busy "
                          f"rejections under the default budget")
    arr = np.asarray(lats or [0.0], np.float64)
    p99 = float(np.percentile(arr, 99))
    passed = (error is None and dropped == 0 and p99 <= slo_p99_s
              and peak["backlog"] <= slo_backlog_bytes)
    return SLOReport(
        profile=profile, tenants=tenants, heavy_tenants=len(heavy),
        rounds=len(lats), wall_s=wall,
        rounds_per_s=len(lats) / wall if wall > 0 else float("inf"),
        p50_s=float(np.percentile(arr, 50)), p99_s=p99,
        dropped_sessions=dropped, busy_rejections=busy_total,
        shed_tenants=shed, backlog_peak_bytes=peak["backlog"],
        metrics_samples=peak["samples"],
        broker_rounds_completed=broker_rounds,
        slo_p99_s=slo_p99_s, slo_backlog_bytes=int(slo_backlog_bytes),
        passed=bool(passed), error=error,
        wan_profile=wan_profile or "none")


async def run_engine_load(addr: Addr, *, tenants: int = 8,
                          rounds_per_tenant: int = 8, n: int = 8,
                          V: int = 1024, seed: int = 0,
                          warmup: bool = True,
                          timeout: float = 300.0,
                          chunk_words: Optional[int] = None) -> LoadReport:
    """Each tenant submits ``rounds_per_tenant`` single-round sessions
    back-to-back (closed-loop), measuring submit→published latency.

    ``chunk_words`` routes submit values and result fetches over the §6
    chunk plane — the path for engine payloads beyond one frame."""
    rng = np.random.RandomState(seed)
    tenant_vals = [rng.uniform(-1, 1, (n, V)).astype(np.float32)
                   for _ in range(tenants)]

    async def submit_and_wait(client, vals, t, r):
        sub_kw = {"values": vals, "rounds": 1,
                  "provisioning_seed": 0xC0FFEE + t,
                  "learner_master": 0x5EED + 17 * t,
                  "rotate0": r}
        if chunk_words is not None:
            sub = await client.submit_session_chunked(sub_kw, chunk_words)
            res = await client.wait_session_chunked(
                sub["sid"], timeout=timeout, chunk_words=chunk_words)
        else:
            sub = await client.request("submit_session", sub_kw)
            res = await client.request(
                "wait_session", {"sid": sub["sid"], "timeout": timeout})
        if res.get("status") != "done":
            raise RuntimeError(f"tenant {t} round {r}: {res}")
        return res

    if warmup:  # first submit compiles the engine program — keep it
        client = await WireClient(*addr).connect()
        try:
            await submit_and_wait(client, tenant_vals[0], 0, 0)
        finally:
            await client.close()

    async def tenant(t: int) -> List[float]:
        client = await WireClient(*addr, node=t).connect()
        lats = []
        try:
            for r in range(rounds_per_tenant):
                t0 = time.perf_counter()
                res = await submit_and_wait(client, tenant_vals[t], t, r)
                lats.append(time.perf_counter() - t0)
                exp = tenant_vals[t].mean(0)
                got = res["results"][0]
                if np.abs(got - exp).max() > 1e-2:
                    raise RuntimeError(f"tenant {t} got a wrong average")
        finally:
            await client.close()
        return lats

    t0 = time.perf_counter()
    per_tenant = await asyncio.gather(*(tenant(t) for t in range(tenants)))
    wall = time.perf_counter() - t0
    lats = [x for lat in per_tenant for x in lat]
    return _report("engine", tenants, lats, wall)


def _check_round(t: int, r: int, res, vals: np.ndarray) -> None:
    """Shared per-round sanity check for the protocol-load shapes."""
    if res.crashed_nodes:
        # churn plan fired: the published mean is over a subset whose
        # membership depends on *when* each crash landed (before vs.
        # after reposting) — value correctness under churn is pinned by
        # tests/test_net.py, not the loadgen
        return
    if res.average is None:
        raise RuntimeError(f"tenant {t} round {r}: no average")
    exp = vals.mean(0)
    if np.abs(res.average - exp).max() > 1e-2:
        raise RuntimeError(f"tenant {t} round {r}: wrong average")


async def _drive_tenants(addr: Addr, tenant_indices: Sequence[int], *,
                         rounds_per_tenant: int, n: int, V: int,
                         seed: int, interceptor=None,
                         chunk_words: Optional[int] = None,
                         prefetch_depth: Optional[int] = None,
                         persistent: bool = False) -> List[float]:
    """Drive a subset of tenants against a running broker; the shared
    core of :func:`run_protocol_load` for both the in-process and the
    multi-process (``client_procs``) paths. Tenant values are
    regenerated from ``seed`` in *global* tenant order, so any process
    driving tenant ``t`` sees the same f32 matrix."""
    max_t = max(tenant_indices) + 1 if tenant_indices else 0
    rng = np.random.RandomState(seed)
    tenant_vals = [rng.uniform(-1, 1, (n, V)).astype(np.float32)
                   for _ in range(max_t)]

    async def tenant(t: int) -> List[float]:
        ic = interceptor(t) if callable(interceptor) else interceptor
        lats = []
        if persistent:
            sess = PersistentNetSession(
                addr, n, provisioning_seed=0xC0FFEE + t,
                learner_master=0x5EED + 17 * t, interceptor=ic,
                chunk_words=chunk_words, prefetch_depth=prefetch_depth,
                words_per_round=V + 1)
            await sess.open()
            try:
                for r in range(rounds_per_tenant):
                    t0 = time.perf_counter()
                    res = await sess.run_round(tenant_vals[t])
                    lats.append(time.perf_counter() - t0)
                    _check_round(t, r, res, tenant_vals[t])
            finally:
                await sess.close()
            return lats
        for r in range(rounds_per_tenant):
            t0 = time.perf_counter()
            res = await run_safe_round_net(
                tenant_vals[t], addr,
                provisioning_seed=0xC0FFEE + t,
                learner_master=0x5EED + 17 * t,
                counter=r * (V + 1),
                interceptor=ic, chunk_words=chunk_words,
                prefetch_depth=prefetch_depth)
            lats.append(time.perf_counter() - t0)
            _check_round(t, r, res, tenant_vals[t])
        return lats

    per_tenant = await asyncio.gather(*(tenant(t) for t in tenant_indices))
    return [x for lat in per_tenant for x in lat]


def _client_worker_main(addr: Addr, tenant_indices, drive_kw: dict,
                        conn, start_ev) -> None:
    """Spawn target for one client-load worker process: signal ready,
    wait for the synchronized start (so spawn + import time stays out
    of the measured wall), drive the tenant subset, ship latencies."""
    try:
        conn.send("ready")
        start_ev.wait()
        lats = asyncio.run(
            _drive_tenants(addr, list(tenant_indices), **drive_kw))
        conn.send(("ok", lats))
    except BaseException as e:  # noqa: BLE001 — parent re-raises
        conn.send(("error", f"{type(e).__name__}: {e}"))
    finally:
        conn.close()


async def run_protocol_load(addr: Addr, *, tenants: int = 4,
                            rounds_per_tenant: int = 3, n: int = 8,
                            V: int = 256, seed: int = 0,
                            interceptor=None,
                            chunk_words: Optional[int] = None,
                            prefetch_depth: Optional[int] = None,
                            persistent: bool = False,
                            client_procs: Optional[int] = None
                            ) -> LoadReport:
    """Each tenant runs full n-learner SAFE rounds concurrently with
    every other tenant — one broker session per round by default, or
    (``persistent=True``) all of a tenant's rounds on ONE
    :class:`~repro_torch.net.client.PersistentNetSession` (shared keys,
    connections and counter space — the amortized path the streaming
    benchmark compares against the rebuild path).

    ``interceptor`` is either a shared Interceptor instance or a
    callable ``tenant_index -> Interceptor`` — use the factory form for
    reproducible per-tenant fault plans (tenants reuse node ids, so a
    shared instance's per-node RNG streams interleave in scheduler
    order; see repro_torch.net.faults).

    ``client_procs`` spreads the tenants over that many *worker
    processes* (spawned, start-synchronized so setup stays out of the
    wall measurement). With a sharded broker the single client event
    loop is otherwise the new bottleneck — one process cannot drive
    more load than one shard can serve, and the scaling curve would
    measure the client. Interceptors don't cross process boundaries
    (they are live objects with RNG state), so the two are exclusive.
    """
    drive_kw = dict(rounds_per_tenant=rounds_per_tenant, n=n, V=V,
                    seed=seed, chunk_words=chunk_words,
                    prefetch_depth=prefetch_depth, persistent=persistent)
    if not client_procs or client_procs <= 1:
        t0 = time.perf_counter()
        lats = await _drive_tenants(addr, range(tenants),
                                    interceptor=interceptor, **drive_kw)
        wall = time.perf_counter() - t0
        return _report("protocol", tenants, lats, wall)

    if interceptor is not None:
        raise ValueError("interceptor is not supported with client_procs "
                         "(live fault plans don't cross processes)")
    procs = min(client_procs, tenants)
    slices = [list(range(w, tenants, procs)) for w in range(procs)]
    ctx = multiprocessing.get_context("spawn")
    start_ev = ctx.Event()
    workers, pipes = [], []
    loop = asyncio.get_running_loop()
    try:
        for idx in slices:
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=_client_worker_main,
                args=(addr, idx, drive_kw, child, start_ev), daemon=True)
            proc.start()
            child.close()
            workers.append(proc)
            pipes.append(parent)
        for pipe in pipes:  # all interpreters up before the clock starts
            if not await loop.run_in_executor(None, pipe.poll, 120.0):
                raise RuntimeError("client worker failed to report ready")
            msg = await loop.run_in_executor(None, pipe.recv)
            if msg != "ready":
                raise RuntimeError(f"client worker: {msg}")
        t0 = time.perf_counter()
        start_ev.set()
        lats: List[float] = []
        for pipe in pipes:
            status, payload = await loop.run_in_executor(None, pipe.recv)
            if status != "ok":
                raise RuntimeError(f"client worker failed: {payload}")
            lats.extend(payload)
        wall = time.perf_counter() - t0
    finally:
        for proc in workers:
            await loop.run_in_executor(None, proc.join, 10.0)
        for proc in workers:
            if proc.is_alive():
                proc.terminate()
        for pipe in pipes:
            pipe.close()
    return _report("protocol", tenants, lats, wall)


async def run_paper_scale(
    *,
    n: int = 36,
    V: int = 256,
    failures: Iterable[int] = (),
    churn: Optional[Dict[int, int]] = None,
    seed: int = 0,
    shards: int = 1,
    chunk_words: Optional[int] = None,
    prefetch_depth: Optional[int] = None,
    stream: Optional[bool] = True,
    weights: Optional[np.ndarray] = None,
    bit_identical: bool = True,
    interceptor=None,
    timeout_scale: float = 1.0,
    progress_timeout: float = 0.3,
    monitor_interval: float = 0.1,
    aggregation_timeout: float = 60.0,
) -> dict:
    """One SAFE round over real TCP at paper scale, closed forms checked.

    Starts a fresh broker, runs ``run_safe_round_net`` with n learners
    (``failures`` dead before the round — the paper's §6.1 failover
    experiment takes out nodes 4–6 after key exchange), and asserts:

      * MessageStats == §5 closed form 4(n−f) + 2f (4n when f=0);
      * one §5.3 monitor repost per dead node;
      * the published average equals the survivors' clear-text mean;
      * (``bit_identical``) the wire average is ``np.array_equal`` to
        the discrete-event simulation's for the same inputs — the
        sim↔wire discipline at n=128+, not just test-sized n.

    ``churn`` maps node id → op count after which the node crashes
    *mid-round* (repro_torch.net.faults.ChurnInterceptor) — failover under
    live churn instead of pre-round death. Message totals under churn
    depend on when each crash lands relative to reposting, so the
    closed form is reported but only bounded (≥ the all-crash-early
    form), while bit-identity vs. the sim with the same nodes dead
    still holds exactly. ``shards`` > 1 runs the round against a
    :class:`~repro_torch.net.shard.ShardedBroker` fleet — same assertions,
    sharded runtime (redirect + direct-dial paths under load).
    ``interceptor`` layers extra transport faults (e.g. a WAN profile
    from ``repro_torch.net.faults.make_wan_interceptor``) under any churn
    schedule; pair it with ``timeout_scale`` and generous
    ``progress_timeout`` so a slow WAN hop doesn't read as a dead node.

    Returns a flat row for the bench harness (wall seconds, messages,
    bytes, chunk-plane frame counts). ``chunk_words`` prices the
    chunk-streaming path at the same scale.
    """
    from repro_torch.net.faults import Chain, ChurnInterceptor

    rng = np.random.RandomState(seed)
    vals = rng.uniform(-1, 1, (n, V)).astype(np.float32)
    failed = sorted(set(failures))
    churn = dict(churn or {})
    if failed and churn:
        raise ValueError("pick failures= (pre-round) or churn= "
                         "(mid-round), not both")
    # each live learner holds a control + possibly an aux chunk
    # connection, broker mirrors both; headroom for pipes/listeners
    ensure_fd_headroom(4 * n + 128)
    if churn:
        churn_icpt = ChurnInterceptor(churn)
        interceptor = (Chain(interceptor, churn_icpt) if interceptor
                       else churn_icpt)
    broker_kw = dict(progress_timeout=progress_timeout,
                     monitor_interval=monitor_interval,
                     aggregation_timeout=aggregation_timeout)
    if shards > 1:
        broker = ShardedBroker(shards, **broker_kw)
    else:
        broker = SafeBroker(**broker_kw)
    addr = await broker.start()
    try:
        res = await run_safe_round_net(
            vals, addr, failed_nodes=failed, weights=weights,
            interceptor=interceptor, timeout_scale=timeout_scale,
            chunk_words=chunk_words,
            prefetch_depth=prefetch_depth, stream=stream)
    finally:
        await broker.stop()

    dead = sorted(churn) if churn else failed
    f = len(dead)
    expected = 4 * (n - f) + 2 * f
    got = res.stats["aggregation_total"]
    if churn:
        if res.crashed_nodes != tuple(sorted(churn)):
            raise AssertionError(
                f"churn plan {sorted(churn)} but crashed nodes "
                f"{res.crashed_nodes}")
        if got < expected:
            raise AssertionError(
                f"n={n} churn f={f}: {got} aggregation messages below "
                f"the §5 floor {expected}")
    else:
        if got != expected:
            raise AssertionError(
                f"n={n} f={f}: {got} aggregation messages, §5 closed "
                f"form says {expected}")
        if res.monitor_reposts != f:
            raise AssertionError(
                f"{res.monitor_reposts} monitor reposts for {f} dead "
                f"nodes")
    mask = np.ones(n, bool)
    for node in dead:
        mask[node - 1] = False
    if weights is None:
        exp_avg = vals[mask].mean(0)
    else:
        w = np.asarray(weights, np.float64)[mask]
        exp_avg = (vals[mask] * w[:, None]).sum(0) / w.sum()
    if np.abs(res.average - exp_avg).max() > 1e-2:
        raise AssertionError("published average off the survivors' mean")
    if bit_identical:
        from repro_torch.core.protocol import run_safe_round

        sim = run_safe_round(vals, failed_nodes=dead, weights=weights)
        if not np.array_equal(sim.average, res.average):
            raise AssertionError(
                f"n={n} f={f} shards={shards}: wire average is not "
                f"bit-identical to the simulation")
    return {
        "n": n,
        "V": V,
        "failures": f,
        "churn": bool(churn),
        "shards": shards,
        "messages": got,
        "expected_messages": expected,
        "monitor_reposts": res.monitor_reposts,
        "wall_s": res.wall_time,
        "bytes_sent": res.bytes_sent,
        "chunk_frames_in": res.stats["chunk_frames_in"],
        "chunk_frames_out": res.stats["chunk_frames_out"],
        "transfers_completed": res.stats["transfers_completed"],
        "streamed_combines": res.streamed_combines,
        "bit_identical": bool(bit_identical),
    }


async def run_bon_scale(
    *,
    n: int = 36,
    V: int = 256,
    failures: Iterable[int] = (),
    churn: Optional[Dict[int, int]] = None,
    seed: int = 0,
    threshold: Optional[int] = None,
    interceptor=None,
    bit_identical: bool = True,
    roster_timeout: float = 0.5,
    monitor_interval: float = 0.1,
    aggregation_timeout: float = 60.0,
    timeout_scale: float = 1.0,
) -> dict:
    """One BON baseline round over real TCP, closed form checked.

    The Bonawitz-style twin of :func:`run_paper_scale`: starts
    a fresh broker, drives ``run_bon_round_net`` with n learners (every
    node connects — BON dropouts fail *after* Rounds 0–1, unlike SAFE's
    pre-round deaths), and asserts:

      * BonStats == the closed form ``2n + 2n(n−1) + ℓ(n+2)`` with
        ``ℓ = n − f`` (docs/PROTOCOL.md §14) — exact even under
        ``churn``, because a BON crash schedule of ``2n`` ops lands
        precisely on the R1/R2 boundary, the point where the sim's
        ``failed_nodes`` semantics place dropouts;
      * the published average equals the survivors' clear-text mean;
      * (``bit_identical``) the wire average is ``np.array_equal`` to
        ``run_bon_round``'s for the same inputs and dropout set.

    ``failures`` marks nodes that stop cooperatively after Round 1;
    ``churn`` maps node → op budget for
    :class:`~repro_torch.net.faults.ChurnInterceptor` (pass ``2n`` per victim
    for the sim-equivalent point). ``interceptor`` layers WAN faults
    (``repro_torch.net.faults.make_wan_interceptor``) on clean runs. Returns
    a flat bench row like ``run_paper_scale``'s.
    """
    from repro_torch.core.bon_protocol import run_bon_round
    from repro_torch.net.faults import Chain, ChurnInterceptor

    rng = np.random.RandomState(seed)
    vals = rng.uniform(-1, 1, (n, V)).astype(np.float32)
    failed = sorted(set(failures))
    churn = dict(churn or {})
    if failed and churn:
        raise ValueError("pick failures= (post-R1) or churn= "
                         "(op schedule), not both")
    ensure_fd_headroom(4 * n + 128)
    icpt = interceptor
    if churn:
        churn_icpt = ChurnInterceptor(churn)
        icpt = Chain(icpt, churn_icpt) if icpt else churn_icpt
    broker = SafeBroker(monitor_interval=monitor_interval,
                        aggregation_timeout=aggregation_timeout)
    addr = await broker.start()
    try:
        res = await run_bon_round_net(
            vals, addr, failed_nodes=failed, threshold=threshold,
            seed=seed, roster_timeout=roster_timeout,
            interceptor=icpt, timeout_scale=timeout_scale)
    finally:
        await broker.stop()

    dead = sorted(set(res.crashed_nodes) | set(failed))
    f = len(dead)
    if churn and sorted(churn) != dead:
        raise AssertionError(
            f"churn plan {sorted(churn)} but crashed nodes {dead}")
    if res.messages != res.expected_messages:
        raise AssertionError(
            f"BON n={n} f={f}: {res.messages} messages, closed form "
            f"says {res.expected_messages}")
    mask = np.ones(n, bool)
    for node in dead:
        mask[node - 1] = False
    exp_avg = vals[mask].mean(0)
    if np.abs(res.average - exp_avg).max() > 1e-2:
        raise AssertionError("BON average off the survivors' mean")
    if bit_identical:
        sim = run_bon_round(vals, failed_nodes=dead, threshold=threshold,
                            seed=seed)
        if not np.array_equal(sim.average, res.average):
            raise AssertionError(
                f"BON n={n} f={f}: wire average is not bit-identical "
                f"to the simulation")
    return {
        "protocol": "bon",
        "n": n,
        "V": V,
        "failures": f,
        "churn": bool(churn),
        "messages": res.messages,
        "expected_messages": res.expected_messages,
        "wall_s": res.wall_time,
        "bytes_sent": res.bytes_sent,
        "shares_reconstructed": res.stats.get("shares_reconstructed", 0),
        "bit_identical": bool(bit_identical),
    }


async def run_hierarchical_scale(
    *,
    n: int = 36,
    orgs: int = 3,
    V: int = 256,
    failed_orgs: Iterable[int] = (),
    failed_nodes: Iterable[int] = (),
    initiator_fails: bool = False,
    seed: int = 0,
    bit_identical: bool = True,
    progress_timeout: float = 1.0,
    monitor_interval: float = 0.2,
    aggregation_timeout: float = 60.0,
    parent_timeout: Optional[float] = None,
) -> dict:
    """One §5.10 chain-of-chains round over real TCP, both levels'
    closed forms checked (docs/PROTOCOL.md §15).

    Starts a parent broker and a child broker (all ``orgs`` child
    sessions on the latter — one broker per org is the deployment
    picture, one broker hosting them all is the same wire path), runs
    :func:`~repro_torch.net.client.run_hierarchical_round_net`, and asserts:

      * per surviving org ``g`` with ``f_g`` dead learners:
        ``MessageStats == 4(n_g − f_g) + 2 f_g + 1`` (the §5 form for a
        single-group session from a ``subgroups=orgs`` build, ``+1`` for
        the org's one global publish) and one monitor repost per dead
        learner;
      * parent level: ``hierarchy_total == 2(c − f)`` for ``c = orgs``
        and ``f`` whole-org crashes — one ``post_org_average`` up and
        one ``get_org_average`` down per surviving org, nothing per
        crashed org (elided like a dead learner);
      * crashed orgs come back in ``crashed_orgs`` exactly as planned;
      * (``bit_identical``) the parent average is ``np.array_equal`` to
        ``run_hierarchical_round_sim``'s for the same inputs — and, on
        a fully clean round, to the flat ``run_safe_round(subgroups=
        orgs)``'s, the §5.10 anonymization-changes-nothing claim.

    The default monitor cadence is gentler than ``run_paper_scale``'s
    (1.0 s progress window): ``orgs`` chains long-poll concurrently on
    one client event loop, and at n=128 a live-but-unscheduled learner
    must not read as dead or the §5.3 monitor walks its posting onward
    and the exact per-org form no longer holds.

    Returns a flat row for the bench harness.
    """
    from repro_torch.core.protocol import run_hierarchical_round_sim, run_safe_round
    from repro_torch.net.client import run_hierarchical_round_net
    from repro_torch.topology import RingTopology

    rng = np.random.RandomState(seed)
    vals = rng.uniform(-1, 1, (n, V)).astype(np.float32)
    failed = sorted(set(failed_nodes))
    dead_orgs = sorted(set(failed_orgs))
    chains = RingTopology(n, orgs).group_chains(node_base=1)
    ensure_fd_headroom(4 * n + 128)

    if parent_timeout is None:
        # with a planned whole-org crash the parent must give up on the
        # missing org; without one it should never elide
        parent_timeout = 2.0 if dead_orgs else aggregation_timeout
    broker_kw = dict(progress_timeout=progress_timeout,
                     monitor_interval=monitor_interval,
                     aggregation_timeout=aggregation_timeout)
    parent = SafeBroker(**broker_kw)
    child = SafeBroker(**broker_kw)
    paddr = await parent.start()
    caddr = await child.start()
    try:
        res = await run_hierarchical_round_net(
            vals, paddr, {g: caddr for g in range(orgs)},
            failed_orgs=dead_orgs, failed_nodes=failed,
            initiator_fails=initiator_fails,
            aggregation_timeout=aggregation_timeout,
            parent_timeout=parent_timeout)
    finally:
        await parent.stop()
        await child.stop()

    f_orgs = len(dead_orgs)
    live = [g for g in range(orgs) if g not in dead_orgs]
    per_org = {}
    for g in live:
        n_g = len(chains[g])
        f_g = sum(1 for node in failed if node in chains[g])
        expected = 4 * (n_g - f_g) + 2 * f_g + 1
        got = res.org_results[g].stats["aggregation_total"]
        if not initiator_fails and got != expected:
            raise AssertionError(
                f"org {g} (n_g={n_g}, f_g={f_g}): {got} aggregation "
                f"messages, §5.10 per-org form says {expected}")
        if not initiator_fails and res.org_results[g].monitor_reposts != f_g:
            raise AssertionError(
                f"org {g}: {res.org_results[g].monitor_reposts} monitor "
                f"reposts for {f_g} dead learners")
        per_org[g] = got
    hier_total = res.parent_stats["hierarchy_total"]
    if hier_total != 2 * (orgs - f_orgs):
        raise AssertionError(
            f"parent level: {hier_total} hierarchy messages, closed "
            f"form says {2 * (orgs - f_orgs)} for c={orgs} f={f_orgs}")
    if res.elided_orgs != tuple(dead_orgs):
        raise AssertionError(
            f"planned org crashes {dead_orgs} but parent elided "
            f"{res.elided_orgs}")
    if bit_identical:
        sim = run_hierarchical_round_sim(
            vals, orgs=orgs, failed_orgs=dead_orgs, failed_nodes=failed,
            initiator_fails=initiator_fails,
            aggregation_timeout=3.0 if initiator_fails else 8.0)
        if not np.array_equal(sim.average, res.average):
            raise AssertionError(
                f"n={n} orgs={orgs}: hierarchical wire average is not "
                f"bit-identical to the simulation")
        if not dead_orgs and not failed and not initiator_fails:
            flat = run_safe_round(vals, subgroups=orgs)
            if not np.array_equal(flat.average, res.average):
                raise AssertionError(
                    f"n={n} orgs={orgs}: clean hierarchical average is "
                    f"not bit-identical to the flat subgroup round")
    return {
        "protocol": "hierarchical",
        "n": n,
        "orgs": orgs,
        "V": V,
        "failed_orgs": f_orgs,
        "failed_nodes": len(failed),
        "org_messages": {str(g): per_org[g] for g in live},
        "hierarchy_messages": hier_total,
        "expected_hierarchy_messages": 2 * (orgs - f_orgs),
        "elided_orgs": list(res.elided_orgs),
        "wall_s": res.wall_time,
        "bit_identical": bool(bit_identical),
    }


async def run_shard_failover_load(
    *,
    tenants: int = 3,
    rounds_per_tenant: int = 2,
    n: int = 4,
    V: int = 32,
    shards: int = 2,
    kill_shard: int = 0,
    kill_after_round: int = 0,
    seed: int = 0,
    progress_timeout: float = 0.4,
    monitor_interval: float = 0.1,
    aggregation_timeout: float = 30.0,
) -> dict:
    """Kill a shard worker mid-run; tenants recover onto the survivors.

    Starts a :class:`~repro_torch.net.shard.ShardedBroker` behind its
    dispatcher (``use_reuseport=False`` — deterministic across
    platforms). Each tenant opens a
    :class:`~repro_torch.net.client.PersistentNetSession` (so its session is
    PINNED to whatever shard the dispatcher's round-robin landed it on)
    and runs rounds; once every tenant has finished round
    ``kill_after_round``, worker ``kill_shard`` is terminated. Tenants
    whose session lives on the dead shard see
    :class:`~repro_torch.net.client.ShardDeadError` on their next round — the
    deterministic §12 surface, not a hang — abandon the stranded
    session, and replay the round as a fresh one-shot session through
    the shared dispatcher address (which routes ``create_session`` to
    LIVE shards only) with the SAME seeds and counter base the
    persistent session would have used (``r * (V+1)``), so the
    recovered average is bit-identical to the uninterrupted
    simulation's.

    Asserts every round of every tenant (including each replayed one)
    matches the §5 closed form and the sim bit-for-bit, and that at
    least one tenant actually exercised the recovery path (with
    ``tenants >= shards`` the round-robin guarantees the dead shard
    owned at least one session). Returns a flat row for the bench/test
    harness.
    """
    from repro_torch.core.protocol import run_safe_round
    from repro_torch.net.client import ShardDeadError

    rng = np.random.RandomState(seed)
    tenant_vals = [rng.uniform(-1, 1, (n, V)).astype(np.float32)
                   for _ in range(tenants)]
    ensure_fd_headroom(4 * n * tenants + 128)

    broker = ShardedBroker(shards, use_reuseport=False,
                           progress_timeout=progress_timeout,
                           monitor_interval=monitor_interval,
                           aggregation_timeout=aggregation_timeout)
    addr = await broker.start()
    killed = asyncio.Event()
    barrier_done = [asyncio.Event() for _ in range(tenants)]
    recoveries = [0] * tenants

    async def kill_worker() -> None:
        for ev in barrier_done:
            await ev.wait()
        loop = asyncio.get_running_loop()
        proc = broker._procs[kill_shard]
        proc.terminate()
        await loop.run_in_executor(None, proc.join, 10.0)
        killed.set()

    def check(t: int, r: int, res, vals) -> None:
        got = res.stats["aggregation_total"]
        if got != 4 * n:
            raise RuntimeError(
                f"tenant {t} round {r}: {got} aggregation messages, "
                f"§5 closed form says {4 * n}")
        sim = run_safe_round(
            vals, provisioning_seed=0xC0FFEE + t,
            learner_master=0x5EED + 17 * t, counter=r * (V + 1))
        if not np.array_equal(sim.average, res.average):
            raise RuntimeError(
                f"tenant {t} round {r}: round not bit-identical to "
                f"the sim")

    async def tenant(t: int) -> None:
        vals = tenant_vals[t]
        sess = PersistentNetSession(
            addr, n, provisioning_seed=0xC0FFEE + t,
            learner_master=0x5EED + 17 * t, words_per_round=V + 1)
        await sess.open()
        stranded = False
        try:
            for r in range(rounds_per_tenant):
                if not stranded:
                    try:
                        res = await sess.run_round(vals)
                    except ShardDeadError:
                        # session stranded on the killed worker: abandon
                        # it and replay this round (and the rest) as
                        # one-shot sessions via the dispatcher, which
                        # only routes creates to live shards
                        stranded = True
                        recoveries[t] += 1
                if stranded:
                    res = await run_safe_round_net(
                        vals, addr,
                        provisioning_seed=0xC0FFEE + t,
                        learner_master=0x5EED + 17 * t,
                        counter=r * (V + 1))
                check(t, r, res, vals)
                if r == kill_after_round:
                    barrier_done[t].set()
                    await killed.wait()
        finally:
            try:
                await sess.close()
            except (ShardDeadError, OSError):
                pass  # the stranded session's shard is gone with it

    try:
        await asyncio.gather(kill_worker(),
                             *(tenant(t) for t in range(tenants)))
        dead = broker.dead_shards()
    finally:
        await broker.stop()

    if kill_shard not in dead:
        raise AssertionError(f"killed shard {kill_shard} not reported "
                             f"dead (dead set: {sorted(dead)})")
    total_recoveries = sum(recoveries)
    if rounds_per_tenant > kill_after_round + 1 and total_recoveries == 0:
        raise AssertionError(
            "no tenant hit the dead shard after the kill — the recovery "
            "path went unexercised (dispatcher routing drifted?)")
    return {
        "protocol": "shard_failover",
        "tenants": tenants,
        "rounds_per_tenant": rounds_per_tenant,
        "n": n,
        "shards": shards,
        "killed_shard": kill_shard,
        "recoveries": total_recoveries,
        "rounds_completed": tenants * rounds_per_tenant,
        "bit_identical": True,
    }
