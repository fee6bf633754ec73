"""Discrete-event simulation of the SAFE protocol (control plane).

This is the paper's distributed system (Figures 3–5) as a deterministic
discrete-event simulation: learner state machines (Python generators),
the broker ``Controller``, and the external progress monitor, exchanging
*real* masked fixed-point payloads (numpy Threefry pads — the same
streams the CUDA kernels generate), while a :class:`~repro_torch.core.costs.CostModel`
accumulates virtual time for network / crypto / vector ops.

Outputs per run: the published average (asserted against the clear-text
mean in tests), per-op message counters (validating §5's closed forms),
virtual completion time (the paper's "aggregation time" axis), and byte
counters.

The learner coroutines themselves live in ``core/machines.py`` (yield
protocol documented there) — they are runtime-agnostic and are also
driven, unmodified, over a real asyncio transport by ``repro_torch.net``.
This module is the *virtual-time* runtime: the discrete-event kernel,
FIFO controller-server queueing, and the progress monitor.

The PyTorch port's copy of the JAX package's ``core/protocol.py``, with the same
semantics.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional

import numpy as np

from repro_torch.core.controller import (
    CALL_OPS,
    TIMED_OPS,
    Controller,
    HierarchicalController,
)
from repro_torch.core.costs import CostModel, EDGE

# Re-exported for backwards compatibility: the state machines moved to
# core/machines.py so the wire runtime (repro_torch/net) can drive them too.
from repro_torch.core.machines import (  # noqa: F401
    LearnerCrypto,
    LearnerGen,
    build_round_machines,
    insec_learner,
    safe_learner,
)
from repro_torch.topology import RingTopology


# ---------------------------------------------------------------------------
# Discrete-event kernel
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Task:
    node: int
    gen: LearnerGen
    time: float = 0.0
    waiting: Optional[tuple] = None  # (kind, kwargs, nbytes, deadline)
    done: bool = False
    result: Any = None


@dataclasses.dataclass
class SimResult:
    average: Optional[np.ndarray]
    weight_avg: Optional[float]
    virtual_time: float
    stats: Any
    bytes_sent: int
    monitor_reposts: int
    initiator_elections: int


class ProtocolSimulation:
    """Event kernel driving learners + controller + progress monitor."""

    def __init__(self, controller: Controller, cost: CostModel = EDGE,
                 progress_timeout: float = 1.0, monitor_interval: float = 0.25,
                 parse_payloads: bool = False):
        self.ctrl = controller
        self.cost = cost
        # INSEC: the controller must parse (and average) the payloads;
        # SAFE/SAF: opaque ciphertext relay (paper's broker-only role)
        self.parse_payloads = parse_payloads
        self.progress_timeout = progress_timeout
        self.monitor_interval = monitor_interval
        self.tasks: Dict[int, _Task] = {}
        self.bytes_sent = 0
        self.monitor_reposts = 0
        self.initiator_elections = 0
        # The controller is a shared resource: requests serialize on it
        # (the reason even INSEC scales linearly in nodes, Fig. 7). The
        # event loop feeds requests in chronological order — every
        # controller interaction is its own event — so a simple busy-until
        # ratchet is exact single-server FIFO queueing.
        self._server_free_at = 0.0

    def _server(self, t: float, nbytes: int = 64) -> float:
        """FIFO single-server: request arriving at t completes at
        max(free, t) + handling. Handling scales with payload size —
        parsed JSON for INSEC, opaque relay for SAFE — and INSEC serving
        additionally re-averages the n posted arrays (O(n·V)/request)."""
        cost = self.cost.t_ctrl
        if self.parse_payloads:
            cost += self.cost.t_parse_byte * nbytes
            n = len(self.tasks)
            cost += self.cost.t_avg_elem * n * (nbytes // 14)
        else:
            cost += self.cost.t_relay_byte * nbytes
        start = max(self._server_free_at, t)
        self._server_free_at = start + cost
        return self._server_free_at

    def spawn(self, node: int, gen: LearnerGen, start: float = 0.0) -> None:
        self.tasks[node] = _Task(node=node, gen=gen, time=start)

    # -- controller op dispatch (counts messages + bytes) -----------------
    def _dispatch(self, task: _Task, op: str, kwargs: dict, nbytes: int) -> Any:
        if op not in CALL_OPS:
            raise ValueError(f"unknown call op {op}")
        self.bytes_sent += nbytes
        task.time = self._server(task.time + self.cost.message(nbytes), nbytes)
        if op in TIMED_OPS:
            kwargs = dict(kwargs, now=task.time)
        res = self.ctrl.call(op, **kwargs)
        if op == "should_initiate" and res:
            self.initiator_elections += 1
        return res

    def _peek_wait(self, kind: str, kwargs: dict) -> Optional[Any]:
        """Non-consuming availability probe (event-queue ordering)."""
        if kind == "__call__":
            return {}  # plain calls are always ready
        return self.ctrl.probe(kind, **kwargs)

    def _try_wait(self, task: _Task, kind: str, kwargs: dict) -> Optional[Any]:
        if self.ctrl.probe(kind, **kwargs) is None:
            return None
        return self.ctrl.consume(kind, **kwargs)

    def run(self, max_virtual_time: float = 3600.0) -> SimResult:
        """Discrete-event loop: process exactly one event at a time in
        global virtual-time order (so controller serialization sees
        requests chronologically), with the progress monitor as a
        recurring event source."""
        next_monitor = self.monitor_interval
        guard = 0
        while not all(t.done for t in self.tasks.values()):
            guard += 1
            if guard > 2_000_000:
                raise RuntimeError("simulation did not converge")

            # gather candidate events: (time, priority, node, action, task)
            events = []
            for task in self.tasks.values():
                if task.done:
                    continue
                if task.waiting is None:
                    events.append((task.time, 0, task.node, "run", task))
                    continue
                kind, kwargs, nbytes, deadline = task.waiting
                peek = self._peek_wait(kind, kwargs)
                if peek is not None:
                    avail = peek.get("time", 0.0) if isinstance(peek, dict) else 0.0
                    events.append((max(task.time, avail), 1, task.node,
                                   "resolve", task))
                elif deadline is not None:
                    events.append((deadline, 2, task.node, "timeout", task))

            if not events:
                # everything parked with no deadline: only the monitor can
                # unstick the chain (ordering a repost, §5.3)
                if next_monitor > max_virtual_time:
                    raise RuntimeError("aggregation exceeded max virtual time")
                self._monitor_tick(next_monitor)
                next_monitor += self.monitor_interval
                continue

            events.sort(key=lambda e: e[:3])
            etime, _, _, action, task = events[0]
            if next_monitor <= etime:
                # the monitor fires between events on its own schedule
                if next_monitor > max_virtual_time:
                    raise RuntimeError("aggregation exceeded max virtual time")
                self._monitor_tick(next_monitor)
                next_monitor += self.monitor_interval
                continue  # a repost order may create an earlier event

            if action == "run":
                self._step(task, None)
            elif action == "resolve":
                kind, kwargs, nbytes, _ = task.waiting
                if kind == "__call__":
                    op, call_kwargs = kwargs
                    task.waiting = None
                    res = self._dispatch(task, op, call_kwargs, nbytes)
                    self._step(task, res)
                else:
                    res = self._try_wait(task, kind, kwargs)
                    assert res is not None
                    self.bytes_sent += nbytes
                    avail = res.get("time", 0.0) if isinstance(res, dict) else 0.0
                    t = self._server(max(task.time, avail), nbytes)
                    task.time = t + self.cost.message(nbytes)
                    task.waiting = None
                    self._step(task, res)
            else:  # timeout
                task.time = max(task.time, etime)
                task.waiting = None
                self._step(task, {"status": "timeout"})

        avg = self.ctrl.try_get_average()
        return SimResult(
            average=None if avg is None else avg["average"],
            weight_avg=None if avg is None else avg.get("weight_avg"),
            virtual_time=max(t.time for t in self.tasks.values()),
            stats=self.ctrl.stats,
            bytes_sent=self.bytes_sent,
            monitor_reposts=self.monitor_reposts,
            initiator_elections=self.initiator_elections,
        )

    def _sim_now(self) -> float:
        live = [t.time for t in self.tasks.values() if not t.done]
        return max(live) if live else max(t.time for t in self.tasks.values())

    def _monitor_tick(self, now: float) -> None:
        """External progress monitor (§5.3): detect stuck postings and
        order reposts; unstick aggregation-timeout waits (§5.4)."""
        for task in self.tasks.values():
            if not task.done:
                task.time = max(task.time, now)
        for group in self.ctrl.groups:
            stuck = self.ctrl.stuck_posting(group, now, self.progress_timeout)
            if stuck is not None:
                poster, failed = stuck
                if self.tasks.get(poster) is None or self.tasks[poster].done:
                    continue  # poster itself gone — aggregation timeout path
                if self.ctrl.order_repost(group, poster, failed) is None:
                    continue  # stalled: §5.4 election will recover, no repost
                self.monitor_reposts += 1
        # aggregation-timeout waits are handled in run() via deadlines; the
        # tick just advanced the clock so those deadlines can fire.

    def _step(self, task: _Task, send_value: Any) -> None:
        """Advance one learner until it parks, finishes, or yields compute."""
        try:
            while True:
                item = task.gen.send(send_value)  # send(None) primes/continues
                kind = item[0]
                if kind == "compute":
                    task.time += item[1]
                    send_value = None
                    continue
                if kind == "call":
                    # park: every controller interaction is its own event,
                    # so the FIFO server sees requests chronologically
                    _, op, kwargs, nbytes = item
                    task.waiting = ("__call__", (op, kwargs), nbytes, None)
                    return
                if kind == "stream":
                    # the fused receive+combine+post yield: virtual time
                    # has no transfer to overlap, so the kernel lowers it
                    # to the plain get_aggregate wait — the machine sees
                    # no "streamed" status and takes the whole-vector
                    # fallback, keeping bits, counts and timing exactly
                    # the pre-streaming discrete-event behaviour
                    _, skwargs, nbytes, timeout = item
                    item = ("wait", "get_aggregate",
                            dict(node=skwargs["node"],
                                 group=skwargs["group"]), nbytes, timeout)
                    kind = "wait"
                if kind == "unmask":
                    # the fused receive+unmask+publish yield (§5.1.1
                    # streaming form): lowered to the plain
                    # get_aggregate wait for the same reason as
                    # "stream" above — the machine sees no "unmasked"
                    # status and takes the whole-vector fallback,
                    # keeping bits, counts and timing exact
                    _, ukwargs, nbytes, timeout = item
                    item = ("wait", "get_aggregate",
                            dict(node=ukwargs["node"],
                                 group=ukwargs["group"]), nbytes, timeout)
                    kind = "wait"
                if kind == "wait":
                    _, wkind, kwargs, nbytes, timeout = item
                    deadline = None
                    if timeout == "aggregation":
                        deadline = task.time + self.ctrl.aggregation_timeout
                    elif isinstance(timeout, (int, float)):
                        deadline = task.time + timeout
                    task.time += self.cost.message(64)  # long-poll request
                    task.waiting = (wkind, kwargs, nbytes, deadline)
                    return
                raise ValueError(f"unknown yield {item!r}")
        except StopIteration as stop:
            task.done = True
            task.result = stop.value


# ---------------------------------------------------------------------------
# Runner: build + run one aggregation round
# ---------------------------------------------------------------------------


def run_safe_round(
    values: np.ndarray,
    mode: str = "safe",
    subgroups: int = 1,
    failed_nodes: Iterable[int] = (),
    initiator_fails: bool = False,
    weights: Optional[np.ndarray] = None,
    cost: CostModel = EDGE,
    aggregation_timeout: float = 8.0,
    progress_timeout: float = 1.0,
    symmetric_only: bool = False,
    scale_bits: int = 16,
    provisioning_seed: int = 0xC0FFEE,
    learner_master: int = 0x5EED,
    counter: int = 0,
) -> SimResult:
    """Simulate one full aggregation round.

    values: f32[n, V]; node ids are 1..n (paper numbering), chain order is
    id order, split into ``subgroups`` contiguous groups (§5.5).
    failed_nodes: 1-based ids of learners dead before the round (the
    paper's failover experiment takes out nodes 4-6 after key exchange).
    initiator_fails: group-0 initiator posts once then crashes (Fig. 5).
    """
    n, V = values.shape
    assert mode in ("safe", "saf", "insec")
    # Shared topology layer: the SAME object family the device plane's
    # ppermute schedule and initiator election are built from.
    topo = RingTopology(n, subgroups)
    if mode in ("safe", "saf"):
        topo.validate_privacy()
    groups = topo.group_chains(node_base=1)
    ctrl = Controller(groups, aggregation_timeout=aggregation_timeout)
    sim = ProtocolSimulation(ctrl, cost, progress_timeout=progress_timeout,
                             parse_payloads=(mode == "insec"))
    failed = set(failed_nodes)
    # Round-start initiators: elected over the all-alive bitmap (a node
    # dead before the round is *discovered* by timeout, §5.4 — the
    # control plane does not know it up front).
    initiators = {r + 1 for r in topo.elect_initiators()}

    machines = build_round_machines(
        values, topo, groups, initiators, mode=mode, weights=weights,
        cost=cost, symmetric_only=symmetric_only, scale_bits=scale_bits,
        provisioning_seed=provisioning_seed, learner_master=learner_master,
        counter=counter, subgroups=subgroups, failed=failed,
        initiator_fails=initiator_fails)
    for node, gen in machines.items():
        sim.spawn(node, gen)

    if mode == "insec":
        _drive_insec(ctrl, sim, groups, failed, weights)
        return sim.run()
    return sim.run()


@dataclasses.dataclass
class HierSimResult:
    """One §5.10 chain-of-chains round: per-org SAFE rounds + parent fold."""

    average: Optional[np.ndarray]   # parent (cross-org) average
    weight_avg: Optional[float]
    org_results: Dict[int, SimResult]  # per child org, surviving orgs only
    org_averages: Dict[int, np.ndarray]
    elided_orgs: tuple              # whole-org crashes (parent-level §5.3)
    up_messages: int                # child -> parent posts (HierarchicalController)


def run_hierarchical_round_sim(
    values: np.ndarray,
    orgs: int = 3,
    failed_orgs: Iterable[int] = (),
    failed_nodes: Iterable[int] = (),
    initiator_fails: bool = False,
    weights: Optional[np.ndarray] = None,
    cost: CostModel = EDGE,
    aggregation_timeout: float = 8.0,
    progress_timeout: float = 1.0,
    monitor_interval: float = 0.25,
    symmetric_only: bool = False,
    scale_bits: int = 16,
    provisioning_seed: int = 0xC0FFEE,
    learner_master: int = 0x5EED,
    counter: int = 0,
) -> HierSimResult:
    """Simulate one §5.10 hierarchical round: the n learners split into
    ``orgs`` contiguous child orgs, each org runs its own full SAFE
    chain (failover included) against its OWN controller, and
    :class:`HierarchicalController` folds the surviving orgs' averages.

    The per-org machines are built from the SAME global topology and
    crypto seeds as the flat ``run_safe_round(values, subgroups=orgs)``
    run, so each surviving org's published average — and, with no org
    crashed, the parent average itself — is bit-identical to the flat
    sim's. This is the sim twin the wire plane's hierarchical rounds
    are asserted against.

    ``failed_orgs``: 0-based org indices crashed whole (never run — the
    parent elides them). ``failed_nodes`` / ``initiator_fails`` follow
    the flat API (``initiator_fails`` crashes group 0's initiator after
    its first post, Fig. 5 — inside child org 0 here).
    """
    n, V = values.shape
    topo = RingTopology(n, orgs)
    topo.validate_privacy()
    groups = topo.group_chains(node_base=1)
    initiators = {r + 1 for r in topo.elect_initiators()}
    failed = set(failed_nodes)
    dead_orgs = set(failed_orgs)
    machines = build_round_machines(
        values, topo, groups, initiators, mode="safe", weights=weights,
        cost=cost, symmetric_only=symmetric_only, scale_bits=scale_bits,
        provisioning_seed=provisioning_seed, learner_master=learner_master,
        counter=counter, subgroups=orgs, failed=failed,
        initiator_fails=initiator_fails)

    children: list[Controller] = []
    org_results: Dict[int, SimResult] = {}
    org_averages: Dict[int, np.ndarray] = {}
    for g, chain in groups.items():
        ctrl = Controller({g: chain}, aggregation_timeout=aggregation_timeout)
        children.append(ctrl)
        if g in dead_orgs:
            continue  # whole org offline: its controller never publishes
        sim = ProtocolSimulation(ctrl, cost, progress_timeout=progress_timeout,
                                 monitor_interval=monitor_interval)
        for node in chain:
            if node in machines:  # dead-before-round nodes are never built
                sim.spawn(node, machines[node])
        org_results[g] = sim.run()
        org_averages[g] = org_results[g].average

    parent = HierarchicalController(children)
    out = parent.collect(elide_incomplete=bool(dead_orgs))
    return HierSimResult(
        average=out["average"],
        weight_avg=out.get("weight_avg"),
        org_results=org_results,
        org_averages=org_averages,
        elided_orgs=out.get("elided", ()),
        up_messages=parent.up_messages,
    )


def _drive_insec(ctrl: Controller, sim: ProtocolSimulation, groups, failed, weights):
    """INSEC controller-side averaging: once all live nodes posted, the
    controller averages raw values (it sees everything — the point of the
    baseline). Implemented as a zero-cost shim around the broker."""
    import types

    orig_post = ctrl.post_aggregate
    expected = sum(len([x for x in chain if x not in failed]) for chain in groups.values())
    posted_vals = []

    def patched(from_node, to_node, payload, group=0, now=0.0):
        orig_post(from_node, to_node, payload, group, now)
        posted_vals.append(np.asarray(payload, np.float64))
        if len(posted_vals) == expected:
            avg = np.mean(np.stack(posted_vals), axis=0).astype(np.float32)
            # controller publishes directly (not a client message)
            ctrl._global_average = {"average": avg, "weight_avg": None}

    ctrl.post_aggregate = patched
