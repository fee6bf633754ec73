"""The PyTorch port's wire plane vs the JAX package's, over real sockets.

* The conformance matrix of ``tests/test_conformance.py``, run through the
  port's broker and client: SAFE × {clean, f1, fq, churn} × {buffered,
  streamed, persistent, pipelined} and the BON cells, at n = 8. Every
  wire average is bit-identical to the port's discrete-event simulation
  and to the reference's, and every closed form holds.
* Mixed deployments: the reference's learners against the port's broker
  and the port's learners against the reference's broker give the same
  bits and counters as an all-port round.
* The engine plane: wire tenants batched through the port's
  ``AggregationEngine`` (on the CPU here) get what a standalone
  ``SecureAggregator`` publishes, and what the reference's engine behind
  the reference's broker publishes; chunked uploads and downloads; a
  failing engine step; results that live on a device.
* The sharded broker, and a process in which JAX cannot be imported.

Every test carries a SIGALRM deadline, so a hung broker fails the test
instead of stalling the suite.
"""
import asyncio
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from helpers import REPO, run_multidevice
from repro.core.bon_protocol import run_bon_round as ref_run_bon_round
from repro.core.protocol import run_hierarchical_round_sim as ref_hier_sim
from repro.core.protocol import run_safe_round as ref_run_safe_round
from repro import net as ref_net
from repro_torch import net
from repro_torch.core import ChainConfig, machines, make_aggregator
from repro_torch.core.bon_protocol import bon_expected_messages, run_bon_round
from repro_torch.core.protocol import run_hierarchical_round_sim, run_safe_round
from repro_torch.net import wire
from repro_torch.serve import AggregationEngine

N = 8
V = 16
DEADLINE_S = 90
SUBPROCESS_DEADLINE_S = 900
_SUBPROCESS_TESTS = {"test_engine_tenants_match_single_rounds_and_reference"}

#: fault pattern -> nodes dead for the closed form (churn kills node 5)
FAULTS = {"clean": (), "f1": (3,), "fq": (3, 6), "churn": (5,)}
BROKER_KW = dict(progress_timeout=0.4, monitor_interval=0.1,
                 aggregation_timeout=30.0)


@pytest.fixture(autouse=True)
def _hard_deadline(request):
    deadline = (SUBPROCESS_DEADLINE_S if request.node.originalname in _SUBPROCESS_TESTS
                else DEADLINE_S)

    def _expired(signum, frame):
        raise TimeoutError(f"net test exceeded {deadline}s hard deadline")

    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(deadline)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _vals(seed, n=N, v=V):
    return np.random.RandomState(seed).uniform(-1, 1, (n, v)).astype(np.float32)


def _same_words(a, b):
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def _safe_expected(f):
    return 4 * (N - f) + 2 * f if f else 4 * N


def _safe_sims(vals, dead=(), **kw):
    """The port's sim, held to the reference's, for one round."""
    sim = run_safe_round(vals, failed_nodes=list(dead), **kw)
    _same_words(sim.average, ref_run_safe_round(vals, failed_nodes=list(dead),
                                                **kw).average)
    return sim


async def _with_broker(coro_fn, broker_cls=net.SafeBroker, **broker_kw):
    broker = broker_cls(**dict(BROKER_KW, **broker_kw))
    addr = await broker.start()
    try:
        return await coro_fn(addr)
    finally:
        await broker.stop()


# ---- the conformance matrix through the port ----------------------------------

def _one_shot(fault, transport, vals):
    kw = dict(stream=False) if transport == "buffered" else dict(
        stream=True, chunk_words=V // 2)
    if fault == "churn":
        # node 5 dies after one op: keys are pre-provisioned, so it never
        # consumes or posts, and §5.3 recovery reposts around it
        kw["interceptor"] = net.ChurnInterceptor({5: 1})
    else:
        kw["failed_nodes"] = FAULTS[fault]
    broker_kw = dict(aggregation_timeout=3.0) if fault == "churn" else {}
    res = asyncio.run(_with_broker(
        lambda addr: net.run_safe_round_net(vals, addr, **kw), **broker_kw))
    return [res], [FAULTS[fault]]


def _persistent(fault, vals):
    """Three rounds on one live session: clean, under the fault, clean."""
    dead = FAULTS[fault]
    churn = net.ChurnInterceptor({}) if fault == "churn" else None

    async def go(addr):
        sess = net.PersistentNetSession(addr, N, interceptor=churn,
                                        aggregation_timeout=3.0 if churn else None)
        await sess.open()
        try:
            r0 = await sess.run_round(vals[0])
            d0 = machines.key_derivations()
            if churn is not None:
                churn.crash_after[5] = churn._ops.get(5, 0) + 1
            r1 = await sess.run_round(vals[1], failed_nodes=() if churn else dead)
            d1 = machines.key_derivations()
            if churn is not None:
                churn.crash_after.pop(5)
            r2 = await sess.run_round(vals[2])
            return [r0, r1, r2], d1 - d0, machines.key_derivations() - d1
        finally:
            await sess.close()

    rs, derivs_fault, derivs_after = asyncio.run(_with_broker(go))
    assert derivs_fault <= 2 * len(dead) if churn else derivs_fault == 2 * len(dead)
    assert derivs_after == 0
    return rs, [(), dead, ()]


def _pipelined(fault, vals):
    """Four rounds on one session with window-2 overlap (§11)."""
    dead = FAULTS[fault]
    churn = net.ChurnInterceptor({}) if fault == "churn" else None

    async def go(addr):
        sess = net.PersistentNetSession(addr, N, interceptor=churn,
                                        aggregation_timeout=3.0 if churn else None)
        await sess.open()
        try:
            if churn is not None:
                await sess.start_round_pipelined(vals[0])
                r0 = await sess.collect_round_pipelined()
                d0 = machines.key_derivations()
                churn.crash_after[5] = churn._ops.get(5, 0) + 1
                await sess.start_round_pipelined(vals[1])
                await sess.start_round_pipelined(vals[2], failed_nodes=(5,))
                r1 = await sess.collect_round_pipelined()
                d1 = machines.key_derivations()
                churn.crash_after.pop(5)
            else:
                await sess.start_round_pipelined(vals[0])
                await sess.start_round_pipelined(vals[1], failed_nodes=dead)
                r0 = await sess.collect_round_pipelined()
                d0 = machines.key_derivations()
                await sess.start_round_pipelined(vals[2])
                r1 = await sess.collect_round_pipelined()
                d1 = machines.key_derivations()
            await sess.start_round_pipelined(vals[3])
            r2 = await sess.collect_round_pipelined()
            r3 = await sess.collect_round_pipelined()
            return [r0, r1, r2, r3], d1 - d0, machines.key_derivations() - d1
        finally:
            await sess.close()

    rs, derivs_fault, derivs_after = asyncio.run(_with_broker(go))
    assert derivs_fault <= 2 * len(dead) if churn else derivs_fault == 2 * len(dead)
    assert derivs_after == 0
    return rs, ([(), dead, (5,), ()] if churn else [(), dead, (), ()])


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("transport", ["buffered", "streamed", "persistent",
                                       "pipelined"])
def test_safe_cell(transport, fault):
    seed = 100 + 10 * ["buffered", "streamed", "persistent", "pipelined"].index(
        transport) + sorted(FAULTS).index(fault)
    vals = [_vals(seed + 100 * i) for i in range(4)]
    if transport in ("buffered", "streamed"):
        rs, dead_by_round = _one_shot(fault, transport, vals[0])
    elif transport == "persistent":
        rs, dead_by_round = _persistent(fault, vals)
    else:
        rs, dead_by_round = _pipelined(fault, vals)
    for i, (r, dead) in enumerate(zip(rs, dead_by_round)):
        sim = _safe_sims(vals[i], dead, counter=i * V)
        _same_words(r.average, sim.average)
        got, expected = r.stats["aggregation_total"], _safe_expected(len(dead))
        churned = fault == "churn" and dead
        if churned and transport != "pipelined" or churned and i == 1:
            # a mid-round crash's timing bounds the count from below only
            assert got >= expected, (i, got, expected)
            assert r.crashed_nodes == (5,)
        else:
            assert got == expected, (i, got, expected)
            assert r.crashed_nodes == ()
        if not dead:  # a clean round's every counter is the sim's
            for op in ("post_aggregate", "check_aggregate", "get_aggregate",
                       "post_average", "get_average", "should_initiate"):
                assert r.stats[op] == getattr(sim.stats, op), (i, op)
    if transport == "streamed" and fault == "clean":
        assert rs[0].streamed_combines == N - 1


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_bon_buffered_cell(fault):
    dead = FAULTS[fault]
    vals = _vals(110 + sorted(FAULTS).index(fault))
    kw = ({"interceptor": net.ChurnInterceptor({5: 2 * N})} if fault == "churn"
          else {"failed_nodes": dead})
    res = asyncio.run(_with_broker(lambda addr: net.run_bon_round_net(vals, addr, **kw)))
    sim = run_bon_round(vals, failed_nodes=list(dead))
    _same_words(sim.average, ref_run_bon_round(vals, failed_nodes=list(dead)).average)
    _same_words(res.average, sim.average)
    assert res.crashed_nodes == (dead if fault == "churn" else ())
    assert res.messages == res.expected_messages == sim.messages == \
        bon_expected_messages(N, len(dead))


def test_bon_streamed_cell_degrades_to_buffered():
    """The chunk plane is not wired to ``bon_*`` ops: a BON round is
    buffered under any transport shape, and shows no chunk activity."""
    vals = _vals(80)
    res = asyncio.run(_with_broker(lambda addr: net.run_bon_round_net(vals, addr)))
    assert res.stats["protocol"] == "bon"
    for key in res.stats:
        assert "chunk" not in key and "stream" not in key, key
    assert res.messages == bon_expected_messages(N)
    _same_words(res.average, run_bon_round(vals).average)
    _same_words(res.average, ref_run_bon_round(vals).average)


def test_bon_persistent_cell_pays_keyagree_per_round():
    """BON re-runs key agreement every round: two rounds each pay the full
    n advertises and n(n-1) share posts, where SAFE's persistent sessions
    derive no new key."""
    for vals, seed in ((_vals(81), 5), (_vals(82), 6)):
        r = asyncio.run(_with_broker(
            lambda addr: net.run_bon_round_net(vals, addr, seed=seed)))
        assert r.stats["bon_advertise"] == N
        assert r.stats["bon_post_share"] == N * (N - 1)
        assert r.messages == bon_expected_messages(N)
        _same_words(r.average, run_bon_round(vals, seed=seed).average)
        _same_words(r.average, ref_run_bon_round(vals, seed=seed).average)


@pytest.mark.parametrize("case", ["clean", "org-dead"])
def test_hierarchical_round_net_matches_both_sims(case):
    vals = _vals(140)
    kw = dict(failed_orgs=(1,), parent_timeout=1.5) if case == "org-dead" else {}

    async def go():
        parent, child = net.SafeBroker(**BROKER_KW), net.SafeBroker(**BROKER_KW)
        paddr, caddr = await parent.start(), await child.start()
        try:
            return await net.run_hierarchical_round_net(
                vals, paddr, {g: caddr for g in range(2)}, **kw)
        finally:
            await parent.stop()
            await child.stop()

    res = asyncio.run(go())
    sim_kw = {k: v for k, v in kw.items() if k == "failed_orgs"}
    sim = run_hierarchical_round_sim(vals, orgs=2, **sim_kw)
    _same_words(sim.average, ref_hier_sim(vals, orgs=2, **sim_kw).average)
    _same_words(res.average, sim.average)
    assert res.elided_orgs == sim.elided_orgs
    assert res.parent_stats["hierarchy_total"] == 2 * (2 - len(sim.elided_orgs))


# ---- mixed deployments -----------------------------------------------------------

#: (client package, broker package)
MIXES = {"ref-client/port-broker": (ref_net, net),
         "port-client/ref-broker": (net, ref_net),
         "port-client/port-broker": (net, net)}


@pytest.mark.parametrize("protocol,shape", [("safe", "buffered"),
                                            ("safe", "streamed-f1"),
                                            ("bon", "f1")])
def test_mixed_deployments_match_all_port_round(protocol, shape):
    vals = _vals(60 + len(shape))
    kw = {"failed_nodes": (3,)} if shape.endswith("f1") else {}
    if shape.startswith("streamed"):
        kw.update(stream=True, chunk_words=V // 4)
    out = {}
    for mix, (client, server) in MIXES.items():
        run = client.run_safe_round_net if protocol == "safe" else client.run_bon_round_net
        out[mix] = asyncio.run(_with_broker(
            lambda addr: run(vals, addr, **kw), broker_cls=server.SafeBroker))
    ours = out["port-client/port-broker"]
    for mix, res in out.items():
        _same_words(res.average, ours.average)
        assert res.stats == ours.stats, mix
        if protocol == "safe":
            assert res.monitor_reposts == ours.monitor_reposts == len(kw.get(
                "failed_nodes", ()))
        else:
            assert res.messages == ours.messages
    sim = (_safe_sims(vals, kw.get("failed_nodes", ())) if protocol == "safe"
           else run_bon_round(vals, failed_nodes=list(kw["failed_nodes"])))
    _same_words(ours.average, sim.average)


# ---- the engine plane, with the port's engine on the CPU --------------------------

ES, EN, EV, EROUNDS = 4, 8, 32, 2


def _tenants():
    """S tenants' submissions: their own keys, alive sets and rotations."""
    rng = np.random.RandomState(0)
    out = []
    for t in range(ES):
        alive = np.ones(EN, np.float32)
        if t == 2:
            alive[[0, 5]] = 0.0  # the default initiator is dead
        out.append({"values": rng.uniform(-1, 1, (EN, EV)).astype(np.float32),
                    "rounds": EROUNDS, "provisioning_seed": 0xC0FFEE + t,
                    "learner_master": 0x5EED + 17 * t, "alive": alive,
                    "rotate0": 3 * t})
    return out


def _single_rounds(spec):
    """What a standalone aggregator publishes for each of the session's rounds."""
    agg = make_aggregator("safe", EN, provisioning_seed=spec["provisioning_seed"],
                          learner_master=spec["learner_master"], device="cpu")
    return [agg.aggregate(spec["values"], r * EV, alive=spec["alive"],
                          rotate=spec["rotate0"] + r).numpy()
            for r in range(spec["rounds"])]


def _engine(cls=AggregationEngine):
    return cls(ChainConfig(num_learners=EN, mode="safe"), slots=ES,
               payload_words=EV, device="cpu")


async def _serve_tenants(engine, specs, chunks=None, timeout=60.0):
    """Submit each spec from its own client, then wait for each; with
    ``chunks = (up, down)`` both ride the chunk plane at those widths."""
    broker = net.SafeBroker(engine=engine)
    addr = await broker.start()
    try:
        clients = [await net.WireClient(*addr, node=t).connect()
                   for t in range(len(specs))]
        sids = []
        for c, spec in zip(clients, specs):
            if chunks:
                sub = await c.submit_session_chunked(spec, chunk_words=chunks[0])
            else:
                sub = await c.request("submit_session", spec)
            sids.append(sub["sid"])
        out = []
        for c, sid in zip(clients, sids):
            if chunks:
                out.append(await c.wait_session_chunked(sid, timeout=timeout,
                                                        chunk_words=chunks[1]))
            else:
                out.append(await c.request("wait_session",
                                           {"sid": sid, "timeout": timeout}))
        for c in clients:
            await c.close()
        return out, broker
    finally:
        await broker.stop()


REF_ENGINE_CODE = """
import asyncio, numpy as np, jax
from repro.core.types import ChainConfig
from repro.serve import AggregationEngine
from repro.net import SafeBroker, WireClient

specs = dict(np.load("@IN@"))
n, V, S = 8, 32, 4
engine = AggregationEngine(jax.make_mesh((8,), ("data",)),
                           ChainConfig(num_learners=n, mode="safe"), slots=S,
                           payload_words=V)

async def go():
    broker = SafeBroker(engine=engine)
    addr = await broker.start()
    out = {}
    try:
        clients = [await WireClient(*addr, node=t).connect() for t in range(S)]
        sids = []
        for t, c in enumerate(clients):
            sub = await c.request("submit_session", {
                "values": specs[f"values{t}"], "rounds": int(specs["rounds"]),
                "provisioning_seed": int(specs[f"pseed{t}"]),
                "learner_master": int(specs[f"master{t}"]),
                "alive": specs[f"alive{t}"], "rotate0": int(specs[f"rotate{t}"])})
            sids.append(sub["sid"])
        for t, c in enumerate(clients):
            res = await c.request("wait_session", {"sid": sids[t], "timeout": 300.0})
            assert res["status"] == "done", res
            for r, x in enumerate(res["results"]):
                out[f"result{t}_{r}"] = x
            await c.close()
    finally:
        await broker.stop()
    return out

np.savez("@OUT@", **asyncio.run(go()))
print("REF_OK")
"""


def test_engine_tenants_match_single_rounds_and_reference(tmp_path):
    """(a) S wire tenants, two rounds each, through the port's engine:
    every result is what a standalone aggregator publishes with the same
    counter base, alive set and rotation, and what the reference's engine
    behind the reference's broker publishes (8 host devices, subprocess)."""
    specs = _tenants()
    results, broker = asyncio.run(_serve_tenants(_engine(), specs))
    assert broker.engine_errors == 0
    flat = {"rounds": np.int64(EROUNDS)}
    for t, s in enumerate(specs):
        flat.update({f"values{t}": s["values"], f"alive{t}": s["alive"],
                     f"pseed{t}": np.int64(s["provisioning_seed"]),
                     f"master{t}": np.int64(s["learner_master"]),
                     f"rotate{t}": np.int64(s["rotate0"])})
    np.savez(tmp_path / "in.npz", **flat)
    code = REF_ENGINE_CODE.replace("@IN@", str(tmp_path / "in.npz")).replace(
        "@OUT@", str(tmp_path / "out.npz"))
    assert "REF_OK" in run_multidevice(code, devices=8)
    ref = dict(np.load(tmp_path / "out.npz"))
    for t, (spec, res) in enumerate(zip(specs, results)):
        assert res["status"] == "done" and res["rounds"] == EROUNDS
        for r, (got, want) in enumerate(zip(res["results"], _single_rounds(spec))):
            _same_words(got, want)
            _same_words(got, ref[f"result{t}_{r}"])


def test_engine_chunked_submit_and_wait_match_unchunked(monkeypatch):
    """(b) With the frame cap shrunk below one session, tenants upload and
    download over the chunk plane; the results equal the unchunked ones."""
    specs = _tenants()[:2]
    plain, _ = asyncio.run(_serve_tenants(_engine(), specs))
    monkeypatch.setattr(wire, "MAX_FRAME", 1 << 10)  # < EN * EV * 4 bytes
    with pytest.raises(wire.WireError):
        asyncio.run(_serve_tenants(_engine(), specs[:1]))
    chunked, broker = asyncio.run(_serve_tenants(_engine(), specs, chunks=(64, 24)))
    assert broker.engine_chunk_frames_in == 2 * wire.num_chunks(EN * EV, 64)
    assert broker.engine_chunk_frames_out == 2 * wire.num_chunks(EROUNDS * EV, 24)
    for a, b, spec in zip(plain, chunked, specs):
        assert b["status"] == "done" and b["rounds"] == EROUNDS
        for x, y, want in zip(a["results"], b["results"], _single_rounds(spec)):
            _same_words(y, x)
            _same_words(y, want)


class _PoisonedEngine(AggregationEngine):
    """An engine whose step raises while a poisoned session is admitted;
    the failing step evicts it, as a tenant whose data breaks a step."""

    poisoned = 0

    def step(self):
        self._admit()
        for i, s in enumerate(self.slot_sessions):
            if s is not None and s.sid == self.poisoned:
                self.slot_sessions[i] = None
                raise RuntimeError("poisoned step")
        return super().step()


def test_engine_failed_step_is_counted_and_others_served():
    """(c) A step that raises is counted in engine_errors, its tenant's
    wait times out, and the broker goes on serving the next tenant."""
    specs = _tenants()[:2]

    async def go():
        broker = net.SafeBroker(engine=_engine(_PoisonedEngine), monitor_interval=0.05)
        addr = await broker.start()
        try:
            c = await net.WireClient(*addr).connect()
            bad = await c.request("submit_session", specs[0])
            assert bad["sid"] == _PoisonedEngine.poisoned
            timed_out = await c.request("wait_session", {"sid": bad["sid"], "timeout": 0.5})
            good = await c.request("submit_session", specs[1])
            done = await c.request("wait_session", {"sid": good["sid"], "timeout": 30.0})
            await c.close()
            return timed_out, done, broker.engine_errors
        finally:
            await broker.stop()

    timed_out, done, errors = asyncio.run(go())
    assert timed_out == {"status": "timeout"}
    assert errors == 1
    assert done["status"] == "done"
    for got, want in zip(done["results"], _single_rounds(specs[1])):
        _same_words(got, want)


class _CardTensor:
    """A result held as a device tensor is: numpy cannot read it in place
    (``np.asarray`` raises TypeError, as on a CUDA tensor), and
    ``.detach().cpu()`` gives its host copy."""

    copies = 0

    def __init__(self, t):
        self._t = t

    def __array__(self, *args, **kwargs):
        raise TypeError("can't convert cuda:0 device type tensor to numpy")

    def detach(self):
        return self

    def cpu(self):
        _CardTensor.copies += 1
        return self._t


class _CardEngine(AggregationEngine):
    """The port's engine with a finished session's results (tensors)
    wrapped as device tensors."""

    def step(self):
        self._admit()
        stepped = [s for s in self.slot_sessions if s is not None]
        done = super().step()
        for sess in stepped:
            if sess.done:
                assert all(isinstance(r, torch.Tensor) for r in sess.results)
                sess.results = [_CardTensor(r) for r in sess.results]
        return done


def test_wait_session_returns_host_float32_from_device_results(monkeypatch):
    """(d) The port's engine keeps results as tensors. The broker copies
    them to the host once per session, and both the plain and the chunked
    wait hand out numpy float32 arrays; the reference broker's
    ``np.asarray`` would raise on a device tensor."""
    spec = _tenants()[1]

    async def go():
        broker = net.SafeBroker(engine=_engine(_CardEngine))
        addr = await broker.start()
        try:
            c = await net.WireClient(*addr).connect()
            sid = (await c.request("submit_session", spec))["sid"]
            plain = await c.request("wait_session", {"sid": sid, "timeout": 30.0})
            direct = await broker._wait_session({"sid": sid, "timeout": 1.0})
            chunked = await c.wait_session_chunked(sid, timeout=30.0, chunk_words=8)
            await c.close()
            return plain, direct, chunked
        finally:
            await broker.stop()

    _CardTensor.copies = 0
    plain, direct, chunked = asyncio.run(go())
    assert _CardTensor.copies == EROUNDS  # one host copy per round, cached
    for res in (plain, direct, chunked):
        assert res["status"] == "done" and len(res["results"]) == EROUNDS
        for got, want in zip(res["results"], _single_rounds(spec)):
            assert isinstance(got, np.ndarray) and got.dtype == np.float32
            _same_words(got, want)
    with pytest.raises(TypeError):
        np.asarray(_CardTensor(torch.zeros(2)))


# ---- sharding, and no JAX ------------------------------------------------------

def test_sharded_broker_round_matches_single_broker():
    """One round through two spawned shard workers is bit-identical to one
    through a single broker, and to the sim."""
    vals = _vals(51, n=6)

    async def sharded():
        sb = net.ShardedBroker(2, **BROKER_KW)
        addr = await sb.start()
        try:
            return [await net.run_safe_round_net(vals, addr) for _ in range(2)]
        finally:
            await sb.stop()

    single = asyncio.run(_with_broker(lambda addr: net.run_safe_round_net(vals, addr)))
    rounds = asyncio.run(sharded())
    _same_words(single.average, run_safe_round(vals).average)
    for r in rounds:
        _same_words(r.average, single.average)
        assert r.stats == single.stats
        assert r.stats["aggregation_total"] == 4 * 6


NO_JAX_CODE = """
import asyncio, sys
sys.modules["jax"] = None  # any import of jax now fails
import numpy as np
import repro_torch.net as net
from repro_torch.core.protocol import run_safe_round

vals = np.random.RandomState(3).uniform(-1, 1, (8, 16)).astype(np.float32)

async def go():
    broker = net.SafeBroker(progress_timeout=0.4, monitor_interval=0.1)
    addr = await broker.start()
    try:
        return await net.run_safe_round_net(vals, addr, failed_nodes=(3,))
    finally:
        await broker.stop()

res = asyncio.run(go())
sim = run_safe_round(vals, failed_nodes=[3])
assert np.array_equal(res.average.view(np.uint32), sim.average.view(np.uint32))
assert res.stats["aggregation_total"] == 4 * 7 + 2
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m in ("jax", "repro") or m.startswith(("jax.", "repro."))))
assert not loaded, loaded
print("NO_JAX_OK")
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(NO_JAX_CODE)],
                          capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
