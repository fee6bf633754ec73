"""The PyTorch port's load harness (``repro_torch.net.loadgen``) against
the JAX package's.

Every entry point runs through the port's broker at a small size, with the
checks the harness makes inside itself (closed-form message counts,
sim-to-wire bit identity, survivors' means) switched on; each report's
counts equal the reference harness's for the same seeds. The engine
plane's answers are held bit for bit against the port's in-process
engine. Each test carries the 90 s SIGALRM deadline of
``tests/test_torch_net.py``.
"""
import asyncio
import dataclasses
import signal

import numpy as np
import pytest

from repro import net as ref_net
from repro_torch import net
from repro_torch.core import make_aggregator
from repro_torch.net import loadgen
from repro_torch.serve import AggregationEngine

DEADLINE_S = 90
PUBLIC = ("run_engine_load", "run_protocol_load", "run_paper_scale", "run_bon_scale",
          "run_hierarchical_scale", "run_shard_failover_load", "run_slo_load",
          "LoadReport", "SLOReport")
# report keys that are clocks or rates, not counts
TIMED = {"wall_s", "rounds_per_s", "p50_s", "p99_s", "latencies_s", "elapsed_s",
         "metrics_samples", "backlog_peak_bytes", "busy_rejections", "shed_tenants"}


@pytest.fixture(autouse=True)
def _hard_deadline():
    def _expired(signum, frame):
        raise TimeoutError(f"loadgen test exceeded {DEADLINE_S}s hard deadline")

    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(DEADLINE_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _counts(report) -> dict:
    row = dataclasses.asdict(report) if dataclasses.is_dataclass(report) else dict(report)
    return {k: v for k, v in row.items() if k not in TIMED and not k.endswith("_s")}


def test_public_names_exported():
    for name in PUBLIC:
        assert getattr(net, name) is getattr(loadgen, name), name
        assert name in net.__all__
    assert callable(loadgen.ensure_fd_headroom)
    assert [f.name for f in dataclasses.fields(loadgen.LoadReport)] == \
        [f.name for f in dataclasses.fields(ref_net.LoadReport)]
    assert [f.name for f in dataclasses.fields(loadgen.SLOReport)] == \
        [f.name for f in dataclasses.fields(ref_net.SLOReport)]


@pytest.mark.parametrize("chunk_words", [None, 96])
def test_engine_load_bit_identical_to_in_process_engine(chunk_words):
    """run_engine_load through the port's broker in front of a CPU engine:
    every tenant's check passes, the report counts every round, and each
    session's answer equals a fresh in-process engine's, bit for bit."""
    n, V, tenants, rounds = 6, 200, 3, 2
    cfg = make_aggregator("safe", n, device="cpu").cfg
    done = []

    class Recording(AggregationEngine):  # the broker owns on_complete
        def submit(self, values, **kw):
            done.append(super().submit(values, **kw))
            return done[-1]

    engine = Recording(cfg, slots=4, payload_words=V, device="cpu")

    async def go():
        broker = net.SafeBroker(engine=engine)
        addr = await broker.start()
        try:
            return await net.run_engine_load(addr, tenants=tenants, rounds_per_tenant=rounds,
                                             n=n, V=V, seed=3, chunk_words=chunk_words)
        finally:
            await broker.stop()

    rep = asyncio.run(go())
    assert isinstance(rep, net.LoadReport)
    assert (rep.plane, rep.tenants, rep.rounds) == ("engine", tenants, tenants * rounds)
    assert len(rep.latencies_s) == rep.rounds and rep.p99_s >= rep.p50_s > 0
    assert len(done) == tenants * rounds + 1  # and the warm-up session
    for sess in done:
        fresh = AggregationEngine(cfg, slots=1, payload_words=V, device="cpu")
        want = fresh.submit(sess.values, provisioning_seed=sess.provisioning_seed,
                            learner_master=sess.learner_master, rotate0=sess.rotate0)
        fresh.run_until_done()
        assert len(sess.results) == len(want.results) == 1
        np.testing.assert_array_equal(sess.results[0].numpy().view(np.uint32),
                                      want.results[0].numpy().view(np.uint32))


def _both(name, **kw):
    """The port's and the reference's harness on the same arguments."""
    port = asyncio.run(getattr(loadgen, name)(**kw))
    ref = asyncio.run(getattr(ref_net, name)(**kw))
    return port, ref


@pytest.mark.parametrize("failures", [(), (5,)])
def test_paper_scale_n36(failures):
    """n = 36, clean and with one learner dead: the harness asserts the §5
    closed form, the reposts, the survivors' mean and sim-to-wire bit
    identity; the counts equal the reference's."""
    port, ref = _both("run_paper_scale", n=36, V=64, failures=failures)
    assert port["messages"] == port["expected_messages"] == 4 * (36 - len(failures)) + \
        2 * len(failures)
    assert _counts(port) == _counts(ref)


@pytest.mark.parametrize("failures", [(), (3,)])
def test_bon_scale(failures):
    port, ref = _both("run_bon_scale", n=8, V=32, failures=failures)
    assert _counts(port) == _counts(ref)


@pytest.mark.parametrize("kw", [dict(), dict(failed_nodes=(6,)), dict(failed_orgs=(1,)),
                                dict(initiator_fails=True, aggregation_timeout=2.0)],
                         ids=["clean", "failed_node", "failed_org", "initiator_fails"])
def test_hierarchical_scale(kw):
    """Node 6 is a learner of org 1; org 1's initiator (node 5) fails only
    through ``initiator_fails``, whose §5.4 election makes the per-org
    message counts depend on timing, so they are compared only for the
    other cases."""
    port, ref = _both("run_hierarchical_scale", n=8, orgs=2, V=32, **kw)
    assert port["bit_identical"] and ref["bit_identical"]
    if kw.get("initiator_fails"):
        port.pop("org_messages"), ref.pop("org_messages")
    assert _counts(port) == _counts(ref)


def test_shard_failover_load():
    """A worker killed mid-tenant: the stranded tenant recovers on a live
    shard and every replayed round is bit-identical to the sim (asserted
    inside the harness)."""
    row = asyncio.run(net.run_shard_failover_load(tenants=3, rounds_per_tenant=2, n=4,
                                                  V=32, shards=2))
    assert row["recoveries"] >= 1
    assert row["rounds_completed"] == 6
    assert row["killed_shard"] == 0


def test_protocol_load_counts_match_reference():
    async def go(mod, broker_cls):
        broker = broker_cls()
        addr = await broker.start()
        try:
            return await mod.run_protocol_load(addr, tenants=2, rounds_per_tenant=2, n=4,
                                               V=16, seed=1)
        finally:
            await broker.stop()

    port = asyncio.run(go(loadgen, net.SafeBroker))
    ref = asyncio.run(go(ref_net, ref_net.SafeBroker))
    assert isinstance(port, net.LoadReport)
    assert (port.plane, port.tenants, port.rounds) == ("protocol", 2, 4)
    assert _counts(port) == _counts(ref)


def test_slo_load_short():
    """A short steady profile: the SLOs pass, nothing is dropped, and the
    counts equal the reference's."""
    kw = dict(profile="steady", tenants=2, rounds_per_tenant=2, n=4, V=32,
              heavy_tenants=1, heavy_factor=2)
    port, ref = _both("run_slo_load", **kw)
    assert isinstance(port, net.SLOReport)
    assert port.passed, port.error
    assert port.dropped_sessions == 0
    assert _counts(port) == _counts(ref)
