"""The PyTorch port's control plane vs the JAX package's, on the host.

The port keeps its own copies of the message-level protocol: the
discrete-event SAFE simulation (``core.protocol``), the BON baseline's
(``core.bon_protocol``), the cost model, Shamir sharing and the
observability primitives. Here both packages run the same operations on
the same seeds and numpy inputs, and everything they give back must be
equal: published averages word for word (integer ring arithmetic, so no
tolerance), virtual times, every message counter, and the §5 closed forms.
"""
import dataclasses
import random

import numpy as np
import pytest

from repro.core import bon_protocol as ref_bon
from repro.core import costs as ref_costs
from repro.core import protocol as ref_protocol
from repro.core import shamir as ref_shamir
from repro import obs as ref_obs
from repro_torch.core import bon_protocol, costs, protocol, shamir
from repro_torch import obs


def _vals(n, V, seed):
    return np.random.RandomState(seed).uniform(-1, 1, (n, V)).astype(np.float32)


def _same_words(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def _same_sim(got, ref):
    _same_words(got.average, ref.average)
    assert got.weight_avg == ref.weight_avg
    assert got.virtual_time == ref.virtual_time
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(ref.stats)
    assert got.stats.aggregation_total == ref.stats.aggregation_total
    assert (got.bytes_sent, got.monitor_reposts, got.initiator_elections) == (
        ref.bytes_sent, ref.monitor_reposts, ref.initiator_elections)


#: (n, keyword arguments of run_safe_round, closed form of
#: aggregation_total or None where the count depends on the election)
SAFE_CASES = {
    "n3-clean": (3, {}, 4 * 3),
    "n8-clean": (8, {}, 4 * 8),
    "n36-clean": (36, {}, 4 * 36),
    "n3-one-dead": (3, dict(failed_nodes=[2]), 4 * 2 + 2),
    "n8-one-dead": (8, dict(failed_nodes=[3]), 4 * 7 + 2),
    "n36-one-dead": (36, dict(failed_nodes=[13]), 4 * 35 + 2),
    "n3-initiator-dead": (3, dict(initiator_fails=True), None),
    "n8-initiator-dead": (8, dict(initiator_fails=True), None),
    "n36-initiator-dead": (36, dict(initiator_fails=True), None),
    "n8-adjacent-dead": (8, dict(failed_nodes=[4, 5]), 4 * 6 + 2 * 2),
    "n36-adjacent-dead": (36, dict(failed_nodes=[13, 14]), 4 * 34 + 2 * 2),
    "n8-weighted": (8, dict(weights=np.arange(1, 9, dtype=np.float32) * 250),
                    4 * 8),
    "n8-weighted-dead": (8, dict(weights=np.arange(1, 9, dtype=np.float32),
                                 failed_nodes=[6]), 4 * 7 + 2),
    "n8-saf": (8, dict(mode="saf"), 4 * 8),
    "n8-insec": (8, dict(mode="insec"), None),
    "n8-subgroups": (8, dict(subgroups=2), 4 * 8 + 2),
    "n36-subgroups": (36, dict(subgroups=3, failed_nodes=[20]), 4 * 35 + 2 + 3),
    "n8-symmetric-counter": (8, dict(symmetric_only=True, counter=5 * 16), 4 * 8),
}


@pytest.mark.parametrize("case", sorted(SAFE_CASES))
def test_safe_round_matches_reference(case):
    n, kw, closed = SAFE_CASES[case]
    vals = _vals(n, 16, seed=sum(map(ord, case)))
    got = protocol.run_safe_round(vals, **kw)
    ref = ref_protocol.run_safe_round(vals, **kw)
    _same_sim(got, ref)
    if closed is not None:
        assert got.stats.aggregation_total == closed


HIER_CASES = {
    "clean": {},
    "learner-dead": dict(failed_nodes=[4]),
    "org-dead": dict(failed_orgs=[1]),
    "initiator-dead": dict(initiator_fails=True),
    "weighted": dict(weights=np.linspace(1, 3, 9).astype(np.float32)),
}


@pytest.mark.parametrize("case", sorted(HIER_CASES))
def test_hierarchical_sim_matches_reference(case):
    vals = _vals(9, 16, seed=90)
    kw = HIER_CASES[case]
    got = protocol.run_hierarchical_round_sim(vals, orgs=3, **kw)
    ref = ref_protocol.run_hierarchical_round_sim(vals, orgs=3, **kw)
    _same_words(got.average, ref.average)
    assert got.weight_avg == ref.weight_avg
    assert got.elided_orgs == ref.elided_orgs
    assert got.up_messages == ref.up_messages
    assert sorted(got.org_results) == sorted(ref.org_results)
    for g in ref.org_results:
        _same_sim(got.org_results[g], ref.org_results[g])
        _same_words(got.org_averages[g], ref.org_averages[g])
    if case == "clean":  # anonymising the org boundary changes no bit
        _same_words(got.average,
                    protocol.run_safe_round(vals, subgroups=3).average)


@pytest.mark.parametrize("n,dead", [(8, ()), (8, (3,)), (8, (3, 6)),
                                    (36, ()), (36, (4, 5, 6))])
def test_bon_round_matches_reference(n, dead):
    vals = _vals(n, 16, seed=n + len(dead))
    got = bon_protocol.run_bon_round(vals, failed_nodes=dead)
    ref = ref_bon.run_bon_round(vals, failed_nodes=dead)
    _same_words(got.average, ref.average)
    assert dataclasses.asdict(got).keys() == dataclasses.asdict(ref).keys()
    for field in ("virtual_time", "messages", "bytes_sent", "shares_created",
                  "shares_reconstructed"):
        assert getattr(got, field) == getattr(ref, field), field
    assert got.messages == bon_protocol.bon_expected_messages(n, len(dead))


def test_cost_models_and_closed_forms_match_reference():
    assert sorted(costs.COST_MODELS) == sorted(ref_costs.COST_MODELS)
    for name, model in costs.COST_MODELS.items():
        ref = ref_costs.COST_MODELS[name]
        assert dataclasses.asdict(model) == dataclasses.asdict(ref)
        for nbytes in (0, 256, 1 << 20):
            assert model.message(nbytes) == ref.message(nbytes)
            for sym in (False, True):
                assert model.encrypt(nbytes, sym) == ref.encrypt(nbytes, sym)
                assert model.decrypt(nbytes, sym) == ref.decrypt(nbytes, sym)
    samples = [({"t_msg": 1.0, "t_byte": float(nb)}, 0.003 + nb * 2e-7)
               for nb in (64, 1024, 65536)]
    samples += [({"t_share": float(k)}, k * 4e-5) for k in (5, 9, 36)]
    got, got_report = costs.CostModel.fit(samples, base=costs.DEEP_EDGE)
    ref, ref_report = ref_costs.CostModel.fit(samples, base=ref_costs.DEEP_EDGE)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got_report == ref_report
    for n in (3, 8, 36, 100):
        for f in range(0, n // 2):
            assert (bon_protocol.bon_expected_messages(n, f)
                    == ref_bon.bon_expected_messages(n, f))


@pytest.mark.parametrize("t,n,seed", [(2, 3, 0), (5, 8, 1), (19, 36, 2)])
def test_shamir_matches_reference(t, n, seed):
    assert shamir.P == ref_shamir.P
    secret = random.Random(seed).getrandbits(64)
    got = shamir.share(secret, t, n, random.Random(seed))
    ref = ref_shamir.share(secret, t, n, random.Random(seed))
    assert got == ref
    picked = random.Random(seed + 1).sample(got, t)
    assert shamir.reconstruct(picked) == ref_shamir.reconstruct(picked) == secret
    with pytest.raises(ValueError):
        shamir.reconstruct([got[0], got[0]])


def _drive_obs(mod):
    """The same operations on one package's registry and tracer."""
    reg = mod.MetricsRegistry()
    c = reg.counter("safe_requests_total")
    c.inc()
    c.inc(4)
    g = reg.gauge("safe_active_sessions")
    g.set(3.5)
    g.inc()
    g.dec(0.25)
    h = reg.histogram("safe_rpc_seconds")
    for i in range(1, 200):
        h.observe(i / 97.0)
    h2 = reg.histogram("chunk_bytes", bounds=[1, 10, 100, 1000])
    for v in (0.5, 5, 50, 500, 5000, 5000):
        h2.observe(v)
    pct = [h.percentile(p) for p in (0, 50, 90, 99, 100)]
    tr = mod.Tracer(capacity=4, enabled=True)
    for i in range(6):
        tr.record("round", i * 0.5, i * 0.5 + 0.25, sid=i, group=0)
    tr.record("chunk", 1.0, 1.5, seq=3)
    off = mod.Tracer(enabled=False)
    off.record("round", 0.0, 1.0)
    return (reg.snapshot(), reg.render_prometheus(prefix="x_"), pct,
            tr.export(), [s.duration for s in tr.spans("round")], len(tr),
            len(off), list(mod.DEFAULT_LATENCY_BUCKETS))


def test_obs_snapshots_match_reference():
    assert _drive_obs(obs) == _drive_obs(ref_obs)
