"""The PyTorch port's multi-session engine vs the JAX package's.

The JAX engine runs the scenario of tests/test_session_engine.py (six
sessions through four slots, one of three rounds, dead ranks including the
default initiator, a rotation per session, and a weighted engine) on an
8-device host mesh in a subprocess and writes every session-round to an
npz. The port's engine runs the same submissions on the CPU; every
session-round must be bit-identical, with the same bookkeeping.
"""
import dataclasses

import numpy as np
import pytest
import torch

from helpers import run_multidevice
from repro.core.session import AggSession as JAggSession
from repro.core.session import RoundCursor as JRoundCursor
from repro.core.session import seed_words as j_seed_words
from repro_torch import convert
from repro_torch.core import (AggSession, ChainConfig, RoundCursor,
                              SecureAggregator, make_aggregator, seed_words)
from repro_torch.serve import AggregationEngine

N, V, S = 8, 37, 4

REF_CODE = """
import jax, numpy as np
from repro.core import ChainConfig
from repro.serve import AggregationEngine

mesh = jax.make_mesh((8,), ("data",))
n, V, S = 8, 37, 4
rng = np.random.RandomState(0)
eng = AggregationEngine(mesh, ChainConfig(num_learners=n, mode="safe"), slots=S,
                        payload_words=V)
done = []
eng.on_complete = lambda sess: done.append(sess.sid)
out = {}
sessions = []
for s in range(6):
    sv = rng.uniform(-2, 2, (n, V)).astype(np.float32)
    alive = np.ones(n, np.float32)
    if s == 2:
        alive[[0, 5]] = 0.0
    out[f"values{s}"], out[f"alive{s}"] = sv, alive
    sessions.append(eng.submit(sv, rounds=3 if s == 0 else 1,
                               provisioning_seed=0xC0FFEE + s,
                               learner_master=0x5EED + 17 * s,
                               alive=alive, rotate0=s))
eng.run_until_done()
for s, sess in enumerate(sessions):
    for r, res in enumerate(sess.results):
        out[f"result{s}_{r}"] = res
out["steps"], out["rounds_completed"] = eng.steps, eng.rounds_completed
out["done_order"] = np.array(done)

weng = AggregationEngine(mesh, ChainConfig(num_learners=n, mode="safe", weighted=True),
                         slots=2, payload_words=V)
w = rng.uniform(1, 10, (n,)).astype(np.float32)
sv = rng.uniform(-2, 2, (n, V)).astype(np.float32)
wsess = weng.submit(sv, weights=w, rounds=2, rotate0=3)
weng.run_until_done()
out["wvalues"], out["wweights"] = sv, w
out["wresult0"], out["wresult1"] = wsess.results
np.savez("@OUT@", **out)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("engine_ref") / "ref.npz"
    assert "REF_OK" in run_multidevice(REF_CODE.replace("@OUT@", str(path)), devices=8)
    return dict(np.load(path))


@pytest.fixture(scope="module")
def port_run(reference):
    eng = AggregationEngine(ChainConfig(num_learners=N, mode="safe"), slots=S,
                            payload_words=V, device="cpu")
    done = []
    eng.on_complete = lambda sess: done.append(sess.sid)
    sessions = [eng.submit(reference[f"values{s}"], rounds=3 if s == 0 else 1,
                           provisioning_seed=0xC0FFEE + s,
                           learner_master=0x5EED + 17 * s,
                           alive=reference[f"alive{s}"], rotate0=s)
                for s in range(6)]
    eng.run_until_done()
    return eng, sessions, done


@pytest.mark.parametrize("s,r", [(0, 0), (0, 1), (0, 2), (1, 0), (2, 0), (3, 0),
                                 (4, 0), (5, 0)])
def test_session_round_bit_identical(reference, port_run, s, r):
    _, sessions, _ = port_run
    got = sessions[s].results[r]
    assert got.dtype == torch.float32 and got.shape == (V,)
    np.testing.assert_array_equal(got.numpy(), reference[f"result{s}_{r}"])


def test_bookkeeping_matches(reference, port_run):
    eng, sessions, done = port_run
    assert all(sess.done for sess in sessions)
    assert eng.steps == int(reference["steps"])
    assert eng.rounds_completed == int(reference["rounds_completed"]) == 8
    assert done == reference["done_order"].tolist()
    assert eng.active == 0 and not eng.queue


def test_session_rounds_equal_single_runs(port_run):
    """The engine's acceptance property inside the port: every
    session-round equals a standalone aggregate with the counter base and
    rotation the session reserved."""
    _, sessions, _ = port_run
    for s, sess in enumerate(sessions):
        single = make_aggregator("safe", N, provisioning_seed=0xC0FFEE + s,
                                 learner_master=0x5EED + 17 * s, device="cpu")
        for r in range(sess.rounds):
            ref = single.aggregate(sess.values, r * V, alive=sess.alive, rotate=s + r)
            assert torch.equal(ref, sess.results[r]), (s, r)


@pytest.mark.parametrize("cfg_kw", [dict(mode="saf"), dict(mode="safe", subgroups=2),
                                    dict(mode="safe", weighted=True)],
                         ids=["saf", "subgroups", "weighted"])
def test_engine_configs_equal_single_runs(cfg_kw):
    """SAF, subgroup rings and weights through the batched path: every
    session-round equals its single-session round."""
    rng = np.random.RandomState(7)
    cfg = ChainConfig(num_learners=N, **cfg_kw)
    eng = AggregationEngine(cfg, slots=3, payload_words=V, device="cpu")
    specs = []
    for s in range(4):
        alive = np.ones(N, np.float32)
        alive[[s, (s + 5) % N]] = 0.0
        vals = rng.uniform(-2, 2, (N, V)).astype(np.float32)
        vals[s] = np.nan  # dead: must not reach the sum
        w = rng.uniform(1, 10, N).astype(np.float32)
        specs.append((eng.submit(vals, rounds=2, alive=alive, weights=w, rotate0=3 * s,
                                 provisioning_seed=s), vals, alive, w))
    eng.run_until_done()
    for s, (sess, vals, alive, w) in enumerate(specs):
        single = SecureAggregator(cfg, provisioning_seed=s, device="cpu")
        for r in range(2):
            want = single.aggregate(vals, r * eng.words_per_round, alive=alive,
                                    weights=w, rotate=3 * s + r)
            assert torch.isfinite(want).all()
            assert torch.equal(sess.results[r], want), (s, r)


def test_weighted_engine_bit_identical(reference):
    eng = AggregationEngine(ChainConfig(num_learners=N, mode="safe", weighted=True),
                            slots=2, payload_words=V, device="cpu")
    sess = eng.submit(reference["wvalues"], weights=reference["wweights"], rounds=2,
                      rotate0=3)
    eng.run_until_done()
    for r in range(2):
        np.testing.assert_array_equal(sess.results[r].numpy(), reference[f"wresult{r}"])


def test_submit_validates():
    eng = AggregationEngine(ChainConfig(num_learners=N), slots=2, payload_words=V,
                            device="cpu")
    with pytest.raises(ValueError, match="session shape"):
        eng.submit(np.zeros((N, V + 1), np.float32))
    with pytest.raises(ValueError, match="rounds"):
        eng.submit(np.zeros((N, V), np.float32), rounds=0)
    with pytest.raises(ValueError, match="chain modes"):
        AggregationEngine(ChainConfig(num_learners=N, mode="insec"), device="cpu")
    assert eng.step() == 0 and eng.steps == 0


def test_sessions_match_reference_bookkeeping():
    """seed_words, RoundCursor and AggSession counters/rotations agree with
    the reference's, and convert.agg_session carries a session mid-stream."""
    for seed in (0, 0x5EED, 2**64 - 1, 0x1234_5678_9ABC):
        np.testing.assert_array_equal(seed_words(seed), j_seed_words(seed))
    cur, jcur = RoundCursor(38, counter0=5), JRoundCursor(38, counter0=5)
    assert [cur.next_round() for _ in range(3)] == [jcur.next_round() for _ in range(3)]
    assert cur.rounds_remaining == jcur.rounds_remaining
    vals = np.ones((N, V), np.float32)
    jsess = JAggSession(3, vals, rounds=4, rotate0=2)
    jsess.reserve_counter(V)
    jsess.record_result(np.zeros(V, np.float32))
    fields = {f.name: getattr(jsess, f.name) for f in dataclasses.fields(jsess)}
    fields.update(rounds_done=jsess.rounds_done, counter_next=V)
    sess = convert.agg_session(fields, device="cpu")
    assert isinstance(sess, AggSession) and sess.values.dtype == torch.float32
    assert sess.rotate == jsess.rotate == 3
    assert sess.reserve_counter(V) == jsess.reserve_counter(V) == V
    assert sess.key_words()[0].tolist() == jsess.key_words()[0].tolist()
