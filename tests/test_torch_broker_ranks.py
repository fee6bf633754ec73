"""The broker's engine plane across ranks: wire tenants served by the
engine one learner a rank.

N gloo ranks on the CPU (a ``repro_torch.dist.RankPool``, one intra-op
thread each) hold one learner each. Rank 0 runs the port's ``SafeBroker``
in front of an ``EngineLead`` around its ``AggregationEngine(...,
world=)``, and S wire tenants on rank 0 submit and wait over 127.0.0.1;
ranks 1..N-1 run ``follow`` around theirs. Each session has two rounds;
tenant 1 has a dead learner, tenant 2 a dead initiator, and tenant 3
uploads and downloads over the chunk plane. A plain and a weighted engine
serve the same tenants. Every ``wait_session`` result must equal, word for
word (``assert_array_equal``):

- the reference's ``AggregationEngine`` on an N-device CPU mesh behind the
  reference's ``SafeBroker`` (one subprocess per engine, run beside the
  ranks);
- the port's one-process engine on the same submissions;
- a standalone ``aggregate`` with the session's counter base and rotation;

and every follower's sessions hold the same results. A submission with a
wrong-shaped ``alive`` is refused on rank 0 while the followers keep
serving; a completion hook that raises once on rank 0 and once on a
follower leaves the world up (the broker counts one engine error, the
follower one hook error, and the sessions of the next wave are published
bit for bit); and a step that raises on one rank raises on every rank instead
of leaving the others waiting. A lead closed with a session not yet
sent ends every follower's loop. Each spawned rank has a time limit
(``faulthandler`` ends a rank stuck past it, and the pool then fails).
"""
import asyncio
import faulthandler
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers import REPO
from repro_torch import net
from repro_torch.core import ChainConfig, make_aggregator
from repro_torch.dist import RankPool, World
from repro_torch.net import wire
from repro_torch.serve import AggregationEngine, EngineLead, follow

N, S, V, ROUNDS, SLOTS = 4, 4, 32, 2, 2
CHUNKED = 3                 # the tenant whose session rides the chunk plane
CHUNK_UP, CHUNK_DOWN = 40, 24
WAIT_S = 60.0               # a tenant's wait_session timeout
RANK_DEADLINE_S = 120       # a spawned rank's time limit
REF_TIMEOUT_S = 600
ENGINES = {"plain": False, "weighted": True}   # name -> weighted


def _tenants():
    """S tenants' submissions: their own rows, keys, alive sets, rotations
    and weights."""
    rng = np.random.RandomState(25)
    out = []
    for t in range(S):
        alive = np.ones(N, np.float32)
        rotate0 = 3 * t
        if t == 1:
            alive[2] = 0.0          # a dead learner
        if t == 2:
            alive[0], rotate0 = 0.0, 0  # the first round's initiator is dead
        out.append({"values": rng.uniform(-1, 1, (N, V)).astype(np.float32),
                    "rounds": ROUNDS, "provisioning_seed": 0xC0FFEE + t,
                    "learner_master": 0x5EED + 17 * t, "alive": alive,
                    "rotate0": rotate0,
                    "weights": rng.uniform(1, 10, N).astype(np.float32)})
    return out


def _cfg(name):
    return ChainConfig(num_learners=N, mode="safe", weighted=ENGINES[name])


async def _serve(engine, refused):
    """Every tenant through a broker in front of ``engine``; first, when
    ``refused``, a submission with a wrong-shaped alive. Returns (each
    tenant's results, the refusal's text, the broker's engine_errors)."""
    broker = net.SafeBroker(engine=engine)
    addr = await broker.start()
    try:
        clients = [await net.WireClient(*addr, node=t).connect() for t in range(S)]
        error = None
        if refused:
            try:
                await clients[0].request("submit_session", dict(
                    _tenants()[0], alive=np.ones(N - 1, np.float32)))
            except wire.WireError as e:
                error = str(e)
        sids = []
        for t, (c, spec) in enumerate(zip(clients, _tenants())):
            sub = (await c.submit_session_chunked(spec, chunk_words=CHUNK_UP)
                   if t == CHUNKED else await c.request("submit_session", spec))
            sids.append(sub["sid"])
        out = []
        for t, (c, sid) in enumerate(zip(clients, sids)):
            res = (await c.wait_session_chunked(sid, timeout=WAIT_S, chunk_words=CHUNK_DOWN)
                   if t == CHUNKED else
                   await c.request("wait_session", {"sid": sid, "timeout": WAIT_S}))
            assert res["status"] == "done" and res["rounds"] == ROUNDS, res
            out.append(np.stack(res["results"]))
        for c in clients:
            await c.close()
        return out, error, broker.engine_errors
    finally:
        await broker.stop()


def _serve_rank(world):
    """One rank: for each engine, rank 0 serves the tenants through its
    lead, the others follow. Rank 0 returns {name: (results, refusal,
    engine_errors)}, the others {name: (results, sids)} of the sessions
    they finished."""
    faulthandler.dump_traceback_later(RANK_DEADLINE_S, exit=True)
    out = {}
    for name in ENGINES:
        eng = AggregationEngine(_cfg(name), SLOTS, V, device="cpu", world=world)
        if world.rank == 0:
            out[name] = asyncio.run(_serve(EngineLead(eng), refused=name == "plain"))
        else:
            done = []
            eng.on_complete = done.append
            follow(eng)
            out[name] = ([torch.stack(s.results) for s in done], [s.sid for s in done])
    faulthandler.cancel_dump_traceback_later()
    return out


HOOK_RANK = 2                # the follower whose completion hook raises once too


def _raising_once(hook, raised):
    """``hook``, then a raise at its first call."""
    def call(sess):
        hook(sess)
        if not raised:
            raised.append(sess.sid)
            raise RuntimeError("injected completion-hook failure")
    return call


async def _serve_waves(lead):
    """Tenants 0 and 1, then 2 and 3 once those are done, through a broker
    in front of ``lead`` whose completion hook raises at its first call.
    Returns (each tenant's results, the broker's engine_errors)."""
    broker = net.SafeBroker(engine=lead)
    lead.on_complete = _raising_once(lead.on_complete, [])
    addr = await broker.start()
    try:
        clients = [await net.WireClient(*addr, node=t).connect() for t in range(S)]
        specs, out = _tenants(), []
        for wave in (range(0, 2), range(2, S)):
            sids = [(await clients[t].request("submit_session", specs[t]))["sid"] for t in wave]
            for t, sid in zip(wave, sids):
                res = await clients[t].request("wait_session", {"sid": sid, "timeout": WAIT_S})
                assert res["status"] == "done" and res["rounds"] == ROUNDS, res
                out.append(np.stack(res["results"]))
        for c in clients:
            await c.close()
        return out, broker.engine_errors
    finally:
        await broker.stop()


def _hook_rank(world):
    """One rank of a served engine whose completion hook raises once on
    rank 0 and on ``HOOK_RANK``: rank 0 returns (results, engine_errors),
    the others ({sid: results}, the hook errors ``follow`` counted)."""
    faulthandler.dump_traceback_later(RANK_DEADLINE_S, exit=True)
    eng = AggregationEngine(_cfg("plain"), SLOTS, V, device="cpu", world=world)
    if world.rank == 0:
        out = asyncio.run(_serve_waves(EngineLead(eng)))
    else:
        done = []
        eng.on_complete = (_raising_once(done.append, []) if world.rank == HOOK_RANK
                           else done.append)
        errors = follow(eng)
        out = ({s.sid: torch.stack(s.results) for s in done}, errors)
    faulthandler.cancel_dump_traceback_later()
    return out


class _FailingEngine(AggregationEngine):
    """An engine whose second step raises (on the one rank that has it)."""

    def step(self):
        if self.steps == 1:
            raise RuntimeError("injected step failure")
        return super().step()


def _failing_rank(world, bad_rank):
    """One rank of a served engine whose second step raises on
    ``bad_rank``: each rank returns what it raised (rank 0: what
    ``step`` raised first, and then refused)."""
    faulthandler.dump_traceback_later(RANK_DEADLINE_S, exit=True)
    cls = _FailingEngine if world.rank == bad_rank else AggregationEngine
    eng = cls(_cfg("plain"), SLOTS, V, device="cpu", world=world)
    raised = []
    if world.rank == 0:
        lead = EngineLead(eng)
        spec = _tenants()[0]
        lead.submit(spec["values"], rounds=3)
        while len(raised) < 2:
            try:
                lead.step()
            except Exception as e:  # noqa: BLE001 - what each step raised is the result
                raised.append(type(e).__name__)
        lead.close()
    else:
        try:
            follow(eng)
        except Exception as e:  # noqa: BLE001
            raised.append(type(e).__name__)
    faulthandler.cancel_dump_traceback_later()
    return raised


def _closing_rank(world):
    """One rank of a lead closed with a session still unsent: rank 0
    steps one session to its end, submits another and closes with no step
    between; every rank returns its engine's steps and the sessions it
    finished."""
    faulthandler.dump_traceback_later(RANK_DEADLINE_S, exit=True)
    eng = AggregationEngine(_cfg("plain"), SLOTS, V, device="cpu", world=world)
    done = []
    eng.on_complete = done.append
    if world.rank == 0:
        lead = EngineLead(eng)
        first, second = _tenants()[:2]
        lead.submit(first["values"], rounds=1)
        lead.run_until_done()
        lead.submit(second["values"], rounds=1)
        lead.close()
    else:
        follow(eng)
    faulthandler.cancel_dump_traceback_later()
    return eng.steps, [s.sid for s in done]


REF_CODE = """
import asyncio, numpy as np, jax
from repro.core.types import ChainConfig
from repro.serve import AggregationEngine
from repro.net import SafeBroker, WireClient

specs = dict(np.load("@IN@"))
n, V, S, slots, weighted = @N@, @V@, @S@, @SLOTS@, @WEIGHTED@
engine = AggregationEngine(jax.make_mesh((n,), ("data",)),
                           ChainConfig(num_learners=n, mode="safe", weighted=weighted),
                           slots=slots, payload_words=V)

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
                "alive": specs[f"alive{t}"], "weights": specs[f"weights{t}"],
                "rotate0": int(specs[f"rotate{t}"])})
            sids.append(sub["sid"])
        for t, c in enumerate(clients):
            res = await c.request("wait_session", {"sid": sids[t], "timeout": 300.0})
            assert res["status"] == "done", res
            out[f"result{t}"] = np.stack(res["results"])
            await c.close()
        assert broker.engine_errors == 0
    finally:
        await broker.stop()
    return out

np.savez("@OUT@", **asyncio.run(go()))
print("REF_OK")
"""


def _reference_procs(tmp):
    """One reference subprocess per engine, started now: {name: (Popen, out path)}."""
    flat = {"rounds": np.int64(ROUNDS)}
    for t, s in enumerate(_tenants()):
        flat.update({f"values{t}": s["values"], f"alive{t}": s["alive"],
                     f"weights{t}": s["weights"],
                     f"pseed{t}": np.int64(s["provisioning_seed"]),
                     f"master{t}": np.int64(s["learner_master"]),
                     f"rotate{t}": np.int64(s["rotate0"])})
    np.savez(tmp / "in.npz", **flat)
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={N}",
               PYTHONPATH=os.path.join(REPO, "src"))
    procs = {}
    for name, weighted in ENGINES.items():
        out = tmp / f"ref_{name}.npz"
        code = REF_CODE
        for key, val in (("@IN@", tmp / "in.npz"), ("@OUT@", out), ("@N@", N), ("@V@", V),
                         ("@S@", S), ("@SLOTS@", SLOTS), ("@WEIGHTED@", weighted)):
            code = code.replace(key, str(val))
        procs[name] = (subprocess.Popen([sys.executable, "-c", code], env=env,
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), out)
    return procs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results of the served engines, of the failing step, the
    reference's results by engine); the reference subprocesses run beside
    the ranks."""
    procs = _reference_procs(tmp_path_factory.mktemp("broker_ranks"))
    try:
        with RankPool(N, "cpu", threads=1) as pool:
            served = [r["result"] for r in pool.run(_serve_rank)]
            closing = [r["result"] for r in pool.run(_closing_rank)]
            hooked = [r["result"] for r in pool.run(_hook_rank)]
            failing = [r["result"] for r in pool.run(_failing_rank, (2,))]
        reference = {}
        for name, (proc, out) in procs.items():
            stdout, stderr = proc.communicate(timeout=REF_TIMEOUT_S)
            assert proc.returncode == 0 and "REF_OK" in stdout, stderr[-3000:]
            reference[name] = dict(np.load(out))
    finally:
        for proc, _ in procs.values():
            proc.kill()
    return served, failing, reference, closing, hooked


def _one_process(name):
    """Each tenant's results through the port's learner-major engine."""
    eng = AggregationEngine(_cfg(name), SLOTS, V, device="cpu")
    sessions = [eng.submit(s["values"], rounds=s["rounds"],
                           provisioning_seed=s["provisioning_seed"],
                           learner_master=s["learner_master"], alive=s["alive"],
                           weights=s["weights"], rotate0=s["rotate0"]) for s in _tenants()]
    eng.run_until_done()
    return [torch.stack(s.results).numpy() for s in sessions]


def _standalone(name, spec):
    """What a standalone aggregator publishes for each of the session's rounds."""
    weighted = ENGINES[name]
    agg = make_aggregator("safe", N, weighted=weighted,
                          provisioning_seed=spec["provisioning_seed"],
                          learner_master=spec["learner_master"], device="cpu")
    words = V + 1 if weighted else V
    return np.stack([agg.aggregate(spec["values"], r * words, alive=spec["alive"],
                                   weights=spec["weights"] if weighted else None,
                                   rotate=spec["rotate0"] + r).numpy()
                     for r in range(spec["rounds"])])


@pytest.mark.parametrize("name", list(ENGINES))
def test_wire_tenants_equal_reference_one_process_and_standalone(runs, name):
    served, _, reference, _, _ = runs
    results, _, errors = served[0][name]
    assert errors == 0
    one = _one_process(name)
    for t, (got, spec) in enumerate(zip(results, _tenants())):
        assert got.dtype == np.float32 and np.isfinite(got).all()
        np.testing.assert_array_equal(got, reference[name][f"result{t}"], err_msg=str(t))
        np.testing.assert_array_equal(got, one[t], err_msg=str(t))
        np.testing.assert_array_equal(got, _standalone(name, spec), err_msg=str(t))


@pytest.mark.parametrize("name", list(ENGINES))
def test_followers_hold_rank0_results(runs, name):
    """Every follower finished the same sessions under the same ids, with
    the published means rank 0 answered with."""
    served, _, _, _, _ = runs
    results = served[0][name][0]
    for r, res in enumerate(served[1:], start=1):
        got, sids = res[name]
        assert sorted(sids) == list(range(S)), (r, sids)
        by_sid = dict(zip(sids, got))
        for t, want in enumerate(results):
            # the plain engine's refused submission took no id
            np.testing.assert_array_equal(by_sid[t].numpy(), want, err_msg=f"{r} {t}")


def test_bad_submission_refused_on_rank0(runs):
    """A wrong-shaped alive is answered with an error before anything is
    sent; the followers then serve every tenant (the results above)."""
    served, _, _, _, _ = runs
    _, error, errors = served[0]["plain"]
    assert error is not None and f"alive must have shape ({N},)" in error
    assert errors == 0


def test_failed_step_raises_on_every_rank(runs):
    """A step that raises on rank 2 tears its groups down: every rank
    raises instead of waiting in a collective, and the lead refuses the
    next step."""
    _, failing, _, _, _ = runs
    assert failing[2] == ["RuntimeError"]
    assert all(len(r) == 1 for r in failing[1:]), failing
    assert len(failing[0]) == 2 and failing[0][1] == "RuntimeError", failing[0]


def test_raising_completion_hook_leaves_the_world_up(runs):
    """The hook's raise comes after the step's last collective: the lead
    re-raises it once the step is whole, the broker counts it in
    ``engine_errors`` and steps on, the follower counts it and goes on; both
    waves' sessions (the second submitted after the raise) are published
    bit for bit, on rank 0 and on every follower."""
    hooked = runs[4]
    results, errors = hooked[0]
    assert errors == 1
    want = [_standalone("plain", spec) for spec in _tenants()]
    for t, got in enumerate(results):
        np.testing.assert_array_equal(got, want[t], err_msg=str(t))
    for r, (by_sid, count) in enumerate(hooked[1:], start=1):
        assert count == (1 if r == HOOK_RANK else 0), (r, count)
        assert sorted(by_sid) == list(range(S)), (r, sorted(by_sid))
        for t in range(S):
            np.testing.assert_array_equal(by_sid[t].numpy(), want[t], err_msg=f"{r} {t}")


def test_close_with_unsent_session_ends_every_rank(runs):
    """A lead closed after a submission and before the next step (as a
    broker stopped under load closes it) drops that session and sends the
    stop command alone: every follower returns after the one step it was
    sent."""
    closing = runs[3]
    assert closing == [(1, [0])] * N, closing


def test_lead_and_follower_refuse_the_wrong_rank():
    """The lead wraps rank 0's per-rank engine, a follower any other rank's."""
    cfg = _cfg("plain")
    with pytest.raises(ValueError, match="rank 0"):
        EngineLead(AggregationEngine(cfg, SLOTS, V, device="cpu"))
    w1 = World(rank=1, size=N, device=torch.device("cpu"), transport="gloo")
    with pytest.raises(ValueError, match="rank 0"):
        EngineLead(AggregationEngine(cfg, SLOTS, V, world=w1))
    w0 = World(rank=0, size=N, device=torch.device("cpu"), transport="gloo")
    with pytest.raises(ValueError, match="ranks 1"):
        follow(AggregationEngine(cfg, SLOTS, V, world=w0))
