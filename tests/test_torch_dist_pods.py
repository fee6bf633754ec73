"""Pods as a second mesh dimension across processes, the multi-session
engine one learner a rank, and the all-to-all's autograd.

Six gloo ranks on the CPU (``repro_torch.dist.spawn``, two intra-op threads
each, as this process uses) form a ('pod', 'data') grid of P = 2 pods × n = 3
learners (``launch/mesh.py::make_pod_mesh``; SAFE's rings need three
members). Each rank runs, on its row:

- the pod rounds of every mode — sequential (rotated, learner 1 dead),
  pipelined, BON (learner 1 dead), INSEC and weighted (learner 0 dead) —
  through ``aggregate_rank`` with the pod ``World``, and one through
  ``aggregate_sharded`` on the mesh; each must equal the one-card
  ``aggregate`` on [2, 3, V] and the reference's per-rank ``aggregate``
  under a ``shard_map`` manual over ('pod', 'data') on six host devices in
  a subprocess, with ``assert_array_equal``;
- two SAFE train steps (the second with learner 1 dead) and one weighted
  FedAvg round (learner 1 dead) of the f32 smoke internlm2-1.8b with the
  pod axis, word for word the one-card pod step's and round's;
- the per-rank ``AggregationEngine`` over its pod's three learners (plain
  and weighted) and over all six as two rings of three (three sessions of
  two rounds through two slots, rotated, one with a dead learner), every
  session-round bit for bit the one-card engine's;
- a tiled ``all_to_all`` over all six ranks under autograd, whose input
  gradient must equal the transpose computed in one process;
- two SAFE train steps of the f32 smoke qwen3-moe with 6 experts by
  expert parallelism with pods (the second with learner 1 dead), each
  rank holding its two experts: within the EP bounds of
  ``tests/test_torch_dist_ep.py`` of the one-card pod step, which sums the
  expert gradients of all P·n learners; the pods' expert shards and their
  moments equal word for word, and each SAFE round the one-card round of
  the rows the ranks sent.

The one-card FedAvg round with ``pod_axis`` (the reference's argument,
missing from the port before) is held to the reference's
``make_federated_round(..., pod_axis="pod")`` from the same weights and
tokens; the reference's ``local_loss`` is established first: its ``pmean``
runs over the learners only, and its replicated output is pod 0's.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from helpers import REPO, run_multidevice
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import ChainConfig, make_aggregator
from repro_torch.data import make_federated_batches
from repro_torch.dist import collectives, spawn
from repro_torch.models import Model
from repro_torch.serve.agg_engine import AggregationEngine
from repro_torch.train import make_federated_round, make_train_step, tree_to_flat
from repro_torch.train.flatten import is_expert_path, leaves, leaves_with_paths

P, N, V, THREADS = 2, 3, 37, 2
COUNTER = 2**32 - 5        # the pads wrap the 32-bit counter
# name -> (aggregator kwargs, round kwargs); "w" stands for the f32[P, n] weights
CELLS = {
    "sequential": (dict(mode="safe"), dict(rotate=2, alive=[1, 0, 1])),
    "pipelined": (dict(mode="safe", pipelined=True), {}),
    "bon": (dict(mode="bon"), dict(alive=[1, 0, 1])),
    "insec": (dict(mode="insec"), dict(weights="w")),
    "weighted": (dict(mode="safe", weighted=True), dict(weights="w", alive=[0, 1, 1])),
}
B, S, LR, K = 2, 32, 1e-3, 2
STEP_ALIVE = ([1, 1, 1], [1, 0, 1])
FED_ALIVE, FED_COUNTER = [1, 0, 1], 777
FED_WEIGHTS = np.asarray([3.0, 1.0, 2.0], np.float32)   # learner l's in every pod
ENGINE_S, ENGINE_ROUNDS = 2, 2
# the one-card FedAvg with pods against the reference, f32. Measured: the
# published delta 1.2e-4 relative L2 (six learners' K = 2 local AdamW steps,
# each ~1e-4 from the reference's as in tests/test_torch_federated.py), the
# loss within 1e-5; the bounds sit 2.5x above.
FED_REL, FED_LOSS_RTOL = 3e-4, 1e-5
# Expert parallelism with pods against the one-card pod step, f32: the
# bounds of tests/test_torch_dist_ep.py (losses 1e-6 relative, the SAFE
# partition's change 5e-3 and the experts' 5e-4 relative L2).
EP_LOSS_RTOL, EP_REL_SEC, EP_REL_EP = 1e-6, 5e-3, 5e-4
EP_EXPERTS, EP_SEED = 6, 5


def _cell(name):
    """(mode, aggregator kwargs, values f32[P, n, V] with a dead learner's
    rows NaN, weights f32[P, n] or None, round kwargs)."""
    akw, kw = CELLS[name]
    akw, kw = dict(akw), dict(kw)
    rng = np.random.RandomState(sum(map(ord, name)))
    vals = rng.uniform(-2, 2, (P, N, V)).astype(np.float32)
    w = rng.uniform(1, 10, (P, N)).astype(np.float32)
    if "alive" in kw:
        vals[:, np.asarray(kw["alive"]) == 0] = np.nan
    weights = w if kw.pop("weights", None) == "w" else None
    return akw.pop("mode"), akw, vals, weights, kw


def _cfg():
    return dataclasses.replace(get_smoke_config("internlm2-1.8b"), dtype="float32")


def _tokens():
    """The train steps' [2, P·n, B, S] and FedAvg's [P·n, K, B, S] tokens."""
    stream = make_federated_batches(_cfg(), P * N, B, S, seed=3)
    steps = np.stack([stream.global_batch(i)["tokens"] for i in range(2)])
    fed = np.stack([np.stack([stream.learner_batch(l, 10 + k)["tokens"] for k in range(K)])
                    for l in range(P * N)])
    return steps, fed


# the engines: name -> (learners, subgroups, weighted); "groups" runs on all
# six ranks as two rings of three
ENGINES = {"plain": (N, 1, False), "weighted": (N, 1, True), "groups": (P * N, 2, True)}


def _sessions(n):
    """The engine's sessions: (values f32[n, V], alive, weights, rotate0)."""
    rng = np.random.RandomState(11 + n)
    return [(rng.uniform(-1, 1, (n, V)).astype(np.float32),
             [0 if l == 1 else 1 for l in range(n)] if i == 1 else None,
             rng.uniform(1, 5, n).astype(np.float32), 2 * i) for i in range(3)]


def _engine(name, world=None):
    """Every session's published means [rounds, V] through an engine of
    ENGINE_S slots (one learner a rank of ``world``, or learner-major on
    the CPU)."""
    n, groups, weighted = ENGINES[name]
    eng = AggregationEngine(ChainConfig(num_learners=n, mode="safe", weighted=weighted,
                                        subgroups=groups), ENGINE_S, V, device="cpu",
                            world=world)
    sess = [eng.submit(v if world is None else v[world.rank], rounds=ENGINE_ROUNDS,
                       alive=a, weights=w, rotate0=r) for v, a, w, r in _sessions(n)]
    eng.run_until_done()
    return [torch.stack(s.results) for s in sess]


def _step(mesh=None, rank=None):
    """Two SAFE pod train steps from seed 0: (losses, final flat parameters).
    ``rank`` None: the one-card step on the [P·n, B, S] tokens; else the
    per-rank step on global rank ``rank``'s."""
    model = Model(_cfg(), device="cpu")
    agg = make_aggregator("safe", N, pod_axis="pod", device="cpu")
    bundle = make_train_step(model, agg, mesh, lr=LR, pod_axis="pod")
    state = bundle.init_state_fn(model.tree())
    steps, _ = _tokens()
    losses = []
    for i, alive in enumerate(STEP_ALIVE):
        toks = steps[i] if rank is None else steps[i][rank]
        state, m = bundle.step_fn(state, torch.from_numpy(toks),
                                  counter=agg.reserve_round(bundle.padded_size + 2),
                                  alive=alive)
        losses.append(float(m["loss"]))
    return losses, tree_to_flat(state["params"])


def _moe_cfg():
    """The f32 smoke qwen3-moe with EP_EXPERTS experts over a pod's N
    learners (two a rank)."""
    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    return dataclasses.replace(cfg, dtype="float32", ep_axis="data", ep_ranks=N,
                               moe=dataclasses.replace(cfg.moe, num_experts=EP_EXPERTS))


def _moe_step(mesh=None, rank=None):
    """Two SAFE pod EP train steps of ``_moe_cfg`` from seed 0, each pod's
    learners on tokens of their own: the one-card step on [P·n, B, S]
    (``rank`` None, every expert local), or global rank ``rank``'s step
    over the ('pod', 'data') ``mesh`` on its E/n experts, recording each
    round's (row sent, mean published, counter, alive, rotate). Returns
    the losses, the final parameters by path, the expert AdamW's m and v
    and the rounds."""
    from repro_torch.dist import rank_world
    data = None if mesh is None else rank_world(mesh, "data")
    model = Model(_moe_cfg(), device="cpu", ep_world=data)
    agg = make_aggregator("safe", N, pod_axis="pod", device="cpu")
    rounds = []
    if mesh is not None:
        inner = agg.aggregate_rank

        def spy(values, counter_base=0, **kw):
            out = inner(values, counter_base, **kw)
            rounds.append((values.clone(), out.clone(), counter_base, kw["alive"],
                           kw["rotate"]))
            return out
        agg.aggregate_rank = spy
    bundle = make_train_step(model, agg, mesh, lr=LR, pod_axis="pod")
    state = bundle.init_state_fn(model.tree())
    stream = make_federated_batches(_moe_cfg(), P * N, B, S, seed=EP_SEED)
    losses = []
    for i, alive in enumerate(STEP_ALIVE):
        toks = stream.global_batch(i)["tokens"]
        state, m = bundle.step_fn(state, torch.from_numpy(toks if rank is None else toks[rank]),
                                  counter=agg.reserve_round(bundle.padded_size + 2),
                                  alive=alive)
        losses.append(float(m["loss"]))
    return {"losses": losses,
            "final": {p: t.detach().clone() for p, t in leaves_with_paths(state["params"])},
            "m": [t.clone() for t in leaves(state["ep_opt"].m)],
            "v": [t.clone() for t in leaves(state["ep_opt"].v)], "rounds": rounds}


def _fed(model, mesh=None, rank=None):
    """One weighted FedAvg round with pods: (published delta, new flat
    parameters, local loss, delta norm)."""
    agg = make_aggregator("safe", N, weighted=True, pod_axis="pod", device="cpu")
    bundle = make_federated_round(model, agg, mesh, local_steps=K, local_lr=LR,
                                  pod_axis="pod", return_delta=True)
    _, fed = _tokens()
    params, m = bundle.round_fn(model.tree(), torch.from_numpy(fed if rank is None
                                                               else fed[rank]),
                                weights=FED_WEIGHTS, counter=FED_COUNTER, alive=FED_ALIVE)
    return m["avg_delta"], tree_to_flat(params), float(m["local_loss"]), float(m["delta_norm"])


def _exchange_input(rank):
    return torch.arange(6 * 2 * 5, dtype=torch.float32).reshape(12, 5) / 7 + rank


def _rank(world):
    """One rank of the grid: the pod rounds, the pod step and round, the
    engine on its pod's learners and the all-to-all's gradient."""
    from repro_torch.dist import rank_world
    from repro_torch.launch.mesh import make_pod_mesh
    mesh = make_pod_mesh(P, N)
    data, pod = rank_world(mesh, "data"), rank_world(mesh, "pod")
    out = {"grid": (data.rank, data.size, pod.rank, pod.size)}
    for name in CELLS:
        mode, akw, vals, w, kw = _cell(name)
        agg = make_aggregator(mode, N, pod_axis="pod", device="cpu", **akw)
        out[name] = agg.aggregate_rank(torch.from_numpy(vals[pod.rank, data.rank]), COUNTER,
                                       weights=w, world=data, pod_world=pod, **kw)
    mode, akw, vals, w, kw = _cell("weighted")
    out["sharded"] = make_aggregator(mode, N, pod_axis="pod", device="cpu", **akw) \
        .aggregate_sharded(mesh, torch.from_numpy(vals), COUNTER, alive=kw["alive"], weights=w)
    out["step"] = _step(mesh, world.rank)
    out["fed"] = _fed(Model(_cfg(), device="cpu"), mesh, world.rank)
    out["moe"] = _moe_step(mesh, world.rank)
    out["engine"] = {name: _engine(name, world if ENGINES[name][0] == P * N else data)
                     for name in ENGINES}
    x = _exchange_input(world.rank).requires_grad_(True)
    y = collectives.all_to_all(x, world)
    (y * (1 + torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape)
          * (world.rank + 1))).sum().backward()
    out["exchange"] = (y.detach(), x.grad)
    return out


REF_CODE = """
import dataclasses
import repro  # the package's jax shims first
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, Mesh, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.core import make_aggregator
from repro.models import Model
from repro.train.federated import make_federated_round
from repro.train.flatten import tree_to_flat
import test_torch_dist_pods as t

out = {}
mesh = Mesh(np.array(jax.devices()[:t.P * t.N]).reshape(t.P, t.N), ("pod", "data"))
for name in t.CELLS:
    mode, akw, vals, w, kw = t._cell(name)
    agg = make_aggregator(mode, t.N, pod_axis="pod", **akw)
    alive = jnp.asarray(kw.get("alive", np.ones(t.N)), jnp.float32)
    ws = np.ones((t.P, t.N), np.float32) if w is None else w
    def pr(v, wr, a, agg=agg, rot=kw.get("rotate", 0), weighted=w is not None):
        return agg.aggregate(v.reshape(-1), t.COUNTER, alive=a,
                             weights=wr.reshape(()) if weighted else None, rotate=rot)
    f = jax.shard_map(pr, mesh=mesh, in_specs=(P(("pod", "data")), P(("pod", "data")), P()),
                      out_specs=P(), axis_names=frozenset({"pod", "data"}), check_vma=False)
    with jax.set_mesh(mesh):
        out[name] = np.asarray(jax.jit(f)(jnp.asarray(vals.reshape(t.P * t.N, -1)),
                                          jnp.asarray(ws.reshape(-1)), alive))

# FedAvg with the pod axis on a (pod, data, model) Auto mesh
cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"), dtype="float32")
model = Model(cfg)
mesh3 = jax.make_mesh((t.P, t.N, 1), ("pod", "data", "model"),
                      axis_types=(AxisType.Auto,) * 3)
params = model.init(jax.random.key(0))
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
    out["init/" + key] = np.asarray(leaf)
agg = make_aggregator("safe", t.N, weighted=True, pod_axis="pod")
b = make_federated_round(model, agg, mesh3, local_steps=t.K, local_lr=t.LR,
                         pod_axis="pod", return_delta=True)
_, fed = t._tokens()
new, m = b.round_fn(params, jnp.asarray(fed), weights=jnp.asarray(t.FED_WEIGHTS),
                    counter=t.FED_COUNTER, alive=jnp.asarray(t.FED_ALIVE, jnp.float32))
out["fed/avg_delta"] = np.asarray(m["avg_delta"])
out["fed/local_loss"] = np.asarray(m["local_loss"])
out["fed/delta_norm"] = np.asarray(m["delta_norm"])
# the local update alone, per learner: what the replicated loss is made of
from repro.train.federated import make_local_update
lu = jax.jit(make_local_update(model, local_steps=t.K, local_lr=t.LR))
out["fed/losses"] = np.asarray([float(lu(params, jnp.asarray(fed[i]))[1])
                                for i in range(t.P * t.N)], np.float32)
np.savez("@OUT@", **out)
print("REF_OK")
"""


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads here and in each rank: a CPU reduction's order
    follows the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks():
    return [r["result"] for r in spawn(_rank, P * N, "cpu", threads=THREADS)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("dist_pods_ref") / "ref.npz"
    code = ("import sys; sys.path.insert(0, %r)\n" % os.path.join(REPO, "tests")
            + REF_CODE.replace("@OUT@", str(path)))
    assert "REF_OK" in run_multidevice(code, devices=P * N, timeout=600)
    return dict(np.load(path))


def _one_card(name):
    mode, akw, vals, w, kw = _cell(name)
    agg = make_aggregator(mode, N, pod_axis="pod", device="cpu", **akw)
    return agg.aggregate(torch.from_numpy(vals), COUNTER, weights=w, **kw)


def test_grid_is_pod_major(ranks):
    """Rank p·n + l is learner l of pod p; its pod World links learner l
    across the pods in pod order."""
    assert [r["grid"] for r in ranks] == [(l, N, p, P) for p in range(P) for l in range(N)]


@pytest.mark.parametrize("name", list(CELLS))
def test_pod_round_equals_one_card_and_reference(ranks, reference, name):
    want = _one_card(name)
    assert want.dtype == torch.float32 and want.shape == (V,)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res[name].numpy(), want.numpy(), err_msg=str(r))
    np.testing.assert_array_equal(want.numpy(), reference[name])


def test_pod_aggregate_sharded_on_live_mesh(ranks):
    want = _one_card("weighted")
    for res in ranks:
        np.testing.assert_array_equal(res["sharded"].numpy(), want.numpy())


def test_pod_train_step_equals_one_card(ranks):
    losses, params = _step()
    for r, res in enumerate(ranks):
        assert res["step"][0] == losses, r
        assert torch.equal(res["step"][1], params), r
    assert losses[1] < losses[0]


def test_pod_fedavg_round_equals_one_card(ranks):
    delta, params, loss, norm = _fed(Model(_cfg(), device="cpu"))
    for r, res in enumerate(ranks):
        got = res["fed"]
        assert torch.equal(got[0], delta) and torch.equal(got[1], params), r
        assert (got[2], got[3]) == (loss, norm), r


def _ref_model(reference):
    tree = {}
    for key, a in reference.items():
        if key.startswith("init/"):
            node, parts = tree, key[len("init/"):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = a
    tree["blocks"] = [tree["blocks"][str(i)] for i in range(len(tree["blocks"]))]
    model = Model(_cfg(), device="cpu")
    model.load_state_dict(convert.model_params(_cfg(), tree))
    return model


def test_reference_fedavg_local_loss_is_pod_zeros(reference):
    """What the reference's replicated ``local_loss`` holds with pods: its
    ``pmean`` runs over the learners alone, and the value it returns is
    pod 0's learner mean, not the mean over every learner."""
    losses = reference["fed/losses"].reshape(P, N)
    assert float(reference["fed/local_loss"]) == pytest.approx(float(losses[0].mean()),
                                                               rel=1e-6)
    assert abs(float(losses[1].mean()) - float(losses[0].mean())) > 1e-4


def test_one_card_fedavg_with_pod_axis_matches_reference(reference):
    """``make_federated_round(..., pod_axis="pod")`` on one card from the
    reference's weights and tokens: tokens [P·n, K, B, S] pod-major, each
    learner weighted by its learner rank's weight in every pod, the
    aggregator's pod mean; the published delta within FED_REL relative L2,
    the local loss (pod 0's) within 1e-5 and the delta's norm within
    FED_REL of the reference's."""
    delta, _, loss, norm = _fed(_ref_model(reference))
    want = reference["fed/avg_delta"]
    e = float(np.linalg.norm(delta.numpy().astype(np.float64) - want)
              / np.linalg.norm(want.astype(np.float64)))
    assert e <= FED_REL, e
    np.testing.assert_allclose(loss, float(reference["fed/local_loss"]), rtol=FED_LOSS_RTOL)
    np.testing.assert_allclose(norm, float(reference["fed/delta_norm"]), rtol=FED_REL)


@pytest.mark.parametrize("name", list(ENGINES))
def test_rank_engine_equals_one_card_engine(ranks, name):
    """Every session-round of the per-rank engine, on each pod's three
    ranks (plain and weighted) and on all six as two rings of three,
    bit for bit the one-card engine's."""
    want = _engine(name)
    for r, res in enumerate(ranks):
        for got, w in zip(res["engine"][name], want):
            np.testing.assert_array_equal(got.numpy(), w.numpy(), err_msg=str(r))


def test_all_to_all_gradient_is_its_transpose(ranks):
    """The exchange on six ranks, and its input gradient under autograd,
    against the same exchange written in one process (rank r's output is
    the concatenation of every rank's chunk r) and its autograd."""
    n = P * N
    xs = [_exchange_input(r).requires_grad_(True) for r in range(n)]
    ys = [torch.cat([x.chunk(n)[r] for x in xs]) for r in range(n)]
    sum((y * (1 + torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape) * (r + 1))).sum()
        for r, y in enumerate(ys)).backward()
    for r, res in enumerate(ranks):
        y, g = res["exchange"]
        assert torch.equal(y, ys[r].detach()), r
        assert torch.equal(g, xs[r].grad), r



def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_pod_ep_step_near_one_card(ranks):
    """Expert parallelism with pods: each pod's experts, gathered from its
    ranks' shards, and the SAFE partition change over the two steps within
    the EP bounds of the one-card pod step's, which sums every learner's
    expert gradients in f32; the losses within 1e-6."""
    one = _moe_step()
    init = {p: t for p, t in leaves_with_paths(Model(_moe_cfg(), device="cpu").tree())}
    ep = [p for p in init if is_expert_path(p)]
    sec = [p for p in init if not is_expert_path(p)]
    assert len(ep) == 3 * len(_moe_cfg().pattern) and sec

    def change(final, paths):
        return np.concatenate([(final[p] - init[p]).detach().numpy().ravel() for p in paths])
    want_sec, want_ep = change(one["final"], sec), change(one["final"], ep)
    for pod in range(P):
        res = [ranks[pod * N + l]["moe"] for l in range(N)]
        for r in res:
            np.testing.assert_allclose(r["losses"], one["losses"], rtol=EP_LOSS_RTOL)
            assert all(torch.equal(r["final"][p], res[0]["final"][p]) for p in sec)
        full = {p: torch.cat([r["final"][p] for r in res], dim=1) for p in ep}
        assert _rel_l2(change(res[0]["final"], sec), want_sec) <= EP_REL_SEC, pod
        assert _rel_l2(change(full, ep), want_ep) <= EP_REL_EP, pod


def test_pod_ep_experts_equal_across_pods(ranks):
    """Learner l's expert shards, and their AdamW m and v, are the same
    words in every pod after the two steps (each pod applies the sum over
    every pod's learners)."""
    for l in range(N):
        a = ranks[l]["moe"]
        for pod in range(1, P):
            b = ranks[pod * N + l]["moe"]
            for p, t in a["final"].items():
                if is_expert_path(p):
                    assert torch.equal(t, b["final"][p]), (l, pod, p)
            for key in ("m", "v"):
                assert all(torch.equal(x, y) for x, y in zip(a[key], b[key])), (l, pod, key)


@pytest.mark.parametrize("step", range(len(STEP_ALIVE)))
def test_pod_ep_safe_round_is_one_card_round_of_the_rows_sent(ranks, step):
    """Each SAFE round of the EP step with pods publishes, word for word,
    the one-card pod round of the [P, n, V] rows the ranks sent (the rows
    differ from the one-card step's by the exchange's float order)."""
    rows = torch.stack([ranks[r]["moe"]["rounds"][step][0] for r in range(P * N)])
    _, _, counter, alive, rotate = ranks[0]["moe"]["rounds"][step]
    want = make_aggregator("safe", N, pod_axis="pod", device="cpu").aggregate(
        rows.view(P, N, -1), counter, alive=alive, rotate=rotate)
    for r, res in enumerate(ranks):
        assert res["moe"]["rounds"][step][2:4] == (counter, alive), r
        np.testing.assert_array_equal(res["moe"]["rounds"][step][1].numpy(), want.numpy())
