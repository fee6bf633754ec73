"""Pods with model shards across ranks: the reference's ('pod', 'data',
'model') train step and FedAvg round, one grid position a rank.

One ``spawn`` of 12 gloo ranks at one intra-op thread each: 2 pods x 3
learners x 2 model shards of the smoke internlm2-1.8b in f32 (rank
r = (p·n + l)·m + j, the reference's device order; ``dist.grid``). SAFE
needs at least 3 learners a ring (``RingTopology.validate_privacy``), so a
pod holds 3. Two SAFE steps (learner 1 of every pod dead in the second)
and one weighted FedAvg round, each rank recording what its chunk's round
was given and what it published. This process runs the one-card port's
pod step and round on the same inputs; beside the ranks, one reference
subprocess with 12 host devices runs its ``make_train_step`` on a (2, 3, 2)
Auto mesh with ``pod_axis="pod"`` and ``chain_model_sharded=True``.

The bar: every (pod, ring, chunk)'s published words equal the one-card
``pod_rounds`` of the same rows' chunk; each ZeRO-1 part is ``FlatAdamW``
on the published mean word for word; losses, grad scales and the
parameters' change are within the f32 bounds of
``tests/test_torch_dist_tp.py`` of the one-card pod step and the
reference's.

Expert parallelism with pods on the same grid: two SAFE steps of the f32
smoke qwen3-moe with 6 experts, each rank holding [E/n, d, f/m] of every
expert matrix, each pod's learners on tokens of their own. Against the
one-card pod step (the f32 sum of every learner's expert gradients): the
losses, the SAFE partition's change and the experts' within the EP bounds
of ``tests/test_torch_dist_ep.py``; the pods' expert shards and moments
equal word for word; every chunk round the one-card round of the rows
sent. The reference subprocess runs its EP step on the same grid: after
step 1 its SAFE partition agrees within the dense bound, and after step 2
its two pods hold different expert buffers under the replicated spec,
where the port keeps one copy (ROADMAP Queue 3).
"""
import dataclasses
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from helpers import REPO
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import make_aggregator
from repro_torch.data import make_federated_batches
from repro_torch.dist import collectives, grid, spawn
from repro_torch.models import Model
from repro_torch.models.sharding import shard_tree, tree_dims
from repro_torch.optim.adamw import AdamState, FlatAdamW
from repro_torch.train import make_federated_round, make_train_step, tree_to_flat
from repro_torch.train.flatten import is_expert_path, leaves, leaves_with_paths, shard_layout

PODS, N, M, B, S, LR, THREADS = 2, 3, 2, 2, 32, 1e-3, 1
ALIVE = ([1, 1, 1], [1, 0, 1])        # step i's alive bitmap, every pod's
FED_K, FED_ALIVE, FED_COUNTER = 2, [1, 1, 0], 777
# f32 bounds of tests/test_torch_dist_tp.py: losses 1e-6, grad_scale 1e-5
# relative, the parameters' change 5e-3 relative L2
LOSS_RTOL, SCALE_RTOL, REL_PARAMS = 1e-6, 1e-5, 5e-3
# the experts' change against the one-card EP step, f32
# (tests/test_torch_dist_ep.py)
REL_EP = 5e-4
EP_EXPERTS, EP_SEED = 6, 5

REF_CODE = """
import repro  # the package's jax shims first
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.core import make_aggregator
from repro.models import Model
from repro.train.flatten import tree_to_flat
from repro.train.train_step import make_train_step
import test_torch_dist_pod_tp as t

init = dict(np.load("@DIR@/init.npz"))
tree = {}
for key, a in init.items():
    node, parts = tree, key.split("/")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = jnp.asarray(a)
tree["blocks"] = [tree["blocks"][str(i)] for i in range(len(tree["blocks"]))]
mesh = jax.make_mesh((t.PODS, t.N, t.M), ("pod", "data", "model"),
                     axis_types=(AxisType.Auto,) * 3)
b = make_train_step(Model(t._cfg()), make_aggregator("safe", t.N, axis="data", pod_axis="pod"),
                    mesh, lr=t.LR, pod_axis="pod", chain_model_sharded=True)
s = b.init_state_fn(tree)
losses, scales = [], []
for i, alive in enumerate(t.ALIVE):
    s, m = b.step_fn(s, jnp.asarray(t._tokens(i)), counter=i * (b.padded_size + 2),
                     alive=jnp.asarray(alive, jnp.float32))
    losses.append(float(m["loss"]))
    scales.append(float(m["grad_scale"]))
np.savez("@DIR@/ref.npz", loss=np.asarray(losses), grad_scale=np.asarray(scales),
         params=np.asarray(tree_to_flat(s["params"])))

# expert parallelism with pods: experts sharded over 'data', replicated over 'pod'
from repro.train.flatten import _path_str, is_expert_path
init = dict(np.load("@DIR@/moe_init.npz"))
tree = {}
for key, a in init.items():
    node, parts = tree, key.split("/")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = jnp.asarray(a)
tree["blocks"] = [tree["blocks"][str(i)] for i in range(len(tree["blocks"]))]
b = make_train_step(Model(t._moe_cfg()), make_aggregator("safe", t.N, axis="data",
                                                          pod_axis="pod"),
                    mesh, lr=t.LR, pod_axis="pod", chain_model_sharded=True)
s = b.init_state_fn(tree)
out = {}
for i, alive in enumerate(t.ALIVE):
    s, m = b.step_fn(s, jnp.asarray(t._moe_tokens(i)), counter=i * (b.padded_size + 2),
                     alive=jnp.asarray(alive, jnp.float32))
    out[f"loss{i}"] = float(m["loss"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(s["params"])[0]:
        key = _path_str(path)
        if not is_expert_path(key):
            out[f"step{i}/{key}"] = np.asarray(leaf)
            continue
        # each device's buffer, by the slice of the array it claims to hold
        by_index = {}
        for sh in leaf.addressable_shards:
            by_index.setdefault(str(sh.index), []).append(np.asarray(sh.data))
        out[f"pod_diff{i}/{key}"] = max(float(np.abs(a - arrs[0]).max())
                                        for arrs in by_index.values() for a in arrs)
np.savez("@DIR@/ref_moe.npz", **out)
print("REF_OK")
"""


def _cfg():
    return dataclasses.replace(get_smoke_config("internlm2-1.8b"), dtype="float32")


def _init_state():
    return {k: v.detach().clone() for k, v in
            Model(_cfg(), device="cpu", generator=torch.Generator().manual_seed(0))
            .state_dict().items()}


def _model(init, tp=None):
    model = Model(_cfg(), device="cpu", tp_world=tp)
    model.load_state_dict(init if tp is None else
                          convert.shard_model(_cfg(), init, tp.rank, tp.size))
    return model


def _tokens(step):
    """Every learner's tokens of ``step``, pod-major [P·n, B, S]."""
    return make_federated_batches(_cfg(), PODS * N, B, S, seed=0).global_batch(step)["tokens"]


def _moe_cfg():
    """The f32 smoke qwen3-moe with EP_EXPERTS experts over a pod's N learners."""
    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    return dataclasses.replace(cfg, dtype="float32", ep_axis="data", ep_ranks=N,
                               moe=dataclasses.replace(cfg.moe, num_experts=EP_EXPERTS))


def _moe_tokens(step):
    """The MoE steps' [P·n, B, S] tokens, each learner of each pod its own."""
    return make_federated_batches(_moe_cfg(), PODS * N, B, S,
                                  seed=EP_SEED).global_batch(step)["tokens"]


def _moe_init():
    return {k: v.detach().clone() for k, v in Model(_moe_cfg(), device="cpu").state_dict().items()}


def _moe_steps(g=None, row=None):
    """Two SAFE pod EP steps of ``_moe_cfg`` from seed 0: on one card
    (``g`` None: tokens [P·n, B, S], every expert local) or rank ``g``'s
    step on its shards. Each step's parameters by path; the expert AdamW's
    m and v; each chunk round's (given, published)."""
    model = Model(_moe_cfg(), device="cpu", tp_world=g and g.model, ep_world=g and g.data)
    agg, seen = _recording(make_aggregator("safe", N, pod_axis="pod", device="cpu"))
    bundle = make_train_step(model, agg, g, lr=LR, pod_axis="pod")
    state = bundle.init_state_fn(model.tree())
    out = {"losses": [], "params": [], "padded": bundle.padded_size}
    for i, alive in enumerate(ALIVE):
        toks = _moe_tokens(i)
        state, m = bundle.step_fn(state, torch.from_numpy(toks if g is None else toks[row]),
                                  counter=i * (bundle.padded_size + 2), alive=alive)
        out["losses"].append(float(m["loss"]))
        out["params"].append({p: t.detach().clone()
                              for p, t in leaves_with_paths(state["params"])})
    out["m"] = [t.clone() for t in leaves(state["ep_opt"].m)]
    out["v"] = [t.clone() for t in leaves(state["ep_opt"].v)]
    out["rounds"] = list(seen)
    return out


def _fed_inputs():
    stream = make_federated_batches(_cfg(), PODS * N, B, S, seed=1)
    toks = np.stack([np.stack([stream.learner_batch(r, k)["tokens"] for k in range(FED_K)])
                     for r in range(PODS * N)])
    return toks, np.asarray([3.0, 1.0, 2.0], np.float32)


def _recording(agg):
    """``agg`` whose ``aggregate_rank`` keeps (chunk given, chunk published)."""
    seen = []
    real = agg.aggregate_rank

    def record(values, *a, **kw):
        out = real(values, *a, **kw)
        seen.append((values.clone(), out.clone()))
        return out

    agg.aggregate_rank = record
    return agg, seen


# ---- the ranks ---------------------------------------------------------------------------

def _rank(world, init):
    g = grid(world, M, PODS)
    me = torch.tensor([world.rank])
    out = {"pos": (g.pod.rank, g.data.rank, g.model.rank),
           "groups": {k: collectives.all_gather(me, getattr(g, k)).reshape(-1)
                      for k in ("pod", "data", "model")}}
    row = g.pod.rank * N + g.data.rank
    model = _model(init, g.model)
    agg, seen = _recording(make_aggregator("safe", N, pod_axis="pod", device="cpu"))
    bundle = make_train_step(model, agg, g, lr=LR, pod_axis="pod")
    state = bundle.init_state_fn(model.tree())
    steps = {"losses": [], "scales": [], "master": [], "master0": state["master"].clone(),
             "padded": bundle.padded_size}
    for i, alive in enumerate(ALIVE):
        state, m = bundle.step_fn(state, torch.from_numpy(_tokens(i)[row]),
                                  counter=i * (bundle.padded_size + 2), alive=alive)
        steps["losses"].append(float(m["loss"]))
        steps["scales"].append(float(m["grad_scale"]))
        steps["master"].append(state["master"].clone())
    steps["params"] = [p.clone() for p in leaves(state["params"])]
    steps["rounds"] = list(seen)
    out["steps"] = steps

    model = _model(init, g.model)
    agg, seen = _recording(make_aggregator("safe", N, weighted=True, pod_axis="pod",
                                           device="cpu"))
    fed = make_federated_round(model, agg, g, local_steps=FED_K, local_lr=LR,
                               return_delta=True)
    toks, weights = _fed_inputs()
    params, m = fed.round_fn(model.tree(), torch.from_numpy(toks[row]), weights=weights,
                             counter=FED_COUNTER, alive=FED_ALIVE)
    out["fed"] = {"delta": m["avg_delta"], "loss": float(m["local_loss"]),
                  "params": [p.clone() for p in leaves(params)], "rounds": list(seen),
                  "padded": fed.padded_size}
    out["moe"] = _moe_steps(g, row)
    return out


# ---- the one-card port and the reference -------------------------------------------------

def _one_card(init):
    model = _model(init)
    agg = make_aggregator("safe", N, pod_axis="pod", device="cpu")
    bundle = make_train_step(model, agg, lr=LR, pod_axis="pod")
    state = bundle.init_state_fn(model.tree())
    losses, scales = [], []
    for i, alive in enumerate(ALIVE):
        state, m = bundle.step_fn(state, torch.from_numpy(_tokens(i)),
                                  counter=i * (bundle.padded_size + 2), alive=alive)
        losses.append(float(m["loss"]))
        scales.append(float(m["grad_scale"]))
    model = _model(init)
    fed = make_federated_round(model, make_aggregator("safe", N, weighted=True, pod_axis="pod",
                                                      device="cpu"),
                               local_steps=FED_K, local_lr=LR, return_delta=True)
    toks, weights = _fed_inputs()
    fparams, fm = fed.round_fn(model.tree(), torch.from_numpy(toks), weights=weights,
                               counter=FED_COUNTER, alive=FED_ALIVE)
    return {"losses": losses, "scales": scales, "params": tree_to_flat(state["params"]),
            "fed_delta": fm["avg_delta"], "fed_loss": float(fm["local_loss"]),
            "fed_params": tree_to_flat(fparams), "moe": _moe_steps()}


def _run_reference(tmp):
    code = ("import sys; sys.path.insert(0, %r)\n" % os.path.join(REPO, "tests")
            + REF_CODE.replace("@DIR@", str(tmp)))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={PODS * N * M} "
                         "--xla_cpu_multi_thread_eigen=false")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess beside the 12 ranks, then the one-card
    port."""
    tmp = tmp_path_factory.mktemp("dist_pod_tp")
    init = _init_state()
    np.savez(tmp / "init.npz", **{k.replace(".", "/"): v.numpy() for k, v in init.items()})
    np.savez(tmp / "moe_init.npz", **{k.replace(".", "/"): v.numpy()
                                      for k, v in _moe_init().items()})
    with ThreadPoolExecutor(1) as pool:
        ref_run = pool.submit(_run_reference, tmp)
        ranks = [r["result"] for r in spawn(_rank, PODS * N * M, "cpu", args=(init,),
                                            threads=THREADS)]
        one = _one_card(init)
        assert "REF_OK" in ref_run.result()
    return {"ranks": ranks, "one": one, "init": init, "ref": dict(np.load(tmp / "ref.npz")),
            "ref_moe": dict(np.load(tmp / "ref_moe.npz"))}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _full_flat(shards_of, init):
    """The full tree's flat vector from model ranks 0..M-1's leaves."""
    model = _model(init)
    full = torch.zeros(tree_to_flat(model.tree()).numel())
    dims = tree_dims(model.tree(), _cfg(), M)
    for j in range(M):
        for sh, x in zip(shard_layout(shard_tree(model.tree(), _cfg(), j, M), dims, j, M),
                         shards_of[j]):
            full[sh.words()] = x.detach().reshape(-1).float()
    return full


def _rank_of(p, l, j):
    return (p * N + l) * M + j


# ---- the tests ----------------------------------------------------------------------------

def test_grid_is_the_reference_device_order(runs):
    """Rank (p·n + l)·m + j is pod p's learner l, model shard j: its pod
    group the ranks (·, l, j), its ring (p, ·, j), its model group (p, l, ·)."""
    for r, res in enumerate(runs["ranks"]):
        p, rest = divmod(r, N * M)
        l, j = divmod(rest, M)
        assert res["pos"] == (p, l, j)
        assert res["groups"]["pod"].tolist() == [_rank_of(q, l, j) for q in range(PODS)]
        assert res["groups"]["data"].tolist() == [_rank_of(p, q, j) for q in range(N)]
        assert res["groups"]["model"].tolist() == [_rank_of(p, l, q) for q in range(M)]


@pytest.mark.parametrize("part", ["steps", "fed", "moe"])
def test_every_chunk_is_the_one_card_pod_rounds(runs, part):
    """Each (pod, ring, chunk)'s published words equal the one-card
    aggregator's pod round (``pod_rounds``) of the same rows' chunk at the
    counter base moved by j·L/2, bit for bit; every rank of a chunk
    publishes the same words (the MoE's rows differ from the one-card
    step's by the exchange's float order: the round is held on the rows
    the ranks sent)."""
    ranks = runs["ranks"]
    weighted = part == "fed"
    counters = ([FED_COUNTER] if weighted else
                [i * (ranks[0][part]["padded"] + 2) for i in range(len(ALIVE))])
    _, weights = _fed_inputs()
    for i, counter in enumerate(counters):
        alive = FED_ALIVE if weighted else ALIVE[i]
        for j in range(M):
            given = torch.stack([torch.stack([ranks[_rank_of(p, l, j)][part]["rounds"][i][0]
                                              for l in range(N)]) for p in range(PODS)])
            L = given.shape[-1]
            agg = make_aggregator("safe", N, weighted=weighted, pod_axis="pod", device="cpu")
            kw = dict(weights=np.tile(weights, (PODS, 1))) if weighted else {}
            rotate = 0 if weighted else counter % (2 * N + 1)
            want = agg.aggregate(given, (counter + j * L // 2) & 0xFFFFFFFF, alive=alive,
                                 rotate=rotate, **kw)
            for p in range(PODS):
                for l in range(N):
                    got = ranks[_rank_of(p, l, j)][part]["rounds"][i][1]
                    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_zero1_parts_are_flat_adamw_on_the_published_mean(runs):
    """ZeRO-1 within each pod over its n·m ranks: rank (p, l, j) holds part
    l of chunk j, and after each step it is, word for word, the one-card
    ``FlatAdamW`` update of the whole master vector by the published mean
    (the chunks of the model ranks joined); the pods hold equal parts."""
    ranks = runs["ranks"]
    P = ranks[0]["steps"]["padded"]
    L, part = P // M, P // (N * M)
    for p in range(PODS):
        def joined(key, step=None):
            out = torch.empty(P)
            for l in range(N):
                for j in range(M):
                    res = ranks[_rank_of(p, l, j)]["steps"]
                    x = res[key] if step is None else res[key][step]
                    out[j * L + l * part:j * L + (l + 1) * part] = x
            return out

        master = joined("master0")
        opt, state = FlatAdamW(lr=LR, weight_decay=0.1), AdamState(0, torch.zeros(P),
                                                                  torch.zeros(P))
        for step in range(len(ALIVE)):
            mean = torch.cat([ranks[_rank_of(p, 0, j)]["steps"]["rounds"][step][1]
                              for j in range(M)])
            master, state = opt.update(mean, state, master)
            assert torch.equal(joined("master", step), master), (p, step)


def test_step_agrees_with_one_card_and_reference(runs):
    """Losses, grad scales and the parameters' change of the pod × model
    step against the one-card pod step and the reference's (2, 3, 2) Auto
    mesh step, within the f32 bounds; every rank of a shard agrees."""
    one, ref, init = runs["one"], runs["ref"], runs["init"]
    start = tree_to_flat(_model(init).tree()).numpy()
    got = _full_flat([runs["ranks"][j]["steps"]["params"] for j in range(M)], init).numpy()
    for r, res in enumerate(runs["ranks"]):
        st = res["steps"]
        np.testing.assert_allclose(st["losses"], one["losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(st["scales"], one["scales"], rtol=SCALE_RTOL)
        np.testing.assert_allclose(st["losses"], ref["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(st["scales"], ref["grad_scale"], rtol=SCALE_RTOL)
        for a, b in zip(st["params"], runs["ranks"][r % M]["steps"]["params"]):
            assert torch.equal(a, b)
    assert _rel_l2(got - start, one["params"].numpy() - start) <= REL_PARAMS
    assert _rel_l2(got - start, ref["params"] - start) <= REL_PARAMS
    assert runs["ranks"][0]["steps"]["losses"][1] < runs["ranks"][0]["steps"]["losses"][0]


def test_fedavg_round_agrees_with_one_card(runs):
    """The weighted pod × model FedAvg round: its published delta and new
    parameters within the f32 bounds of the one-card pod round's, and its
    ``local_loss`` pod 0's learner mean, as the one-card round's."""
    one, init = runs["one"], runs["init"]
    start = tree_to_flat(_model(init).tree()).numpy()
    got = _full_flat([runs["ranks"][j]["fed"]["params"] for j in range(M)], init).numpy()
    for res in runs["ranks"]:
        assert res["fed"]["padded"] % (2 * N * M) == 0
        np.testing.assert_allclose(res["fed"]["loss"], one["fed_loss"], rtol=LOSS_RTOL)
        assert _rel_l2(res["fed"]["delta"], one["fed_delta"]) <= REL_PARAMS
    assert _rel_l2(got - start, one["fed_params"].numpy() - start) <= REL_PARAMS


def _moe_full(shards, step):
    """The full parameters by path after ``step`` from the ranks' shards
    ``shards[p][l][j]`` (each a ``_moe_steps`` result) of pod p: the SAFE
    partition joined over learner 0's model group, each expert leaf over
    every (l, j), the experts along dim 1 in learner order."""
    cfg = _moe_cfg()
    meta = Model(cfg, device="meta").tree()
    out = {}
    for (path, _), split in zip(leaves_with_paths(meta), tree_dims(meta, cfg, M)):
        def join(l):
            parts = [shards[l][j]["params"][step][path] for j in range(M)]
            return parts[0] if split is None else split.join(parts)
        out[path] = (torch.cat([join(l) for l in range(N)], dim=1) if is_expert_path(path)
                     else join(0))
    return out


def _moe_init_leaves():
    return {p: t.detach().numpy() for p, t in
            leaves_with_paths(Model(_moe_cfg(), device="cpu").tree())}


def _moe_change(final, init, want, paths):
    got = np.concatenate([(final[p].numpy() - init[p]).ravel() for p in paths])
    ref = np.concatenate([(want[p] - init[p]).ravel() for p in paths])
    return _rel_l2(got, ref)


def test_pod_ep_step_near_one_card(runs):
    """Expert parallelism with pods and model shards: the losses, the SAFE
    partition's change and the experts' change over the two steps of
    each pod's ranks within the EP bounds of the one-card pod step's."""
    one, ranks = runs["one"]["moe"], runs["ranks"]
    init = _moe_init_leaves()
    ep = [p for p in init if is_expert_path(p)]
    sec = [p for p in init if not is_expert_path(p)]
    want = {p: t.numpy() for p, t in one["params"][-1].items()}
    for pod in range(PODS):
        shards = [[ranks[_rank_of(pod, l, j)]["moe"] for j in range(M)] for l in range(N)]
        for row in shards:
            for res in row:
                np.testing.assert_allclose(res["losses"], one["losses"], rtol=LOSS_RTOL)
        full = _moe_full(shards, -1)
        assert _moe_change(full, init, want, sec) <= REL_PARAMS, pod
        assert _moe_change(full, init, want, ep) <= REL_EP, pod


def test_pod_ep_shards_equal_across_pods(runs):
    """Rank (l, j)'s expert shards and their AdamW m and v are the same
    words in both pods after each step."""
    ranks = runs["ranks"]
    for l in range(N):
        for j in range(M):
            a, b = ranks[_rank_of(0, l, j)]["moe"], ranks[_rank_of(1, l, j)]["moe"]
            for step in range(len(ALIVE)):
                for p, t in a["params"][step].items():
                    if is_expert_path(p):
                        assert torch.equal(t, b["params"][step][p]), (l, j, step, p)
            for key in ("m", "v"):
                assert all(torch.equal(x, y) for x, y in zip(a[key], b[key])), (l, j, key)


def test_reference_ep_step_with_pods(runs):
    """The reference's EP step on the same (2, 3, 2) grid: after step 1
    (where no expert update has yet reached the forward) its loss and SAFE
    partition's change agree with the port's within the dense step's
    bounds; after step 2 its two pods hold different expert buffers, each
    pod's copy updated by its own pod's sum, under an out_spec that calls
    them one replicated array. The port's pods hold one copy."""
    ref, ranks = runs["ref_moe"], runs["ranks"]
    init = _moe_init_leaves()
    sec = [p for p in init if not is_expert_path(p)]
    shards = [[ranks[_rank_of(0, l, j)]["moe"] for j in range(M)] for l in range(N)]
    got = _moe_full(shards, 0)
    want = {p: ref[f"step0/{p}"] for p in sec}
    np.testing.assert_allclose(ranks[0]["moe"]["losses"][0], float(ref["loss0"]),
                               rtol=LOSS_RTOL)
    assert _moe_change(got, init, want, sec) <= REL_PARAMS
    ep_keys = [k for k in ref if k.startswith("pod_diff1/")]
    assert len(ep_keys) == 3 * len(_moe_cfg().pattern)
    assert max(float(ref[k]) for k in ep_keys) > 0
