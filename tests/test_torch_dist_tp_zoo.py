"""The 'model' axis across ranks for the rest of the zoo: Megatron tensor
parallelism for Mamba2 and RWKV6 (by head), the MoE's expert-ff and
shared experts, and zamba2's shared block, on the reference's ('data',
'model') grid (rank l·m + j is learner l's model shard j).

In process: each rank's shards and the (segmented) flat layout against the
full tree's ``tree_to_flat`` for the smoke zamba2, rwkv6, qwen3-moe and
llama4 (m = 2 and m = 4), the full configurations built at m = 2 on meta
tensors, and the splits once refused, which now split by whole units.

One ``spawn`` of 8 gloo ranks (4 learners x 2 model shards, one intra-op
thread each) runs the both-ways all-reduce against autograd of one
process, then the smoke zamba2, rwkv6 and qwen3-moe (its experts over the
learners' ring, ``ep_axis="data"``) in f32: a gradient of every leaf, two
SAFE train steps (learner 1 dead in the second) and a weighted FedAvg
round, against the one-card port in this process on the same weights and
tokens. Every ring's published chunk must be the one-card round's words of
the ranks' own gradient rows, ZeRO-1's parts the one-card ``FlatAdamW``
on the published means, and every replicated leaf's gradient the same on
each rank of a model group.

One subprocess runs the reference's ``make_train_step`` on a (4, 2) Auto
mesh with ``chain_model_sharded`` for the same three configurations (the
MoE with ``ep_axis="data"``), from the port's initial weights. Beside them
the launcher runs zamba2-smoke under ``torch.distributed.run`` on 4 CPU
ranks (2 learners x 2 model shards, BON): a checkpoint, a resume equal to
the uninterrupted run word for word, and the one-process launcher
restoring the model-sharded ranks' checkpoint.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from helpers import REPO
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import make_aggregator
from repro_torch.data import make_federated_batches
from repro_torch.dist import World, collectives, grid_worlds, spawn
from repro_torch.models import Model
from repro_torch.models import moe as moe_mod
from repro_torch.models.sharding import check_tp, shard_tree, tree_dims
from repro_torch.optim.adamw import AdamState, FlatAdamW
from repro_torch.train import make_federated_round, make_train_step, tree_to_flat
from repro_torch.train.flatten import (is_expert_path, leaf_paths, leaves, leaves_with_paths,
                                       shard_layout, tree_map)
from repro_torch.train.loss import next_token_loss, param_grads

N, M, B, S, LR, THREADS = 4, 2, 2, 32, 1e-3, 2
# one intra-op thread a rank: every check against this process's one-card
# port is a bound or integer arithmetic, so the ranks need not match its two
# threads, and eight ranks then keep to eight cores
RANK_THREADS = 1
ALIVE = ([1, 1, 1, 1], [1, 0, 1, 1])      # step i's alive bitmap
FED_K, FED_ALIVE, FED_COUNTER = 2, [1, 1, 0, 1], 12345
ZOO = ("zamba2-2.7b", "rwkv6-1.6b", "qwen3-moe-235b-a22b")
MOE = "qwen3-moe-235b-a22b"
# f32 bounds of tests/test_torch_dist_tp.py: losses 1e-6, grad_scale 1e-5
# relative, the parameters' change 5e-3 relative L2; for qwen3-moe, whose
# expert sums already run in another order than one card's, the EP test's
# 5e-4 relative L2 on each leaf's change
LOSS_RTOL, SCALE_RTOL, REL_PARAMS, MOE_REL = 1e-6, 1e-5, 5e-3, 5e-4
# rwkv6's grad_scale at the second step: the first AdamW step moves each word
# by about ±lr whatever its gradient's size, so a gradient near zero whose
# sign the row-parallel sums flip moves its word the other way, and RWKV6's
# data-dependent decay exp(-exp(w0 + x·w_proj)) carries that into the next
# gradient's norm. Measured (f32, the CPU): step 1 3.0e-6 relative to one
# card, step 2 7.5e-5 (the reference on the (4, 2) mesh: 2.9e-5 and 7.2e-5);
# the losses agree to 2.3e-7 and the change over both steps to 2.1e-3
# relative L2, inside the bounds above. The bound sits ~3x above.
SCALE_RTOL_OF = {"rwkv6-1.6b": 2.5e-4}
# a replicated leaf's gradient against one process's (both f32, the
# row-parallel sums added in another order): relative L2
GRAD_REL = 1e-4
# smoke llama4 has 5 q heads, which m = 2 splits unevenly (3 and 2); the
# ranks here give it 4, its full configuration's even head count, and the
# uneven head splits run in tests/test_torch_dist_heads.py
LLAMA4_HEADS = 4

REF_CODE = """
import repro  # the package's jax shims first
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.core import make_aggregator
from repro.data import make_federated_batches
from repro.configs import get_smoke_config
from repro.models import Model
from repro.train.flatten import tree_to_flat
from repro.train.train_step import make_train_step
import dataclasses
import test_torch_dist_tp_zoo as t

out = {}
mesh = jax.make_mesh((t.N, t.M), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
for arch in t.ZOO:
    init = dict(np.load("@DIR@/" + arch + ".npz"))
    tree = {}
    for key, a in init.items():
        node, parts = tree, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(a)
    tree["blocks"] = [tree["blocks"][str(i)] for i in range(len(tree["blocks"]))]
    cfg = dataclasses.replace(get_smoke_config(arch), **t.train_options(arch))
    stream = make_federated_batches(cfg, t.N, t.B, t.S, seed=0)
    b = make_train_step(Model(cfg), make_aggregator("safe", t.N, axis="data"), mesh, lr=t.LR,
                        chain_model_sharded=True)
    s = b.init_state_fn(tree)
    losses, scales = [], []
    for i, alive in enumerate(t.ALIVE):
        s, m = b.step_fn(s, jnp.asarray(stream.global_batch(i)["tokens"]),
                         counter=i * (b.padded_size + 2), alive=jnp.asarray(alive, jnp.float32))
        losses.append(float(m["loss"]))
        scales.append(float(m["grad_scale"]))
    out[arch + "/loss"], out[arch + "/grad_scale"] = np.asarray(losses), np.asarray(scales)
    out[arch + "/params"] = np.asarray(tree_to_flat(s["params"]))
np.savez("@DIR@/ref.npz", **out)
print("REF_OK")
"""


def train_options(arch):
    """The train step's options of the smoke configuration: f32, and a
    MoE's experts by expert parallelism over the N learners."""
    moe = get_smoke_config(arch).moe is not None
    return dict(dtype="float32", **(dict(ep_axis="data", ep_ranks=N) if moe else {}))


def _cfg(arch, train=True):
    """The f32 smoke configuration, with ``train_options`` for the train
    step (FedAvg carries every expert)."""
    return dataclasses.replace(get_smoke_config(arch),
                               **(train_options(arch) if train else dict(dtype="float32")))


def _model(arch, train=True, tp=None, ring=None):
    """The one-card model from seed 0, or the grid rank's shards of it (the
    same generator draws; with expert parallelism its ring rank's experts)."""
    cfg = _cfg(arch, train)
    ep = ring if cfg.ep_axis is not None else None
    return Model(cfg, device="cpu", generator=torch.Generator().manual_seed(0), tp_world=tp,
                 ep_world=ep)


def _stream(arch):
    return make_federated_batches(_cfg(arch), N, B, S, seed=0)


def _fed_inputs(arch):
    stream = _stream(arch)
    toks = np.stack([np.stack([stream.learner_batch(l, k)["tokens"] for k in range(FED_K)])
                     for l in range(N)])
    return toks, stream.global_batch(0)["weights"]


def _grads(model, tokens):
    """(loss, every leaf's gradient) of one forward and backward."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), model.tree())
    logits, aux = model.apply(p, tokens)
    loss = next_token_loss(logits, tokens, model.cfg.prefix_embeds) + aux
    return loss.detach(), [g.detach().clone() for g in param_grads(loss, leaves(p))]


# ---- the ranks ---------------------------------------------------------------------------

def _norm_inputs():
    rng = np.random.RandomState(7)
    return tuple(torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))
                 for s in ((3, 8), (8, 5), (3, 5)))


def _norm_loss(a, w, d, tp):
    """Mamba2's pattern: the channels ``a`` [3, 8] normalised by their mean
    square over all 8 channels, then a row-parallel product by ``w``
    [8, 5]; on model rank j its 8/m channels (``tp`` None: one process)."""
    if tp is None:
        var = torch.sum(torch.square(a), -1, keepdim=True) / a.shape[1]
        return (((a * torch.rsqrt(var)) @ w) * d).sum()
    k = a.shape[1] // tp.size
    mine = a[:, tp.rank * k:(tp.rank + 1) * k]
    var = collectives.all_reduce_model(torch.sum(torch.square(mine), -1, keepdim=True),
                                       tp) / a.shape[1]
    y = collectives.reduce_from_model((mine * torch.rsqrt(var)) @ w[tp.rank * k:
                                                                   (tp.rank + 1) * k], tp)
    return (y * d).sum()


def _both_ways(tp):
    a, w, d = (t.clone().requires_grad_(True) for t in _norm_inputs())
    loss = _norm_loss(a, w, d, tp)
    loss.backward()
    return {"loss": loss.detach(), "da": a.grad, "dw": w.grad}


def _watch(agg, fn_name, into):
    """Record each call's (input chunk, published chunk, counter, kwargs)."""
    real = getattr(agg, fn_name)

    def record(values, counter_base=0, **kw):
        out = real(values, counter_base, **kw)
        into.append((values.clone(), out.clone(), int(counter_base),
                     {k: v for k, v in kw.items() if k in ("alive", "rotate", "weights")}))
        return out
    setattr(agg, fn_name, record)


def _rank_grads(arch, ring, tp):
    """Learner ``ring.rank``'s gradient of every leaf of its shards on its
    step-0 tokens, and (MoE) each block's dispatch indices."""
    dispatch = []
    real = moe_mod._dispatch_indices

    def watched(*a, **kw):
        out = real(*a, **kw)
        dispatch.append(out[0].clone())
        return out
    moe_mod._dispatch_indices = watched
    try:
        model = _model(arch, tp=tp, ring=ring)
        loss, grads = _grads(model, torch.from_numpy(_stream(arch).global_batch(0)["tokens"]
                                                     [ring.rank]))
    finally:
        moe_mod._dispatch_indices = real
    return {"loss": loss, "grads": grads, "dispatch": dispatch}


def _rank_steps(arch, ring, tp):
    """Two train steps: losses, grad scales, each round's chunks, the ZeRO-1
    parts and the shards afterwards."""
    model = _model(arch, tp=tp, ring=ring)
    agg = make_aggregator("safe", N, device="cpu")
    rounds = []
    _watch(agg, "aggregate_rank", rounds)
    bundle = make_train_step(model, agg, ring, lr=LR)
    state = bundle.init_state_fn(model.tree())
    res = {"losses": [], "scales": [], "master": [], "padded_size": bundle.padded_size,
           "sec_size": bundle.sec_size, "master0": state["master"].clone()}
    for i, alive in enumerate(ALIVE):
        state, m = bundle.step_fn(state, torch.from_numpy(_stream(arch).global_batch(i)["tokens"]
                                                          [ring.rank]),
                                  counter=i * (bundle.padded_size + 2), alive=alive)
        res["losses"].append(float(m["loss"]))
        res["scales"].append(float(m["grad_scale"]))
        res["master"].append(state["master"].clone())
    res["params"] = [p.clone() for p in leaves(state["params"])]
    res["rounds"] = rounds
    return res


def _rank_fed(arch, ring, tp):
    model = _model(arch, train=False, tp=tp)
    agg = make_aggregator("safe", N, weighted=True, device="cpu")
    rounds = []
    _watch(agg, "aggregate_rank", rounds)
    bundle = make_federated_round(model, agg, ring, local_steps=FED_K, local_lr=LR,
                                  return_delta=True)
    toks, weights = _fed_inputs(arch)
    params, m = bundle.round_fn(model.tree(), torch.from_numpy(toks[ring.rank]),
                                weights=weights, counter=FED_COUNTER, alive=FED_ALIVE)
    return {"delta": m["avg_delta"], "loss": float(m["local_loss"]), "rounds": rounds,
            "params": [p.clone() for p in leaves(params)], "padded": bundle.padded_size}


def _rank(world):
    ring, tp = grid_worlds(world, M)
    out = {"ring": (ring.rank, ring.size), "model": (tp.rank, tp.size), "norm": _both_ways(tp)}
    for arch in ZOO:
        out[arch] = {"grads": _rank_grads(arch, ring, tp), "steps": _rank_steps(arch, ring, tp),
                     "fed": _rank_fed(arch, ring, tp)}
    return out


# ---- the one-card port, the reference and the launcher -----------------------------------

def _one_card(arch):
    """The one-card steps, FedAvg round and each learner's gradient."""
    model = _model(arch)
    agg = make_aggregator("safe", N, device="cpu")
    bundle = make_train_step(model, agg, lr=LR)
    init = tree_to_flat(model.tree()).clone()
    init_leaves = [p.detach().clone() for p in leaves(model.tree())]
    grads = [_grads(model, torch.from_numpy(_stream(arch).global_batch(0)["tokens"][l]))
             for l in range(N)]
    state = bundle.init_state_fn(model.tree())
    losses, scales = [], []
    for i, alive in enumerate(ALIVE):
        state, m = bundle.step_fn(state, torch.from_numpy(_stream(arch).global_batch(i)["tokens"]),
                                  counter=i * (bundle.padded_size + 2), alive=alive)
        losses.append(float(m["loss"]))
        scales.append(float(m["grad_scale"]))
    out = {"init": init, "init_leaves": init_leaves, "losses": losses, "scales": scales,
           "params": [p.detach().clone() for p in leaves(state["params"])], "grads": grads,
           "paths": leaf_paths(model.tree())}
    model = _model(arch, train=False)
    agg = make_aggregator("safe", N, weighted=True, device="cpu")
    fb = make_federated_round(model, agg, local_steps=FED_K, local_lr=LR, return_delta=True)
    toks, weights = _fed_inputs(arch)
    params, m = fb.round_fn(model.tree(), torch.from_numpy(toks), weights=weights,
                            counter=FED_COUNTER, alive=FED_ALIVE)
    out["fed"] = (m["avg_delta"], float(m["local_loss"]), tree_to_flat(params),
                  tree_to_flat(model.tree()))
    return out


LAUNCH = ["--arch", "zamba2-2.7b", "--smoke", "--seq-len", "32", "--learners", "2",
          "--aggregator", "bon", "--device", "cpu", "--ckpt-every", "1"]


def _launch(ckpt, steps, env):
    """The launcher on 2 learners x 2 model shards, CPU ranks under
    torch.distributed.run."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "4", "-m", "repro_torch.launch.train", *LAUNCH, "--model-shards", "2",
           "--steps", str(steps), "--ckpt-dir", str(ckpt)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


def _launches(tmp, env):
    """A: two uninterrupted steps (a checkpoint each); B: a resume of A's
    step-1 checkpoint to step 2; one: the one-process launcher restoring
    A's step-2 checkpoint (written by the model-sharded ranks) and taking
    step 3."""
    from repro_torch.launch.train import parse_args, run
    out = {"A": _launch(tmp / "A", 2, env)}
    shutil.copytree(tmp / "A" / "step_00000001", tmp / "B" / "step_00000001")
    out["B"] = _launch(tmp / "B", 2, env)
    shutil.copytree(tmp / "A" / "step_00000002", tmp / "C" / "step_00000002")
    threads = torch.get_num_threads()
    out["one"] = run(parse_args([*LAUNCH, "--steps", "3", "--ckpt-dir", str(tmp / "C")]))
    torch.set_num_threads(threads)
    return out


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads, here and in each rank: a CPU reduction's order
    follows the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The launcher, the one-card port and the 8 ranks side by side, then
    the reference."""
    tmp = tmp_path_factory.mktemp("dist_tp_zoo")
    for arch in ZOO:
        np.savez(tmp / f"{arch}.npz", **{k.replace(".", "/"): v.numpy() for k, v in
                                         _model(arch).state_dict().items()})
    code = ("import sys; sys.path.insert(0, %r)\n" % os.path.join(REPO, "tests")
            + REF_CODE.replace("@DIR@", str(tmp)))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    with ThreadPoolExecutor(2) as pool:
        launched = pool.submit(_launches, tmp, env)
        one = pool.submit(lambda: {arch: _one_card(arch) for arch in ZOO})
        ranks = [r["result"] for r in spawn(_rank, N * M, "cpu", threads=RANK_THREADS)]
        # the reference after the ranks, so the file never loads more cores
        # than the machine has
        assert "REF_OK" in _run_reference(code)
        out = {"launch": launched.result(), "one": one.result()}
    out.update(ranks=ranks, ref=dict(np.load(tmp / "ref.npz")), tmp=tmp)
    return out


def _run_reference(code):
    """``code`` in a child python with N·M host devices, XLA's CPU thread
    pool off (the devices still run side by side); its stdout."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N * M} "
                         "--xla_cpu_multi_thread_eigen=false")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _layouts(arch, ranks):
    """Each model rank's layout of the whole tree (the EP model's leaves
    for the train step: every learner's experts are joined along dim 1)."""
    tree = _model(arch).tree()
    dims = tree_dims(tree, _cfg(arch), M)
    return [shard_layout(shard_tree(tree, _cfg(arch), j, M), dims, j, M) for j in range(M)]


def _full_leaves(arch, ranks, key):
    """The full leaves from the ranks' shards ``ranks[r][arch][key]
    ["params"]``: each split leaf joined over a learner's model group, an
    expert leaf's learners then joined along dim 1."""
    layout = _layouts(arch, ranks)[0]
    paths = leaf_paths(_model(arch).tree())
    out = []
    for i, (path, sh) in enumerate(zip(paths, layout)):
        per_learner = []
        for l in range(N):
            shards = [ranks[l * M + j][arch][key]["params"][i] for j in range(M)]
            per_learner.append(sh.join(shards))
        expert = key == "steps" and _cfg(arch).ep_axis is not None and is_expert_path(path)
        out.append(torch.cat(per_learner, dim=1) if expert else per_learner[0])
    return out


def _grad_close(got, want):
    """Within GRAD_REL relative L2 of ``want``; exactly zero where it is
    (a norm scale no MLP reads)."""
    if not want.any():
        return not got.any()
    return _rel_l2(got, want) <= GRAD_REL


def _flat(leaf_list):
    return torch.cat([x.reshape(-1).float() for x in leaf_list])


# ---- (i) shards and the flat layout, in process -------------------------------------------

def _shard_cfg(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    return dataclasses.replace(cfg, n_heads=LLAMA4_HEADS) if arch == "llama4-maverick" else cfg


@pytest.mark.parametrize("arch", ZOO + ("llama4-maverick",))
@pytest.mark.parametrize("m", [2, 4])
def test_shards_and_layout_match_tree_to_flat(arch, m):
    """Rank j's model (its own generator draws) holds ``shard_tree`` of the
    one-card model; each shard's words of the full ``tree_to_flat`` are its
    values; a cut segment's words are on one rank, a replicated segment's
    (Mamba2's B and C columns) and a replicated leaf's on every rank; the
    segmented leaf joins back from the shards; ``convert.shard_model`` cuts
    the same shards from a state."""
    cfg = _shard_cfg(arch)
    check_tp(cfg, m)
    full = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    flat = tree_to_flat(full.tree())
    dims = tree_dims(full.tree(), cfg, m)
    seen = torch.zeros(flat.numel(), dtype=torch.int64)
    state = convert.model_params(cfg, _as_tree(full.tree()))
    shards = []
    for j in range(m):
        rank = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(1),
                     tp_world=World(rank=j, size=m, device=torch.device("cpu"),
                                    transport="gloo"))
        assert rank.tp_dims == dims
        got = leaves(rank.tree())
        for a, b in zip(got, leaves(shard_tree(full.tree(), cfg, j, m))):
            assert a.shape == b.shape and torch.equal(a.detach(), b.detach())
        layout = shard_layout(rank.tree(), dims, j, m)
        for sh, x in zip(layout, got):
            w = sh.words()
            assert torch.equal(flat[w], x.detach().reshape(-1).float())
            seen[w] += 1
        cut = convert.shard_model(cfg, state, j, m)
        for (path, x) in leaves_with_paths(rank.tree()):
            assert torch.equal(cut[path.replace("/", ".")], x.detach()), path
        shards.append((layout, got))
    # every word once, or on every rank where it is replicated
    rep = torch.zeros(flat.numel(), dtype=torch.bool)
    for sh in shards[0][0]:
        if sh.split is None:
            rep[sh.offset:sh.offset + sh.numel] = True
        else:
            kept = torch.zeros(sh.shape, dtype=torch.bool)
            off = 0
            for n, c in sh.split.segments:
                if not c:
                    kept.narrow(sh.split.dim, off, n).fill_(True)
                off += n
            rep[sh.offset:sh.offset + sh.numel] = kept.reshape(-1)
    assert bool((seen[rep] == m).all()) and bool((seen[~rep] == 1).all())
    segmented = [i for i, sp in enumerate(dims) if sp is not None and len(sp.segments) > 1]
    assert (len(segmented) > 0) == (arch == "zamba2-2.7b")
    for i in segmented:
        assert torch.equal(shards[0][0][i].join([s[1][i].detach() for s in shards]),
                           leaves(full.tree())[i].detach())


def _as_tree(tree):
    return {k: (_as_tree(v) if isinstance(v, dict) else
                [_as_tree(b) for b in v] if isinstance(v, list) else v.detach().numpy())
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ZOO + ("llama4-maverick",))
def test_full_configuration_splits_at_two(arch):
    """The full configurations build at m = 2 (meta tensors), each rank
    holding half the words of every cut leaf."""
    cfg = get_config(arch)
    check_tp(cfg, 2)
    full = Model(cfg, device="meta")
    half = Model(cfg, device="meta", tp_world=World(rank=1, size=2, device=torch.device("cpu"),
                                                    transport="gloo"))
    for x, y, sp in zip(leaves(full.tree()), leaves(half.tree()), half.tp_dims):
        if sp is None:
            assert x.shape == y.shape
        else:
            want = list(x.shape)
            want[sp.dim] = sp.size(2, 1)
            assert list(y.shape) == want


REFUSALS = {
    "llama4-smoke 5 q heads": ("llama4-maverick", {}),
    "zamba2 shared block 3 q heads": ("zamba2-2.7b", dict(n_heads=3, n_kv_heads=3)),
    "mamba2 heads": ("zamba2-2.7b", dict(ssm_heads=3)),
    "rwkv6 heads": ("rwkv6-1.6b", dict(rwkv_head_size=256)),
    "mlp d_ff": ("rwkv6-1.6b", dict(d_ff=767)),
    "expert_d_ff": ("llama4-maverick", dict(n_heads=LLAMA4_HEADS)),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_that_remain(case):
    """The splits ``check_tp`` refused until whole units split unevenly (a
    q head, a Mamba2 or RWKV6 head, an MLP's or an expert's ff column that
    m does not divide; the reference's GSPMD cuts or replicates them): none
    remains. Each builds at m = 2, the first rank holding the extra unit,
    and its shards cover every word of the one-card tree once (a
    replicated word on every rank)."""
    arch, kw = REFUSALS[case]
    m = 2
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)
    if case == "expert_d_ff":  # the shared expert's s·ff = 511 too
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, expert_d_ff=511))
    check_tp(cfg, m)
    full = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    flat = tree_to_flat(full.tree())
    dims = tree_dims(full.tree(), cfg, m)
    seen = torch.zeros(flat.numel(), dtype=torch.int64)
    uneven = 0
    for j in range(m):
        rank = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(1),
                     tp_world=World(rank=j, size=m, device=torch.device("cpu"),
                                    transport="gloo"))
        for sh, x in zip(shard_layout(rank.tree(), dims, j, m), leaves(rank.tree())):
            w = sh.words()
            assert torch.equal(flat[w], x.detach().reshape(-1).float())
            seen[w] += 1 if sh.split is not None else int(j == 0)
            if sh.split is not None and j == 0:
                uneven += sh.split.size(m, 0) != sh.split.size(m, m - 1)
    cut = torch.zeros(flat.numel(), dtype=torch.bool)  # Mamba2's B, C columns: every rank
    for sh in shard_layout(full.tree(), dims, 0, m):
        if sh.split is not None and len(sh.split.segments) > 1:
            kept = torch.ones(sh.shape, dtype=torch.bool)
            off = 0
            for n, c in sh.split.segments:
                if not c:
                    kept.narrow(sh.split.dim, off, n).fill_(False)
                off += n
            cut[sh.offset:sh.offset + sh.numel] = ~kept.reshape(-1)
    assert bool((seen[~cut] == 1).all()) and bool((seen[cut] == m).all())
    assert uneven > 0


def test_dry_run_sizes_rank_zero_of_the_grid():
    """The dry run's ``--per-rank --model-shards 2`` for zamba2: rank 0 of
    the 4 x 2 grid holds about half the parameters and optimizer state of
    one learner a rank's step."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    shape = dict(seq_len=S, global_batch=N * B, kind="train")
    cfg = _cfg("zamba2-2.7b")
    try:
        one = dryrun.measure(cfg, "train_4k", shape=shape, learners=N, batch=B, per_rank=True)
        tp = dryrun.measure(cfg, "train_4k", shape=shape, learners=N, batch=B, per_rank=True,
                            model_shards=M)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert tp["description"].startswith(f"train_step rank 0 of n={N} m={M}")
    for cat in ("parameters", "optimizer state"):
        assert tp["peak_by_category"][cat] < 0.6 * one["peak_by_category"][cat], cat
    assert tp["kernels"]["mask_add"]["calls"] >= 1


# ---- (ii) the both-ways all-reduce and the replicated leaves -------------------------------

def test_both_ways_all_reduce_matches_autograd(runs):
    """Mamba2's gated-norm pattern over the model group, against autograd
    of one process: each rank's gradient is its slice of the one-process
    gradient (the sum of squares' cotangent summed over the group)."""
    a, w, d = (t.clone().requires_grad_(True) for t in _norm_inputs())
    loss = _norm_loss(a, w, d, None)
    loss.backward()
    k = a.shape[1] // M
    for res in runs["ranks"]:
        got, j = res["norm"], res["model"][0]
        torch.testing.assert_close(got["loss"], loss.detach(), rtol=1e-6, atol=0)
        torch.testing.assert_close(got["da"][:, j * k:(j + 1) * k], a.grad[:, j * k:(j + 1) * k],
                                   rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(got["dw"][j * k:(j + 1) * k], w.grad[j * k:(j + 1) * k],
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("arch", ZOO)
def test_replicated_gradients_equal_across_the_group(runs, arch):
    """Every replicated leaf's gradient, and Mamba2's replicated B and C
    columns, is the same bits on each rank of a model group (``write_chunk``
    takes this rank's), and within GRAD_REL of one process's; the cut
    pieces are within it of the one-process gradient's."""
    one = runs["one"][arch]
    layouts = _layouts(arch, runs["ranks"])
    for r, res in enumerate(runs["ranks"]):
        l, j = divmod(r, M)
        got = res[arch]["grads"]
        want_loss, want = one["grads"][l]
        np.testing.assert_allclose(float(got["loss"]), float(want_loss), rtol=LOSS_RTOL)
        for i, (path, sh) in enumerate(zip(one["paths"], layouts[j])):
            g = got["grads"][i]
            if _cfg(arch).ep_axis is not None and is_expert_path(path):
                continue  # summed over every learner's tokens by the exchange
            other = runs["ranks"][l * M + (1 - j)][arch]["grads"]["grads"][i]
            if sh.split is None:
                assert torch.equal(g, other), (path, r)
                assert _grad_close(g, want[i]), (path, r)
                continue
            cut, rep = sh.split.pieces(g, j, M)
            other_rep = sh.split.pieces(other, 1 - j, M)[1]
            _, want_rep = sh.split.pieces(sh.cut(want[i]), j, M)
            for x, y, z in zip(rep, other_rep, want_rep):
                assert torch.equal(x, y), (path, r)
                assert _grad_close(x, z), (path, r)
            assert _grad_close(g, sh.cut(want[i])), (path, r)


def test_moe_dispatch_indices_equal_across_the_group(runs):
    """The router reads the replicated block input, so each model group's
    ranks route their learner's tokens to the same slots, bit for bit."""
    for l in range(N):
        group = [runs["ranks"][l * M + j][MOE]["grads"]["dispatch"] for j in range(M)]
        assert len(group[0]) == _cfg(MOE).n_units
        for other in group[1:]:
            for a, b in zip(group[0], other):
                assert torch.equal(a, b)


# ---- (iii) the chunks, ZeRO-1, the steps and the FedAvg round ------------------------------

def _check_chunks(ranks, arch, key, weighted):
    """Each round's published chunks == words of the one-card aggregate of
    the ranks' own input rows (a learner's row its model ranks' chunks
    joined), bit for bit."""
    n_rounds = len(ranks[0][arch][key]["rounds"])
    assert n_rounds == (len(ALIVE) if key == "steps" else 1)
    for i in range(n_rounds):
        rows = torch.stack([torch.cat([ranks[l * M + j][arch][key]["rounds"][i][0]
                                       for j in range(M)]) for l in range(N)])
        _, _, counter, kw = ranks[0][arch][key]["rounds"][i]
        agg = make_aggregator("safe", N, weighted=weighted, device="cpu")
        want = agg.aggregate(rows, counter, alive=kw["alive"], rotate=kw.get("rotate", 0),
                             weights=None if not weighted else torch.as_tensor(
                                 _fed_inputs(arch)[1]))
        L = rows.shape[1] // M
        for r, res in enumerate(ranks):
            j = r % M
            np.testing.assert_array_equal(res[arch][key]["rounds"][i][1].numpy(),
                                          want[j * L:(j + 1) * L].numpy())


@pytest.mark.parametrize("arch", ZOO)
def test_tp_zoo_chunks_are_the_one_card_rounds_words(runs, arch):
    _check_chunks(runs["ranks"], arch, "steps", False)
    _check_chunks(runs["ranks"], arch, "fed", True)


@pytest.mark.parametrize("arch", ZOO)
def test_tp_zoo_zero1_is_flat_adamw_on_the_published_mean(runs, arch):
    """ZeRO-1 over all n·m ranks: rank (l, j) holds part l of chunk j, and
    after each step it is, word for word, the one-card ``FlatAdamW`` update
    of the whole master vector (the SAFE partition's words) by the
    published mean."""
    ranks = runs["ranks"]
    P = ranks[0][arch]["steps"]["padded_size"]
    part = P // (N * M)

    def joined(key, step=None):
        out = torch.empty(P)
        for r, res in enumerate(ranks):
            l, j = divmod(r, M)
            x = res[arch]["steps"][key] if step is None else res[arch]["steps"][key][step]
            out[j * (P // M) + l * part:j * (P // M) + (l + 1) * part] = x
        return out

    one = runs["one"][arch]
    sec = [x for x, p in zip(one["init_leaves"], one["paths"]) if not is_expert_path(p)]
    want0 = torch.zeros(P)
    want0[:ranks[0][arch]["steps"]["sec_size"]] = _flat(sec)
    master = joined("master0")
    assert torch.equal(master, want0)
    opt, state = FlatAdamW(lr=LR, weight_decay=0.1), AdamState(0, torch.zeros(P), torch.zeros(P))
    for step in range(len(ALIVE)):
        mean = torch.cat([ranks[j][arch]["steps"]["rounds"][step][1] for j in range(M)])
        master, state = opt.update(mean, state, master)
        assert torch.equal(joined("master", step), master), step


@pytest.mark.parametrize("arch", ZOO)
def test_tp_zoo_step_agrees_with_one_card(runs, arch):
    """The TP step's losses and grad scales against the one-card port's
    within the f32 bounds (rwkv6's second grad scale within its measured
    bound), the same on every rank; the parameters' change within
    REL_PARAMS (qwen3-moe: each leaf's within MOE_REL)."""
    one = runs["one"][arch]
    for res in runs["ranks"]:
        np.testing.assert_allclose(res[arch]["steps"]["losses"], one["losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(res[arch]["steps"]["scales"], one["scales"],
                                   rtol=SCALE_RTOL_OF.get(arch, SCALE_RTOL))
    got = _full_leaves(arch, runs["ranks"], "steps")
    if arch == MOE:
        for p, x, y, z in zip(one["paths"], got, one["params"], one["init_leaves"]):
            assert _rel_l2(x - z, y - z) <= MOE_REL, p
    else:
        start = one["init"].numpy()
        assert _rel_l2(_flat(got).numpy() - start, _flat(one["params"]).numpy() - start) \
            <= REL_PARAMS


@pytest.mark.parametrize("arch", ZOO)
def test_tp_zoo_step_agrees_with_reference(runs, arch):
    """Against the reference's step on a (4, 2) Auto mesh with
    ``chain_model_sharded``, from the same weights and tokens: the losses
    and grad scales, the SAFE partition's change within REL_PARAMS and the
    experts' within MOE_REL."""
    ref, one = runs["ref"], runs["one"][arch]
    got = _full_leaves(arch, runs["ranks"], "steps")
    for res in runs["ranks"]:
        np.testing.assert_allclose(res[arch]["steps"]["losses"], ref[arch + "/loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(res[arch]["steps"]["scales"], ref[arch + "/grad_scale"],
                                   rtol=SCALE_RTOL_OF.get(arch, SCALE_RTOL))
    want = torch.from_numpy(ref[arch + "/params"])
    expert = [is_expert_path(p) for p in one["paths"]]
    for part, bound in ((False, REL_PARAMS), (True, MOE_REL)):
        keep = [i for i, e in enumerate(expert) if e == part]
        if not keep:
            continue
        offs = np.cumsum([0] + [x.numel() for x in one["init_leaves"]])
        start = _flat([one["init_leaves"][i] for i in keep]).numpy()
        w = torch.cat([want[offs[i]:offs[i + 1]] for i in keep]).numpy()
        assert _rel_l2(_flat([got[i] for i in keep]).numpy() - start, w - start) <= bound


@pytest.mark.parametrize("arch", ZOO)
def test_tp_zoo_fedavg_round_agrees_with_one_card(runs, arch):
    delta, loss, params, start = runs["one"][arch]["fed"]
    got = _flat(_full_leaves(arch, runs["ranks"], "fed")).numpy()
    for res in runs["ranks"]:
        assert res[arch]["fed"]["padded"] % (2 * N * M) == 0
        np.testing.assert_allclose(res[arch]["fed"]["loss"], loss, rtol=LOSS_RTOL)
        assert _rel_l2(res[arch]["fed"]["delta"][:delta.numel()], delta) <= REL_PARAMS
    assert _rel_l2(got - start.numpy(), params.numpy() - start.numpy()) <= REL_PARAMS


# ---- (iv) the launcher ---------------------------------------------------------------------

def test_launcher_zamba2_checkpoints_restore_across_model_shards(runs):
    """zamba2-smoke at 2 learners x 2 model shards (BON): the resumed step-2
    checkpoint is the uninterrupted run's word for word, and the one-process
    launcher restores it (the segmented in_proj joined from its shards) and
    takes step 3."""
    from repro_torch.ckpt import latest_step, restore_checkpoint
    launch, tmp = runs["launch"], runs["tmp"]
    assert "learner 1 of 2 (WORLD_SIZE 4 / 2 model shards), model shard 1 of 2" in launch["A"]
    assert "resumed from step 1" in launch["B"]
    assert latest_step(str(tmp / "C")) == 3
    one = launch["one"]
    assert len(one["losses"]) == 1 and np.isfinite(one["losses"][0])
    skeleton = one["state"]
    a, extra_a = restore_checkpoint(str(tmp / "A"), 2, skeleton)
    b, extra_b = restore_checkpoint(str(tmp / "B"), 2, skeleton)
    assert extra_a == extra_b
    for x, y in zip(leaves(a), leaves(b)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y
    c, _ = restore_checkpoint(str(tmp / "C"), 3, skeleton)
    assert c["step"] == 3 and c["master"].shape == skeleton["master"].shape
