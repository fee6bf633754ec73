"""Whole-unit uneven splits over the 'model' axis: heads and ff columns that
the model ranks do not divide.

Over m ranks a leaf's u units (heads, ff columns) split whole: the first
u mod m ranks hold ⌈u/m⌉, the rest ⌊u/m⌋, which may be none
(``models/sharding.py::unit_share``). kv heads split only where m divides
them and are otherwise on every rank, each q head q reading kv head
q·n_kv/n_heads. The reference's GSPMD instead cuts a head where the
columns divide (``sanitize_spec`` looks only at the column count) and
reshards around the cut.

In process: ``Split``'s cut, join, pad and words over (units, m),
zero-unit ranks included; ``check_tp`` for every q head count at every m;
each rank's model against the one-card tree's shards and flat layout.

One ``spawn`` of 12 gloo ranks at one intra-op thread (3 learners x 4
model shards: SAFE's ring needs 3 learners) runs six smoke layouts in
f32. Three of qwen3-14b: 14 q heads and 2 kv heads (4, 4, 3, 3 q heads a
rank; rank 1's q heads 4-7 read kv heads 0 and 1), 6 q heads and 3 kv
heads with an MLP of 766 columns (m neither divides nor is divided by
n_kv), and 3 q heads over 4 ranks (rank 3 holds none). And the other
split units: zamba2 with 3 Mamba2 heads (rank 3 holds none, only the
replicated B and C columns, and its gated norm still divides by the full
192 channels), rwkv6 at d_model 160 (5 heads of 32: 2, 1, 1, 1), and
llama4 with 3 experts and expert and shared-expert ff of 511 columns
(128, 128, 128, 127) beside its 5 q heads (2, 1, 1, 1), its train step's
experts by expert parallelism over the 3 learners (the step needs it;
FedAvg and serving carry every expert). Each: two SAFE steps
(learner 1 dead in the second), a weighted FedAvg round, and prefill and
decode over ('data', 'model') = (3, 4), one row a data rank; the first
layout's state is gathered into a one-process checkpoint. This process
runs the one-card port on the same inputs; beside the ranks a reference
subprocess with 12 host devices runs its ``make_train_step`` on a (3, 4)
Auto mesh, whose GSPMD cuts the heads.

The bar: every chunk's published words equal the one-card round of the
ranks' rows bit for bit; every ZeRO-1 part is ``FlatAdamW`` on the
published means word for word; losses, grad scales and the parameters'
change within ``tests/test_torch_dist_tp.py``'s f32 bounds of the one-card
step and of the reference's (llama4's experts, and rwkv6's second grad
scale, within ``tests/test_torch_dist_tp_zoo.py``'s bounds for them);
FedAvg within them of the one-card round; serving within 2e-4 of max
|logit| of one process; the checkpoint saved at m = 4 restores at m = 2,
at m = 3 and on one card.
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
from repro_torch.dist import World, grid, spawn
from repro_torch.models import Model
from repro_torch.models.sharding import (Split, check_tp, shard_tree, tp_dim, tree_dims,
                                         unit_share)
from repro_torch.optim.adamw import AdamState, FlatAdamW
from repro_torch.serve.engine import make_serve_step
from repro_torch.train import make_federated_round, make_train_step, tree_to_flat
from repro_torch.train.flatten import (LeafShard, is_expert_path, leaves, leaves_with_paths,
                                       partition_tree, shard_layout)
from repro_torch.train.train_step import tp_padded_size

N, M, B, S, LR, THREADS = 3, 4, 2, 32, 1e-3, 1
ALIVE = ([1, 1, 1], [1, 0, 1])        # step i's alive bitmap
FED_K, FED_ALIVE, FED_COUNTER = 2, [1, 1, 0], 4321
# f32 bounds of tests/test_torch_dist_tp.py: losses 1e-6, grad_scale 1e-5
# relative, the parameters' change 5e-3 relative L2; for the experts of a
# MoE's step, which expert parallelism sums in another order than one
# card, tests/test_torch_dist_tp_zoo.py's 5e-4 relative L2 on each leaf's
# change
LOSS_RTOL, SCALE_RTOL, REL_PARAMS, MOE_REL = 1e-6, 1e-5, 5e-3, 5e-4
# serving: prompts of S0 tokens into caches of MAX slots, STEPS decode steps
S0, MAX, STEPS, SERVE_TOL = 12, 20, 4, 2e-4
# name: (smoke configuration, overrides, MoE overrides)
LAYOUTS = {
    "14q-2kv": ("qwen3-14b", dict(n_heads=14, n_kv_heads=2, head_dim=16), {}),
    "6q-3kv-ff766": ("qwen3-14b", dict(n_heads=6, n_kv_heads=3, head_dim=16, d_ff=766), {}),
    "3q-1kv": ("qwen3-14b", dict(n_heads=3, n_kv_heads=1, head_dim=16), {}),
    "zamba2-3ssm": ("zamba2-2.7b", dict(ssm_heads=3), {}),
    "rwkv6-5h": ("rwkv6-1.6b", dict(d_model=160), {}),
    "llama4-ff511": ("llama4-maverick-400b-a17b", {}, dict(expert_d_ff=511, num_experts=3)),
}
# rwkv6's grad_scale at the second step: tests/test_torch_dist_tp_zoo.py's
# bound for it (a gradient near zero whose sign the row-parallel sums flip
# moves its word the other way in the first AdamW step, and the decay
# carries that into the next gradient's norm). How far that goes depends on
# the width: weights moved by 1e-7 relative noise move the one-card step's
# second grad_scale by 3.1e-5 relative at d_model 160 (5 heads), 6.2e-5 at
# 224, 7.6e-4 at 256 and 2e-3 at 192 (measured, f32, the CPU); d_model 160
# keeps the bound a test of the split rather than of that noise
SCALE_RTOL_OF = {"rwkv6-5h": 2.5e-4}
# the uneven unit of each layout: (leaf, its split dim, units, words a unit)
UNITS = {
    "14q-2kv": ("blocks/0/attn/wq", -1, 14, 16),
    "6q-3kv-ff766": ("blocks/0/mlp/wi", -1, 766, 1),
    "3q-1kv": ("blocks/0/attn/wq", -1, 3, 16),
    "zamba2-3ssm": ("blocks/0/mamba/out_proj", -2, 3, 64),
    "rwkv6-5h": ("blocks/0/rwkv/wr", -1, 5, 32),
    "llama4-ff511": ("blocks/0/moe/wi", -1, 511, 1),
}
CKPT_LAYOUT, CKPT_STEP = "14q-2kv", 2

REF_CODE = """
import repro  # the package's jax shims first
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.core import make_aggregator
from repro.models import Model
from repro.train.flatten import tree_to_flat
from repro.train.train_step import make_train_step
import dataclasses
import test_torch_dist_heads as t

mesh = jax.make_mesh((t.N, t.M), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {}
for name in t.LAYOUTS:
    init = dict(np.load("@DIR@/init_%s.npz" % name))
    tree = {}
    for key, a in init.items():
        node, parts = tree, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(a)
    tree["blocks"] = [tree["blocks"][str(i)] for i in range(len(tree["blocks"]))]
    cfg = t.layout_config(name, get_smoke_config, train=True)
    b = make_train_step(Model(cfg), make_aggregator("safe", t.N, axis="data"), mesh, lr=t.LR,
                        chain_model_sharded=True)
    s = b.init_state_fn(tree)
    losses, scales = [], []
    for i, alive in enumerate(t.ALIVE):
        s, m = b.step_fn(s, jnp.asarray(t._tokens(name, i)), counter=i * (b.padded_size + 2),
                         alive=jnp.asarray(alive, jnp.float32))
        losses.append(float(m["loss"]))
        scales.append(float(m["grad_scale"]))
    out[name + "/loss"] = np.asarray(losses)
    out[name + "/grad_scale"] = np.asarray(scales)
    out[name + "/params"] = np.asarray(tree_to_flat(s["params"]))
np.savez("@DIR@/ref.npz", **out)
print("REF_OK")
"""


def layout_config(name, smoke_config, train=False):
    """Layout ``name``'s f32 configuration from ``smoke_config`` (the
    port's ``get_smoke_config`` or the reference's); for a MoE's train
    step (``train``) its experts by expert parallelism over the N
    learners, which the step needs (FedAvg and serving carry every
    expert)."""
    arch, kw, moe_kw = LAYOUTS[name]
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32", **kw)
    if moe_kw:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
        if train:
            cfg = dataclasses.replace(cfg, ep_axis="data", ep_ranks=N)
    return cfg


def _cfg(name, train=False):
    return layout_config(name, get_smoke_config, train)


def _init_state(name):
    return {k: v.detach().clone() for k, v in
            Model(_cfg(name), device="cpu", generator=torch.Generator().manual_seed(0))
            .state_dict().items()}


def _model(name, init, tp=None, ring=None, train=False):
    """The model holding ``init`` (the full weights), or model rank j's
    shards of them (``tp`` its model group); for a MoE's train step
    (``train``) with learner ``ring.rank``'s experts."""
    cfg = _cfg(name, train)
    ep = ring if cfg.ep_axis is not None else None
    model = Model(cfg, device="cpu", tp_world=tp, ep_world=ep)
    state = init if tp is None else convert.shard_model(cfg, init, tp.rank, tp.size)
    model.load_state_dict(state if ep is None else
                          convert.shard_experts(state, ep.rank, ep.size))
    return model


def _tokens(name, step):
    return make_federated_batches(_cfg(name), N, B, S, seed=0).global_batch(step)["tokens"]


def _fed_inputs(name):
    stream = make_federated_batches(_cfg(name), N, B, S, seed=1)
    toks = np.stack([np.stack([stream.learner_batch(l, k)["tokens"] for k in range(FED_K)])
                     for l in range(N)])
    return toks, np.asarray([3.0, 1.0, 2.0], np.float32)


def _prompts(name):
    """One row a data rank: [N, S0 + STEPS] tokens."""
    return np.random.RandomState(7).randint(0, _cfg(name).vocab,
                                            (N, S0 + STEPS)).astype(np.int32)


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


def _serve(model, rows, mesh=None):
    """Prefill of ``rows``' first S0 tokens, then STEPS teacher-forced
    decode steps: the logits [STEPS + 1, rows, V]."""
    with torch.inference_mode():
        cache = model.init_cache(rows.shape[0], MAX, prefilled=False)
        logits, cache = model.prefill(model.tree(), torch.from_numpy(rows[:, :S0]), cache=cache)
        out = [logits.clone()]
        step = make_serve_step(model, mesh)
        for i in range(STEPS):
            logits, cache = step(model.tree(), torch.from_numpy(rows[:, S0 + i]), cache)
            out.append(logits.clone())
    return torch.stack(out)


# ---- the ranks ---------------------------------------------------------------------------

def _layout_rank(world, g, name, init, ckpt_dir):
    import torch.distributed as dist

    from repro_torch.ckpt import save_checkpoint
    from repro_torch.ckpt.checkpoint import gather_tp_state
    l = g.data.rank
    model = _model(name, init, g.model, g.data, train=True)
    agg, seen = _recording(make_aggregator("safe", N, device="cpu"))
    bundle = make_train_step(model, agg, g, lr=LR)
    state = bundle.init_state_fn(model.tree())
    steps = {"losses": [], "scales": [], "master": [], "master0": state["master"].clone(),
             "padded": bundle.padded_size, "sec_size": bundle.sec_size}
    for i, alive in enumerate(ALIVE):
        state, m = bundle.step_fn(state, torch.from_numpy(_tokens(name, i)[l]),
                                  counter=i * (bundle.padded_size + 2), alive=alive)
        steps["losses"].append(float(m["loss"]))
        steps["scales"].append(float(m["grad_scale"]))
        steps["master"].append(state["master"].clone())
    steps["params"] = [p.clone() for p in leaves(state["params"])]
    steps["rounds"] = list(seen)
    if name == CKPT_LAYOUT:
        full = gather_tp_state(state, model.shard_layout(), bundle.sec_size, g.data, g.model,
                               world)
        if world.rank == 0:
            save_checkpoint(ckpt_dir, CKPT_STEP, full)
        dist.barrier()

    model = _model(name, init, g.model)
    agg, seen = _recording(make_aggregator("safe", N, weighted=True, device="cpu"))
    fed = make_federated_round(model, agg, g, local_steps=FED_K, local_lr=LR,
                               return_delta=True)
    toks, weights = _fed_inputs(name)
    params, m = fed.round_fn(model.tree(), torch.from_numpy(toks[l]), weights=weights,
                             counter=FED_COUNTER, alive=FED_ALIVE)
    fed_out = {"delta": m["avg_delta"], "loss": float(m["local_loss"]),
               "params": [p.clone() for p in leaves(params)], "rounds": list(seen),
               "padded": fed.padded_size}
    serve = _serve(_model(name, init, g.model), _prompts(name)[l:l + 1], g)
    return {"steps": steps, "fed": fed_out, "serve": serve,
            "shapes": [tuple(x.shape) for x in leaves(model.tree())]}


def _rank(world, inits, ckpt_dir):
    g = grid(world, M)
    out = {"pos": (g.data.rank, g.model.rank)}
    for name in LAYOUTS:
        out[name] = _layout_rank(world, g, name, inits[name], ckpt_dir)
    return out


# ---- the one-card port and the reference -------------------------------------------------

def _one_card(name, init):
    model = _model(name, init, train=True)
    agg = make_aggregator("safe", N, device="cpu")
    bundle = make_train_step(model, agg, lr=LR)
    state = bundle.init_state_fn(model.tree())
    losses, scales = [], []
    for i, alive in enumerate(ALIVE):
        state, m = bundle.step_fn(state, torch.from_numpy(_tokens(name, i)),
                                  counter=i * (bundle.padded_size + 2), alive=alive)
        losses.append(float(m["loss"]))
        scales.append(float(m["grad_scale"]))
    model = _model(name, init)
    fed = make_federated_round(model, make_aggregator("safe", N, weighted=True, device="cpu"),
                               local_steps=FED_K, local_lr=LR, return_delta=True)
    toks, weights = _fed_inputs(name)
    fparams, fm = fed.round_fn(model.tree(), torch.from_numpy(toks), weights=weights,
                               counter=FED_COUNTER, alive=FED_ALIVE)
    return {"losses": losses, "scales": scales, "params": leaves(state["params"]),
            "state": state, "fed_delta": fm["avg_delta"], "fed_loss": float(fm["local_loss"]),
            "fed_params": tree_to_flat(fparams),
            "serve": _serve(_model(name, init), _prompts(name))}


def _run_reference(tmp):
    code = ("import sys; sys.path.insert(0, %r)\n" % os.path.join(REPO, "tests")
            + REF_CODE.replace("@DIR@", str(tmp)))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N * M} "
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
    """The reference beside the 12 ranks, then the one-card port."""
    tmp = tmp_path_factory.mktemp("dist_heads")
    inits = {name: _init_state(name) for name in LAYOUTS}
    for name, init in inits.items():
        np.savez(tmp / f"init_{name}.npz",
                 **{k.replace(".", "/"): v.numpy() for k, v in init.items()})
    ckpt = tmp / "ckpt"
    with ThreadPoolExecutor(1) as pool:
        ref_run = pool.submit(_run_reference, tmp)
        ranks = [r["result"] for r in spawn(_rank, N * M, "cpu", args=(inits, str(ckpt)),
                                            threads=THREADS)]
        one = {name: _one_card(name, inits[name]) for name in LAYOUTS}
        assert "REF_OK" in ref_run.result()
    return {"ranks": ranks, "one": one, "inits": inits, "ckpt": str(ckpt),
            "ref": dict(np.load(tmp / "ref.npz"))}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _full_leaves(name, ranks, part):
    """The full leaves from the ranks' shards of ``part`` ("steps" or
    "fed"): each split leaf joined over learner 0's model group; an expert
    leaf of a MoE's step, which holds a learner's experts, joined over each
    learner's group and then along dim 1."""
    cfg = _cfg(name, train=part == "steps")
    tree = Model(cfg, device="cpu").tree()
    out = []
    for i, ((path, _), sp) in enumerate(zip(leaves_with_paths(tree), tree_dims(tree, cfg, M))):
        per = []
        for l in range(N):
            shards = [ranks[l * M + j][name][part]["params"][i] for j in range(M)]
            per.append(shards[0] if sp is None else sp.join(shards))
        out.append(torch.cat(per, 1) if cfg.ep_axis and is_expert_path(path) else per[0])
    return out


def _flat(leaf_list):
    return torch.cat([x.reshape(-1).float() for x in leaf_list])


def _check_change(name, got, want, start):
    """The change ``got - start`` within REL_PARAMS relative L2 of ``want -
    start`` over the SAFE partition's leaves, and each expert leaf of a
    MoE's step within MOE_REL (leaf lists in the flat order)."""
    expert = [is_expert_path(p) for p, _ in
              leaves_with_paths(Model(_cfg(name, train=True), device="cpu").tree())]
    keep = [i for i, e in enumerate(expert) if not e]
    g, w, s0 = (_flat([x[i] for i in keep]).numpy() for x in (got, want, start))
    assert _rel_l2(g - s0, w - s0) <= REL_PARAMS
    for i in (i for i, e in enumerate(expert) if e):
        assert _rel_l2(got[i] - start[i], want[i] - start[i]) <= MOE_REL, i


# ---- (i) the split, in process ------------------------------------------------------------

SPLITS = [(14, 64, 4), (14, 1, 16), (5, 1, 16), (40, 128, 16), (3, 16, 4), (1, 2, 2),
          (16, 1, 4), (767, 1, 2), (7, 3, 3), (2, 4, 5)]


@pytest.mark.parametrize("units,width,m", SPLITS)
def test_split_cuts_and_joins_whole_units(units, width, m):
    """``Split.whole`` of ``units`` units ``width`` words wide over m ranks:
    the first units mod m ranks hold one unit more, every shard is whole
    units (none on a rank past the units), the shards' words cover the
    leaf's once, they join back to it, and ``pad``/``trim`` round-trip the
    unequal shapes a gather needs."""
    full = torch.arange(2 * units * width * 3, dtype=torch.float32).view(2, units * width, 3)
    sp = Split.whole(1, units * width, width)
    q, r = divmod(units, m)
    counts = [unit_share(units, m, j)[1] - unit_share(units, m, j)[0] for j in range(m)]
    assert counts == [q + (j < r) for j in range(m)]
    shards = [sp.cut(full, j, m) for j in range(m)]
    assert [s.shape[1] for s in shards] == [c * width for c in counts]
    assert torch.equal(sp.join(shards), full)
    padded = [sp.pad(s, m) for s in shards]
    assert len({tuple(p.shape) for p in padded}) == 1
    assert all(torch.equal(a, b) for a, b in zip(sp.trim(padded), shards))
    seen = torch.zeros(full.numel(), dtype=torch.int64)
    for j in range(m):
        sh = LeafShard(0, tuple(full.shape), sp, j, m)
        w = sh.words()
        assert w.numel() == sh.shard_numel() == shards[j].numel()
        assert torch.equal(full.reshape(-1)[w], shards[j].reshape(-1))
        seen[w] += 1
        cut, rep = sp.pieces(shards[j], j, m)
        assert rep == [] and torch.equal(cut[0], shards[j])
    assert bool((seen == 1).all())


@pytest.mark.parametrize("m", [3, 4, 5])
def test_segmented_split_keeps_replicated_segments_whole(m):
    """Mamba2's packed [z | x | B | C | dt] with 5 heads: z, x and dt cut by
    head (64, 64 and 1 words a head), B and C whole on every rank; the
    shards join back and ``pieces`` parts a rank's shard by segment."""
    H, N_ = 5, 3
    segs = ((H * 64, True), (H * 64, True), (N_, False), (N_, False), (H, True))
    sp = Split(1, segs, (64, 64, 1, 1, 1))
    width = sum(n for n, _ in segs)
    full = torch.randn(2, width, generator=torch.Generator().manual_seed(0))
    shards = [sp.cut(full, j, m) for j in range(m)]
    for j, s in enumerate(shards):
        h0, h1 = unit_share(H, m, j)
        assert s.shape[1] == (h1 - h0) * 129 + 2 * N_
        cut, rep = sp.pieces(s, j, m)
        assert [c.shape[1] for c in cut] == [(h1 - h0) * 64, (h1 - h0) * 64, h1 - h0]
        assert torch.equal(torch.cat(rep, 1), full[:, 2 * H * 64:2 * H * 64 + 2 * N_])
    assert torch.equal(sp.join(shards, rank=m - 1), full)


@pytest.mark.parametrize("m", [2, 3, 4, 5, 8, 16])
def test_check_tp_refuses_no_q_head_count(m):
    """Every q head count from 1 to 48 builds at m model ranks: ``check_tp``
    passes, and wq's shares are whole heads that add up to the heads."""
    base = _cfg("14q-2kv")
    for nh in range(1, 49):
        cfg = dataclasses.replace(base, n_heads=nh, n_kv_heads=1)
        check_tp(cfg, m)
        sp = tp_dim("blocks/0/attn/wq", torch.empty(0, 256, nh * 16), cfg, m)
        sizes = [sp.size(m, j) for j in range(m)]
        assert sum(sizes) == nh * 16 and all(s % 16 == 0 for s in sizes)
        assert max(sizes) - min(sizes) <= 16


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_shards_and_layout_match_tree_to_flat(name):
    """Rank j's model (its own generator draws) holds ``shard_tree`` of the
    one-card model at m = 4; the shards' words of the full ``tree_to_flat``
    are their values and cover every word once, a replicated leaf's and a
    replicated segment's (Mamba2's B and C columns) on every rank; the
    units (heads, ff columns) of the layout's uneven leaf that a rank holds
    are its ``unit_share``."""
    cfg = _cfg(name)
    full = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    flat = tree_to_flat(full.tree())
    dims = tree_dims(full.tree(), cfg, M)
    seen = torch.zeros(flat.numel(), dtype=torch.int64)
    for j in range(M):
        rank = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(1),
                     tp_world=World(rank=j, size=M, device=torch.device("cpu"),
                                    transport="gloo"))
        assert rank.tp_dims == dims
        got = leaves(rank.tree())
        for a, b in zip(got, leaves(shard_tree(full.tree(), cfg, j, M))):
            assert a.shape == b.shape and torch.equal(a.detach(), b.detach())
        for sh, x in zip(shard_layout(rank.tree(), dims, j, M), got):
            w = sh.words()
            assert torch.equal(flat[w], x.detach().reshape(-1).float())
            seen[w] += 1
        path, dim, units, width = UNITS[name]
        h0, h1 = unit_share(units, M, j)
        assert dict(leaves_with_paths(rank.tree()))[path].shape[dim] == (h1 - h0) * width
    rep = torch.zeros(flat.numel(), dtype=torch.bool)  # the words on every rank
    for sh in shard_layout(rank.tree(), dims, M - 1, M):
        kept = torch.full(sh.shape, sh.split is None)
        off = 0
        for n, c in (sh.split.segments if sh.split is not None else ()):
            kept.narrow(sh.split.dim, off, n).fill_(not c)
            off += n
        rep[sh.offset:sh.offset + sh.numel] = kept.reshape(-1)
    assert bool((seen[rep] == M).all()) and bool((seen[~rep] == 1).all())


# ---- (ii) the ranks against the one-card port and the reference ---------------------------

@pytest.mark.parametrize("name", list(LAYOUTS))
def test_every_chunk_is_the_one_card_round(runs, name):
    """Each ring's published words, of both steps and the FedAvg round,
    equal the one-card aggregator's round of the same rows' chunk at the
    counter base moved by j·L/2, bit for bit; every rank of a chunk
    publishes the same words; every rank's leaves had its share's shapes."""
    ranks = runs["ranks"]
    _, weights = _fed_inputs(name)
    for part in ("steps", "fed"):
        res0 = ranks[0][name][part]
        counters = ([i * (res0["padded"] + 2) for i in range(len(ALIVE))]
                    if part == "steps" else [FED_COUNTER])
        for i, counter in enumerate(counters):
            alive = ALIVE[i] if part == "steps" else FED_ALIVE
            for j in range(M):
                given = torch.stack([ranks[l * M + j][name][part]["rounds"][i][0]
                                     for l in range(N)])
                L = given.shape[-1]
                agg = make_aggregator("safe", N, weighted=part == "fed", device="cpu")
                kw = dict(weights=weights) if part == "fed" else {}
                rotate = 0 if part == "fed" else counter % (2 * N + 1)
                want = agg.aggregate(given, (counter + j * L // 2) & 0xFFFFFFFF, alive=alive,
                                     rotate=rotate, **kw)
                for l in range(N):
                    got = ranks[l * M + j][name][part]["rounds"][i][1]
                    np.testing.assert_array_equal(got.numpy(), want.numpy())
    full = _model(name, runs["inits"][name]).tree()
    for r, res in enumerate(ranks):
        assert res[name]["shapes"] == [tuple(x.shape) for x in
                                       leaves(shard_tree(full, _cfg(name), r % M, M))]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_zero1_parts_are_flat_adamw_on_the_published_mean(runs, name):
    """Rank (l, j) holds part l of chunk j; after each step it is, word for
    word, the one-card ``FlatAdamW`` update of the whole master vector by
    the published mean (the model ranks' chunks joined), from the master
    vector of the one-card tree."""
    ranks = runs["ranks"]
    P = ranks[0][name]["steps"]["padded"]
    L, part = P // M, P // (N * M)
    tree = _model(name, runs["inits"][name], train=True).tree()
    flat = tree_to_flat(partition_tree(tree, lambda p: not is_expert_path(p))[0])
    assert P == tp_padded_size(flat.numel(), N, M)

    def joined(key, step=None):
        out = torch.empty(P)
        for l in range(N):
            for j in range(M):
                res = ranks[l * M + j][name]["steps"]
                x = res[key] if step is None else res[key][step]
                out[j * L + l * part:j * L + (l + 1) * part] = x
        return out

    master = joined("master0")
    assert torch.equal(master[:flat.numel()], flat) and not master[flat.numel():].any()
    opt, state = FlatAdamW(lr=LR, weight_decay=0.1), AdamState(0, torch.zeros(P), torch.zeros(P))
    for step in range(len(ALIVE)):
        mean = torch.cat([ranks[j][name]["steps"]["rounds"][step][1] for j in range(M)])
        master, state = opt.update(mean, state, master)
        assert torch.equal(joined("master", step), master), step


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_step_agrees_with_one_card_and_reference(runs, name):
    """Losses, grad scales and the parameters' change of the uneven step
    against the one-card step and the reference's (3, 4) Auto-mesh step
    (GSPMD cutting the heads), within the f32 bounds; every learner holds
    the same shards."""
    one, init = runs["one"][name], runs["inits"][name]
    scale_rtol = SCALE_RTOL_OF.get(name, SCALE_RTOL)
    ref = {k: runs["ref"][f"{name}/{k}"] for k in ("loss", "grad_scale", "params")}
    start = [x.detach() for x in leaves(_model(name, init, train=True).tree())]
    got = _full_leaves(name, runs["ranks"], "steps")
    offs = np.cumsum([0] + [x.numel() for x in start])
    ref_leaves = [torch.from_numpy(ref["params"][offs[i]:offs[i + 1]]).view(x.shape)
                  for i, x in enumerate(start)]
    expert = [is_expert_path(p) for p, _ in
              leaves_with_paths(Model(_cfg(name, train=True), device="cpu").tree())]
    for r, res in enumerate(runs["ranks"]):
        st = res[name]["steps"]
        np.testing.assert_allclose(st["losses"], one["losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(st["scales"], one["scales"], rtol=scale_rtol)
        np.testing.assert_allclose(st["losses"], ref["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(st["scales"], ref["grad_scale"], rtol=scale_rtol)
        for a, b, e in zip(st["params"], runs["ranks"][r % M][name]["steps"]["params"], expert):
            assert e or torch.equal(a, b)  # a learner's own experts differ
    _check_change(name, got, one["params"], start)
    _check_change(name, got, ref_leaves, start)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_fedavg_round_agrees_with_one_card(runs, name):
    """The weighted FedAvg round: its published delta and new parameters
    within the f32 bounds of the one-card round's, its ``local_loss`` the
    learners' mean as one card's."""
    one, init = runs["one"][name], runs["inits"][name]
    start = tree_to_flat(_model(name, init).tree()).numpy()
    got = _flat(_full_leaves(name, runs["ranks"], "fed")).numpy()
    for res in runs["ranks"]:
        fed = res[name]["fed"]
        assert fed["padded"] % (2 * N * M) == 0
        np.testing.assert_allclose(fed["loss"], one["fed_loss"], rtol=LOSS_RTOL)
        assert _rel_l2(fed["delta"], one["fed_delta"]) <= REL_PARAMS
    assert _rel_l2(got - start, one["fed_params"].numpy() - start) <= REL_PARAMS


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_prefill_and_decode_agree_with_one_process(runs, name):
    """Prefill and STEPS decode steps over ('data', 'model') = (3, 4), one
    row a data rank (``make_serve_step(model, grid)``): every rank's logits
    within 2e-4 of max |logit| of one process's for its row, and the model
    ranks of a row equal."""
    want = runs["one"][name]["serve"]
    for r, res in enumerate(runs["ranks"]):
        l = r // M
        got = res[name]["serve"][:, 0]
        scale = float(want[:, l].abs().max())
        assert float((got - want[:, l]).abs().max()) <= SERVE_TOL * scale, (name, r)
        assert torch.equal(got, runs["ranks"][l * M][name]["serve"][:, 0])


def test_checkpoint_saved_at_four_restores_at_two_and_one(runs):
    """The 14q-2kv state after two steps, gathered from 3 x 4 ranks into a
    one-process checkpoint: it restores on one card (the leaves the model
    ranks' shards joined, the master vector their ZeRO-1 parts), at m = 2
    (7 q heads a rank) and at m = 3 (5, 5 and 4 q heads): each rank's
    shards join back to the same leaves and its ZeRO-1 parts are those
    words of the master vector."""
    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.ckpt.checkpoint import shard_tp_state, tp_skeleton
    name = CKPT_LAYOUT
    init, ranks = runs["inits"][name], runs["ranks"]
    one_state = runs["one"][name]["state"]
    full, _ = restore_checkpoint(runs["ckpt"], CKPT_STEP, one_state)
    dims = tree_dims(_model(name, init).tree(), _cfg(name), M)
    want = [sp.join([ranks[j][name]["steps"]["params"][i] for j in range(M)])
            if sp is not None else ranks[0][name]["steps"]["params"][i]
            for i, sp in enumerate(dims)]
    for a, b in zip(leaves(full["params"]), want):
        assert torch.equal(a, b)
    P, sec = ranks[0][name]["steps"]["padded"], ranks[0][name]["steps"]["sec_size"]
    L, part = P // M, P // (N * M)
    master = torch.empty(P)
    for l in range(N):
        for j in range(M):
            master[j * L + l * part:j * L + (l + 1) * part] = \
                ranks[l * M + j][name]["steps"]["master"][-1]
    assert torch.equal(full["master"][:sec], master[:sec])
    for m2, heads in ((2, [7, 7]), (3, [5, 5, 4])):
        P2 = tp_padded_size(sec, N, m2)
        part2 = P2 // (N * m2)
        padded = torch.cat([full["master"][:sec], torch.zeros(P2 - sec)])
        shards = {}
        for l in range(N):
            for j in range(m2):
                tp = World(rank=j, size=m2, device=torch.device("cpu"), transport="gloo")
                ring = World(rank=l, size=N, device=torch.device("cpu"), transport="gloo")
                model = _model(name, init, tp)
                like = {"params": model.tree(), "sec_opt": None, "ep_opt": None,
                        **{k: torch.zeros(part2) for k in ("master", "fm", "fv")}}
                layout = model.shard_layout()
                skeleton = tp_skeleton(like, layout, sec, ring)
                assert [tuple(x.shape) for x in leaves(skeleton["params"])] == \
                    [tuple(x.shape) for x in leaves(full["params"])]
                st = shard_tp_state(full, like, layout, sec, P2, ring, tp)
                shards[l, j] = st
                lo = j * (P2 // m2) + l * part2
                assert torch.equal(st["master"], padded[lo:lo + part2])
            assert [shards[l, j]["params"]["blocks"][0]["attn"]["wq"].shape[-1]
                    for j in range(m2)] == [h * 16 for h in heads]
        for j in range(m2):
            layout = _model(name, init, World(rank=j, size=m2, device=torch.device("cpu"),
                                              transport="gloo")).shard_layout()
            for i, sh in enumerate(layout):
                got = [leaves(shards[0, k]["params"])[i] for k in range(m2)]
                assert torch.equal(sh.join(got), leaves(full["params"])[i])
