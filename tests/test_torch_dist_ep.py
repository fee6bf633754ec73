"""Expert parallelism across processes: the experts' all-to-all, one learner
a rank, against the JAX package's EP step and the one-card port.

Four gloo ranks on the CPU (``repro_torch.dist.spawn``, two intra-op threads
each, as this process uses) each build their quarter of the experts of the
f32 smoke qwen3-moe (``Model(cfg, ep_world=world)``, E = 4: one expert a
rank), load the reference's initial weights cut to their shard
(``convert.shard_experts``) and take two SAFE train steps, the second with
learner 1 dead: the MoE blocks exchange the [n, E/n, C, d] dispatch
buffers and the products with two tiled all-to-alls, and autograd carries
the cotangents back through the exchange. The reference runs its EP step
(``ep_axis="data"``) on a (4, 1) Auto mesh of host devices in a
subprocess; the one-card port runs the same steps in this process, the
learners as dim 0 (its ``_moe_apply_ep`` dispatches to all E experts and
the step sums the learners' expert gradients in f32). Each rank's
gradient rows fed to the one-card aggregator must give the rank's
published mean word for word. Beside it, the launcher trains the smoke
qwen3-moe under ``torch.distributed.run`` on four CPU ranks with a
checkpoint every step, and a second run resumes from step 1.
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

from helpers import REPO, run_multidevice
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import make_aggregator
from repro_torch.data import make_federated_batches
from repro_torch.dist import World, spawn
from repro_torch.models import Model
from repro_torch.train import make_train_step
from repro_torch.train.flatten import is_expert_path, leaf_paths, leaves, leaves_with_paths

N, B, S, LR, THREADS = 4, 2, 32, 1e-3, 2
ALIVE = ([1, 1, 1, 1], [1, 0, 1, 1])      # step i's alive bitmap
ARCH = "qwen3-moe-235b-a22b"
# f32 bounds against the reference: those of tests/test_torch_train_step.py's
# zoo (losses 1e-6, grad_scale 1e-5 relative, the SAFE partition's change
# 5e-3 and the experts' change and second moment 5e-4 relative L2).
LOSS_RTOL, SCALE_RTOL, REL_SEC, REL_EP = 1e-6, 1e-5, 5e-3, 5e-4
# Against the one-card port (the same math, the expert gradients summed in
# another order: one product over n·C rows against the f32 sum of the
# learners'). Measured, f32: the SAFE partition's change 5.5e-5 relative
# L2 at worst (a leaf), the experts' 7.1e-6, the losses equal; the bounds
# sit ~10x above.
ONE_CARD_REL, ONE_CARD_LOSS_RTOL = 5e-4, 1e-6
# The launcher (bf16 smoke, two steps) across four ranks against the
# one-process launcher. Measured: the f32 master vector 8.3e-4 relative L2,
# the expert and flat moments 1.0e-2 to 1.4e-2 (the bf16 expert gradients
# round in another order); the bounds sit ~4-6x above.
LAUNCH_MASTER_REL, LAUNCH_MOMENT_REL = 5e-3, 5e-2
LAUNCH_RANKS = 4

REF_CODE = """
import dataclasses
import repro  # the package's jax shims first
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.core import make_aggregator
from repro.data import make_federated_batches
from repro.models import Model
from repro.train.flatten import tree_to_flat
from repro.train.train_step import make_train_step

N, B, S, LR, ALIVE, ARCH = @ARGS@
mesh = jax.make_mesh((N, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32", ep_axis="data", ep_ranks=N)
model = Model(cfg)
stream = make_federated_batches(cfg, N, B, S, seed=0)
out = {}

def path_str(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)

params0 = model.init(jax.random.key(0))
for path, leaf in jax.tree_util.tree_flatten_with_path(params0)[0]:
    out["init/" + path_str(path)] = np.asarray(leaf)
b = make_train_step(model, make_aggregator("safe", N, axis="data"), mesh, lr=LR)
s = b.init_state_fn(params0)
W = b.padded_size + 2
losses, scales = [], []
for i, alive in enumerate(ALIVE):
    s, m = b.step_fn(s, jnp.asarray(stream.global_batch(i)["tokens"]), counter=i * W,
                     alive=jnp.asarray(alive, jnp.float32))
    losses.append(float(m["loss"]))
    scales.append(float(m["grad_scale"]))
out["loss"], out["grad_scale"] = np.asarray(losses), np.asarray(scales)
for path, leaf in jax.tree_util.tree_flatten_with_path(s["params"])[0]:
    out["final/" + path_str(path)] = np.asarray(leaf)
out["ep_v"] = np.asarray(tree_to_flat(s["ep_opt"].v))
out["ep_step"] = np.asarray(s["ep_opt"].step)
np.savez("@OUT@", **out)
print("REF_OK")
"""


def _cfg():
    return dataclasses.replace(get_smoke_config(ARCH), dtype="float32", ep_axis="data",
                               ep_ranks=N)


def _init_tree(init):
    """The reference's initial parameter tree from its saved leaves."""
    tree = {}
    for key, a in init.items():
        node, parts = tree, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a
    tree["blocks"] = [tree["blocks"][str(i)] for i in range(len(tree["blocks"]))]
    return tree


def _model(init, world=None):
    """The port's model holding the reference's initial weights: all E
    experts, or with ``world`` this rank's shard of them."""
    state = convert.model_params(_cfg(), _init_tree(init))
    if world is not None:
        state = convert.shard_experts(state, world.rank, world.size)
    model = Model(_cfg(), device="cpu", ep_world=world)
    model.load_state_dict(state)
    return model


def _steps(init, world=None):
    """Two EP steps from the reference's weights: losses, grad_scales, the
    final parameters by path, the state, and what each aggregation round
    took and gave (this rank's gradient row, the published mean, the round's
    arguments). ``world`` None: the one-card step on the global batch."""
    model = _model(init, world)
    agg = make_aggregator("safe", N, device="cpu")
    rounds = []
    if world is not None:
        inner = agg.aggregate_rank

        def spy(values, counter_base=0, **kw):
            out = inner(values, counter_base, **kw)
            rounds.append((values.clone(), out.clone(), counter_base,
                           {k: kw[k] for k in ("alive", "rotate")}))
            return out
        agg.aggregate_rank = spy
    bundle = make_train_step(model, agg, world, lr=LR)
    state = bundle.init_state_fn(model.tree())
    stream = make_federated_batches(_cfg(), N, B, S, seed=0)
    losses, scales = [], []
    for i, alive in enumerate(ALIVE):
        toks = stream.global_batch(i)["tokens"]
        state, m = bundle.step_fn(state, torch.from_numpy(toks if world is None
                                                          else toks[world.rank]),
                                  counter=agg.reserve_round(bundle.padded_size + 2),
                                  alive=alive)
        losses.append(float(m["loss"]))
        scales.append(float(m["grad_scale"]))
    final = {p: t.detach() for p, t in leaves_with_paths(state["params"])}
    return {"losses": losses, "scales": scales, "final": final, "rounds": rounds,
            "ep_v": [t.clone() for t in leaves(state["ep_opt"].v)],
            "ep_step": int(state["ep_opt"].step), "padded_size": bundle.padded_size}


def _rank(world, init):
    return _steps(init, world)


def _launch(ckpt, env):
    """The launcher on LAUNCH_RANKS CPU ranks: two steps of the smoke MoE,
    a checkpoint after each."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(LAUNCH_RANKS), "-m", "repro_torch.launch.train",
           "--arch", ARCH, "--smoke", "--seq-len", "32", "--steps", "2",
           "--model-shards", "1", "--device", "cpu", "--ckpt-dir", str(ckpt),
           "--ckpt-every", "1"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


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
    """The reference's EP step and the launcher's two runs side by side,
    then the ranks from the reference's weights."""
    tmp = tmp_path_factory.mktemp("dist_ep")
    code = (REF_CODE.replace("@ARGS@", repr((N, B, S, LR, ALIVE, ARCH)))
            .replace("@OUT@", str(tmp / "ref.npz")))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="2")
    with ThreadPoolExecutor(1) as pool:
        ref_run = pool.submit(run_multidevice, code, N, 600)
        first = _launch(tmp / "a", env)
        shutil.copytree(tmp / "a", tmp / "b")
        shutil.rmtree(tmp / "b" / "step_00000002")
        resumed = _launch(tmp / "b", env)
        assert "REF_OK" in ref_run.result()
    ref = dict(np.load(tmp / "ref.npz"))
    init = {k[len("init/"):]: v for k, v in ref.items() if k.startswith("init/")}
    ranks = [r["result"] for r in spawn(_rank, N, "cpu", args=(init,), threads=THREADS)]
    return {"ref": ref, "init": init, "ranks": ranks, "ckpt": tmp, "first_log": first,
            "resume_log": resumed}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _full(ranks):
    """The parameters by path, the experts gathered from the ranks' shards
    (every other leaf equal on every rank)."""
    out = {}
    for p, t in ranks[0]["final"].items():
        if is_expert_path(p):
            out[p] = torch.cat([r["final"][p] for r in ranks], dim=1)
        else:
            for r in ranks[1:]:
                assert torch.equal(r["final"][p], t), p
            out[p] = t
    return out


def _change(final, init, want, paths):
    got = np.concatenate([(final[p].numpy() - init[p]).ravel() for p in paths])
    ref = np.concatenate([(want[p] - init[p]).ravel() for p in paths])
    return _rel_l2(got, ref)


def test_rank_shards_hold_their_experts(runs):
    """Each rank's expert leaves are [n_units, E/n, ...]; the rest of the
    model is whole on every rank."""
    E = _cfg().moe.num_experts
    for r, res in enumerate(runs["ranks"]):
        for p, t in res["final"].items():
            full = runs["init"][p].shape
            want = (full[0], E // N) + full[2:] if is_expert_path(p) else full
            assert tuple(t.shape) == want, (r, p)


def test_rank_ep_step_agrees_with_reference(runs):
    """The per-rank EP step against the reference's EP step: losses,
    grad_scale, the SAFE partition's change and the experts' change and
    second moment within the zoo's f32 bounds; two expert updates."""
    ref, ranks, init = runs["ref"], runs["ranks"], runs["init"]
    for res in ranks:
        np.testing.assert_allclose(res["losses"], ref["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(res["scales"], ref["grad_scale"], rtol=SCALE_RTOL)
        assert res["ep_step"] == int(ref["ep_step"]) == len(ALIVE)
    final = _full(ranks)
    want = {p[len("final/"):]: v for p, v in ref.items() if p.startswith("final/")}
    assert sorted(final) == sorted(want)
    ep = [p for p in final if is_expert_path(p)]
    sec = [p for p in final if not is_expert_path(p)]
    assert len(ep) == 3
    assert _change(final, init, want, sec) <= REL_SEC
    assert _change(final, init, want, ep) <= REL_EP
    v = np.concatenate([torch.cat([r["ep_v"][i] for r in ranks], dim=1).numpy().ravel()
                        for i in range(len(ep))])
    assert _rel_l2(v, ref["ep_v"]) <= REL_EP


def test_rank_ep_step_near_one_card(runs):
    """The per-rank EP step against the one-card port's EP step from the
    same weights: every leaf's change within ONE_CARD_REL relative L2."""
    one = _steps(runs["init"])
    final, init = _full(runs["ranks"]), runs["init"]
    np.testing.assert_allclose(runs["ranks"][0]["losses"], one["losses"],
                               rtol=ONE_CARD_LOSS_RTOL)
    for p, t in one["final"].items():
        if p.endswith("scale") or p.endswith("_norm"):  # unchanged by a zero gradient
            continue
        e = _change(final, init, {p: t.numpy()}, [p])
        assert e <= ONE_CARD_REL, (p, e)


@pytest.mark.parametrize("step", range(len(ALIVE)))
def test_rank_ep_safe_call_is_exact(runs, step):
    """SAFE on the per-rank step's own gradients: the ranks' rows stacked
    and aggregated on one card give each rank's published mean word for
    word (the exchange changes the float math, never the SAFE call)."""
    ranks = runs["ranks"]
    rows = torch.stack([r["rounds"][step][0] for r in ranks])
    _, _, counter, kw = ranks[0]["rounds"][step]
    want = make_aggregator("safe", N, device="cpu").aggregate(rows, counter, **kw)
    for r, res in enumerate(ranks):
        assert res["rounds"][step][2:] == (counter, kw), r
        assert torch.equal(res["rounds"][step][1], want), r


def test_launcher_trains_moe_and_resumes_across_ranks(runs):
    """The launcher under torch.distributed.run trains the smoke MoE by
    expert parallelism on four ranks; rank 0's checkpoint has the
    one-process (the reference's full-E) layout, a run resumed from step 1
    writes step 2 word for word as the uninterrupted run did, and its state
    is within the stated bounds of the one-process launcher's two steps."""
    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.launch.train import parse_args, run
    assert "resumed from step 1" in runs["resume_log"]
    want = run(parse_args(["--arch", ARCH, "--smoke", "--seq-len", "32", "--steps", "2",
                           "--learners", str(LAUNCH_RANKS), "--device", "cpu"]))
    a, extra_a = restore_checkpoint(str(runs["ckpt"] / "a"), 2, want["state"])
    b, extra_b = restore_checkpoint(str(runs["ckpt"] / "b"), 2, want["state"])
    assert extra_a == extra_b and extra_a["step"] == 2
    for (p, x), y in zip(leaves_with_paths(a), leaves(b)):
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y), p
    for (p, x), y in zip(leaves_with_paths(a), leaves(want["state"])):
        if not isinstance(x, torch.Tensor):
            assert x == y, p
            continue
        assert x.shape == y.shape and x.dtype == y.dtype, p
        if p == "master":
            assert _rel_l2(x.numpy(), y.numpy()) <= LAUNCH_MASTER_REL, p
        elif p in ("fm", "fv") or p.startswith(("ep_opt/1/", "ep_opt/2/")):
            assert _rel_l2(x.numpy(), y.numpy()) <= LAUNCH_MOMENT_REL, p


def test_expert_shard_equals_rows_of_the_whole_model():
    """A rank's model from the same generator holds rows [r·E/n, (r+1)·E/n)
    of the one-card model's experts, and every other leaf equal."""
    cfg = dataclasses.replace(_cfg(), ep_ranks=2)
    whole = Model(cfg, device="cpu").state_dict()
    for r in range(2):
        world = World(rank=r, size=2, device=torch.device("cpu"), transport="gloo")
        shard = Model(cfg, device="cpu", ep_world=world).state_dict()
        assert list(shard) == list(whole)
        want = convert.shard_experts(whole, r, 2)
        for k in whole:
            assert torch.equal(shard[k], want[k]), (r, k)
    back = convert.gather_experts([convert.shard_experts(whole, r, 2) for r in range(2)])
    assert all(torch.equal(back[k], whole[k]) for k in whole)
    assert [p for p in leaf_paths(Model(cfg, device="meta").tree()) if is_expert_path(p)]


def test_dry_run_sizes_one_rank():
    """The dry run's per-rank train step (rank 0 of n, on meta tensors over
    a fake group): its experts are E/n a rank and its optimizer state the
    ZeRO-1 slice, so it holds less than the one-card step of n learners;
    the one-card sizing is unchanged beside it."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    cfg = get_smoke_config(ARCH)
    shape = dict(seq_len=S, global_batch=N * B, kind="train")
    one = dryrun.measure(cfg, "train_4k", shape=shape, learners=N, batch=B)
    try:
        rank = dryrun.measure(cfg, "train_4k", shape=shape, learners=N, batch=B, per_rank=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert rank["description"].startswith("train_step rank 0 of n=4")
    assert 0 < rank["peak_bytes"] < one["peak_bytes"]
    assert (rank["peak_by_category"]["optimizer state"]
            < one["peak_by_category"]["optimizer state"])
    assert rank["kernels"]["mask_add"]["calls"] >= 1
