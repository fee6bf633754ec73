"""The per-rank train step and FedAvg round (one learner a process) against
the one-card port, word for word, and the JAX package's step.

Four gloo ranks on the CPU (``repro_torch.dist.spawn``, two intra-op
threads each, as this process uses) start from the reference's initial
weights of the smoke internlm2-1.8b in f32 and take two SAFE train steps,
the second with learner 1 dead: flat (ZeRO-1, each rank holding its slice
of the master vector and moments) and leafwise; then one weighted FedAvg
round with learner 2 dead. The one-card port runs the same in this
process. The reference runs its step on a (4, 1) Auto mesh of host devices
in a subprocess (as ``tests/test_torch_train_step.py`` does). Beside it,
the launcher runs under ``torch.distributed.run`` on three CPU ranks: one
step with a checkpoint, then a resumed second step, whose checkpoint must
equal the one-process launcher's two uninterrupted steps word for word.
"""
import dataclasses
import os
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
from repro_torch.train import make_federated_round, make_train_step, tree_to_flat
from repro_torch.train.flatten import leaves

N, B, S, LR, THREADS = 4, 2, 32, 1e-3, 2
ALIVE = ([1, 1, 1, 1], [1, 0, 1, 1])      # step i's alive bitmap
FED_K, FED_ALIVE, FED_COUNTER = 2, [1, 1, 0, 1], 12345
LAUNCH_RANKS = 3
# f32 bounds against the reference, those of tests/test_torch_train_step.py
# for a run with a dead learner: losses 1e-6, grad_scale 1e-5 relative, the
# parameters' change 5e-3 relative L2.
LOSS_RTOL, SCALE_RTOL, REL_PARAMS = 1e-6, 1e-5, 5e-3

REF_CODE = """
import repro  # the package's jax shims first
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.core import make_aggregator
from repro.data import make_federated_batches
from repro.models import Model
from repro.train.flatten import tree_to_flat
from repro.train.train_step import make_train_step
import dataclasses

N, B, S, LR, ALIVE = @ARGS@
mesh = jax.make_mesh((N, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"), dtype="float32")
model = Model(cfg)
stream = make_federated_batches(cfg, N, B, S, seed=0)
out = {}
for path, leaf in jax.tree_util.tree_flatten_with_path(model.init(jax.random.key(0)))[0]:
    key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
    out["init/" + key] = np.asarray(leaf)
b = make_train_step(model, make_aggregator("safe", N, axis="data"), mesh, lr=LR)
s = b.init_state_fn(model.init(jax.random.key(0)))
losses, scales = [], []
for i, alive in enumerate(ALIVE):
    s, m = b.step_fn(s, jnp.asarray(stream.global_batch(i)["tokens"]),
                     counter=i * (b.padded_size + 2), alive=jnp.asarray(alive, jnp.float32))
    losses.append(float(m["loss"]))
    scales.append(float(m["grad_scale"]))
out["loss"], out["grad_scale"] = np.asarray(losses), np.asarray(scales)
out["params"] = np.asarray(tree_to_flat(s["params"]))
np.savez("@OUT@", **out)
print("REF_OK")
"""


def _cfg():
    return dataclasses.replace(get_smoke_config("internlm2-1.8b"), dtype="float32")


def _model(init):
    """The port's model holding the reference's initial weights (``init``:
    path -> array)."""
    tree = {}
    for key, a in init.items():
        node, parts = tree, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a
    tree["blocks"] = [tree["blocks"][str(i)] for i in range(len(tree["blocks"]))]
    model = Model(_cfg(), device="cpu")
    model.load_state_dict(convert.model_params(_cfg(), tree))
    return model


def _steps(init, leafwise, mesh=None, rank=None):
    """Two steps from the reference's weights: (losses, grad_scales, final
    flat parameters, state). ``rank`` None: the one-card step on the global
    batch; else the per-rank step on that learner's batch."""
    model = _model(init)
    agg = make_aggregator("safe", N, device="cpu")
    bundle = make_train_step(model, agg, mesh, lr=LR, leafwise=leafwise)
    state = bundle.init_state_fn(model.tree())
    stream = make_federated_batches(_cfg(), N, B, S, seed=0)
    losses, scales = [], []
    for i, alive in enumerate(ALIVE):
        toks = stream.global_batch(i)["tokens"]
        state, m = bundle.step_fn(state, torch.from_numpy(toks if rank is None else toks[rank]),
                                  counter=agg.reserve_round(bundle.padded_size + 2),
                                  alive=alive)
        losses.append(float(m["loss"]))
        scales.append(float(m["grad_scale"]))
    return losses, scales, tree_to_flat(state["params"]), state, bundle


def _fed(init, mesh=None, rank=None):
    """One weighted FedAvg round from the reference's weights: (published
    delta, new flat parameters, local loss)."""
    model = _model(init)
    agg = make_aggregator("safe", N, weighted=True, device="cpu")
    bundle = make_federated_round(model, agg, mesh, local_steps=FED_K, local_lr=LR,
                                  return_delta=True)
    stream = make_federated_batches(_cfg(), N, B, S, seed=0)
    toks = np.stack([np.stack([stream.learner_batch(l, k)["tokens"] for k in range(FED_K)])
                     for l in range(N)])
    weights = stream.global_batch(0)["weights"]
    params, m = bundle.round_fn(model.tree(), torch.from_numpy(toks if rank is None
                                                               else toks[rank]),
                                weights=weights, counter=FED_COUNTER, alive=FED_ALIVE)
    return m["avg_delta"], tree_to_flat(params), float(m["local_loss"])


def _rank(world, init):
    """One rank: the flat and leafwise steps and the FedAvg round."""
    losses, scales, params, state, bundle = _steps(init, False, world, world.rank)
    out = {"losses": losses, "scales": scales, "params": params,
           "master": state["master"], "fm": state["fm"], "fv": state["fv"],
           "padded_size": bundle.padded_size}
    out["leafwise"] = _steps(init, True, world, world.rank)[2]
    out["fed_delta"], out["fed_params"], out["fed_loss"] = _fed(init, world, world.rank)
    return out


def _launch(ckpt, steps, env):
    """The launcher on LAUNCH_RANKS CPU ranks under torch.distributed.run."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(LAUNCH_RANKS), "-m", "repro_torch.launch.train",
           "--arch", "internlm2-1.8b", "--smoke", "--seq-len", "32", "--steps", str(steps),
           "--model-shards", "1", "--device", "cpu", "--ckpt-dir", str(ckpt),
           "--ckpt-every", "1"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads, here and in each rank: a CPU reduction's order
    (the leafwise clip's norm) follows the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's step and the launcher runs side by side, then the
    ranks from the reference's weights, then the one-card port's."""
    tmp = tmp_path_factory.mktemp("dist_train")
    code = (REF_CODE.replace("@ARGS@", repr((N, B, S, LR, ALIVE)))
            .replace("@OUT@", str(tmp / "ref.npz")))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="2")
    with ThreadPoolExecutor(1) as pool:
        ref_run = pool.submit(run_multidevice, code, N, 600)
        out = {"resume_log": _launch(tmp / "ckpt", 1, env) + _launch(tmp / "ckpt", 2, env),
               "ckpt": tmp / "ckpt"}
        assert "REF_OK" in ref_run.result()
    ref = dict(np.load(tmp / "ref.npz"))
    init = {k[len("init/"):]: v for k, v in ref.items() if k.startswith("init/")}
    out["ref"], out["init"] = ref, init
    out["ranks"] = [r["result"] for r in spawn(_rank, N, "cpu", args=(init,), threads=THREADS)]
    return out


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_rank_step_equals_one_card_word_for_word(runs):
    losses, scales, params, _, _ = _steps(runs["init"], False)
    for r, res in enumerate(runs["ranks"]):
        assert torch.equal(res["params"], params), r
        assert res["losses"] == losses, r
        assert res["scales"] == scales, r


def test_rank_step_agrees_with_reference(runs):
    ref, res = runs["ref"], runs["ranks"][0]
    init = tree_to_flat(_model(runs["init"]).tree()).numpy()
    np.testing.assert_allclose(res["losses"], ref["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(res["scales"], ref["grad_scale"], rtol=SCALE_RTOL)
    e = _rel_l2(res["params"].numpy() - init, ref["params"] - init)
    assert e <= REL_PARAMS, e
    assert res["losses"][1] < res["losses"][0]


def test_rank_optimizer_state_is_one_slice(runs):
    """ZeRO-1: each rank's master, m and v hold padded_size / n words, its
    own slice of the one-card step's."""
    _, _, _, state, bundle = _steps(runs["init"], False)
    L = bundle.padded_size // N
    for r, res in enumerate(runs["ranks"]):
        assert res["padded_size"] == bundle.padded_size
        for key in ("master", "fm", "fv"):
            assert res[key].shape == (L,), (r, key, res[key].shape)
            assert torch.equal(res[key], state[key][r * L:(r + 1) * L]), (r, key)


def test_rank_leafwise_equals_one_card(runs):
    want = _steps(runs["init"], True)[2]
    for r, res in enumerate(runs["ranks"]):
        assert torch.equal(res["leafwise"], want), r


def test_rank_fedavg_round_equals_one_card(runs):
    delta, params, loss = _fed(runs["init"])
    for r, res in enumerate(runs["ranks"]):
        assert torch.equal(res["fed_delta"], delta), r
        assert torch.equal(res["fed_params"], params), r
        assert res["fed_loss"] == loss, r


def test_launcher_resume_equals_one_process_run(runs):
    """Three ranks: one step with a checkpoint (rank 0 writes the slices it
    gathered), then a run that resumes at step 1 and writes step 2. That
    state equals, word for word, the one-process launcher's after two
    uninterrupted steps."""
    from repro_torch.ckpt import latest_step, restore_checkpoint
    from repro_torch.launch.train import parse_args, run
    assert "resumed from step 1" in runs["resume_log"]
    assert latest_step(str(runs["ckpt"])) == 2
    want = run(parse_args(["--arch", "internlm2-1.8b", "--smoke", "--seq-len", "32",
                           "--steps", "2", "--learners", str(LAUNCH_RANKS),
                           "--device", "cpu"]))
    got, extra = restore_checkpoint(str(runs["ckpt"]), 2, want["state"])
    assert extra["step"] == 2 and extra["counter"] == want["counters"][-1] + (
        want["counters"][1] - want["counters"][0])
    for a, b in zip(leaves(got), leaves(want["state"])):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


def test_moe_experts_must_divide_the_ranks():
    """What stays refused of expert parallelism across ranks: a learner
    count that does not divide E (the reference's exchange needs equal
    shards), and a model that holds every expert on a rank of several."""
    cpu = torch.device("cpu")
    three = World(rank=0, size=3, device=cpu, transport="gloo")
    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-235b-a22b"), dtype="float32",
                              ep_axis="data", ep_ranks=3)
    with pytest.raises(ValueError, match="4 experts do not shard over 3 ranks"):
        Model(cfg, device="cpu", ep_world=three)
    world = World(rank=0, size=N, device=cpu, transport="gloo")
    cfg = dataclasses.replace(cfg, ep_ranks=N)
    with pytest.raises(ValueError, match="ep_world=world"):
        make_train_step(Model(cfg, device="cpu"), make_aggregator("safe", N, device="cpu"),
                        world)


def test_pod_world_must_match_the_pods():
    """What stays refused with pods across ranks: weights of more pods than
    the pod World has ranks, a pod axis without a pod World, and a pod
    World without a pod axis."""
    cpu = torch.device("cpu")
    data = World(rank=0, size=N, device=cpu, transport="gloo")
    pod = World(rank=0, size=2, device=cpu, transport="gloo")
    agg = make_aggregator("safe", N, weighted=True, pod_axis="pod", device="cpu")
    with pytest.raises(ValueError, match="pod World of 2 ranks for 3 pods"):
        agg.aggregate_rank(torch.zeros(8), weights=np.ones((3, N), np.float32), world=data,
                           pod_world=pod)
    with pytest.raises(ValueError, match="needs the pod World"):
        agg.aggregate_rank(torch.zeros(8), world=data)
    with pytest.raises(ValueError, match="no pod axis"):
        make_aggregator("safe", N, device="cpu").aggregate_rank(torch.zeros(8), world=data,
                                                               pod_world=pod)
    with pytest.raises(ValueError, match="needs the pod World"):
        make_train_step(Model(_cfg(), device="cpu"),
                        make_aggregator("safe", N, pod_axis="pod", device="cpu"), data,
                        pod_axis="pod")
