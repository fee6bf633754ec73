"""The 'model' axis across ranks: Megatron tensor parallelism and SAFE
chains sharded over the model ranks, on the reference's ('data', 'model')
grid (rank l·m + j is learner l's model shard j).

In process: each rank's shards and the flat layout against the full tree's
``tree_to_flat`` for every dense smoke configuration (m = 2 and m = 4,
whose 6 q heads split 2, 2, 1, 1), the refusals, and what the reference's
``sanitize_spec`` does with a split that cuts a head.

One ``spawn`` of 8 gloo ranks (4 learners x 2 model shards, two intra-op
threads each) runs Megatron's three operators, the sharded rounds (safe,
saf, pipelined, bon, insec) and the smoke internlm2-1.8b's train steps
and FedAvg round in f32. This process runs the one-card port on the same
inputs; one subprocess runs the reference's rounds and its
``make_train_step`` on a (4, 2) Auto mesh with ``chain_model_sharded``;
beside them the launcher runs under ``torch.distributed.run`` on 4 CPU
ranks (2 learners x 2 model shards, BON): a checkpoint, a resume that
must equal the uninterrupted run word for word, and checkpoints that
restore across m = 2 and one process.
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
from repro_torch.dist import World, collectives, grid_worlds, spawn
from repro_torch.models import Model
from repro_torch.models.sharding import check_tp, shard_tree, tree_dims, unit_share
from repro_torch.optim.adamw import AdamState, FlatAdamW
from repro_torch.train import make_federated_round, make_train_step, tree_to_flat
from repro_torch.train.flatten import leaves, leaves_with_paths, shard_layout
from repro_torch.train.train_step import tp_padded_size

N, M, B, S, LR, THREADS = 4, 2, 2, 32, 1e-3, 2
ALIVE = ([1, 1, 1, 1], [1, 0, 1, 1])      # step i's alive bitmap
FED_K, FED_ALIVE, FED_COUNTER = 2, [1, 1, 0, 1], 12345
# f32 bounds of tests/test_torch_dist_train.py: losses 1e-6, grad_scale 1e-5
# relative, the parameters' change 5e-3 relative L2
LOSS_RTOL, SCALE_RTOL, REL_PARAMS = 1e-6, 1e-5, 5e-3
# the sharded rounds: chunks of L words (V = M·L), the counter wrapping 2^32
L, COUNTER = 38, 2**32 - 5
DEAD, DEAD0 = [1, 0, 1, 1], [0, 1, 1, 1]
CELLS = {
    "safe": (dict(mode="safe"), {}),
    "safe-weighted-dead": (dict(mode="safe", weighted=True),
                           dict(weights="w", alive=DEAD, rotate=1)),
    "saf-dead-initiator": (dict(mode="saf"), dict(alive=DEAD0)),
    "pipelined-weighted-dead": (dict(mode="safe", pipelined=True, weighted=True),
                                dict(weights="w", alive=DEAD0)),
    "bon-dead": (dict(mode="bon"), dict(alive=DEAD)),
    "insec-weighted-dead": (dict(mode="insec"), dict(weights="w", alive=DEAD)),
}
# the rounds whose messages are words of the whole vector's round's
SLICED_MESSAGES = ("safe", "safe-weighted-dead", "saf-dead-initiator", "bon-dead")
DENSE = ("internlm2-1.8b", "qwen3-14b", "gemma2-27b", "gemma3-12b", "internvl2-1b",
         "musicgen-large")
# smoke configurations whose q heads m = 2 splits unevenly (5 and 7) run with
# the head ratio of their full configuration's kind: one kv head, an even
# count (the uneven splits: tests/test_torch_dist_heads.py)
HEADS = {"qwen3-14b": dict(n_heads=4), "internvl2-1b": dict(n_heads=6)}

REF_CODE = """
import repro  # the package's jax shims first
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, Mesh
from repro.core import make_aggregator
from repro.data import make_federated_batches
from repro.configs import get_smoke_config
from repro.models import Model
from repro.train.flatten import tree_to_flat
from repro.train.train_step import make_train_step
import dataclasses
import test_torch_dist_tp as t

out = {}
mesh4 = Mesh(np.array(jax.devices()[:t.N]), ("data",))
for name in t.CELLS:
    mode, akw, vals, kw = t._round_args(name)
    w = kw.get("weights")
    out["round/" + name] = np.asarray(make_aggregator(mode, t.N, **akw).aggregate_sharded(
        mesh4, jnp.asarray(vals), t.COUNTER, jnp.asarray(kw.get("alive", np.ones(t.N)),
                                                         jnp.float32),
        None if w is None else jnp.asarray(w)))

init = dict(np.load("@INIT@"))
tree = {}
for key, a in init.items():
    node, parts = tree, key.split("/")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = jnp.asarray(a)
tree["blocks"] = [tree["blocks"][str(i)] for i in range(len(tree["blocks"]))]
cfg = t._cfg()
mesh = jax.make_mesh((t.N, t.M), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
model = Model(cfg)
stream = make_federated_batches(cfg, t.N, t.B, t.S, seed=0)
b = make_train_step(model, make_aggregator("safe", t.N, axis="data"), mesh, lr=t.LR,
                    chain_model_sharded=True)
s = b.init_state_fn(tree)
losses, scales = [], []
for i, alive in enumerate(t.ALIVE):
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


def _dense_cfg(arch, **kw):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               **HEADS.get(arch, {}), **kw)


def _round_args(name):
    """(mode, aggregator kwargs, values f32[N, M·L], round kwargs with the
    weights filled in); a dead learner's row is NaN."""
    akw, kw = (dict(d) for d in CELLS[name])
    rng = np.random.RandomState(11)
    vals = rng.uniform(-2, 2, (N, M * L)).astype(np.float32)
    if "alive" in kw:
        vals[np.asarray(kw["alive"]) == 0] = np.nan
    if kw.get("weights") == "w":
        kw["weights"] = rng.uniform(1, 10, N).astype(np.float32)
    return akw.pop("mode"), akw, vals, kw


def _init_state():
    """The one-card model's initial weights (the port's generator, seed 0),
    as the state dict every side starts from."""
    return {k: v.detach().clone() for k, v in
            Model(_cfg(), device="cpu", generator=torch.Generator().manual_seed(0))
            .state_dict().items()}


def _model(init, tp=None):
    """The model holding ``init`` (the full weights), or model rank j's
    shards of them (``tp`` its model group)."""
    model = Model(_cfg(), device="cpu", tp_world=tp)
    model.load_state_dict(init if tp is None else
                          convert.shard_model(_cfg(), init, tp.rank, tp.size))
    return model


def _tokens(step):
    return make_federated_batches(_cfg(), N, B, S, seed=0).global_batch(step)["tokens"]


def _fed_inputs():
    stream = make_federated_batches(_cfg(), N, B, S, seed=0)
    toks = np.stack([np.stack([stream.learner_batch(l, k)["tokens"] for k in range(FED_K)])
                     for l in range(N)])
    return toks, stream.global_batch(0)["weights"]


# ---- the ranks ---------------------------------------------------------------------------

def _op_inputs():
    rng = np.random.RandomState(3)
    return tuple(torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))
                 for s in ((5, 6), (6, 8), (5, 6), (6, 7), (5, 8), (5, 7)))


def _op_loss(x, a, e, b, c, d, tp):
    """Megatron's pattern on model rank ``tp.rank``'s shards: the replicated
    ``x`` [5, 6] into a column-parallel product by ``a`` [6, 8], gathered,
    and the split ``e`` [5, 6] (its columns as a column-parallel layer
    leaves them) into a row-parallel product by ``b`` [6, 7], reduced
    (``tp`` None: the one-process function)."""
    if tp is None:
        return ((x @ a) * c).sum() + ((e @ b) * d).sum()
    j, k, r = tp.rank, a.shape[1] // tp.size, e.shape[1] // tp.size
    y = collectives.gather_from_model(collectives.copy_to_model(x, tp) @ a[:, j * k:(j + 1) * k],
                                      tp, dim=-1)
    z = collectives.reduce_from_model(e[:, j * r:(j + 1) * r] @ b[j * r:(j + 1) * r], tp)
    return (y * c).sum() + (z * d).sum()


def _operators(tp):
    x, a, e, b, c, d = (t.clone().requires_grad_(True) for t in _op_inputs())
    loss = _op_loss(x, a, e, b, c, d, tp)
    loss.backward()
    part = (torch.arange(8) + tp.rank).to(torch.bfloat16)  # a bf16 psum of exact partials
    return {"loss": loss.detach(), "dx": x.grad, "da": a.grad, "de": e.grad, "db": b.grad,
            "bf16": collectives.reduce_from_model(part / 3, tp)}


def _rounds(ring, tp):
    """Every cell's chunk through ``aggregate_rank(model_world=)``, and its
    uint32 messages; then the round of the whole vector on the same ring,
    and its messages."""
    out = {}
    sent = []
    real_send, real_psum = collectives.send, collectives.psum

    def send(x, dst, world):
        sent.append(x.clone())
        real_send(x, dst, world)

    def psum(x, world):
        if x.dtype == torch.uint32:
            sent.append(x.clone())
        return real_psum(x, world)

    collectives.send, collectives.psum = send, psum
    try:
        for name in CELLS:
            mode, akw, vals, kw = _round_args(name)
            agg = make_aggregator(mode, N, device="cpu", **akw)
            j = tp.rank
            sent.clear()
            out["chunk/" + name] = agg.aggregate_rank(
                torch.from_numpy(vals[ring.rank, j * L:(j + 1) * L]), COUNTER, world=ring,
                model_world=tp, **kw)
            out["sent/" + name] = list(sent)
            sent.clear()
            agg.aggregate_rank(torch.from_numpy(vals[ring.rank]), COUNTER, world=ring, **kw)
            out["whole/" + name] = list(sent)
    finally:
        collectives.send, collectives.psum = real_send, real_psum
    return out


def _tp_steps(init, ring, tp, leafwise):
    """Two train steps of learner ``ring.rank``'s shard ``tp.rank``: losses,
    grad scales, the shards, the state, and (flat) each step's published
    chunk and the ZeRO-1 part after it."""
    model = _model(init, tp)
    agg = make_aggregator("safe", N, device="cpu")
    published = []
    real = agg.aggregate_rank

    def record(*a, **kw):
        out = real(*a, **kw)
        published.append(out.clone())
        return out

    agg.aggregate_rank = record
    bundle = make_train_step(model, agg, ring, lr=LR, leafwise=leafwise)
    state = bundle.init_state_fn(model.tree())
    res = {"losses": [], "scales": [], "master": [], "padded_size": bundle.padded_size,
           "master0": state["master"].clone()}
    for i, alive in enumerate(ALIVE):
        state, m = bundle.step_fn(state, torch.from_numpy(_tokens(i)[ring.rank]),
                                  counter=i * (bundle.padded_size + 2), alive=alive)
        res["losses"].append(float(m["loss"]))
        res["scales"].append(float(m["grad_scale"]))
        res["master"].append(state["master"].clone())
    res["params"] = [p.clone() for p in leaves(state["params"])]
    res["published"] = published if not leafwise else []
    return res


def _tp_fed(init, ring, tp):
    model = _model(init, tp)
    agg = make_aggregator("safe", N, weighted=True, device="cpu")
    bundle = make_federated_round(model, agg, ring, local_steps=FED_K, local_lr=LR,
                                  return_delta=True)
    toks, weights = _fed_inputs()
    params, m = bundle.round_fn(model.tree(), torch.from_numpy(toks[ring.rank]),
                                weights=weights, counter=FED_COUNTER, alive=FED_ALIVE)
    return {"delta": m["avg_delta"], "loss": float(m["local_loss"]),
            "params": [p.clone() for p in leaves(params)], "padded": bundle.padded_size}


def _mesh_groups(world):
    """The ('data', 'model') test mesh over the live group: its two
    dimensions' Worlds and, through them, each group's global ranks."""
    from repro_torch.dist import model_world_of, rank_world
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(N, M)
    data, model = rank_world(mesh, "data"), rank_world(mesh, "model")
    me = torch.tensor([world.rank])
    return {"data": (data.rank, data.size, collectives.all_gather(me, data).reshape(-1)),
            "model": (model.rank, model.size, collectives.all_gather(me, model).reshape(-1)),
            "model_world_of": model_world_of(mesh).size}


def _rank(world, init):
    ring, tp = grid_worlds(world, M)
    out = {"ring": (ring.rank, ring.size), "model": (tp.rank, tp.size)}
    out["mesh"] = _mesh_groups(world)
    out["grid"] = {"data": collectives.all_gather(torch.tensor([world.rank]), ring).reshape(-1),
                   "model": collectives.all_gather(torch.tensor([world.rank]), tp).reshape(-1)}
    out["ops"] = _operators(tp)
    out.update(_rounds(ring, tp))
    out["flat"] = _tp_steps(init, ring, tp, False)
    out["leafwise"] = _tp_steps(init, ring, tp, True)
    out["fed"] = _tp_fed(init, ring, tp)
    return out


# ---- the one-card port, the reference and the launcher -----------------------------------

def _one_card_steps(init, leafwise):
    model = _model(init)
    agg = make_aggregator("safe", N, device="cpu")
    bundle = make_train_step(model, agg, lr=LR, leafwise=leafwise)
    state = bundle.init_state_fn(model.tree())
    losses, scales = [], []
    for i, alive in enumerate(ALIVE):
        state, m = bundle.step_fn(state, torch.from_numpy(_tokens(i)),
                                  counter=i * (bundle.padded_size + 2), alive=alive)
        losses.append(float(m["loss"]))
        scales.append(float(m["grad_scale"]))
    return losses, scales, state["params"]


def _one_card_fed(init):
    model = _model(init)
    agg = make_aggregator("safe", N, weighted=True, device="cpu")
    bundle = make_federated_round(model, agg, local_steps=FED_K, local_lr=LR,
                                  return_delta=True)
    toks, weights = _fed_inputs()
    params, m = bundle.round_fn(model.tree(), torch.from_numpy(toks), weights=weights,
                                counter=FED_COUNTER, alive=FED_ALIVE)
    return m["avg_delta"], float(m["local_loss"]), params


LAUNCH = ["--arch", "internlm2-1.8b", "--smoke", "--seq-len", "32", "--learners", "2",
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
    step-1 checkpoint to step 2; C: a resume to step 4 of a checkpoint the
    one-process launcher wrote at step 3 after restoring A's step 2."""
    from repro_torch.launch.train import parse_args, run
    out = {"A": _launch(tmp / "A", 2, env)}
    shutil.copytree(tmp / "A" / "step_00000001", tmp / "B" / "step_00000001")
    out["B"] = _launch(tmp / "B", 2, env)
    shutil.copytree(tmp / "A" / "step_00000002", tmp / "C" / "step_00000002")
    threads = torch.get_num_threads()
    out["one"] = run(parse_args([*LAUNCH, "--steps", "3", "--ckpt-dir", str(tmp / "C")]))
    torch.set_num_threads(threads)
    out["C"] = _launch(tmp / "C", 4, env)
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
    """The reference, the launcher and the 8 ranks side by side."""
    tmp = tmp_path_factory.mktemp("dist_tp")
    init = _init_state()
    np.savez(tmp / "init.npz", **{k.replace(".", "/"): v.numpy() for k, v in init.items()})
    code = ("import sys; sys.path.insert(0, %r)\n" % os.path.join(REPO, "tests")
            + REF_CODE.replace("@INIT@", str(tmp / "init.npz"))
            .replace("@OUT@", str(tmp / "ref.npz")))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="2")
    with ThreadPoolExecutor(2) as pool:
        ref_run = pool.submit(run_multidevice, code, N * M, 600)
        launched = pool.submit(_launches, tmp, env)
        ranks = [r["result"] for r in spawn(_rank, N * M, "cpu", args=(init,),
                                            threads=THREADS)]
        assert "REF_OK" in ref_run.result()
        out = {"launch": launched.result()}
    out.update(ranks=ranks, init=init, ref=dict(np.load(tmp / "ref.npz")), tmp=tmp)
    return out


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _full_flat(res_params):
    """The full tree's flat vector from the shards of model ranks 0..M-1
    (``res_params[j]``: rank j's leaves)."""
    model = _model(_init_state())
    full = torch.zeros(tree_to_flat(model.tree()).numel())
    dims = tree_dims(model.tree(), _cfg(), M)
    for j in range(M):
        shards = shard_tree(model.tree(), _cfg(), j, M)
        for sh, x in zip(shard_layout(shards, dims, j, M), res_params[j]):
            full[sh.words()] = x.detach().reshape(-1).float()
    return full


# ---- (i) shards and the flat layout, in process -------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("m", [2, 4])
def test_shards_and_layout_match_tree_to_flat(arch, m):
    """Rank j's model (its own generator draws) holds ``shard_tree`` of the
    one-card model; each shard's words of the full ``tree_to_flat`` are its
    values; the shards cover every word once (a replicated leaf on every
    rank); ``convert.shard_model`` cuts the same shards from a state."""
    cfg = _dense_cfg(arch, vocab=511) if arch == "internvl2-1b" else _dense_cfg(arch)
    check_tp(cfg, m)  # 6 q heads over 4 shards: 2, 2, 1 and 1
    full = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    flat = tree_to_flat(full.tree())
    dims = tree_dims(full.tree(), cfg, m)
    seen = torch.zeros(flat.numel(), dtype=torch.int64)
    state = convert.model_params(cfg, _as_tree(full.tree()))
    for j in range(m):
        rank = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(1),
                     tp_world=World(rank=j, size=m, device=torch.device("cpu"),
                                    transport="gloo"))
        assert rank.tp_dims == dims
        want = leaves(shard_tree(full.tree(), cfg, j, m))
        got = leaves(rank.tree())
        assert [tuple(a.shape) for a in got] == [tuple(a.shape) for a in want]
        for a, b in zip(got, want):
            assert torch.equal(a.detach(), b.detach())
        for sh, x in zip(shard_layout(rank.tree(), dims, j, m), got):
            w = sh.words()
            assert torch.equal(flat[w], x.detach().reshape(-1).float())
            seen[w] += 1 if sh.dim is not None else (1 if j == 0 else 0)
        cut = convert.shard_model(cfg, state, j, m)
        for (path, x) in leaves_with_paths(rank.tree()):
            assert torch.equal(cut[path.replace("/", ".")], x.detach()), path
    assert bool((seen == 1).all())
    if arch == "internvl2-1b":  # the odd vocabulary splits by whole words, unevenly
        sp = dims[[p for p, _ in leaves_with_paths(full.tree())].index("embed")]
        assert [sp.size(m, j) for j in range(m)] == [unit_share(511, m, j)[1]
                                                     - unit_share(511, m, j)[0]
                                                     for j in range(m)]


def _as_tree(tree):
    return {k: (_as_tree(v) if isinstance(v, dict) else
                [_as_tree(b) for b in v] if isinstance(v, list) else v.detach().numpy())
            for k, v in tree.items()}


def test_a_split_that_cuts_a_head_raises_where_the_reference_cuts():
    """14 q heads of 64 at m = 4 (internvl2-1b): the columns (896) divide,
    the heads do not. The reference's ``sanitize_spec`` keeps 'model' on
    wq, so GSPMD cuts heads and reshards; the port no longer raises: it
    splits whole heads unevenly, 4, 4, 3 and 3, wo's rows with them, and
    keeps the 2 kv heads on every rank (m does not divide them)."""
    import repro  # noqa: F401 - the package's jax shims first
    import jax
    from repro.configs import get_config as ref_config
    from repro.models import Model as RefModel
    from repro.models.sharding import param_pspecs
    from repro_torch.configs import get_config
    cfg = get_config("internvl2-1b")
    assert cfg.n_heads == 14 and cfg.resolved_head_dim == 64
    ref_cfg = ref_config("internvl2-1b")
    abstract = jax.eval_shape(RefModel(ref_cfg).init, jax.random.key(0))
    specs = param_pspecs(ref_cfg, abstract, {"model": 4, "data": 1})
    assert tuple(specs["blocks"][0]["attn"]["wq"]) == (None, None, "model")
    check_tp(cfg, 4)
    meta = Model(cfg, device="meta")
    dims = dict(zip([p for p, _ in leaves_with_paths(meta.tree())],
                    tree_dims(meta.tree(), cfg, 4)))
    wq, wo = dims["blocks/0/attn/wq"], dims["blocks/0/attn/wo"]
    assert [wq.size(4, j) for j in range(4)] == [256, 256, 192, 192]
    assert [wo.size(4, j) for j in range(4)] == [256, 256, 192, 192]
    assert dims["blocks/0/attn/wk"] is None and dims["blocks/0/attn/wv"] is None
    check_tp(cfg, 2)  # 14 q heads and 2 kv heads split at m = 2


def test_refusals():
    """No split is refused (a head m does not divide splits whole, unevenly;
    the MoE, Mamba2, RWKV6 and zamba2 split: tests/test_torch_dist_tp_zoo.py),
    only a model axis of no rank, and a WORLD_SIZE that is not learners x
    model shards. Expert parallelism with pods on a model split over model
    ranks, once refused, builds its step (it runs in
    tests/test_torch_dist_pod_tp.py)."""
    from repro_torch.dist import Grid
    from repro_torch.launch.train import parse_args, run
    two = World(rank=0, size=2, device=torch.device("cpu"), transport="gloo")
    for arch in ("qwen3-moe-235b-a22b", "rwkv6-1.6b", "zamba2-2.7b"):
        Model(get_smoke_config(arch), device="meta", tp_world=two)
    # 5 q heads over 2 model shards: 3 and 2 (once refused as a cut head)
    odd = Model(get_smoke_config("llama4-maverick"), device="cpu", tp_world=two)
    assert odd.tree()["blocks"][0]["attn"]["wq"].shape[-1] == 3 * 64
    with pytest.raises(ValueError, match="a model axis holds at least one"):
        check_tp(_cfg(), 0)
    data = World(rank=0, size=N, device=torch.device("cpu"), transport="gloo")
    pod = World(rank=0, size=2, device=torch.device("cpu"), transport="gloo")
    agg = make_aggregator("safe", N, pod_axis="pod", device="cpu")
    moe = dataclasses.replace(get_smoke_config("qwen3-moe-235b-a22b"), ep_axis="data",
                              ep_ranks=N)
    bundle = make_train_step(Model(moe, device="meta", tp_world=two, ep_world=data), agg,
                             Grid(data=data, model=two, pod=pod), pod_axis="pod")
    assert bundle.padded_size % (2 * N * 2) == 0
    with pytest.raises(ValueError, match="the per-rank round needs the pod World"):
        make_train_step(Model(_cfg(), device="cpu", tp_world=two), agg, data, pod_axis="pod")
    with pytest.raises(ValueError, match="even length"):
        make_aggregator("safe", N, device="cpu").aggregate_rank(torch.zeros(7), world=data,
                                                               model_world=two)
    env = {"RANK": "0", "WORLD_SIZE": "6"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        for extra in (["--learners", "4", "--model-shards", "2"], ["--model-shards", "4"]):
            with pytest.raises(SystemExit, match="WORLD_SIZE must be learners x model shards"):
                run(parse_args(["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu",
                                *extra]))
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("start", [0, 2, 38, 2**31 + 2])
def test_moved_counter_base_is_the_pad_from_the_start_word(start):
    """What a chunk's round rests on, in the plain versions (the kernels'
    card cases are in tests/test_torch_cuda.py): for an even start word s,
    the counter base moved by s/2 gives the pads of words s, s + 1, ... of
    the whole vector, the 32-bit counter wrapping."""
    from repro_torch.kernels import ref
    x = torch.from_numpy(np.random.RandomState(5).uniform(-9, 9, 37).astype(np.float32))
    c = torch.from_numpy(np.random.RandomState(6).randint(0, 2**32, 37, dtype=np.uint64)
                         .astype(np.uint32))
    for base in (0, 2**32 - 5):
        moved = (base + start // 2) & 0xFFFFFFFF
        assert torch.equal(ref.mask_add_ref(x, [5, 6], moved),
                           ref.mask_add_ref(x, [5, 6], base, offset=start))
        assert torch.equal(ref.chain_combine_ref(c, x, [1, 2], [3, 4], moved),
                           ref.chain_combine_ref(c, x, [1, 2], [3, 4], base, offset=start))


def test_grid_is_the_reference_device_order(runs):
    """Rank l·m + j is learner l's model shard j: ``grid_worlds`` gives the
    ring of the ranks with the same j (rank l of it) and the model group of
    learner l's m consecutive ranks (rank j), as ``make_test_mesh(n, m)``'s
    'data' and 'model' dimensions over the live group do."""
    for r, res in enumerate(runs["ranks"]):
        l, j = divmod(r, M)
        assert res["ring"] == (l, N) and res["model"] == (j, M)
        ring = [q * M + j for q in range(N)]
        group = [l * M + q for q in range(M)]
        assert res["grid"]["data"].tolist() == ring and res["grid"]["model"].tolist() == group
        mesh = res["mesh"]
        assert mesh["data"][:2] == (l, N) and mesh["data"][2].tolist() == ring
        assert mesh["model"][:2] == (j, M) and mesh["model"][2].tolist() == group
        assert mesh["model_world_of"] == M


def test_dry_run_sizes_rank_zero_of_the_grid():
    """The dry run's ``--per-rank --model-shards 2``: rank 0 of the 4 x 2
    grid on meta tensors over a fake group of 8 holds half the parameters
    and half the optimizer state of one learner a rank's step."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    shape = dict(seq_len=S, global_batch=N * B, kind="train")
    try:
        one = dryrun.measure(_cfg(), "train_4k", shape=shape, learners=N, batch=B,
                             per_rank=True)
        tp = dryrun.measure(_cfg(), "train_4k", shape=shape, learners=N, batch=B,
                            per_rank=True, model_shards=M)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert tp["description"].startswith(f"train_step rank 0 of n={N} m={M}")
    for cat in ("parameters", "optimizer state"):
        assert tp["peak_by_category"][cat] < 0.6 * one["peak_by_category"][cat], cat
    assert tp["kernels"]["mask_add"]["calls"] >= 1


# ---- (ii) the operators --------------------------------------------------------------------

def test_operators_match_autograd_of_one_process(runs):
    x, a, e, b, c, d = (t.clone().requires_grad_(True) for t in _op_inputs())
    loss = _op_loss(x, a, e, b, c, d, None)
    loss.backward()
    k, r = 8 // M, 6 // M
    for res in runs["ranks"]:
        ops, j = res["ops"], res["model"][0]
        torch.testing.assert_close(ops["loss"], loss.detach(), rtol=1e-6, atol=0)
        # copy's backward sums the ranks' partial cotangents of x
        torch.testing.assert_close(ops["dx"], x.grad, rtol=1e-6, atol=1e-7)
        # gather's backward is this rank's slice (not summed m times)
        assert torch.equal(ops["da"][:, j * k:(j + 1) * k], a.grad[:, j * k:(j + 1) * k])
        assert not ops["da"][:, :j * k].any() and not ops["da"][:, (j + 1) * k:].any()
        # reduce's backward passes the cotangent: each rank's columns of e, and b's rows
        torch.testing.assert_close(ops["de"][:, j * r:(j + 1) * r], e.grad[:, j * r:(j + 1) * r],
                                   rtol=1e-6, atol=1e-7)
        assert not ops["de"][:, :j * r].any() and not ops["de"][:, (j + 1) * r:].any()
        assert torch.equal(ops["db"][j * r:(j + 1) * r], b.grad[j * r:(j + 1) * r])
        # a bf16 psum: the m bf16 partials summed in f32, rounded once
        parts = [((torch.arange(8) + q).to(torch.bfloat16) / 3) for q in range(M)]
        assert torch.equal(ops["bf16"], torch.stack(parts).float().sum(0).to(torch.bfloat16))


# ---- (iii) the sharded rounds --------------------------------------------------------------

@pytest.mark.parametrize("name", list(CELLS))
def test_sharded_round_is_the_one_card_rounds_words(runs, name):
    """Ring j publishes words [j·L, (j + 1)·L) of the one-card ``aggregate``
    of the same rows and of the reference's, bit for bit; its sequential
    and BON messages are those words of the whole vector's round (a
    weighted round's weight word rides with the last chunk)."""
    mode, akw, vals, kw = _round_args(name)
    want = make_aggregator(mode, N, device="cpu", **akw).aggregate(
        torch.from_numpy(vals), COUNTER, **kw)
    ref = runs["ref"]["round/" + name]
    np.testing.assert_array_equal(want.numpy(), ref)
    weighted = akw.get("weighted", False)
    for res in runs["ranks"]:
        j = res["model"][0]
        chunk = res["chunk/" + name]
        np.testing.assert_array_equal(chunk.numpy(), want[j * L:(j + 1) * L].numpy())
        if name not in SLICED_MESSAGES:
            continue
        sent, whole = res["sent/" + name], res["whole/" + name]
        assert len(sent) == len(whole) > 0
        end = (j + 1) * L + (1 if weighted and j == M - 1 else 0)
        for a, b in zip(sent, whole):
            assert torch.equal(a, b[j * L:end]), (name, res["ring"], j)


# ---- (iv) the train step and the FedAvg round ---------------------------------------------

def test_tp_step_agrees_with_one_card_and_reference(runs):
    """The TP step's losses, grad scales and parameters' change against the
    one-card port's and the reference's (4, 2) Auto-mesh step, within the
    f32 bounds; both model ranks of a learner agree, and every learner."""
    init = runs["init"]
    losses, scales, params = _one_card_steps(init, False)
    start = tree_to_flat(_model(init).tree()).numpy()
    want = tree_to_flat(params).numpy()
    ref = runs["ref"]
    got = _full_flat([runs["ranks"][j]["flat"]["params"] for j in range(M)]).numpy()
    for res in runs["ranks"]:
        np.testing.assert_allclose(res["flat"]["losses"], losses, rtol=LOSS_RTOL)
        np.testing.assert_allclose(res["flat"]["scales"], scales, rtol=SCALE_RTOL)
        np.testing.assert_allclose(res["flat"]["losses"], ref["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(res["flat"]["scales"], ref["grad_scale"], rtol=SCALE_RTOL)
        other = runs["ranks"][res["model"][0]]["flat"]["params"]
        for a, b in zip(res["flat"]["params"], other):  # every learner holds the same shards
            assert torch.equal(a, b)
    assert _rel_l2(got - start, want - start) <= REL_PARAMS
    assert _rel_l2(got - start, ref["params"] - start) <= REL_PARAMS
    assert runs["ranks"][0]["flat"]["losses"][1] < runs["ranks"][0]["flat"]["losses"][0]


def test_tp_zero1_is_flat_adamw_on_the_published_mean(runs):
    """ZeRO-1 over all n·m ranks: rank (l, j) holds part l of chunk j, and
    after each step it is, word for word, the one-card ``FlatAdamW`` update
    of the whole master vector by the published mean (the chunks of the
    model ranks joined)."""
    ranks = runs["ranks"]
    P = ranks[0]["flat"]["padded_size"]
    assert P == tp_padded_size(tree_to_flat(_model(runs["init"]).tree()).numel(), N, M)
    part = P // (N * M)

    def joined(key, step=None):
        out = torch.empty(P)
        for r, res in enumerate(ranks):
            l, j = divmod(r, M)
            x = res["flat"][key] if step is None else res["flat"][key][step]
            out[j * (P // M) + l * part:j * (P // M) + (l + 1) * part] = x
        return out

    master = joined("master0")
    want0 = torch.zeros(P)
    want0[:tree_to_flat(_model(runs["init"]).tree()).numel()] = \
        tree_to_flat(_model(runs["init"]).tree())
    assert torch.equal(master, want0)
    opt, state = FlatAdamW(lr=LR, weight_decay=0.1), AdamState(0, torch.zeros(P), torch.zeros(P))
    for step in range(len(ALIVE)):
        mean = torch.cat([ranks[j]["flat"]["published"][step] for j in range(M)])
        for res in ranks:  # every learner of ring j saw the same chunk
            assert torch.equal(res["flat"]["published"][step],
                               mean[res["model"][0] * (P // M):(res["model"][0] + 1) * (P // M)])
        master, state = opt.update(mean, state, master)
        assert torch.equal(joined("master", step), master), step


def test_tp_leafwise_agrees_with_one_card(runs):
    init = runs["init"]
    losses, scales, params = _one_card_steps(init, True)
    start = tree_to_flat(_model(init).tree()).numpy()
    got = _full_flat([runs["ranks"][j]["leafwise"]["params"] for j in range(M)]).numpy()
    for res in runs["ranks"]:
        np.testing.assert_allclose(res["leafwise"]["losses"], losses, rtol=LOSS_RTOL)
        np.testing.assert_allclose(res["leafwise"]["scales"], scales, rtol=SCALE_RTOL)
    assert _rel_l2(got - start, tree_to_flat(params).numpy() - start) <= REL_PARAMS


def test_tp_fedavg_round_agrees_with_one_card(runs):
    delta, loss, params = _one_card_fed(runs["init"])
    start = tree_to_flat(_model(runs["init"]).tree()).numpy()
    got = _full_flat([runs["ranks"][j]["fed"]["params"] for j in range(M)]).numpy()
    for res in runs["ranks"]:
        assert res["fed"]["padded"] % (2 * N * M) == 0
        np.testing.assert_allclose(res["fed"]["loss"], loss, rtol=LOSS_RTOL)
        assert _rel_l2(res["fed"]["delta"], delta) <= REL_PARAMS
    assert _rel_l2(got - start, tree_to_flat(params).numpy() - start) <= REL_PARAMS


# ---- (v) the launcher ---------------------------------------------------------------------

def test_launcher_checkpoints_restore_across_model_shards(runs):
    """2 learners x 2 model shards (BON): the resumed step-2 checkpoint is
    the uninterrupted run's word for word; that run's step-2 checkpoint
    restores in the one-process launcher, and the one-process step-3
    checkpoint in the model-sharded ranks."""
    from repro_torch.ckpt import latest_step, restore_checkpoint
    launch, tmp = runs["launch"], runs["tmp"]
    assert "learner 1 of 2 (WORLD_SIZE 4 / 2 model shards), model shard 1 of 2" in launch["A"]
    assert "resumed from step 1" in launch["B"] and "resumed from step 3" in launch["C"]
    assert latest_step(str(tmp / "C")) == 4
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
    c, _ = restore_checkpoint(str(tmp / "C"), 4, skeleton)
    assert c["step"] == 4 and c["master"].shape == skeleton["master"].shape
