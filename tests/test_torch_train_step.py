"""The PyTorch port's SAFE-aggregated train step against the JAX package's.

The JAX side runs ``train/train_step.py::make_train_step`` in a
subprocess on a (4, 1) ("data", "model") mesh of host devices whose axis
types are Auto: ``jax.make_mesh`` makes Explicit axes by default on this
jax, and the reference's sharding constraint (``train_step.py:201``) then
raises, but on Auto axes the step runs. At the smoke size of
internlm2-1.8b it takes three steps from the same initial weights for
each case below — SAFE flat, SAFE leafwise, INSEC, learner 1 dead, rank 0
(the initiator) dead — with the launcher's counters (step i at
i·(padded_size + 2)) and its token stream, and keeps the losses,
``grad_scale`` and final parameters. It also keeps each learner's flat,
padded gradient at the initial weights and the reference aggregator's
published mean of that matrix with the train step's rotation, for key
domain 0 and for every leaf's domain idx + 1. A second subprocess beside
it runs SAFE flat in bf16 with XLA's excess precision off (as the FedAvg
tests do: XLA then rounds after every bf16 operation, as PyTorch does).

Bit for bit: the SAFE call. To a tolerance, stated per test: the float
math of the whole step.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from helpers import run_multidevice
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import make_aggregator, make_round_keys
from repro_torch.data import make_federated_batches
from repro_torch.models import Model
from repro_torch.train import leaf_paths, make_train_step, tree_to_flat
from repro_torch.train.flatten import leaves

N, B, S, STEPS, LR = 4, 2, 32, 3, 1e-3
# case -> (aggregator mode, leafwise, alive bitmap)
RUNS = {"safe": ("safe", False, [1, 1, 1, 1]),
        "leafwise": ("safe", True, [1, 1, 1, 1]),
        "insec": ("insec", False, [1, 1, 1, 1]),
        "dead1": ("safe", False, [1, 0, 1, 1]),
        "dead0": ("safe", False, [0, 1, 1, 1])}
BIT_COUNTER_STEP = 2    # the SAFE call is checked at step 2's counter and rotation
BIT_ALIVE = ([1, 1, 1, 1], [1, 0, 1, 1])

REF_CODE = """
@PRELUDE@
import dataclasses
import repro  # the package's jax shims first
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, Mesh, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.core import make_aggregator
from repro.data import make_federated_batches
from repro.models import Model
from repro.train.flatten import tree_to_flat
from repro.train.loss import next_token_loss
from repro.train.train_step import make_train_step

N, B, S, STEPS, LR, RUNS, DTYPES, TAG, BITS = @ARGS@
mesh = jax.make_mesh((N, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {}
for dtype in DTYPES:
    pre = dtype + TAG
    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"), dtype=dtype)
    model = Model(cfg)
    stream = make_federated_batches(cfg, N, B, S, seed=0)
    toks = [stream.global_batch(i)["tokens"] for i in range(STEPS)]
    out["tokens"] = np.stack(toks)
    params0 = model.init(jax.random.key(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params0)[0]:
        a = np.asarray(leaf)
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[f"{pre}/init/{key}"] = a.view(np.uint16) if a.dtype.itemsize == 2 else a
    bundles = {}
    for run, (mode, leafwise, alive) in RUNS.items():
        if (mode, leafwise) not in bundles:
            bundles[mode, leafwise] = make_train_step(
                model, make_aggregator(mode, N, axis="data"), mesh, lr=LR, leafwise=leafwise)
        b = bundles[mode, leafwise]
        s = b.init_state_fn(model.init(jax.random.key(0)))
        W = b.padded_size + 2
        losses, scales = [], []
        for i in range(STEPS):
            s, m = b.step_fn(s, jnp.asarray(toks[i]), counter=i * W,
                             alive=jnp.asarray(alive, jnp.float32))
            losses.append(float(m["loss"]))
            scales.append(float(m["grad_scale"]))
        out[f"{pre}/{run}/loss"] = np.asarray(losses, np.float32)
        out[f"{pre}/{run}/grad_scale"] = np.asarray(scales, np.float32)
        out[f"{pre}/{run}/params"] = np.asarray(tree_to_flat(s["params"]))
    if not BITS:
        continue
    # each learner's flat, padded gradient at the initial weights
    b = bundles["safe", False]
    W = b.padded_size + 2
    def loss_fn(p, t):
        logits, aux = model.forward(p, t)
        return next_token_loss(logits, t, cfg.prefix_embeds) + aux
    grad = jax.jit(jax.grad(loss_fn))
    p0 = model.init(jax.random.key(0))
    mat = np.zeros((N, b.padded_size), np.float32)
    for l in range(N):
        mat[l, :b.sec_size] = np.asarray(tree_to_flat(grad(p0, jnp.asarray(toks[0][l]))))
    out["grads"] = mat
    counter, sizes = BITS * W, [int(np.prod(x.shape)) for x in jax.tree.leaves(p0)]
    rotate = counter % (2 * N + 1)
    mesh1 = Mesh(np.array(jax.devices()[:N]), ("data",))
    agg = make_aggregator("safe", N, axis="data")
    def pr(v, a, c, d, r):
        return agg.aggregate(v.reshape(-1), c, alive=a, domain=d, rotate=r)
    f = jax.jit(jax.shard_map(pr, mesh=mesh1, in_specs=(P("data"), P(), P(), P(), P()),
                              out_specs=P(), axis_names=frozenset({"data"}), check_vma=False))
    args = (jnp.uint32(counter), jnp.uint32(0), jnp.int32(rotate))
    for j, alive in enumerate(@BIT_ALIVE@):
        a = jnp.asarray(alive, jnp.float32)
        with jax.set_mesh(mesh1):
            out[f"bit/flat/{j}"] = np.asarray(f(jnp.asarray(mat), a, *args))
            off = 0
            for idx, size in enumerate(sizes):
                out[f"bit/leaf{idx}/{j}"] = np.asarray(f(
                    jnp.asarray(mat[:, off:off + size]), a, jnp.uint32(counter),
                    jnp.uint32(idx + 1), jnp.int32(rotate)))
                off += size
np.savez("@OUT@", **out)
print("REF_OK")
"""

# The rest of the zoo through the same step, f32 at the smoke size: the MoE
# (qwen3-moe) by expert parallelism over the four learners, two steps;
# zamba2 (Mamba2 + shared attention) and rwkv6, one step each.
ZOO = {"qwen3-moe-235b-a22b": ({"ep_axis": "data", "ep_ranks": N}, 2),
       "zamba2-2.7b": ({}, 1), "rwkv6-1.6b": ({}, 1)}

ZOO_CODE = """
import dataclasses
import repro  # the package's jax shims first
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.core import make_aggregator
from repro.data import make_federated_batches
from repro.models import Model
from repro.train.flatten import is_expert_path, partition_tree, tree_to_flat
from repro.train.train_step import make_train_step

N, B, S, LR, ZOO = @ARGS@
mesh = jax.make_mesh((N, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {}

def path_str(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)

for arch, (kw, steps) in ZOO.items():
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)
    model = Model(cfg)
    stream = make_federated_batches(cfg, N, B, S, seed=0)
    params0 = model.init(jax.random.key(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params0)[0]:
        out[f"{arch}/init/{path_str(path)}"] = np.asarray(leaf)
    sec, ep = partition_tree(params0, lambda p: not is_expert_path(p))
    out[f"{arch}/ep_paths"] = np.asarray([path_str(p) for p, _ in
                                          jax.tree_util.tree_flatten_with_path(ep)[0]])
    b = make_train_step(model, make_aggregator("safe", N, axis="data"), mesh, lr=LR)
    s = b.init_state_fn(model.init(jax.random.key(0)))
    W = b.padded_size + 2
    losses, scales = [], []
    for i in range(steps):
        s, m = b.step_fn(s, jnp.asarray(stream.global_batch(i)["tokens"]), counter=i * W)
        losses.append(float(m["loss"]))
        scales.append(float(m["grad_scale"]))
    out[f"{arch}/loss"] = np.asarray(losses, np.float32)
    out[f"{arch}/grad_scale"] = np.asarray(scales, np.float32)
    out[f"{arch}/sec_size"] = np.asarray(b.sec_size)
    for path, leaf in jax.tree_util.tree_flatten_with_path(s["params"])[0]:
        out[f"{arch}/final/{path_str(path)}"] = np.asarray(leaf)
    if s["ep_opt"] is not None:
        out[f"{arch}/ep_step"] = np.asarray(s["ep_opt"].step)
        out[f"{arch}/ep_m"] = np.asarray(tree_to_flat(s["ep_opt"].m))
        out[f"{arch}/ep_v"] = np.asarray(tree_to_flat(s["ep_opt"].v))
np.savez("@OUT@", **out)
print("REF_OK")
"""


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs test files in parallel
    processes, and several processes' full sets of spinning OpenMP threads
    on the same cores slow every file down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


NO_EXCESS = ('import os; os.environ["XLA_FLAGS"] += '
             '" --xla_allow_excess_precision=false"')


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The f32 run (every case, and the SAFE-call data), the bf16 run
    without excess precision (SAFE flat; keys "bfloat16-nx/") and the zoo's
    steps (keys "<arch>/"), side by side."""
    tmp = tmp_path_factory.mktemp("train_step_ref")
    runs = [("", RUNS, ("float32",), "", BIT_COUNTER_STEP, tmp / "ref.npz"),
            (NO_EXCESS, {"safe": RUNS["safe"]}, ("bfloat16",), "-nx", 0, tmp / "ref_nx.npz"),
            (None, None, None, None, None, tmp / "ref_zoo.npz")]

    def run(prelude, cases, dtypes, tag, bits, path):
        if prelude is None:  # the zoo: its keys start with the arch id
            code = (ZOO_CODE.replace("@ARGS@", repr((N, B, S, LR, ZOO)))
                    .replace("@OUT@", str(path)))
        else:
            args = repr((N, B, S, STEPS, LR, cases, dtypes, tag, bits))
            code = (REF_CODE.replace("@PRELUDE@", prelude).replace("@ARGS@", args)
                    .replace("@BIT_ALIVE@", repr(BIT_ALIVE)).replace("@OUT@", str(path)))
        assert "REF_OK" in run_multidevice(code, devices=N, timeout=900)
        return dict(np.load(path))

    with ThreadPoolExecutor(len(runs)) as pool:
        parts = list(pool.map(lambda a: run(*a), runs))
    return {k: v for part in parts for k, v in part.items()}


def _cfg(dtype):
    return dataclasses.replace(get_smoke_config("internlm2-1.8b"), dtype=dtype)


def _model(reference, run, cfg=None):
    """The port's model holding the initial weights the reference saved
    under "<run>/init/" (run: a dtype, "bfloat16-nx", or a zoo arch with
    its ``cfg``)."""
    cfg = cfg or _cfg(run.split("-")[0])
    prefix = f"{run}/init/"
    tree = {}
    for key, a in reference.items():
        if key.startswith(prefix):
            node, parts = tree, key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = a
    tree["blocks"] = [tree["blocks"][str(i)] for i in range(len(tree["blocks"]))]
    model = Model(cfg, device="cpu")
    model.load_state_dict(convert.model_params(cfg, tree))
    return model


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _run_port(reference, run, case, steps=STEPS, tokens=None):
    """The port's steps of ``case`` from reference ``run``'s initial
    weights: (losses, grad_scales, final flat parameters, initial flat)."""
    mode, leafwise, alive = RUNS[case]
    model = _model(reference, run)
    agg = make_aggregator(mode, N, device="cpu")
    bundle = make_train_step(model, agg, lr=LR, leafwise=leafwise)
    state = bundle.init_state_fn(model.tree())
    init = tree_to_flat(state["params"]).numpy().copy()
    toks = reference["tokens"] if tokens is None else tokens
    losses, scales = [], []
    for i in range(steps):
        state, m = bundle.step_fn(state, torch.from_numpy(toks[i % len(toks)]),
                                  counter=agg.reserve_round(bundle.padded_size + 2),
                                  alive=alive)
        assert set(m) == {"loss", "grad_scale", "weight"} and float(m["weight"]) == 1.0
        losses.append(float(m["loss"]))
        scales.append(float(m["grad_scale"]))
    return np.asarray(losses), np.asarray(scales), tree_to_flat(state["params"]).numpy(), init


def test_token_stream_identical(reference):
    stream = make_federated_batches(_cfg("float32"), N, B, S, seed=0)
    np.testing.assert_array_equal(
        np.stack([stream.global_batch(i)["tokens"] for i in range(STEPS)]), reference["tokens"])


def test_sizes_match_reference(reference):
    bundle = make_train_step(_model(reference, "float32"), make_aggregator("safe", N, device="cpu"))
    assert bundle.sec_size == bundle.padded_size == reference["grads"].shape[1]
    assert bundle.leafwise is False
    assert make_train_step(_model(reference, "float32"), make_aggregator("safe", 3, device="cpu")
                           ).padded_size % 3 == 0


@pytest.mark.parametrize("j", range(len(BIT_ALIVE)))
def test_safe_call_bit_identical(reference, j):
    """For the reference's flat, padded gradient matrix, at step 2's
    counter and the step's rotation counter % (2n + 1), the port's
    published mean equals the reference aggregator's bit for bit: the
    flat vector in key domain 0, and every leaf in its domain idx + 1. (The
    pads cancel in the mean; the next test checks which keys mask it.)"""
    mat = reference["grads"]
    agg = make_aggregator("safe", N, device="cpu")
    counter = BIT_COUNTER_STEP * (mat.shape[1] + 2)
    rotate = counter % (2 * N + 1)
    got = agg.aggregate(torch.from_numpy(mat), counter, alive=BIT_ALIVE[j], rotate=rotate)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  reference[f"bit/flat/{j}"].view(np.uint32))
    sizes = [t.numel() for t in leaves(_model(reference, "float32").tree())]
    off = 0
    for idx, size in enumerate(sizes):
        got = agg.aggregate(torch.from_numpy(mat[:, off:off + size]), counter,
                            alive=BIT_ALIVE[j], domain=idx + 1, rotate=rotate)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      reference[f"bit/leaf{idx}/{j}"].view(np.uint32))
        off += size


def test_aggregate_derives_the_domains_keys(monkeypatch):
    """The published mean does not depend on the pads (they cancel), so the
    bit-for-bit test above cannot see which keys masked it: each mode's
    aggregate must derive its round keys in the domain it is given."""
    from repro_torch.core import aggregators
    seen = []
    real = aggregators.make_round_keys

    def spy(*args):
        seen.append(args[4] if len(args) > 4 else 0)
        return real(*args)

    monkeypatch.setattr(aggregators, "make_round_keys", spy)
    vals = torch.from_numpy(np.random.RandomState(3).uniform(-1, 1, (N, 64)).astype(np.float32))
    for kw in ({}, {"pipelined": True}, {"mode": "bon"}):
        seen.clear()
        agg = make_aggregator(kw.pop("mode", "safe"), N, device="cpu", **kw)
        for domain in (0, 1, 7):
            agg.aggregate(vals, 5, domain=domain, rotate=2)
        assert seen == [0, 1, 7]


@pytest.mark.parametrize("domain", [0, 1, 11, 2**32 - 2])
def test_round_keys_per_domain(domain):
    """Every rank's keys of a domain equal the reference's, and domains
    differ from each other."""
    import jax.numpy as jnp
    from repro.core import make_round_keys as ref_keys
    mine = make_round_keys(0xC0FFEE, 0x5EED, 11, N, domain)
    for r in range(N):
        want = ref_keys(0xC0FFEE, 0x5EED, 11, rank=jnp.uint32(r), domain=domain)
        np.testing.assert_array_equal(np.asarray(mine.provisioning_seed),
                                      np.asarray(want.provisioning_seed))
        np.testing.assert_array_equal(np.asarray(mine.learner_seed[r]),
                                      np.asarray(want.learner_seed))
    other = make_round_keys(0xC0FFEE, 0x5EED, 11, N, domain + 1)
    assert not np.array_equal(np.asarray(other.provisioning_seed),
                              np.asarray(mine.provisioning_seed))
    assert not np.array_equal(np.asarray(other.learner_seed), np.asarray(mine.learner_seed))


def test_step_calls_aggregate_as_reference(reference):
    """The step hands the aggregator its [n, padded_size] gradient matrix
    (its pad zero) with the step's counter, alive and rotation; leafwise,
    one call a leaf with domain idx + 1."""
    calls = []

    class Spy:
        def __init__(self, agg):
            self.agg, self.cfg = agg, agg.cfg

        def aggregate(self, values, counter_base=0, alive=None, weights=None, domain=0,
                      rotate=0):
            calls.append((tuple(values.shape), counter_base, domain, rotate, weights,
                          list(alive)))
            return self.agg.aggregate(values, counter_base, alive=alive, domain=domain,
                                      rotate=rotate)

    for leafwise in (False, True):
        calls.clear()
        model = _model(reference, "float32")
        bundle = make_train_step(model, Spy(make_aggregator("safe", N, device="cpu")),
                                 leafwise=leafwise)
        state = bundle.init_state_fn(model.tree())
        bundle.step_fn(state, reference["tokens"][0], counter=2**32 + 1234, alive=[1, 0, 1, 1])
        rot = 1234 % (2 * N + 1)
        if not leafwise:
            assert calls == [((N, bundle.padded_size), 1234, 0, rot, None, [1, 0, 1, 1])]
        else:
            sizes = [t.numel() for t in leaves(model.tree())]
            assert calls == [((N, s), 1234, i + 1, rot, None, [1, 0, 1, 1])
                             for i, s in enumerate(sizes)]


# f32 bounds, port against reference after three steps. Measured: the
# losses agree to 3.0e-7 relative at worst, grad_scale to 3.3e-6, and the
# parameters' change from the initial weights to a relative L2 of 1.3e-4
# (SAFE flat and leafwise), 9.1e-5 (INSEC), 8.8e-4 (learner 1 dead) and
# 1.2e-3 (rank 0 dead). The bounds sit above those by 3x to 7x.
LOSS_RTOL, SCALE_RTOL = 1e-6, 1e-5
REL_PARAMS = {"safe": 1e-3, "leafwise": 1e-3, "insec": 1e-3, "dead1": 5e-3, "dead0": 5e-3}


@pytest.mark.parametrize("case", list(RUNS))
def test_steps_match_reference_f32(reference, case):
    losses, scales, params, init = _run_port(reference, "float32", case)
    pre = f"float32/{case}"
    assert np.isfinite(params).all()
    np.testing.assert_allclose(losses, reference[f"{pre}/loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(scales, reference[f"{pre}/grad_scale"], rtol=SCALE_RTOL)
    e = _rel_l2(params - init, reference[f"{pre}/params"] - init)
    assert e <= REL_PARAMS[case], e
    assert losses[-1] < losses[0]


def test_safe_matches_insec_in_port(reference):
    """The port alone: SAFE and INSEC from the same weights on one
    repeated batch for four steps (tests/test_train.py's shape) — the loss
    falls, and the two runs' losses agree within 5e-3 (that test's
    bound)."""
    toks = reference["tokens"][:1]
    safe = _run_port(reference, "float32", "safe", steps=4, tokens=toks)[0]
    insec = _run_port(reference, "float32", "insec", steps=4, tokens=toks)[0]
    assert safe[-1] < safe[0]
    assert np.max(np.abs(safe - insec)) < 5e-3, (safe, insec)


def test_steps_match_reference_bf16(reference):
    """bf16, held against the reference run without excess precision
    (XLA rounding after every operation, as PyTorch does). Measured: losses
    1.6e-5 relative, grad_scale 8.1e-4, the parameters' change 6.5e-2
    relative L2. The JAX package against itself, excess precision on and
    off, reads 7.1e-5, 1.5e-4 and 4.4e-2 on the same three steps: bf16's
    first AdamW step turns a one-ulp gradient difference near zero into a
    whole ±lr. Bounds: 1e-4, 5e-3 and 0.1."""
    losses, scales, params, init = _run_port(reference, "bfloat16-nx", "safe")
    pre = "bfloat16-nx/safe"
    assert np.isfinite(params).all()
    np.testing.assert_allclose(losses, reference[f"{pre}/loss"], rtol=1e-4)
    np.testing.assert_allclose(scales, reference[f"{pre}/grad_scale"], rtol=5e-3)
    e = _rel_l2(params - init, reference[f"{pre}/params"] - init)
    assert e <= 0.1, e


def test_pod_axis_step(reference):
    """With the aggregator's pod axis the step takes [P·n, B, S] tokens and
    aggregates f32[P, n, padded_size]. Two pods on the same batch publish
    the one-pod mean, so the state after the step is bit-identical to the
    flat step's."""
    toks = reference["tokens"][0]
    states = {}
    for pods, kw in ((1, {}), (2, {"pod_axis": "pod"})):
        model = _model(reference, "float32")
        agg = make_aggregator("safe", N, device="cpu", **kw)
        bundle = make_train_step(model, agg, lr=LR, pod_axis=kw.get("pod_axis"))
        state, m = bundle.step_fn(bundle.init_state_fn(model.tree()),
                                  np.concatenate([toks] * pods), counter=5)
        states[pods] = (state, float(m["loss"]))
    (flat, l1), (pod, l2) = states[1], states[2]
    assert l1 == l2
    for key in ("master", "fm", "fv"):
        assert torch.equal(flat[key], pod[key]), key
    with pytest.raises(ValueError, match="tokens"):
        make_train_step(_model(reference, "float32"),
                        make_aggregator("safe", N, device="cpu", pod_axis="pod")
                        ).step_fn(flat, toks[:3], counter=5)


# ---- the rest of the zoo: expert parallelism, Mamba2 + shared attention, RWKV6 --------

def _zoo_model(reference, arch):
    """The port's smoke model of ``arch`` (f32, with ZOO's options) holding
    the reference's initial weights."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **ZOO[arch][0])
    return _model(reference, arch, cfg)


def _zoo_port(reference, arch):
    """(losses, grad_scales, {path: initial leaf}, {path: final leaf}, state,
    bundle) of the port's steps from the reference's weights, on the
    reference's token stream, counters from ``reserve_round``."""
    model = _zoo_model(reference, arch)
    agg = make_aggregator("safe", N, device="cpu")
    bundle = make_train_step(model, agg, lr=LR)
    state = bundle.init_state_fn(model.tree())
    init = {p: t.detach().clone() for p, t in zip(leaf_paths(model.tree()), leaves(model.tree()))}
    stream = make_federated_batches(model.cfg, N, B, S, seed=0)
    losses, scales = [], []
    for i in range(ZOO[arch][1]):
        state, m = bundle.step_fn(state, stream.global_batch(i)["tokens"],
                                  counter=agg.reserve_round(bundle.padded_size + 2))
        losses.append(float(m["loss"]))
        scales.append(float(m["grad_scale"]))
    final = dict(zip(leaf_paths(state["params"]), leaves(state["params"])))
    return np.asarray(losses), np.asarray(scales), init, final, state, bundle


def _change(final, init, reference, arch, paths):
    """Relative L2 of the port's parameter change against the reference's,
    over ``paths`` as one vector."""
    got = np.concatenate([(final[p] - init[p]).numpy().ravel() for p in paths])
    want = np.concatenate([(reference[f"{arch}/final/{p}"] - init[p].numpy()).ravel()
                           for p in paths])
    return _rel_l2(got, want)


# f32 bounds of the zoo's steps against the reference. Measured: losses
# 7.5e-8 relative at worst, grad_scale 3.4e-7, the SAFE partition's change
# 1.3e-3 (qwen3-moe, zamba2) and 2.0e-3 (rwkv6) relative L2, the experts'
# change 8.2e-5 and their second moment 3.4e-5. A first AdamW step moves
# each word by about ±lr whatever its gradient's size, so a gradient near
# zero that differs by an ulp moves its word the other way: one step reads
# more than internlm2's three (1.3e-4). The bounds sit 2.5x to 6x above.
ZOO_LOSS_RTOL, ZOO_SCALE_RTOL, ZOO_REL_SEC, ZOO_REL_EP = 1e-6, 1e-5, 5e-3, 5e-4


@pytest.mark.parametrize("arch", list(ZOO))
def test_zoo_steps_match_reference_f32(reference, arch):
    """qwen3-moe by expert parallelism (two steps), zamba2 and rwkv6 (one
    step each) against the reference's step on a (4, 1) Auto mesh from the
    same weights and tokens: the losses, grad_scale and the change of the
    SAFE partition's parameters, and for the MoE the change of the expert
    matrices. Every leaf is present and updated; the MoE keeps all 15."""
    losses, scales, init, final, state, bundle = _zoo_port(reference, arch)
    np.testing.assert_allclose(losses, reference[f"{arch}/loss"], rtol=ZOO_LOSS_RTOL)
    np.testing.assert_allclose(scales, reference[f"{arch}/grad_scale"], rtol=ZOO_SCALE_RTOL)
    ref_paths = sorted(k[len(f"{arch}/final/"):] for k in reference
                       if k.startswith(f"{arch}/final/"))
    assert sorted(final) == ref_paths == sorted(init)
    ep_paths = list(reference[f"{arch}/ep_paths"])
    sec_paths = [p for p in final if p not in ep_paths]
    assert bundle.sec_size == int(reference[f"{arch}/sec_size"])
    assert _change(final, init, reference, arch, sec_paths) <= ZOO_REL_SEC
    for p in final:  # every leaf moves (the placeholder, zero, only by decay of 0)
        if not p.endswith("_shared") and not (arch.startswith("zamba2") and "ln2" in p):
            assert not torch.equal(final[p], init[p]), p
    if ep_paths:
        assert len(final) == 15 and sorted(ep_paths) == sorted(
            p for p in final if p.rsplit("/", 1)[-1] in ("wi", "wg", "wo") and "moe/" in p)
        assert _change(final, init, reference, arch, ep_paths) <= ZOO_REL_EP
        ep = state["ep_opt"]
        assert int(ep.step) == int(reference[f"{arch}/ep_step"]) == ZOO[arch][1]
        assert _rel_l2(tree_to_flat(ep.v).numpy(), reference[f"{arch}/ep_v"]) <= ZOO_REL_EP
    else:
        assert state["ep_opt"] is None


def test_moe_without_ep_axis_refused():
    """A MoE with no ep_axis: the reference's step would drop its expert
    leaves (and fail at the next step); the port refuses it."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-235b-a22b"), dtype="float32")
    with pytest.raises(ValueError, match="ep_axis"):
        make_train_step(Model(cfg, device="cpu"), make_aggregator("safe", N, device="cpu"))


def test_ep_step_sums_expert_gradients():
    """The expert update is a tree AdamW (no clip) of the SUM over the
    learners of their expert gradients, dead learners included (alive
    touches SAFE alone): a learner marked dead changes the SAFE partition's
    update but not the experts'."""
    from repro_torch.optim import AdamW
    from repro_torch.train.flatten import is_expert_path
    from repro_torch.train.loss import next_token_loss
    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-235b-a22b"), dtype="float32",
                              ep_axis="data", ep_ranks=N)
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (N, B, 16)).astype(np.int32)
    model = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    paths = leaf_paths(model.tree())
    ep_idx = [i for i, p in enumerate(paths) if is_expert_path(p)]
    plist = leaves(model.tree())
    total = [torch.zeros_like(plist[i]) for i in ep_idx]
    for l in range(N):
        t = torch.from_numpy(toks[l])
        logits, aux = model.apply(model.tree(), t)
        g = torch.autograd.grad(next_token_loss(logits, t) + aux, [plist[i] for i in ep_idx])
        for acc, gi in zip(total, g):
            acc += gi
    opt = AdamW(lr=LR, weight_decay=0.1, grad_clip=None)
    ep_params = [plist[i].detach() for i in ep_idx]
    want, _ = opt.update(total, opt.init(ep_params), ep_params)
    out = {}
    for alive in ([1, 1, 1, 1], [1, 0, 1, 1]):
        bundle = make_train_step(model, make_aggregator("safe", N, device="cpu"), lr=LR,
                                 donate=False)
        state, _ = bundle.step_fn(bundle.init_state_fn(model.tree()), toks, counter=7,
                                  alive=alive)
        out[tuple(alive)] = [leaves(state["params"])[i] for i in ep_idx], state["master"]
    for got in (out[1, 1, 1, 1][0], out[1, 0, 1, 1][0]):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)
    assert not torch.equal(out[1, 1, 1, 1][1], out[1, 0, 1, 1][1])


def test_partition_round_trip():
    """partition_tree / combine_trees split and rebuild the tree leaf for
    leaf, with the reference's expert paths: the per-expert matrices, not
    the router or the shared experts."""
    import jax
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import Model as RefModel
    from repro.train.flatten import is_expert_path as ref_is_expert
    from repro.train.flatten import partition_tree as ref_partition
    from repro_torch.train.flatten import combine_trees, is_expert_path, partition_tree
    for arch in ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"):
        tree = Model(get_smoke_config(arch), device="cpu").tree()
        ep, rest = partition_tree(tree, is_expert_path)
        ref = RefModel(ref_smoke(arch)).init(jax.random.key(0))
        ref_ep, ref_rest = ref_partition(ref, ref_is_expert)
        for mine, theirs in ((ep, ref_ep), (rest, ref_rest)):
            got = leaf_paths(mine)
            want = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
                    for path, _ in jax.tree_util.tree_flatten_with_path(theirs)[0]]
            assert got == want
        assert all(p.rsplit("/", 1)[-1] in ("wi", "wg", "wo") for p in leaf_paths(ep))
        assert any("router" in p for p in leaf_paths(rest))
        back = combine_trees(ep, rest)
        assert leaf_paths(back) == leaf_paths(tree)
        assert all(a is b for a, b in zip(leaves(back), leaves(tree)))
