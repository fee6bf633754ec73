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
from repro_torch.train import make_train_step, tree_to_flat
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
    """The f32 run (every case, and the SAFE-call data) and the bf16 run
    without excess precision (SAFE flat; keys "bfloat16-nx/"), side by
    side."""
    tmp = tmp_path_factory.mktemp("train_step_ref")
    runs = [("", RUNS, ("float32",), "", BIT_COUNTER_STEP, tmp / "ref.npz"),
            (NO_EXCESS, {"safe": RUNS["safe"]}, ("bfloat16",), "-nx", 0, tmp / "ref_nx.npz")]

    def run(prelude, cases, dtypes, tag, bits, path):
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


def _model(reference, run):
    """The port's model holding the initial weights of reference ``run``
    (a dtype, or "bfloat16-nx")."""
    cfg = _cfg(run.split("-")[0])
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
