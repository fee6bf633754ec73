"""The PyTorch port's FedAvg round against the JAX package's.

The JAX side runs ``train/federated.py::make_federated_round`` (weighted
SAFE, ``return_delta=True``) for two rounds on a fully manual ("data",)
mesh of four host devices in a subprocess, at the smoke size of
internlm2-1.8b, in f32 and in bf16; round 1 runs with learner 1 dead.
Before each round it also computes every learner's delta with
``jax.jit(make_local_update(...))``. Everything goes into one npz (bf16
leaves as their uint16 bits), shared by the tests of this file. A second
subprocess, beside the first, runs the bf16 case again with XLA's excess
precision switched off (``--xla_allow_excess_precision=false``): XLA then
rounds to bf16 after every operation, as PyTorch does, so that run is
what the port's bf16 float math is held against.

What must be equal bit for bit: the aggregate-and-apply step fed the
reference's own deltas (the ring is exact), ``apply_delta``, the token
batches, and the wire round (``make_wire_federated``'s callables through
the port's broker, and their deltas through the reference's) against the
in-process ``round_fn``. What is held to a tolerance: the float math of the local update
and of the whole round (relative L2 over the flat vector; each test
states its measured margin).

The tests live here and run from two files, so that two of the suite's
workers share them: ``test_torch_federated.py`` (f32, the token batches and
the wire rounds) and ``test_torch_federated_bf16.py`` (bf16 and the
reference's bf16 noise floor). Each file's ``reference`` fixture runs only
the reference runs its tests read (``reference_runs``), and its ``dtype``
fixture gives its dtype.
"""
import asyncio
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _torch_threads import _few_threads  # noqa: F401
from helpers import run_multidevice
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import make_aggregator
from repro_torch.data import make_federated_batches
from repro_torch.models import Model
from repro_torch.train import (apply_delta, flat_to_tree, make_federated_round,
                               make_local_update, make_wire_federated, tree_to_flat)
from repro_torch.train.flatten import leaves

N, K, B, S, ROUNDS, LR = 4, 2, 2, 32, 2, 1e-3
ALIVE = ([1.0, 1.0, 1.0, 1.0], [1.0, 0.0, 1.0, 1.0])  # round r's alive bitmap
# The reference run each dtype's float math is held against: f32 the
# plain run, bf16 the run without XLA's excess precision.
FLOAT_REF = {"float32": "float32", "bfloat16": "bfloat16-nx"}
# Relative L2 bounds of the float math. f32: the local update's delta
# agrees to 9.1e-5 (measured), under 1e-4. bf16: a delta after two AdamW
# steps is about lr times the signs of the gradients, rounded to the bf16
# grid of the parameter, so one bf16 ulp of difference in a gradient near
# zero flips a whole element. That sets a floor no bf16 port goes under:
# the JAX package differs from itself by 8.5e-2 to 8.8e-2 when only its
# excess precision is switched (test_bf16_reference_noise). Against the
# run without it the port reads 7.9e-2 to 8.3e-2 (local update and
# round); copies of the port with one bf16 fault read more: the softmax
# kept in f32 8.9e-2 to 9.4e-2, ``1.0 + scale`` promoted to f32 0.10 to
# 0.105 (each fails test_local_update_matches on every learner). The
# bound lies between.
REL_L2 = {"float32": 1e-4, "bfloat16": 0.087}

REF_CODE = """
@PRELUDE@
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.core import make_aggregator
from repro.data import make_federated_batches
from repro.models import Model
from repro.train.federated import make_federated_round, make_local_update
from repro.train.flatten import tree_size, tree_to_flat

N, K, B, S, ROUNDS, LR, ALIVE, DTYPES, TAG = @ARGS@
mesh = Mesh(np.array(jax.devices()[:N]), ("data",))  # fully manual
out = {}
for dtype in DTYPES:
    pre = dtype + TAG
    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"), dtype=dtype)
    stream = make_federated_batches(cfg, N, B, S, seed=0)
    toks = np.stack([np.stack([stream.learner_batch(l, k)["tokens"]
                               for k in range(K)]) for l in range(N)])
    w = stream.global_batch(0)["weights"]
    out["tokens"], out["weights"] = toks, w
    model = Model(cfg)
    agg = make_aggregator("safe", N, axis="data", weighted=True)
    bundle = make_federated_round(model, agg, mesh, local_steps=K, local_lr=LR,
                                  return_delta=True)
    local = jax.jit(make_local_update(model, local_steps=K, local_lr=LR))
    params = model.init(jax.random.key(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        a = np.asarray(leaf)
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[f"{pre}/init/{key}"] = a.view(np.uint16) if a.dtype.itemsize == 2 else a
    W = tree_size(params) + 1  # counter words a weighted round consumes
    for r in range(ROUNDS):
        out[f"{pre}/r{r}/params"] = np.asarray(tree_to_flat(params))
        d = [local(params, jnp.asarray(toks[l])) for l in range(N)]
        out[f"{pre}/r{r}/deltas"] = np.stack([np.asarray(x[0]) for x in d])
        out[f"{pre}/r{r}/losses"] = np.asarray([float(x[1]) for x in d], np.float32)
        params, m = bundle.round_fn(params, jnp.asarray(toks), weights=jnp.asarray(w),
                                    counter=r * W,
                                    alive=jnp.asarray(ALIVE[r], jnp.float32))
        for k, v in m.items():
            out[f"{pre}/r{r}/{k}"] = np.asarray(v)
        out[f"{pre}/r{r}/new_params"] = np.asarray(tree_to_flat(params))
np.savez("@OUT@", **out)
print("REF_OK")
"""


NO_EXCESS = ('import os; os.environ["XLA_FLAGS"] += '
             '" --xla_allow_excess_precision=false"')


#: the reference runs: the plain run of a dtype, and the bf16 run without
#: excess precision, whose keys start "bfloat16-nx/"
PLAIN_F32 = ("", ("float32",), "")
PLAIN_BF16 = ("", ("bfloat16",), "")
BF16_NX = (NO_EXCESS, ("bfloat16",), "-nx")


def reference_runs(tmp_path_factory, runs):
    """The reference ``runs`` (of PLAIN_F32, PLAIN_BF16, BF16_NX) side by
    side, their arrays in one dict."""
    tmp = tmp_path_factory.mktemp("fed_ref")
    runs = [(prelude, dtypes, tag, tmp / f"ref{i}.npz")
            for i, (prelude, dtypes, tag) in enumerate(runs)]

    def run(prelude, dtypes, tag, path):
        args = repr((N, K, B, S, ROUNDS, LR, ALIVE, dtypes, tag))
        code = (REF_CODE.replace("@PRELUDE@", prelude).replace("@ARGS@", args)
                .replace("@OUT@", str(path)))
        assert "REF_OK" in run_multidevice(code, devices=N, timeout=600)
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


def _params_at(reference, model, run, r):
    """Reference ``run``'s parameters before round r, as a port tree."""
    return flat_to_tree(torch.from_numpy(reference[f"{run}/r{r}/params"]), model.tree())


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_token_batches_identical(reference):
    stream = make_federated_batches(_cfg("float32"), N, B, S, seed=0)
    toks = np.stack([np.stack([stream.learner_batch(l, k)["tokens"] for k in range(K)])
                     for l in range(N)])
    np.testing.assert_array_equal(toks, reference["tokens"])
    np.testing.assert_array_equal(stream.global_batch(0)["weights"], reference["weights"])


def test_converted_weights_bit_identical(reference, dtype):
    model = _model(reference, dtype)
    np.testing.assert_array_equal(tree_to_flat(model.tree()).numpy(),
                                  reference[f"{dtype}/r0/params"])


@pytest.mark.parametrize("r", range(ROUNDS))
def test_aggregate_bit_identical(reference, dtype, r):
    """The port's weighted SAFE round on the reference's own deltas
    publishes the reference round's avg_delta, bit for bit."""
    deltas = reference[f"{dtype}/r{r}/deltas"]
    agg = make_aggregator("safe", N, weighted=True, device="cpu")
    avg = agg.aggregate(torch.from_numpy(deltas), r * (deltas.shape[1] + 1),
                        alive=ALIVE[r], weights=reference["weights"])
    np.testing.assert_array_equal(avg.numpy(), reference[f"{dtype}/r{r}/avg_delta"])


@pytest.mark.parametrize("r", range(ROUNDS))
def test_apply_delta_bit_identical(reference, dtype, r):
    model = _model(reference, dtype)
    params = _params_at(reference, model, dtype, r)
    new = apply_delta(params, torch.from_numpy(reference[f"{dtype}/r{r}/avg_delta"]))
    for a, b in zip(leaves(new), leaves(params)):
        assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(tree_to_flat(new).numpy(),
                                  reference[f"{dtype}/r{r}/new_params"])


@pytest.mark.parametrize("r", range(ROUNDS))
def test_bf16_reference_noise(reference, r):
    """The floor of the bf16 bounds: the JAX package against itself, its
    excess precision on and off. Round 0 starts both runs from the same
    weights; round 1 from each run's own round-0 parameters. Every
    learner's delta and the published delta move by 8.5e-2 to 8.8e-2
    relative L2 in round 0 and by 0.110 to 0.120 in round 1 (measured);
    the band is 0.06 to 0.15. Should the floor move, the bf16 bounds
    above must be set again."""
    got = [_rel_l2(reference[f"bfloat16/r{r}/deltas"][l], reference[f"bfloat16-nx/r{r}/deltas"][l])
           for l in range(N)]
    got.append(_rel_l2(reference[f"bfloat16/r{r}/avg_delta"],
                       reference[f"bfloat16-nx/r{r}/avg_delta"]))
    assert all(0.06 <= e <= 0.15 for e in got), got


@pytest.mark.parametrize("learner", range(N))
def test_local_update_matches(reference, dtype, learner):
    """One learner's K local AdamW steps from the reference's round-1
    parameters: f32 within 1e-4 relative L2 (measured 9.1e-5 at worst),
    bf16 within 0.087 of the run without excess precision (measured
    8.1e-2 to 8.3e-2); the mean loss within 1e-5 (f32) or 1e-3 (bf16)
    relative (measured 1.2e-7 and 8.4e-5)."""
    run = FLOAT_REF[dtype]
    model = _model(reference, run)
    params = _params_at(reference, model, run, 1)
    local = make_local_update(model, local_steps=K, local_lr=LR)
    delta, loss = local(params, torch.from_numpy(reference["tokens"][learner]))
    assert delta.dtype == torch.float32 and delta.shape == (tree_to_flat(params).numel(),)
    e = _rel_l2(delta.numpy(), reference[f"{run}/r1/deltas"][learner])
    assert e <= REL_L2[dtype]
    np.testing.assert_allclose(float(loss), reference[f"{run}/r1/losses"][learner],
                               rtol=1e-5 if dtype == "float32" else 1e-3)


def _round(reference, run):
    model = _model(reference, run)
    agg = make_aggregator("safe", N, weighted=True, device="cpu")
    bundle = make_federated_round(model, agg, local_steps=K, local_lr=LR,
                                  return_delta=True)
    return model, bundle


def _check_round(reference, run, r, m, bound):
    assert set(m) == {"local_loss", "delta_norm", "avg_delta"}
    assert _rel_l2(m["avg_delta"].numpy(), reference[f"{run}/r{r}/avg_delta"]) <= bound
    np.testing.assert_allclose(float(m["local_loss"]), reference[f"{run}/r{r}/local_loss"],
                               rtol=1e-5 if run == "float32" else 1e-3)
    np.testing.assert_allclose(float(m["delta_norm"]), reference[f"{run}/r{r}/delta_norm"],
                               rtol=bound)


# The two chained rounds: round 1 starts from the port's own round-0
# parameters, so AdamW amplifies round 0's float differences once more.
# Measured: f32 6.4e-5 then 3.6e-4; bf16 7.9e-2 then 0.114, where the JAX
# package's own chained runs differ by 0.110 to 0.120.
CHAINED = {"float32": (1e-4, 1e-3), "bfloat16": (0.087, 0.13)}


def test_federated_round_two_rounds(reference, dtype):
    """The whole round, twice, from the reference's initial weights: the
    published delta within CHAINED's relative L2 bounds, the local loss
    within 1e-5 (f32) or 1e-3 (bf16) relative (measured 1.2e-7 and 2.5e-5),
    and the new parameters finite."""
    run = FLOAT_REF[dtype]
    model, bundle = _round(reference, run)
    params = bundle.init_state_fn(model.tree())
    W = tree_to_flat(params).numel() + 1
    toks = torch.from_numpy(reference["tokens"])
    for r in range(ROUNDS):
        params, m = bundle.round_fn(params, toks, weights=reference["weights"],
                                    counter=r * W, alive=ALIVE[r])
        _check_round(reference, run, r, m, CHAINED[dtype][r])
        assert bool(torch.isfinite(tree_to_flat(params)).all())


@pytest.mark.parametrize("r", range(ROUNDS))
def test_federated_round_from_reference_params(reference, dtype, r):
    """Round r from the reference's own parameters before it: the
    published delta within the local update's bound (REL_L2; measured f32
    6.4e-5 and 7.9e-5, bf16 7.9e-2 and 8.2e-2)."""
    run = FLOAT_REF[dtype]
    model, bundle = _round(reference, run)
    params = _params_at(reference, model, run, r)
    W = tree_to_flat(params).numel() + 1
    _, m = bundle.round_fn(params, torch.from_numpy(reference["tokens"]),
                           weights=reference["weights"], counter=r * W, alive=ALIVE[r])
    _check_round(reference, run, r, m, REL_L2[dtype])


def test_round_uses_its_own_deltas(reference, dtype):
    """round_fn is deltas_fn, then the aggregate, then apply_delta: the
    same three calls made by hand give the same parameters bit for bit."""
    model, bundle = _round(reference, dtype)
    agg = make_aggregator("safe", N, weighted=True, device="cpu")
    params = model.tree()
    toks = torch.from_numpy(reference["tokens"])
    new, m = bundle.round_fn(params, toks, weights=reference["weights"], counter=7,
                             alive=ALIVE[1])
    deltas, losses = bundle.deltas_fn(params, toks)
    assert deltas.shape == (N, tree_to_flat(params).numel()) and losses.shape == (N,)
    avg = agg.aggregate(deltas, 7, alive=ALIVE[1], weights=reference["weights"])
    assert torch.equal(avg, m["avg_delta"])
    assert torch.equal(tree_to_flat(apply_delta(params, avg)), tree_to_flat(new))
    assert torch.equal(losses.mean(), m["local_loss"])


# ---- the wire runtime: make_wire_federated through a broker -------------------------

WIRE_FAILED = {"clean": (), "node 3 failed": (3,)}


def _wire_setup(reference):
    """The f32 model from the reference's weights, its in-process weighted
    round, and the wire callables over the same tokens (node l + 1 holds
    learner l's microbatches)."""
    model, bundle = _round(reference, "float32")
    toks = reference["tokens"]
    wf = make_wire_federated(model, {l + 1: toks[l] for l in range(N)}, local_steps=K,
                             local_lr=LR)
    return model, bundle, wf


def _run_wire(run_round, broker, params, wf, weights, counter, failed):
    async def go():
        addr = await broker.start()
        try:
            return await asyncio.wait_for(
                run_round(params, wf.local_fns, wf.apply_fn, addr, weights=weights,
                          counter=counter, failed_nodes=failed), 120)
        finally:
            await broker.stop()
    return asyncio.run(go())


@pytest.mark.parametrize("case", list(WIRE_FAILED))
def test_wire_round_bit_identical(reference, case):
    """One FedAvg round on the wire — each live learner's callable runs its
    two local steps, the deltas travel the SAFE chain through the port's
    broker on 127.0.0.1 — publishes the in-process ``round_fn``'s delta bit
    for bit at the same counter, weights and alive bitmap (a failed node
    never computes or connects; in process its row is dead), and applying
    it gives the same parameters."""
    from repro_torch.net import SafeBroker, run_federated_round_net
    model, bundle, wf = _wire_setup(reference)
    failed = WIRE_FAILED[case]
    alive = [0.0 if l + 1 in failed else 1.0 for l in range(N)]
    params = model.tree()
    W = wf.words_per_round(weighted=True)
    assert W == wf.payload_words + 1 == tree_to_flat(params).numel() + 1
    new, m = bundle.round_fn(params, torch.from_numpy(reference["tokens"]),
                             weights=reference["weights"], counter=W, alive=alive)
    got, res = _run_wire(run_federated_round_net,
                         SafeBroker(progress_timeout=0.4, monitor_interval=0.1),
                         params, wf, reference["weights"], W, failed)
    assert res.average.dtype == np.float32
    np.testing.assert_array_equal(res.average.view(np.uint32),
                                  m["avg_delta"].numpy().view(np.uint32))
    assert torch.equal(tree_to_flat(got), tree_to_flat(new))
    # each live node's callable ran and kept its loss; a failed node's never ran
    assert sorted(wf.last_losses) == [l for l in range(1, N + 1) if l not in failed]
    assert all(np.isfinite(v) for v in wf.last_losses.values())


@pytest.mark.parametrize("case", list(WIRE_FAILED))
def test_reference_wire_round_same_words(reference, case):
    """The same callables' deltas through the JAX package's broker and wire
    round publish the same words as the port's in-process round."""
    from repro.net import SafeBroker as RefBroker
    from repro.net import run_federated_round_net as ref_round_net
    model, bundle, wf = _wire_setup(reference)
    failed = WIRE_FAILED[case]
    alive = [0.0 if l + 1 in failed else 1.0 for l in range(N)]
    params = model.tree()
    W = wf.words_per_round()
    _, m = bundle.round_fn(params, torch.from_numpy(reference["tokens"]),
                           weights=reference["weights"], counter=2 * W, alive=alive)
    published = {}

    def keep(state, avg):
        published["avg"] = avg
        return state

    wf.apply_fn = keep
    _run_wire(ref_round_net, RefBroker(progress_timeout=0.4, monitor_interval=0.1), params, wf,
              reference["weights"], 2 * W, failed)
    np.testing.assert_array_equal(np.asarray(published["avg"], np.float32).view(np.uint32),
                                  m["avg_delta"].numpy().view(np.uint32))
