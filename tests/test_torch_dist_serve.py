"""Serving across ranks: prefill and decode over ('data', 'model'), the
reference's decode_32k / prefill_32k layouts, and long_500k's
sequence-sharded KV cache.

One ``spawn`` of 4 gloo ranks at one intra-op thread each, 2 data x 2
model ranks (``dist.grid``; rank 2·i + j is data rank i's model shard j),
on the smoke configurations in f32:

- batch over 'data': internlm2-1.8b, zamba2-2.7b, rwkv6-1.6b and
  qwen3-moe-235b-a22b (its experts over 'data', the ring's two
  all-to-alls, expert-ff over 'model'). 4 rows of a 16-token prompt, each
  data rank prefilling its 2 rows into its caches of 32 positions and its
  model rank's heads, then 4 decode steps through
  ``make_serve_step(model, grid)``;
- the sequence over 'data' (batch 1): gemma3-12b with a 64-slot cache,
  each data rank holding 32 slots of every attention cache (local ring
  buffers and the global cache), prefilled with 40 and with 60 tokens
  (the second wraps the local rings and clamps the global cache), then 8
  decode steps through ``make_serve_step(model, grid, seq_axis="data")``.

Each rank also checks that a decode step writes only the slot its rank
owns, that ``pmax`` is the ranks' max, and that the log-sum-exp merge
(``layers._merged_attention``) of its slots equals ``_dense_attention`` of
the whole cache within ``MERGE_TOL``. This process runs the one-process
port on the same inputs (a MoE's rows a data rank at a time through its
expert-parallel routing, which a rank's capacity follows); after the
ranks, one reference subprocess with 4 host devices runs the reference's
prefill and then ``make_serve_step(model, mesh)`` on a (2, 2) Auto mesh,
its parameters placed by ``param_pspecs`` and its caches by
``cache_pspecs`` as ``decode_spec`` places them.

Bounds: each step's logits within ``LOGIT_TOL`` of the step's largest
|logit| of the one-process port and of the reference. The k and v are
rounded to the bf16 cache in every package, and a value that the ranks'
split products put on the other side of a rounding edge moves its word by
one bf16 step (tests/test_torch_serve.py sees 1e-4 between the port and
the reference on one process for the same reason). Measured on the CPU:
3.1e-5 at worst (internlm2 against both), 1.1e-5 between the one-process
port and the reference themselves.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers import REPO
from repro_torch.configs import get_smoke_config
from repro_torch.dist import collectives, grid, spawn
from repro_torch.models import Model, layers
from repro_torch.serve import make_serve_step

DATA, M, THREADS = 2, 2, 1
BATCHED = ("internlm2-1.8b", "zamba2-2.7b", "rwkv6-1.6b", "qwen3-moe-235b-a22b")
B, S0, MAX, STEPS = 4, 16, 32, 4          # batch-sharded: rows, prompt, cache, decode steps
SEQ_ARCH, SEQ_MAX, SEQ_STEPS = "gemma3-12b", 64, 8
SEQ_PROMPTS = (40, 60)                    # pos in data rank 1's slots; a wrapped ring
LOGIT_TOL = 2e-4                          # of the step's largest |logit| (3.1e-5 seen)
MERGE_TOL = 2e-6                          # the merge against dense attention, f32 (4.8e-7)

REF_CODE = """
import repro  # the package's jax shims first
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.models import Model
from repro.models.sharding import param_pspecs
from repro.serve.engine import cache_pspecs, make_serve_step
import test_torch_dist_serve as t

mesh = jax.make_mesh((t.DATA, t.M), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def placed(tree, specs):
    return jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs,
                        is_leaf=lambda x: isinstance(x, P))


def load(arch):
    flat = dict(np.load(f"@DIR@/{arch}.npz"))
    tree = {}
    for key, a in flat.items():
        node, parts = tree, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(a)
    tree["blocks"] = [tree["blocks"][str(i)] for i in range(len(tree["blocks"]))]
    return tree


def serve(arch, toks, s0, cache_len, steps, batch_sharded):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = Model(cfg)
    params = load(arch)
    logits, cache = jax.jit(model.prefill)(params, jnp.asarray(toks[:, :s0]),
                                            cache=model.init_cache(toks.shape[0], cache_len,
                                                                   prefilled=False))
    out = [np.asarray(logits)]
    params = placed(params, param_pspecs(cfg, params, {"data": t.DATA, "model": t.M}))
    cache = placed(cache, cache_pspecs(cache, batch_sharded,
                                       None if batch_sharded else "data", model_size=t.M))
    step = make_serve_step(model, mesh)
    spec = NamedSharding(mesh, P("data") if batch_sharded else P())
    for i in range(steps):
        logits, cache = step(params, jax.device_put(jnp.asarray(toks[:, s0 + i]), spec), cache)
        out.append(np.asarray(logits))
    return np.stack(out)


out = {}
for arch in t.BATCHED:
    out[arch] = serve(arch, t._tokens(arch, t.B, t.S0 + t.STEPS), t.S0, t.MAX, t.STEPS, True)
for s0 in t.SEQ_PROMPTS:
    out[f"seq{s0}"] = serve(t.SEQ_ARCH, t._tokens(t.SEQ_ARCH, 1, s0 + t.SEQ_STEPS), s0,
                            t.SEQ_MAX, t.SEQ_STEPS, False)
np.savez("@DIR@/ref.npz", **out)
print("REF_OK")
"""


def _cfg(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    return cfg


def _ep(cfg):
    """A MoE's serving configuration: its experts over the 'data' ranks."""
    return (dataclasses.replace(cfg, ep_axis="data", ep_ranks=DATA)
            if cfg.moe is not None else cfg)


def _model(arch, tp=None, ring=None, ep=False):
    """The one-process model from seed 0 (``ep``: with the expert-parallel
    routing), or rank (ring, tp)'s shards of it."""
    cfg = _ep(_cfg(arch)) if (ep or ring is not None) else _cfg(arch)
    return Model(cfg, device="cpu", generator=torch.Generator().manual_seed(0), tp_world=tp,
                 ep_world=ring if cfg.moe is not None else None)


def _tokens(arch, rows, length):
    return np.random.RandomState(5).randint(0, _cfg(arch).vocab, (rows, length)).astype(np.int32)


def _decode(model, step, cache, toks, s0, steps):
    out = []
    for i in range(steps):
        logits, cache = step(model.tree(), torch.from_numpy(toks[:, s0 + i]), cache)
        out.append(logits.clone())
    return out, cache


# ---- the ranks ---------------------------------------------------------------------------

def _written_slots(before, after):
    """Per attention pattern position: the (unit, slot) pairs whose k a
    decode step changed."""
    out = {}
    for pos, (a, b) in enumerate(zip(before, after)):
        if "k" in a:
            changed = (a["k"].float() != b["k"].float()).flatten(3).any(-1).any(1)  # [U, slots]
            out[pos] = changed.nonzero().tolist()
    return out


def _merge_check(g):
    """The merge of this rank's slots against dense attention of all of
    them, and ``pmax`` of a rank-dependent tensor; max |difference|."""
    cfg = _cfg(SEQ_ARCH)
    rng = np.random.RandomState(9)
    nkv, gq, hd, S_c = 2, 2, 16, 64
    qg = torch.from_numpy(rng.randn(1, 1, nkv, gq, hd).astype(np.float32)) * 3
    k = torch.from_numpy(rng.randn(1, S_c, nkv, hd).astype(np.float32)) * 3
    v = torch.from_numpy(rng.randn(1, S_c, nkv, hd).astype(np.float32))
    q_pos = torch.tensor([[50]], dtype=torch.int32)
    k_pos = torch.arange(S_c, dtype=torch.int32)[None]
    valid = k_pos <= 50
    want = layers._dense_attention(qg, k, v, q_pos, k_pos, valid, cfg, "global")
    lo, n = g.data.rank * (S_c // DATA), S_c // DATA
    got = layers._merged_attention(qg, k[:, lo:lo + n], v[:, lo:lo + n], q_pos,
                                   k_pos[:, lo:lo + n], valid[:, lo:lo + n], cfg, "global",
                                   g.data)
    x = torch.tensor([float(g.data.rank), -float(g.data.rank), 7.0])
    return {"merge_err": float((got - want).abs().max()),
            "pmax": collectives.pmax(x, g.data)}


def _rank(world):
    g = grid(world, M)
    i = g.data.rank
    out = {"pos": (i, g.model.rank)}
    with torch.inference_mode():
        for arch in BATCHED:
            model = _model(arch, g.model, g.data)
            rows = _tokens(arch, B, S0 + STEPS)[i * (B // DATA):(i + 1) * (B // DATA)]
            cache = model.init_cache(B // DATA, MAX, prefilled=False)
            logits, cache = model.prefill(model.tree(), torch.from_numpy(rows[:, :S0]),
                                          cache=cache)
            steps, _ = _decode(model, make_serve_step(model, g), cache, rows, S0, STEPS)
            out[arch] = torch.stack([logits] + steps)
        model = _model(SEQ_ARCH, g.model)
        step = make_serve_step(model, g, seq_axis="data")
        for s0 in SEQ_PROMPTS:
            toks = _tokens(SEQ_ARCH, 1, s0 + SEQ_STEPS)
            cache = model.init_cache(1, SEQ_MAX, prefilled=False, seq_world=g.data)
            logits, cache = model.prefill(model.tree(), torch.from_numpy(toks[:, :s0]),
                                          cache=cache, seq_world=g.data)
            before = [{k: v.clone() for k, v in c.items()} for c in cache]
            first, cache = step(model.tree(), torch.from_numpy(toks[:, s0]), cache)
            written = _written_slots(before, cache)
            rest, _ = _decode(model, step, cache, toks[:, 1:], s0, SEQ_STEPS - 1)
            out[f"seq{s0}"] = torch.stack([logits, first] + rest)
            out[f"written{s0}"] = written
    out.update(_merge_check(g))
    return out


# ---- the one-process port and the reference ----------------------------------------------

def _one_process():
    out = {}
    with torch.inference_mode():
        for arch in BATCHED:
            toks = _tokens(arch, B, S0 + STEPS)
            moe = _cfg(arch).moe is not None
            parts = ([toks[i * (B // DATA):(i + 1) * (B // DATA)] for i in range(DATA)]
                     if moe else [toks])
            runs = []
            for rows in parts:  # a MoE's rows a data rank at a time: its routing's capacity
                model = _model(arch, ep=moe)
                cache = model.init_cache(rows.shape[0], MAX, prefilled=False)
                logits, cache = model.prefill(model.tree(), torch.from_numpy(rows[:, :S0]),
                                              cache=cache)
                steps, _ = _decode(model, make_serve_step(model), cache, rows, S0, STEPS)
                runs.append(torch.stack([logits] + steps))
            out[arch] = torch.cat(runs, dim=1)
        model = _model(SEQ_ARCH)
        for s0 in SEQ_PROMPTS:
            toks = _tokens(SEQ_ARCH, 1, s0 + SEQ_STEPS)
            cache = model.init_cache(1, SEQ_MAX, prefilled=False)
            logits, cache = model.prefill(model.tree(), torch.from_numpy(toks[:, :s0]),
                                          cache=cache)
            steps, _ = _decode(model, make_serve_step(model), cache, toks, s0, SEQ_STEPS)
            out[f"seq{s0}"] = torch.stack([logits] + steps)
    return out


def _run_reference(tmp):
    code = ("import sys; sys.path.insert(0, %r)\n" % os.path.join(REPO, "tests")
            + REF_CODE.replace("@DIR@", str(tmp)))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={DATA * M} "
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
    """The 4 ranks, the one-process port, then the reference."""
    tmp = tmp_path_factory.mktemp("dist_serve")
    for arch in BATCHED + (SEQ_ARCH,):
        np.savez(tmp / f"{arch}.npz", **{k.replace(".", "/"): v.numpy() for k, v in
                                         _model(arch).state_dict().items()})
    ranks = [r["result"] for r in spawn(_rank, DATA * M, "cpu", threads=THREADS)]
    one = _one_process()
    assert "REF_OK" in _run_reference(tmp)
    return {"ranks": ranks, "one": one, "ref": dict(np.load(tmp / "ref.npz"))}


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    for s in range(want.shape[0]):
        err = np.max(np.abs(got[s] - want[s])) / np.max(np.abs(want[s]))
        assert err <= LOGIT_TOL, (what, s, err)


# ---- the tests ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", BATCHED)
def test_batch_sharded_serving_agrees(runs, arch):
    """Each data rank's rows: the prefill's and every decode step's logits
    within ``LOGIT_TOL`` of the one-process port's and of the reference's
    (2, 2) mesh step; both model ranks of a data rank hold the same
    (gathered) logits."""
    rows = B // DATA
    for r, res in enumerate(runs["ranks"]):
        i, j = res["pos"]
        got = res[arch]
        assert torch.equal(got, runs["ranks"][2 * i][arch]), (arch, r)
        want = runs["one"][arch][:, i * rows:(i + 1) * rows]
        _close(got, want, (arch, "port", r))
        _close(got, runs["ref"][arch][:, i * rows:(i + 1) * rows], (arch, "reference", r))


@pytest.mark.parametrize("s0", SEQ_PROMPTS)
def test_sequence_sharded_decode_agrees(runs, s0):
    """gemma3's caches split over the data ranks by slot: every rank's
    logits within ``LOGIT_TOL`` of the one-process dense decode of the
    whole cache and of the reference's seq-sharded mesh step; the data
    ranks agree bit for bit."""
    key = f"seq{s0}"
    for res in runs["ranks"]:
        assert torch.equal(res[key], runs["ranks"][res["pos"][1]][key])
        _close(res[key], runs["one"][key], ("port", res["pos"]))
        _close(res[key], runs["ref"][key], ("reference", res["pos"]))


@pytest.mark.parametrize("s0", SEQ_PROMPTS)
def test_only_the_owning_rank_writes_a_slot(runs, s0):
    """The first decode step after the prompt writes token s0's k: at slot
    s0 % 64 of each local ring and min(s0, 63) of the global cache, in
    every unit, on the data rank holding that slot (32 a rank) only."""
    cfg = _cfg(SEQ_ARCH)
    half = SEQ_MAX // DATA
    for res in runs["ranks"]:
        i = res["pos"][0]
        for pos, kind in enumerate(cfg.pattern):
            slot = s0 % SEQ_MAX if kind.startswith("local") else min(s0, SEQ_MAX - 1)
            owner = slot // half
            want = ([[u, slot - i * half] for u in range(cfg.n_units)] if owner == i else [])
            assert res[f"written{s0}"][pos] == want, (kind, i)


def test_merge_and_pmax(runs):
    for res in runs["ranks"]:
        assert res["merge_err"] <= MERGE_TOL
        assert res["pmax"].tolist() == [float(DATA - 1), 0.0, 7.0]
