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
- ``IMB``: the smoke qwen3-moe at a capacity factor of 1 whose routing is
  imbalanced across the data ranks: 32 rows, data rank 0's tokens routed
  to experts 0 and 1 and data rank 1's to experts 0 and 2 (two embedding
  columns and the router's rows on them, ``_imbalance``). The global batch
  overfills expert 0, so the reference keeps its first C = 256 prompt
  assignments (16 at decode), all of them data rank 0's, and drops data
  rank 1's; a rank routing its own rows with its own capacity would keep
  half of each rank's;
- the sequence over 'data' (batch 1): gemma3-12b with a 64-slot cache,
  each data rank holding 32 slots of every attention cache (local ring
  buffers and the global cache), prefilled with 40 and with 60 tokens
  (the second wraps the local rings and clamps the global cache), then 8
  decode steps through ``make_serve_step(model, grid, seq_axis="data")``.

Each rank also checks that a decode step writes only the slot its rank
owns, that ``pmax`` is the ranks' max, and that the log-sum-exp merge
(``layers._merged_attention``) of its slots equals ``_dense_attention`` of
the whole cache within ``MERGE_TOL``. This process runs the one-process
port on the same inputs (a MoE's whole batch through its one-process
routing: the ranks route the global batch as the reference does, and keep
as many assignments an expert, ``moe.route_stats``); after the
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
from repro_torch.models import Model, layers, moe
from repro_torch.serve import make_serve_step

DATA, M, THREADS = 2, 2, 1
BATCHED = ("internlm2-1.8b", "zamba2-2.7b", "rwkv6-1.6b", "qwen3-moe-235b-a22b")
B, S0, MAX, STEPS = 4, 16, 32, 4          # batch-sharded: rows, prompt, cache, decode steps
IMB, IMB_ROWS, IMB_CF = "qwen3-moe-imbalanced", 32, 1.0   # the imbalanced routing's case
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
    cfg = dataclasses.replace(get_smoke_config(t._arch(arch)), dtype="float32")
    if arch == t.IMB:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               capacity_factor=t.IMB_CF))
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
out[t.IMB] = serve(t.IMB, t._tokens(t.IMB, t.IMB_ROWS, t.S0 + t.STEPS), t.S0, t.MAX, t.STEPS,
                   True)
for s0 in t.SEQ_PROMPTS:
    out[f"seq{s0}"] = serve(t.SEQ_ARCH, t._tokens(t.SEQ_ARCH, 1, s0 + t.SEQ_STEPS), s0,
                            t.SEQ_MAX, t.SEQ_STEPS, False)
np.savez("@DIR@/ref.npz", **out)
print("REF_OK")
"""


def _arch(name):
    return "qwen3-moe-235b-a22b" if name == IMB else name


def _cfg(arch):
    cfg = dataclasses.replace(get_smoke_config(_arch(arch)), dtype="float32")
    if arch == IMB:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=IMB_CF))
    return cfg


def _imbalance(model):
    """``IMB``'s weights: embedding columns 0 and 1 of a token id below
    vocab/2 are (1, 1) and of the rest (−1, 1), the router reads only those
    two rows: expert 0 takes 2·h_1, expert 1 h_0 and expert 2 −h_0, so the
    first half's tokens go to experts 0 and 1 and the second half's to 0
    and 2 (the columns dominate the normalised residual through both
    units). Rank shards take their own vocabulary rows."""
    cfg = model.cfg
    with torch.no_grad():
        lo, hi = model.vocab_span
        ids = torch.arange(lo, hi)
        model.embed[:, 0] = torch.where(ids < cfg.vocab // 2, 1.0, -1.0)
        model.embed[:, 1] = 1.0
        for block in model.blocks:
            router = block["moe"]["router"]          # [U, d, E]
            router.zero_()
            router[:, 1, 0] = 2.0
            router[:, 0, 1] = 1.0
            router[:, 0, 2] = -1.0
    return model


def _ep(cfg):
    """A MoE's serving configuration: its experts over the 'data' ranks."""
    return (dataclasses.replace(cfg, ep_axis="data", ep_ranks=DATA)
            if cfg.moe is not None else cfg)


def _model(arch, tp=None, ring=None):
    """The one-process model from seed 0, or rank (ring, tp)'s shards of it."""
    cfg = _ep(_cfg(arch)) if ring is not None else _cfg(arch)
    model = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(0), tp_world=tp,
                  ep_world=ring if cfg.moe is not None else None)
    return _imbalance(model) if arch == IMB else model


def _tokens(arch, rows, length):
    vocab = _cfg(arch).vocab
    toks = np.random.RandomState(5).randint(0, vocab, (rows, length)).astype(np.int32)
    if arch == IMB:  # data rank 0's rows in the first half of the vocabulary, rank 1's in the second
        half = rows // DATA
        toks[:half] %= vocab // 2
        toks[half:] = vocab // 2 + toks[half:] % (vocab // 2)
    return toks


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
        for arch, rows_all in [(a, B) for a in BATCHED] + [(IMB, IMB_ROWS)]:
            model = _model(arch, g.model, g.data)
            rows = _tokens(arch, rows_all, S0 + STEPS)[i * (rows_all // DATA):
                                                      (i + 1) * (rows_all // DATA)]
            cache = model.init_cache(rows_all // DATA, MAX, prefilled=False)
            moe.route_stats["kept"] = []
            logits, cache = model.prefill(model.tree(), torch.from_numpy(rows[:, :S0]),
                                          cache=cache)
            steps, _ = _decode(model, make_serve_step(model, g), cache, rows, S0, STEPS)
            out[arch] = torch.stack([logits] + steps)
            out[f"kept {arch}"] = moe.route_stats["kept"]
            moe.route_stats["kept"] = None
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
        for arch, rows in [(a, B) for a in BATCHED] + [(IMB, IMB_ROWS)]:
            toks = _tokens(arch, rows, S0 + STEPS)
            model = _model(arch)  # a MoE's whole batch through the one-process routing
            cache = model.init_cache(rows, MAX, prefilled=False)
            moe.route_stats["kept"] = []
            logits, cache = model.prefill(model.tree(), torch.from_numpy(toks[:, :S0]),
                                          cache=cache)
            steps, _ = _decode(model, make_serve_step(model), cache, toks, S0, STEPS)
            out[arch] = torch.stack([logits] + steps)
            out[f"kept {arch}"] = moe.route_stats["kept"]
            moe.route_stats["kept"] = None
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
    for arch in BATCHED + (SEQ_ARCH, IMB):
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


def test_imbalanced_moe_routing_is_the_global_batchs(runs):
    """``IMB``: each data rank's rows within ``LOGIT_TOL`` of the one-process
    port's and of the reference's mesh step on the whole batch, and the
    assignments each expert keeps, summed over the data ranks, equal to
    one process's in every MoE call (each unit of the prefill and of every
    decode step): the ranks keep the tokens the global batch's routing
    keeps, not each rank's own capacity's."""
    rows = IMB_ROWS // DATA
    one = runs["one"][f"kept {IMB}"]
    for res in runs["ranks"]:
        i = res["pos"][0]
        want = runs["one"][IMB][:, i * rows:(i + 1) * rows]
        _close(res[IMB], want, (IMB, "port", res["pos"]))
        _close(res[IMB], runs["ref"][IMB][:, i * rows:(i + 1) * rows], (IMB, "reference",
                                                                         res["pos"]))
    firsts = [res for res in runs["ranks"] if res["pos"][1] == 0]
    kept = [sum(k) for k in zip(*[res[f"kept {IMB}"] for res in firsts])]
    assert len(kept) == len(one) == 2 * (1 + STEPS)
    for got, want in zip(kept, one):
        assert torch.equal(got, want), (got, want)
    assert int(one[0][0]) < IMB_ROWS * S0  # the prefill's expert 0 overflows: drops happen


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
