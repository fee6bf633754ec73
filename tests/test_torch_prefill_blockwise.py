"""A prefill into a cache above ``FLASH_THRESHOLD`` takes the blockwise
attention (``models/layers.py::_flash_attention``): the keys are the
prompt's own, as in training. The reference's ``attention_apply`` takes
its blockwise path only without a cache, so its prefill with one is dense.

The smoke gemma3-12b (a windowed layer of 64 slots, then a global one) at
d_model 128 with 2 q heads and 1 kv head of 64, in f32, the reference's
weights carried across, B = 1, a prompt of S0 = 4096
+ 256 tokens (q blocks of 1088, k blocks of 544) into a cache of S0 +
STEPS slots, then STEPS decode steps:

- every attention layer of the port's prefill against the dense form (the
  parent's path) on the same input and a copy of the same cache: the cache
  words torch.equal (they are written before the attention), the layer's
  output within ``LAYER_RTOL``/``LAYER_ATOL`` (tests/test_torch_serve.py's
  one-layer bound: the two differ by the order of the softmax's sums);
- the port's logits after the prefill and after each decode step within
  ``LOGIT_TOL`` of the largest |logit| of the reference's dense prefill and
  decode (measured 1.3e-6 after the prefill, 2.1e-4 at worst after a
  decode step: the decode steps read the bf16 cache, where a word on a
  rounding edge rounds the other way in one package), and the prefilled
  cache's words within one bf16 rounding (rtol 2^-7) and ``CACHE_ATOL``
  (measured 4.7e-5 beyond one rounding, a word of 0.0038 in the global
  layer's k: from the second layer on, the layers' inputs carry the first
  layer's f32 differences, and RoPE's cancellations near zero keep them);
- the cache split by slot over a ``RankPool`` of 2 gloo ranks (long_500k's
  layout, ``seq_world``): each rank's slots of the prefilled cache torch.equal
  to the same slots of the whole cache the rank fills alone, its prefill's
  logits the whole prefill's, and the decode steps' log-sum-exp merge within
  the same bound of the reference;
- a prompt of PRIME = 4099 tokens, which no block size but 1 divides,
  prefilled in blocks of ``FLASH_QBLOCK`` and ``FLASH_KBLOCK`` with a short
  last one, each layer beside the dense form as above.
"""
import contextlib
import dataclasses
from concurrent.futures import Future, ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (installs the jax compatibility shims)
from _torch_threads import _few_threads  # noqa: F401
from repro import configs as jconfigs
from repro.models import Model as JModel
from repro_torch import configs, convert
from repro_torch.dist import RankPool, grid
from repro_torch.models import Model, layers, transformer
from repro_torch.serve import make_serve_step

ARCH, S0, STEPS = "gemma3-12b", 4096 + 256, 4
PRIME = 4099
MAX = S0 + STEPS
LOGIT_TOL = 1e-3                        # of the largest |reference logit|
BF16_RTOL, CACHE_ATOL = 2.0 ** -7, 1e-4
LAYER_RTOL, LAYER_ATOL = 1e-5, 1e-5


def _cfgs():
    kw = dict(dtype="float32", n_layers=2, d_model=128, n_heads=2, n_kv_heads=1)
    return (dataclasses.replace(jconfigs.get_smoke_config(ARCH), **kw),
            dataclasses.replace(configs.get_smoke_config(ARCH), **kw))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _dense(qg, k_all, v_all, q_pos, k_pos, cfg, base_kind):
    return layers._dense_attention(qg, k_all, v_all, q_pos, k_pos, None, cfg, base_kind)


@contextlib.contextmanager
def _checked_against_dense():
    """Every attention layer of a prefill above ``FLASH_THRESHOLD`` into a
    cache run twice, the dense form (the parent's path) on a copy of the
    cache first: yields the list of {kind, blockwise taken once, cache words
    equal, (blockwise, dense) outputs}, the blockwise output going on."""
    checked = []
    apply = transformer.attention_apply

    def attention_apply(params, x, cfg, kind="global", positions=None, cache=None, tp=None,
                        seq=None):
        if cache is None or x.shape[1] <= layers.FLASH_THRESHOLD:
            return apply(params, x, cfg, kind, positions, cache, tp, seq)
        dense_cache = {k: v.clone() for k, v in cache.items()}
        flash = layers._flash_attention
        layers._flash_attention = _dense
        try:
            want, wc = apply(params, x, cfg, kind, positions, dense_cache, tp, seq)
        finally:
            layers._flash_attention = flash
        calls = []

        def counted(*args):
            calls.append(1)
            return flash(*args)

        layers._flash_attention = counted
        try:
            got, gc = apply(params, x, cfg, kind, positions, cache, tp, seq)
        finally:
            layers._flash_attention = flash
        checked.append({"kind": kind, "blockwise": len(calls) == 1,
                        "cache": all(torch.equal(gc[k], wc[k]) for k in ("k", "v", "pos")),
                        "out": (got, want)})
        return got, gc

    transformer.attention_apply = attention_apply
    try:
        yield checked
    finally:
        transformer.attention_apply = apply


def _assert_layers(checked):
    assert [c["kind"] for c in checked] == list(_cfgs()[1].pattern)
    for c in checked:
        assert c["blockwise"] and c["cache"], c["kind"]
        got, want = c["out"]
        np.testing.assert_allclose(_np(got), _np(want), rtol=LAYER_RTOL, atol=LAYER_ATOL,
                                   err_msg=c["kind"])


def _seq_rank(world, state, toks):
    """The prompt prefilled into a whole cache and into this rank's slots of
    a cache split over ``world``, then STEPS decode steps on the split one."""
    _, cfg = _cfgs()
    model = Model(cfg, device="cpu")
    model.load_state_dict(state)
    g = grid(world)
    n, i = world.size, world.rank
    toks = torch.from_numpy(toks)
    with torch.inference_mode():
        whole = model.init_cache(1, MAX, prefilled=False)
        lw, whole = model.prefill(model.tree(), toks[:, :S0], cache=whole)
        split = model.init_cache(1, MAX, prefilled=False, seq_world=g.data)
        logits, split = model.prefill(model.tree(), toks[:, :S0], cache=split,
                                      seq_world=g.data)
        slots = all(torch.equal(split[p][k], whole[p][k].chunk(n, dim=2)[i])
                    for p in range(len(cfg.pattern)) for k in ("k", "v"))
        step = make_serve_step(model, g, seq_axis="data")
        out = [logits]
        for t in range(S0, MAX):
            logits, split = step(model.tree(), toks[:, t], split)
            out.append(logits)
    return {"slots": slots, "prefill": torch.equal(lw, out[0]), "logits": torch.stack(out)}


@pytest.fixture(scope="module")
def runs():
    """The reference's dense prefill and decode, the port's in this process
    with each attention layer checked against the dense form, and the
    ranks' split cache, the ranks starting and running beside the rest."""
    jcfg, cfg = _cfgs()
    toks = np.random.RandomState(3).randint(0, cfg.vocab, (1, MAX)).astype(np.int32)
    weights = Future()

    def on_ranks():
        with RankPool(2, "cpu", threads=2) as pool:
            return [r["result"] for r in pool.run(_seq_rank, (weights.result(), toks))]

    with ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(on_ranks)
        try:
            jm = JModel(jcfg)
            jp = jax.jit(jm.init)(jax.random.key(0))
            state = convert.model_params(cfg, jax.tree.map(np.asarray, jp))
        except BaseException as e:
            weights.set_exception(e)
            raise
        weights.set_result(state)
        ref, port, checked = _reference_and_port(jm, jp, state, toks)
        ranks = ranks.result()
    return {"ref": ref, "port": port, "checked": checked, "ranks": ranks,
            "scale": float(np.max(np.abs(_np(ref["logits"][0]))))}


def _reference_and_port(jm, jp, state, toks):
    """The reference's dense prefill and STEPS decode steps, and the
    port's, each attention layer of its prefill checked against the dense
    form."""
    jl, jc = jax.jit(jm.prefill)(jp, jnp.asarray(toks[:, :S0]),
                                 cache=jm.init_cache(1, MAX, prefilled=False))
    ref = {"logits": [jl], "caches": [jc]}
    step = jax.jit(jm.decode_step)
    for t in range(S0, MAX):
        jl, jc = step(jp, jnp.asarray(toks[:, t]), jc)
        ref["logits"].append(jl)
        ref["caches"].append(jc)

    model = Model(_cfgs()[1], device="cpu")
    model.load_state_dict(state)
    port = {"logits": [], "pos": []}
    with torch.no_grad():
        with _checked_against_dense() as checked:
            logits, cache = model.prefill(model.tree(), torch.from_numpy(toks[:, :S0]),
                                          cache=model.init_cache(1, MAX, prefilled=False))
        port["cache"] = [{k: v.clone() for k, v in c.items()} for c in cache]
        for t in range(S0, MAX + 1):
            port["logits"].append(logits)
            port["pos"].append([c["pos"].clone() for c in cache])
            if t < MAX:
                logits, cache = model.decode_step(model.tree(), torch.from_numpy(toks[:, t]),
                                                  cache)
    return ref, port, checked


def test_each_layer_blockwise_with_the_dense_forms_cache_words(runs):
    _assert_layers(runs["checked"])


def test_prompt_of_a_prime_length():
    """PRIME tokens, which no block size but 1 divides: blocks of
    ``FLASH_QBLOCK`` and ``FLASH_KBLOCK``, the last one short, each layer
    beside the dense form as above."""
    assert (layers._block(PRIME, layers.FLASH_QBLOCK),
            layers._block(PRIME, layers.FLASH_KBLOCK)) == (layers.FLASH_QBLOCK,
                                                            layers.FLASH_KBLOCK)
    _, cfg = _cfgs()
    model = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    toks = np.random.RandomState(5).randint(0, cfg.vocab, (1, PRIME)).astype(np.int32)
    with torch.no_grad(), _checked_against_dense() as checked:
        logits, _ = model.prefill(model.tree(), torch.from_numpy(toks),
                                  cache=model.init_cache(1, PRIME, prefilled=False))
    _assert_layers(checked)
    assert bool(torch.isfinite(logits).all())


def test_prefill_like_the_reference(runs):
    got, want = runs["port"]["logits"][0], runs["ref"]["logits"][0]
    err = float(np.max(np.abs(_np(got) - _np(want))))
    assert err <= LOGIT_TOL * runs["scale"], (err, runs["scale"])
    for g, w in zip(runs["port"]["cache"], runs["ref"]["caches"][0]):
        assert set(g) == set(w)
        np.testing.assert_array_equal(g["pos"].numpy(), np.asarray(w["pos"]))
        for k in ("k", "v"):
            assert g[k].dtype == torch.bfloat16 and tuple(g[k].shape) == w[k].shape
            np.testing.assert_allclose(_np(g[k]), _np(w[k]), rtol=BF16_RTOL, atol=CACHE_ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("step", range(1, STEPS + 1))
def test_decode_after_the_prefill_like_the_reference(runs, step):
    got, want = runs["port"]["logits"][step], runs["ref"]["logits"][step]
    err = float(np.max(np.abs(_np(got) - _np(want))))
    assert err <= LOGIT_TOL * runs["scale"], (step, err, runs["scale"])
    for g, w in zip(runs["port"]["pos"][step], runs["ref"]["caches"][step]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w["pos"]))


def test_cache_split_by_slot(runs):
    for r, res in enumerate(runs["ranks"]):
        assert res["slots"] and res["prefill"], r
        for step, (got, want) in enumerate(zip(res["logits"], runs["ref"]["logits"])):
            err = float(np.max(np.abs(_np(got) - _np(want))))
            assert err <= LOGIT_TOL * runs["scale"], (r, step, err)
