"""The PyTorch port's model, optimizer, flat layout and data against the
JAX package's, on the CPU at the smoke size.

Bit for bit (``assert_array_equal``): the configuration copies, the flat
leaf order, converted weights through the port's ``tree_to_flat``,
``flat_to_tree`` round trips and the token batches. Within a stated
tolerance: the layers, the forward logits, the loss and its gradients
(f32: ``allclose`` rtol 1e-5, atol 1e-6), one AdamW update fed the same
gradients, and the schedules.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (installs the jax compatibility shims)
from _torch_threads import _few_threads  # noqa: F401
from helpers import REPO
from repro import configs as jconfigs
from repro.data import make_federated_batches as j_batches
from repro.models import Model as JModel
from repro.models import layers as jlayers
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as j_cosine
from repro.optim import linear_warmup_cosine as j_warmup
from repro.train.flatten import tree_size as j_tree_size
from repro.train.flatten import tree_to_flat as j_tree_to_flat
from repro.train.loss import next_token_loss as j_loss
from repro_torch import configs, convert
from repro_torch.data import make_federated_batches
from repro_torch.models import Model
from repro_torch.models import layers
from repro_torch.optim import AdamW, cosine_schedule, linear_warmup_cosine
from repro_torch.train import flat_to_tree, leaf_paths, next_token_loss, tree_to_flat
from repro_torch.train.flatten import leaves, tree_unflatten

ARCH = "internlm2-1.8b"
DTYPES = ("float32", "bfloat16")
# The dense decoder's flat order: jax.tree.leaves order of the reference's
# tree (dict keys sorted, units stacked inside each leaf).
LEAF_ORDER = [
    "blocks/0/attn/wk", "blocks/0/attn/wo", "blocks/0/attn/wq", "blocks/0/attn/wv",
    "blocks/0/ln1/scale", "blocks/0/ln2/scale",
    "blocks/0/mlp/wg", "blocks/0/mlp/wi", "blocks/0/mlp/wo",
    "embed", "final_norm/scale",
]
# Smoke configurations of every ported block kind and frontend: global
# (internlm2), local + global with softcaps (gemma2), five locals and a
# global (gemma3), qk-norm and an untied head (qwen3), four codebooks
# (musicgen), a prefix of frontend embeddings (internvl2).
PORTED_ARCHS = ("internlm2-1.8b", "gemma2-27b", "gemma3-12b", "qwen3-14b",
                "musicgen-large", "internvl2-1b")
# The kinds ported later (MoE, Mamba2, RWKV6, shared attention), serving
# included.
NOT_PORTED = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b", "rwkv6-1.6b",
              "zamba2-2.7b")


def _pair(arch=ARCH, dtype="float32", **kw):
    """(reference model, its params, port model holding the same weights)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=dtype, **kw)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype, **kw)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    m = Model(cfg, device="cpu")
    m.load_state_dict(convert.model_params(cfg, jax.tree.map(np.asarray, jp)))
    return jm, jp, m


def _tokens(cfg, B=2, S=32, seed=0):
    shape = (B, S, cfg.num_codebooks) if cfg.num_codebooks > 1 else (B, S)
    return np.random.RandomState(seed).randint(0, cfg.vocab, shape).astype(np.int32)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.detach().float().numpy()


@pytest.mark.parametrize("arch", sorted(jconfigs.ALIASES))
def test_config_copies_equal(arch):
    assert dataclasses.asdict(configs.get_config(arch)) == dataclasses.asdict(
        jconfigs.get_config(arch))
    assert dataclasses.asdict(configs.get_smoke_config(arch)) == dataclasses.asdict(
        jconfigs.get_smoke_config(arch))


def test_registry_equal():
    assert configs.ALIASES == jconfigs.ALIASES and configs.ARCHS == jconfigs.ARCHS
    assert configs.all_arch_ids() == jconfigs.all_arch_ids()


def _mixer_decode(jm, jp, m, kind, name, x, positions):
    """One decode step of unit 0's token mixer of pattern position 0 on a
    prefilled cache of 16 positions, in both packages: (reference's y and
    cache, port's y and cache)."""
    from repro.models import ssm as jssm
    from repro.models import transformer as jtransformer
    from repro_torch.models import ssm, transformer
    jparams = {k: v[0] for k, v in jp["blocks"][0][name].items()}
    params = {k: v[0] for k, v in m.tree()["blocks"][0][name].items()}
    jc = jtransformer.block_init_cache(jm.cfg, kind, 2, 16)
    c = transformer.block_init_cache(m.cfg, kind, 2, 16, device="cpu")
    if name == "attn":
        jout = jlayers.attention_apply(jparams, jnp.asarray(x), jm.cfg, kind,
                                       jnp.asarray(positions), jc)
        with torch.no_grad():
            out = layers.attention_apply(params, torch.from_numpy(x), m.cfg, kind,
                                         torch.from_numpy(positions), c)
    else:
        jfn, fn = {"mamba": (jssm.mamba2_apply, ssm.mamba2_apply),
                   "rwkv": (jssm.rwkv6_apply, ssm.rwkv6_apply)}[name]
        jout = jfn(jparams, jnp.asarray(x), jm.cfg, jc)
        with torch.no_grad():
            out = fn(params, torch.from_numpy(x), m.cfg, c)
    return jout, out


@pytest.mark.parametrize("arch", NOT_PORTED)
def test_unported_kinds_raise(arch):
    """These configurations' kinds are ported, serving included: the model
    builds and runs forward (tests/test_torch_moe.py and test_torch_ssm.py
    hold the forward to the reference), and the block's token mixer given a
    real decode cache returns the reference's output and cache (f32, one
    decode step at position 16: rtol 1e-5, atol 1e-5; the cache's k and v
    within one bf16 rounding)."""
    jm, jp, m = _pair(arch)
    cfg = m.cfg
    logits, aux = m(torch.from_numpy(_tokens(cfg, S=64)))
    assert logits.shape == (2, 64, cfg.vocab) and bool(torch.isfinite(logits).all())
    assert (float(aux) > 0) == cfg.uses_moe
    block = m.tree()["blocks"][0]
    name = next(k for k in ("mamba", "rwkv", "attn") if k in block)
    x = np.random.RandomState(4).randn(2, 1, cfg.d_model).astype(np.float32)
    (jy, jc), (y, c) = _mixer_decode(jm, jp, m, cfg.pattern[0], name, x,
                                     np.full((2, 1), 16, np.int32))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    assert set(c) == set(jc)
    for k in jc:
        assert str(c[k].dtype).split(".")[1] == str(jc[k].dtype), k
        np.testing.assert_allclose(_f32(c[k]), _f32(jc[k]), rtol=2.0 ** -7, atol=1e-5)


def test_attention_refuses_cache_and_long_sequences():
    """Attention with a real decode cache, and at S = FLASH_THRESHOLD + 1
    (the blockwise path: q blocks of 2048 and k blocks of 1024, the last of
    each one token, where the reference takes 17 x 17 blocks of 241),
    returns the reference's output (f32: rtol 1e-5, atol 1e-5)."""
    jm, jp, m = _pair()
    x = np.random.RandomState(5).randn(2, 1, m.cfg.d_model).astype(np.float32)
    for pos in (3, 15):  # a slot in the middle of the cache, and the last
        (jy, jc), (y, c) = _mixer_decode(jm, jp, m, "global", "attn", x,
                                         np.full((2, 1), pos, np.int32))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jc["pos"]))
    S = layers.FLASH_THRESHOLD + 1
    xl = np.random.RandomState(6).randn(1, S, m.cfg.d_model).astype(np.float32)
    jparams = {k: v[0] for k, v in jp["blocks"][0]["attn"].items()}
    params = {k: v[0] for k, v in m.tree()["blocks"][0]["attn"].items()}
    want, _ = jlayers.attention_apply(jparams, jnp.asarray(xl), m.cfg, "global")
    with torch.no_grad():
        got, cache = layers.attention_apply(params, torch.from_numpy(xl), m.cfg, "global")
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flat_layout_bit_identical(dtype):
    """Leaf order, shapes, dtypes, converted weights through the port's
    tree_to_flat, and the flat_to_tree round trip."""
    _, jp, m = _pair(dtype=dtype)
    tree = m.tree()
    assert leaf_paths(tree) == LEAF_ORDER
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert jpaths == LEAF_ORDER
    for a, b in zip(leaves(tree), jax.tree.leaves(jp)):
        assert tuple(a.shape) == b.shape and str(a.dtype).split(".")[1] == str(b.dtype)
    flat = tree_to_flat(tree)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(j_tree_to_flat(jp)))
    assert flat.numel() == j_tree_size(jp)
    back = flat_to_tree(flat, tree)
    for a, b in zip(leaves(back), leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b.detach())


def test_bf16_carried_as_bits():
    """bf16 leaves convert from ml_dtypes arrays and from their uint16 bits
    alike, bit for bit; a leaf of the wrong dtype is refused."""
    _, jp, m = _pair(dtype="bfloat16")
    npt = jax.tree.map(np.asarray, jp)
    bits = jax.tree.map(lambda a: a.view(np.uint16) if a.dtype.itemsize == 2 else a, npt)
    s1, s2 = convert.model_params(m.cfg, npt), convert.model_params(m.cfg, bits)
    assert s1.keys() == s2.keys() == m.state_dict().keys()
    for k in s1:
        assert s1[k].dtype == m.state_dict()[k].dtype and torch.equal(s1[k], s2[k])
    npt["embed"] = npt["embed"].astype(np.float32)
    with pytest.raises(ValueError, match="embed"):
        convert.model_params(m.cfg, npt)


def test_full_width_size():
    """P of internlm2-1.8b at full width, shapes only: the reference's
    jax.eval_shape count at 24 layers and at the 12 that chip_smoke runs."""
    for n_layers, want in ((24, 1_699_579_904), (12, 944_556_032)):
        cfg = dataclasses.replace(configs.get_config(ARCH), n_layers=n_layers)
        got = Model(cfg, device="meta").tree()
        jcfg = dataclasses.replace(jconfigs.get_config(ARCH), n_layers=n_layers)
        jp = jax.eval_shape(JModel(jcfg).init, jax.random.key(0))
        assert sum(t.numel() for t in leaves(got)) == j_tree_size(jp) == want
        assert got["blocks"][0]["ln1"]["scale"].dtype == torch.bfloat16
        assert got["final_norm"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_and_rope(dtype):
    """rmsnorm with a stacked bf16 scale (1.0 + scale stays bf16) and
    RoPE, against the reference's functions: bf16 outputs equal to within
    one bf16 rounding (rtol 2^-7), f32 rtol 1e-6."""
    rng = np.random.RandomState(1)
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = jnp.asarray(rng.randn(2, 8, 4, 64).astype(np.float32)).astype(dt)
    scale = jnp.asarray(rng.randn(64).astype(np.float32) * 0.1).astype(dt)
    tx, ts = (torch.tensor(np.asarray(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in (x, scale))
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(_f32(layers.rmsnorm({"scale": ts}, tx)),
                               _f32(jlayers.rmsnorm({"scale": scale}, x)), rtol=rtol, atol=1e-6)
    pos = jnp.arange(8, dtype=jnp.int32)[None, :].repeat(2, 0)
    np.testing.assert_allclose(
        _f32(layers.rope(tx, torch.tensor(np.asarray(pos)), 1e6)),
        _f32(jlayers.rope(x, pos, 1e6)), rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("kind", ["global", "local", "chunked"])
def test_attention_and_mlp(kind):
    """f32 attention of each kind (S = 128 over window = chunk = 64, so
    the masks bite) and the gated MLP: allclose rtol 1e-5, atol 1e-6."""
    cfg = configs.get_smoke_config(ARCH)
    jcfg = jconfigs.get_smoke_config(ARCH)
    rng = np.random.RandomState(2)
    p = {k: rng.randn(*s).astype(np.float32) / np.sqrt(s[0]) for k, s in (
        ("wq", (256, 256)), ("wk", (256, 128)), ("wv", (256, 128)), ("wo", (256, 256)))}
    x = rng.randn(2, 128, 256).astype(np.float32)
    want, _ = jlayers.attention_apply({k: jnp.asarray(v) for k, v in p.items()},
                                      jnp.asarray(x), jcfg, kind)
    got, _ = layers.attention_apply({k: torch.from_numpy(v) for k, v in p.items()},
                                    torch.from_numpy(x), cfg, kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    mp = {k: rng.randn(*s).astype(np.float32) / np.sqrt(s[0]) for k, s in (
        ("wi", (256, 768)), ("wg", (256, 768)), ("wo", (768, 256)))}
    np.testing.assert_allclose(
        layers.mlp_apply({k: torch.from_numpy(v) for k, v in mp.items()},
                         torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.mlp_apply({k: jnp.asarray(v) for k, v in mp.items()},
                                     jnp.asarray(x))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_forward_logits_f32(arch):
    """Forward logits of each ported smoke configuration in f32: allclose
    rtol 1e-5, atol 4e-6. The f32 products sum in another order than
    XLA's, which leaves up to 1.9e-6 (measured) on logits up to 2.6: eight
    ulps of the largest, and more than 1e-6 + 1e-5·|x| on a few logits
    near 0."""
    jm, jp, m = _pair(arch, remat=True)
    toks = _tokens(m.cfg, S=128)
    prefix = None
    if m.cfg.prefix_embeds:
        prefix = np.random.RandomState(3).randn(2, m.cfg.prefix_embeds,
                                                m.cfg.d_model).astype(np.float32)
    want, _ = jm.forward(jp, jnp.asarray(toks),
                         None if prefix is None else jnp.asarray(prefix))
    got, aux = m(torch.from_numpy(toks), None if prefix is None else torch.from_numpy(prefix))
    assert got.dtype == torch.float32 and got.shape == want.shape and float(aux) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=4e-6)


def test_loss_and_gradients_f32():
    """next_token_loss and its gradient on every leaf against
    jax.value_and_grad, f32: allclose rtol 1e-5, atol 1e-6 (gradients
    measured 1.7e-7 at most)."""
    jm, jp, m = _pair()
    toks = _tokens(m.cfg, S=64)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: j_loss(jm.forward(p, jnp.asarray(toks))[0], jnp.asarray(toks))))(jp)
    loss = next_token_loss(m(torch.from_numpy(toks))[0], torch.from_numpy(toks))
    grads = torch.autograd.grad(loss, leaves(m.tree()))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for g, w in zip(grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_forward_bf16():
    """The bf16 forward: the loss within 1e-4 relative (measured 5e-5) and
    the logits within 2e-2 relative L2 (the reference fuses bf16 chains
    without rounding between ops, the port rounds after each)."""
    jm, jp, m = _pair(dtype="bfloat16")
    toks = _tokens(m.cfg, S=64)
    want = np.asarray(jm.forward(jp, jnp.asarray(toks))[0])
    got = m(torch.from_numpy(toks))[0].detach().numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-2
    np.testing.assert_allclose(float(next_token_loss(torch.from_numpy(got), torch.from_numpy(toks))),
                               float(j_loss(jnp.asarray(want), jnp.asarray(toks))), rtol=1e-4)


def test_remat_changes_nothing():
    """Checkpointing each block recomputes the same activations: loss and
    gradients equal with and without it."""
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), dtype="float32")
    toks = torch.from_numpy(_tokens(cfg))
    out = []
    for remat in (False, True):
        m = Model(dataclasses.replace(cfg, remat=remat), device="cpu",
                  generator=torch.Generator().manual_seed(5))
        loss = next_token_loss(m(toks)[0], toks)
        out.append((loss, torch.autograd.grad(loss, leaves(m.tree()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_adamw_update(dtype):
    """One AdamW step fed the reference's own gradients, with the clip
    engaged (grad_clip far below the norm): m and v (f32) allclose rtol
    1e-6, the new parameters within one ulp of their dtype (a bf16 ulp is
    up to 2^-7 relative; measured: 1 of 65,536 elements off by one). In bf16
    this holds only if the clipped gradients stay f32, as JAX promotes
    them: rounding them to bf16 moves m by up to 2^-9 relative."""
    jm, jp, m = _pair(dtype=dtype)
    toks = _tokens(m.cfg)
    jg = jax.jit(jax.grad(lambda p: j_loss(jm.forward(p, jnp.asarray(toks))[0],
                                           jnp.asarray(toks))))(jp)
    gnorm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                               for g in jax.tree.leaves(jg))))
    kw = dict(lr=1e-3, weight_decay=0.1, grad_clip=gnorm / 3.3)
    jopt, opt = JAdamW(**kw), AdamW(**kw)
    jnew, js = jax.jit(jopt.update)(jg, jopt.init(jp), jp)
    grads = tree_unflatten(m.tree(), [
        torch.tensor(_f32(g)).to(p.dtype) for g, p in zip(jax.tree.leaves(jg),
                                                               leaves(m.tree()))])
    new, state = opt.update(grads, opt.init(m.tree()), m.tree())
    assert state.step == 1
    for a, b in zip(leaves(state.m) + leaves(state.v), jax.tree.leaves(js.m) + jax.tree.leaves(js.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-12)
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 1e-6  # bf16: one ulp
    for a, b, p in zip(leaves(new), jax.tree.leaves(jnew), leaves(m.tree())):
        assert a.dtype == p.dtype
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("dtype", DTYPES)
def test_adamw_update_in_place(dtype, monkeypatch):
    """``update_`` in passes of 1000 words (most leaves take several)
    writes into the given moments and parameters the very words that
    ``update`` returns in one pass a leaf; ``update`` leaves its inputs as
    they were. Two steps, clip engaged, exact equality."""
    from repro_torch.optim import adamw
    m = Model(dataclasses.replace(configs.get_smoke_config(ARCH), dtype=dtype), device="cpu",
              generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    opt = AdamW(lr=1e-3, weight_decay=0.1, grad_clip=0.5)
    params = m.tree()
    before = [t.clone() for t in leaves(params)]
    mine = adamw.copied(params)
    state, mine_state = opt.init(params), opt.init(params)
    for _ in range(2):
        grads = tree_unflatten(params, [torch.randn(p.shape, generator=gen).to(p.dtype)
                                        for p in leaves(params)])
        monkeypatch.setattr(adamw, "_CHUNK", 1 << 26)
        params, state = opt.update(grads, state, params)
        monkeypatch.setattr(adamw, "_CHUNK", 1000)
        out, mine_state = opt.update_(grads, mine_state, mine)
        assert out is mine
    assert all(torch.equal(a, b) for a, b in zip(leaves(m.tree()), before))
    for a, b in zip(leaves(mine) + leaves(mine_state.m) + leaves(mine_state.v),
                    leaves(params) + leaves(state.m) + leaves(state.v)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("step", [0, 1, 7, 50, 99, 100, 250])
def test_schedules(step):
    """Learning-rate schedules at f32: rtol 1e-6."""
    s = jnp.asarray(step, jnp.int32)
    np.testing.assert_allclose(float(cosine_schedule(3e-4, 100)(torch.tensor(step))),
                               float(j_cosine(3e-4, 100)(s)), rtol=1e-6)
    np.testing.assert_allclose(float(linear_warmup_cosine(3e-4, 10, 200)(torch.tensor(step))),
                               float(j_warmup(3e-4, 10, 200)(s)), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 3])
def test_token_batches_identical(seed):
    for arch in (ARCH, "musicgen-large"):
        cfg, jcfg = configs.get_smoke_config(arch), jconfigs.get_smoke_config(arch)
        got, want = make_federated_batches(cfg, 3, 2, 16, seed), j_batches(jcfg, 3, 2, 16, seed)
        for step in (0, 5):
            g, w = got.global_batch(step), want.global_batch(step)
            np.testing.assert_array_equal(g["tokens"], w["tokens"])
            np.testing.assert_array_equal(g["weights"], w["weights"])


def test_import_is_jax_free():
    code = ("import sys, repro_torch, repro_torch.models, repro_torch.train, "
            "repro_torch.optim, repro_torch.data, repro_torch.configs, repro_torch.convert; "
            "assert 'jax' not in sys.modules and not any(m == 'repro' or "
            "m.startswith('repro.') for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
