"""The PyTorch port's serving path against the JAX package's, on the CPU at
the smoke size: the decode caches of every block kind, ``prefill`` and
``decode_step``, the blockwise attention, ``ServeEngine`` and the
conversion of a reference cache.

Inputs are numpy arrays from seeds; the models' weights come from the
reference's ``init``, carried across with ``convert.model_params``. The
reference runs in process (jitted, on the CPU), and the bf16 cases
against a subprocess run without XLA's excess precision.

Tolerances (f32 unless said):
* logits within ``LOGIT_TOL`` x max|reference logit| (1e-3; measured
  1.3e-4 at worst, zamba2): the prompt's k and v are rounded to the bf16
  cache in both packages, and a value that lands on the other side of a
  bf16 rounding in one of them moves later logits by that much;
* cache leaves: the same dtype at every step; ``pos`` equal; attention
  k, v and RWKV6's ``prev`` within one bf16 rounding (rtol 2^-7, atol
  1e-5, for the same reason); recurrent states rtol 1e-4, atol 1e-4
  (measured 1.4e-5 on states up to 11);
* one layer: rtol 1e-5, atol 1e-5 (attention, the recurrent mixers, the
  blockwise attention; measured 3.2e-6 absolute at worst, behind
  Mamba2's gated norm).
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
from helpers import REPO, run_multidevice
from repro import configs as jconfigs
from repro.models import Model as JModel
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs, convert
from repro_torch.models import Model, layers, ssm, transformer
from repro_torch.serve import Request, ServeEngine, make_serve_step

ARCHS = tuple(sorted(configs.ALIASES))  # the ten smoke configurations
LOGIT_TOL = 1e-3
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5
STATE_RTOL, STATE_ATOL = 1e-4, 1e-4
LAYER_RTOL, LAYER_ATOL = 1e-5, 1e-5


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=dtype, **kw),
            dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype, **kw))


def _pair(arch, dtype="float32", seed=0, **kw):
    """(reference model, its params, port model holding the same weights)."""
    jcfg, cfg = _cfgs(arch, dtype, **kw)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(seed))
    m = Model(cfg, device="cpu")
    m.load_state_dict(convert.model_params(cfg, jax.tree.map(np.asarray, jp)))
    return jm, jp, m


def _tokens(cfg, B, S, seed=0):
    shape = (B, S, cfg.num_codebooks) if cfg.num_codebooks > 1 else (B, S)
    return np.random.RandomState(seed).randint(0, cfg.vocab, shape).astype(np.int32)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _dtype(a):
    return str(a.dtype).replace("torch.", "")


def _check_cache(got, want, where=""):
    """The port's stacked cache against the reference's, leaf by leaf."""
    assert len(got) == len(want)
    for pos, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), where
        for k in w:
            msg = f"{where} position {pos} {k}"
            assert tuple(g[k].shape) == w[k].shape, msg
            assert _dtype(g[k]) == str(w[k].dtype), msg
            if k == "pos":
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=msg)
            elif k == "state":
                np.testing.assert_allclose(_np(g[k]), _np(w[k]), rtol=STATE_RTOL,
                                           atol=STATE_ATOL, err_msg=msg)
            else:
                np.testing.assert_allclose(_np(g[k]), _np(w[k]), rtol=BF16_RTOL,
                                           atol=BF16_ATOL, err_msg=msg)


def _close_logits(got, want, scale, msg=""):
    err = float(np.max(np.abs(_np(got) - _np(want))))
    assert err <= LOGIT_TOL * scale, f"{msg}: max |err| {err} against {LOGIT_TOL} x {scale}"


# ---------------------------------------------------------------------------
# (a) the caches' shapes and dtypes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["global", "local", "chunked", "shared_attn", "local_moe",
                                  "chunked_moe", "moe"])
@pytest.mark.parametrize("seq_len", [16, 100])
def test_attention_init_cache_like_reference(kind, seq_len):
    """S_c = min(window, seq_len) for a local layer, min(chunk, seq_len)
    for a chunked one, seq_len otherwise; bf16 k and v, int32 pos."""
    jcfg, cfg = _cfgs("gemma3-12b")
    for prefilled in (True, False):
        want = jlayers.attention_init_cache(jcfg, kind, 3, seq_len, prefilled=prefilled)
        got = layers.attention_init_cache(cfg, kind, 3, seq_len, prefilled=prefilled,
                                          device="cpu")
        for k in want:
            assert tuple(got[k].shape) == want[k].shape and _dtype(got[k]) == str(want[k].dtype)
            np.testing.assert_array_equal(_np(got[k]), _np(want[k]))


def test_recurrent_init_caches_like_reference():
    """f32 states, int32 pos, and RWKV6's prev in bf16 whatever the model's
    dtype."""
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = _cfgs("zamba2-2.7b", dtype)
        pairs = [(jssm.mamba2_init_cache(jcfg, 3), ssm.mamba2_init_cache(cfg, 3, device="cpu"))]
        jcfg, cfg = _cfgs("rwkv6-1.6b", dtype)
        pairs.append((jssm.rwkv6_init_cache(jcfg, 3, cfg.d_model),
                      ssm.rwkv6_init_cache(cfg, 3, cfg.d_model, device="cpu")))
        for want, got in pairs:
            assert set(got) == set(want)
            for k in want:
                assert tuple(got[k].shape) == want[k].shape
                assert _dtype(got[k]) == str(want[k].dtype)
                np.testing.assert_array_equal(_np(got[k]), _np(want[k]))
    assert ssm.rwkv6_init_cache(cfg, 1, cfg.d_model, device="cpu")["prev"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_model_init_cache_like_reference(arch):
    """Every pattern position's stacked cache: leaves, shapes, dtypes and
    values, prefilled and not; each leaf its own memory."""
    jcfg, cfg = _cfgs(arch)
    jm, m = JModel(jcfg), Model(cfg, device="meta")
    for prefilled in (True, False):
        want = jm.init_cache(2, 40, prefilled=prefilled)
        got = m.init_cache(2, 40, prefilled=prefilled, device="cpu")
        _check_cache(got, want, f"prefilled={prefilled}")
        for c in got:
            for v in c.values():
                assert v.is_contiguous() and 0 not in v.stride()


# ---------------------------------------------------------------------------
# (b) one layer: attention through the ring buffer, the recurrent mixers
# ---------------------------------------------------------------------------


def _attn_params(cfg, seed=2):
    rng = np.random.RandomState(seed)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    shapes = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    return {k: (rng.randn(*s) / np.sqrt(s[0])).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("kind", ["global", "local", "chunked"])
@pytest.mark.parametrize("S0", [5, 12])
def test_attention_decode_through_the_ring_buffer(kind, S0):
    """window = chunk = 8: a prompt of S0 tokens (12 overflows the ring),
    then 2 x window + 3 decode steps, so every ring slot is rewritten twice.
    Output and cache each step against the reference."""
    jcfg, cfg = _cfgs("gemma3-12b", window=8, chunk=8)
    p = _attn_params(cfg)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    B, steps = 2, 2 * 8 + 3
    x = np.random.RandomState(3).randn(B, S0 + steps, cfg.d_model).astype(np.float32)
    jc = jlayers.attention_init_cache(jcfg, kind, B, 40, prefilled=False)
    c = layers.attention_init_cache(cfg, kind, B, 40, prefilled=False, device="cpu")
    want, jc = jlayers.attention_apply(jp, jnp.asarray(x[:, :S0]), jcfg, kind, cache=jc)
    got, c = layers.attention_apply(tp, torch.from_numpy(x[:, :S0]), cfg, kind, cache=c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LAYER_RTOL, atol=LAYER_ATOL)
    _check_cache([c], [jc], "prefill")
    for t in range(S0, S0 + steps):
        pos = np.full((B, 1), t, np.int32)
        want, jc = jlayers.attention_apply(jp, jnp.asarray(x[:, t:t + 1]), jcfg, kind,
                                           jnp.asarray(pos), jc)
        got, c = layers.attention_apply(tp, torch.from_numpy(x[:, t:t + 1]), cfg, kind,
                                        torch.from_numpy(pos), c)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LAYER_RTOL,
                                   atol=LAYER_ATOL, err_msg=f"step {t}")
        _check_cache([c], [jc], f"step {t}")


def _mixer_params(kind, cfg, seed=0):
    """f32 weights of one recurrent mixer, every vector drawn away from its
    init."""
    rng = np.random.RandomState(seed)
    d = cfg.d_model
    if kind == "mamba2":
        H, N = cfg.ssm_heads, cfg.ssm_state
        inner = H * 64
        p = {"in_proj": rng.standard_normal((d, 2 * inner + 2 * N + H)) / np.sqrt(d),
             "out_proj": rng.standard_normal((inner, d)) / np.sqrt(inner),
             "A_log": rng.uniform(-1.5, 0.0, H), "D": rng.uniform(0.5, 1.5, H),
             "dt_bias": rng.uniform(-1.0, 0.0, H), "norm_scale": rng.uniform(-0.2, 0.2, inner)}
    else:
        hd = cfg.rwkv_head_size
        p = {k: rng.standard_normal((d, d)) / np.sqrt(d) for k in ("wr", "wk", "wv", "wg", "wo")}
        p.update(w0=rng.uniform(-3.0, -1.0, d), w_proj=rng.standard_normal((d, d)) * 0.01,
                 u=rng.uniform(-0.5, 0.5, (d // hd, hd)), mu=rng.uniform(0.0, 1.0, (5, d)),
                 ln_scale=rng.uniform(-0.2, 0.2, d))
    return {k: v.astype(np.float32) for k, v in p.items()}


MIXERS = {"mamba2": ("zamba2-2.7b", jssm.mamba2_apply, ssm.mamba2_apply),
          "rwkv6": ("rwkv6-1.6b", jssm.rwkv6_apply, ssm.rwkv6_apply)}


def _mixer_caches(kind, jcfg, cfg, B):
    if kind == "mamba2":
        return jssm.mamba2_init_cache(jcfg, B), ssm.mamba2_init_cache(cfg, B, device="cpu")
    return (jssm.rwkv6_init_cache(jcfg, B, cfg.d_model),
            ssm.rwkv6_init_cache(cfg, B, cfg.d_model, device="cpu"))


@pytest.mark.parametrize("S0", [8, 128])
@pytest.mark.parametrize("kind", list(MIXERS))
def test_recurrent_prefill_then_decode(kind, S0):
    """A prompt with a cache (one chunk of 8, or two of 64: the state
    carried across chunks), then 8 single-step decodes; output, state,
    prev and pos each step against the reference."""
    arch, japply, apply = MIXERS[kind]
    jcfg, cfg = _cfgs(arch)
    p = _mixer_params(kind, cfg)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    B = 2
    x = np.random.RandomState(1).randn(B, S0 + 8, cfg.d_model).astype(np.float32)
    jc, c = _mixer_caches(kind, jcfg, cfg, B)
    for t0, t1 in [(0, S0)] + [(t, t + 1) for t in range(S0, S0 + 8)]:
        want, jc = japply(jp, jnp.asarray(x[:, t0:t1]), jcfg, jc)
        got, c = apply(tp, torch.from_numpy(x[:, t0:t1]), cfg, c)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LAYER_RTOL,
                                   atol=LAYER_ATOL, err_msg=f"tokens {t0}:{t1}")
        _check_cache([c], [jc], f"tokens {t0}:{t1}")


# ---------------------------------------------------------------------------
# (c) the model: prefill, then decode, every smoke configuration
# ---------------------------------------------------------------------------


def _prefix(cfg, B):
    if not cfg.prefix_embeds:
        return None
    return np.random.RandomState(3).randn(B, cfg.prefix_embeds, cfg.d_model).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_like_reference(arch):
    """f32, B = 2: prefill S0 = 8 tokens (after internvl2's prefix of
    frontend embeddings) into a cache of 24 positions, then decode to
    S = 24. Each step's logits and every cache leaf (dtype and values)
    against the reference's."""
    jm, jp, m = _pair(arch)
    cfg = m.cfg
    B, S0, S = 2, 8, 24
    toks = _tokens(cfg, B, S)
    prefix = _prefix(cfg, B)
    P = cfg.prefix_embeds
    jc = jm.init_cache(B, S + P, prefilled=False)
    jl, jc = jax.jit(jm.prefill)(jp, jnp.asarray(toks[:, :S0]),
                                 None if prefix is None else jnp.asarray(prefix), cache=jc)
    with torch.no_grad():
        c = m.init_cache(B, S + P, prefilled=False)
        l, c = m.prefill(m.tree(), torch.from_numpy(toks[:, :S0]),
                         None if prefix is None else torch.from_numpy(prefix), cache=c)
        scale = float(np.max(np.abs(_np(jl))))
        assert l.shape == jl.shape and l.dtype == torch.float32
        _close_logits(l, jl, scale, "prefill")
        _check_cache(c, jc, "prefill")
        step = jax.jit(jm.decode_step)
        for t in range(S0, S):
            jl, jc = step(jp, jnp.asarray(toks[:, t]), jc)
            l, c = m.decode_step(m.tree(), torch.from_numpy(toks[:, t]), c)
            _close_logits(l, jl, scale, f"step {t}")
            _check_cache(c, jc, f"step {t}")


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma3-12b", "zamba2-2.7b"])
def test_prompt_longer_than_cache_like_reference(arch):
    """f32, B = 2: a 20-token prompt prefilled into a cache of 12 positions
    (a global layer keeps the slots that exist, as the reference's scatter
    drops the rest; its later writes clamp to the last slot), then 6
    decode steps: logits and every cache leaf against the reference's."""
    jm, jp, m = _pair(arch)
    B, S0, S_c = 2, 20, 12
    toks = _tokens(m.cfg, B, S0 + 6, seed=9)
    jl, jc = jax.jit(jm.prefill)(jp, jnp.asarray(toks[:, :S0]),
                                 cache=jm.init_cache(B, S_c, prefilled=False))
    with torch.no_grad():
        l, c = m.prefill(m.tree(), torch.from_numpy(toks[:, :S0]),
                         cache=m.init_cache(B, S_c, prefilled=False))
        scale = float(np.max(np.abs(_np(jl))))
        _close_logits(l, jl, scale, "prefill")
        _check_cache(c, jc, "prefill")
        step = jax.jit(jm.decode_step)
        for t in range(S0, S0 + 6):
            jl, jc = step(jp, jnp.asarray(toks[:, t]), jc)
            l, c = m.decode_step(m.tree(), torch.from_numpy(toks[:, t]), c)
            _close_logits(l, jl, scale, f"step {t}")
            _check_cache(c, jc, f"step {t}")


NO_EXCESS = ('import os; os.environ["XLA_FLAGS"] += '
             '" --xla_allow_excess_precision=false"')
BF16_CODE = """
@PRELUDE@
import numpy as np, jax, jax.numpy as jnp
import repro
from repro.configs import get_smoke_config
from repro.models import Model
out = {}
for arch in @ARCHS@:
    cfg = get_smoke_config(arch)
    m = Model(cfg)
    p = m.init(jax.random.key(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
        a = np.asarray(leaf)
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[f"{arch}/init/{key}"] = a.view(np.uint16) if a.dtype.itemsize == 2 else a
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (2, 24)).astype(np.int32)
    c = m.init_cache(2, 24, prefilled=False)
    l, c = jax.jit(m.prefill)(p, jnp.asarray(toks[:, :8]), cache=c)
    logits = [np.asarray(l)]
    step = jax.jit(m.decode_step)
    for t in range(8, 24):
        l, c = step(p, jnp.asarray(toks[:, t]), c)
        logits.append(np.asarray(l))
    out[f"{arch}/logits"] = np.stack(logits)
    out[f"{arch}/tokens"] = toks
np.savez("@OUT@", **out)
print("REF_OK")
"""
BF16_ARCHS = ("internlm2-1.8b", "zamba2-2.7b")
# The bound of the port's bf16 forward test (tests/test_torch_model.py:
# logits within 2e-2 relative L2 of the reference's).
BF16_REL_L2 = 2e-2


@pytest.fixture(scope="module")
def bf16_reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("serve_ref") / "ref.npz"
    code = (BF16_CODE.replace("@PRELUDE@", NO_EXCESS).replace("@ARCHS@", repr(BF16_ARCHS))
            .replace("@OUT@", str(path)))
    assert "REF_OK" in run_multidevice(code, devices=1, timeout=600)
    return dict(np.load(path))


def _tree_from(ref, prefix):
    tree = {}
    for key, a in ref.items():
        if key.startswith(prefix):
            node, parts = tree, key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = a
    tree["blocks"] = [tree["blocks"][str(i)] for i in range(len(tree["blocks"]))]
    return tree


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_prefill_then_decode_bf16(bf16_reference, arch):
    """bf16: each step's logits within 2e-2 relative L2 of the reference's
    run with --xla_allow_excess_precision=false (XLA then rounds after every
    operation, as PyTorch does)."""
    cfg = configs.get_smoke_config(arch)
    m = Model(cfg, device="cpu")
    m.load_state_dict(convert.model_params(cfg, _tree_from(bf16_reference, f"{arch}/init/")))
    toks = bf16_reference[f"{arch}/tokens"]
    want = bf16_reference[f"{arch}/logits"]
    with torch.no_grad():
        l, c = m.prefill(m.tree(), torch.from_numpy(toks[:, :8]),
                         cache=m.init_cache(2, 24, prefilled=False))
        got = [l]
        for t in range(8, 24):
            l, c = m.decode_step(m.tree(), torch.from_numpy(toks[:, t]), c)
            got.append(l)
    assert c[0]["pos"].dtype == torch.int32 and int(c[0]["pos"][0, 0]) == 24
    for t, (g, w) in enumerate(zip(got, want)):
        rel = np.linalg.norm(_np(g) - w) / np.linalg.norm(w)
        assert rel < BF16_REL_L2, f"step {t}: relative L2 {rel}"


# ---------------------------------------------------------------------------
# (e) the reference's own decode tests, on the port
# ---------------------------------------------------------------------------


def _own(arch, seed):
    cfg = configs.get_smoke_config(arch)
    return Model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma3-12b", "rwkv6-1.6b",
                                  "zamba2-2.7b", "qwen3-moe-235b-a22b", "musicgen-large"])
def test_decode_matches_forward(arch):
    """Token-by-token decode reproduces the teacher-forced forward (bf16,
    2e-2 of max |logit|, the reference's bound)."""
    m = _own(arch, 1)
    cfg = m.cfg
    B, S = 1, 16
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=2))
    with torch.no_grad():
        full, _ = m(toks)
        cache = m.init_cache(B, S, prefilled=False)
        scale = float(full.abs().max())
        for t in range(S):
            dl, cache = m.decode_step(m.tree(), toks[:, t], cache)
            err = float((dl - full[:, t]).abs().max())
            assert err / scale < 2e-2, f"pos {t}: rel err {err / scale}"


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma2-27b", "rwkv6-1.6b",
                                  "zamba2-2.7b"])
def test_prefill_then_decode(arch):
    m = _own(arch, 3)
    B, S, S0 = 1, 16, 8
    toks = torch.from_numpy(_tokens(m.cfg, B, S, seed=4))
    with torch.no_grad():
        full, _ = m(toks)
        scale = float(full.abs().max())
        pl, cache = m.prefill(m.tree(), toks[:, :S0], cache=m.init_cache(B, S, prefilled=False))
        assert float((pl - full[:, S0 - 1]).abs().max()) / scale < 2e-2
        for t in range(S0, S):
            dl, cache = m.decode_step(m.tree(), toks[:, t], cache)
            assert float((dl - full[:, t]).abs().max()) / scale < 2e-2


def test_sliding_window_masks_old_tokens():
    """A local layer does not attend beyond its window: a change to a token
    far in the past does not move the output."""
    cfg = dataclasses.replace(configs.get_smoke_config("gemma3-12b"), pattern=("local",),
                              n_layers=1, window=8)
    m = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg, 1, 32, seed=1))
    toks2 = toks.clone()
    toks2[0, 0] = (toks[0, 0] + 1) % cfg.vocab
    with torch.no_grad():
        a, _ = m(toks)
        b, _ = m(toks2)
    np.testing.assert_allclose(a[0, 9:].numpy(), b[0, 9:].numpy(), atol=1e-6)
    assert float((a[0, 0] - b[0, 0]).abs().max()) > 1e-4


def test_rwkv6_state_decode_is_constant_memory():
    m = Model(configs.get_smoke_config("rwkv6-1.6b"), device="meta")
    cache = m.init_cache(2, 10_000, prefilled=True, device="cpu")
    assert sum(v.numel() for c in cache for v in c.values()) < 2 ** 22


# ---------------------------------------------------------------------------
# (f), (g) ServeEngine
# ---------------------------------------------------------------------------


def _requests(cls, cfg, n, max_new, seed=0, lo=4, hi=32):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        plen = int(rng.randint(lo, hi))
        out.append(cls(rid=i, prompt=rng.randint(0, cfg.vocab, plen).astype(np.int32),
                       max_new=max_new))
    return out


def _record_reference(eng):
    """Wrap the reference engine's jitted prefill and decode: the logits
    row behind each (request, token index)."""
    rows, count = {}, {}
    prefill, decode = eng._prefill, eng._decode

    def rec_prefill(*a, **kw):
        logits, cache = prefill(*a, **kw)
        rid = next(r.rid for r in eng.slot_req if r is not None and r.rid not in count)
        count[rid] = 0
        rows[(rid, 0)] = np.asarray(logits[0])
        return logits, cache

    def rec_decode(params, tokens, cache):
        logits, cache = decode(params, tokens, cache)
        for i, r in enumerate(eng.slot_req):
            if r is not None:
                count[r.rid] += 1
                rows[(r.rid, count[r.rid])] = np.asarray(logits[i])
        return logits, cache

    eng._prefill, eng._decode = rec_prefill, rec_decode
    return rows


def test_serve_engine_like_reference():
    """Smoke internlm2 in f32, 4 slots, 6 requests (two slots are reused),
    greedy: every request's tokens equal the reference engine's. Where the
    reference's top two logits lie within LOGIT_TOL x max |logit| of each
    other, the two packages may pick either; a divergence is accepted only
    there, and that request is compared no further."""
    jm, jp, m = _pair("internlm2-1.8b")
    cfg = m.cfg
    jeng = JServeEngine(jm, jp, batch_slots=4, max_seq=64)
    rows = _record_reference(jeng)
    eng = ServeEngine(m, m.tree(), batch_slots=4, max_seq=64)
    jreqs, reqs = (_requests(cls, cfg, 6, 12, seed=5) for cls in (JRequest, Request))
    for a, b in zip(jreqs, reqs):
        jeng.submit(a)
        eng.submit(b)
    jeng.run_until_done()
    eng.run_until_done()
    assert eng.steps == jeng.steps and not eng.queue and not any(eng.slot_req)
    compared = 0
    for a, b in zip(jreqs, reqs):
        assert b.done and len(b.generated) == len(a.generated) == 12
        for t, (x, y) in enumerate(zip(a.generated, b.generated)):
            if x != y:
                row = rows[(a.rid, t)]
                top2 = np.sort(row)[-2:]
                assert top2[1] - top2[0] <= LOGIT_TOL * np.abs(row).max(), (a.rid, t)
                break
            compared += 1
    assert compared >= 60  # at most a few requests stop early


def test_serve_engine_prompts_longer_than_max_seq_like_reference():
    """max_seq 16 with prompts of 4-31 tokens (the serve launcher's with
    --max-seq 16): the engine keeps serving as the reference's does, and
    every request's tokens equal the reference engine's (a divergence
    accepted only at a near tie, as above)."""
    jm, jp, m = _pair("internlm2-1.8b")
    jeng = JServeEngine(jm, jp, batch_slots=2, max_seq=16)
    rows = _record_reference(jeng)
    eng = ServeEngine(m, m.tree(), batch_slots=2, max_seq=16)
    jreqs, reqs = (_requests(cls, m.cfg, 4, 6, seed=0) for cls in (JRequest, Request))
    assert max(len(r.prompt) for r in reqs) > 16
    for a, b in zip(jreqs, reqs):
        jeng.submit(a)
        eng.submit(b)
    jeng.run_until_done()
    eng.run_until_done()
    assert eng.steps == jeng.steps
    for a, b in zip(jreqs, reqs):
        assert b.done and len(b.generated) == len(a.generated) == 6
        for t, (x, y) in enumerate(zip(a.generated, b.generated)):
            if x != y:
                row = rows[(a.rid, t)]
                top2 = np.sort(row)[-2:]
                assert top2[1] - top2[0] <= LOGIT_TOL * np.abs(row).max(), (a.rid, t)
                break


def test_serve_engine_samples_like_reference():
    """temperature > 0: both samplers, seeded alike and given the same
    logits arrays, draw the same tokens."""
    jm, jp, m = _pair("internlm2-1.8b")
    jeng = JServeEngine(jm, jp, batch_slots=4, max_seq=16, temperature=0.7, seed=3)
    eng = ServeEngine(m, m.tree(), batch_slots=4, max_seq=16, temperature=0.7, seed=3)
    rng = np.random.RandomState(0)
    for _ in range(5):
        logits = (rng.randn(4, m.cfg.vocab) * 3).astype(np.float32)
        np.testing.assert_array_equal(eng._sample(torch.from_numpy(logits)),
                                      jeng._sample(jnp.asarray(logits)))


def test_serve_engine_runs_on_its_model_device_without_graphs():
    """The engine's decode keeps no autograd graph, and make_serve_step is
    decode_step under inference mode."""
    m = _own("zamba2-2.7b", 0)
    eng = ServeEngine(m, m.tree(), batch_slots=2, max_seq=32)
    for r in _requests(Request, m.cfg, 3, 4, seed=1):
        eng.submit(r)
    eng.run_until_done()
    assert all(not v.requires_grad for c in eng.cache for v in c.values())
    cache = m.init_cache(2, 8, prefilled=False)
    logits, cache = make_serve_step(m)(m.tree(), torch.tensor([1, 2]), cache)
    assert not logits.requires_grad and logits.shape == (2, m.cfg.vocab)


def test_musicgen_engine_fails_like_reference():
    """Neither engine serves a multi-codebook model: admission prefills
    and takes the argmax of the flattened [nc, vocab] logits, the decode
    step embeds a token row without its codebook axis, and the first step
    raises TypeError turning a row of nc tokens into an int."""
    jm, jp, m = _pair("musicgen-large")
    jeng = JServeEngine(jm, jp, batch_slots=2, max_seq=32)
    eng = ServeEngine(m, m.tree(), batch_slots=2, max_seq=32)
    for e, cls in ((jeng, JRequest), (eng, Request)):
        e.submit(_requests(cls, m.cfg, 1, 4, seed=2)[0])
    errors = []
    for e in (jeng, eng):
        with pytest.raises(TypeError) as info:
            e.step()
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert eng.steps == jeng.steps == 1
    assert eng.slot_req[0].generated == jeng.slot_req[0].generated
    # decode_step with the codebook axis serves a [B, nc] token row in both
    toks = _tokens(m.cfg, 2, 3, seed=3)
    jc = jm.init_cache(2, 8, prefilled=False)
    with torch.no_grad():
        c = m.init_cache(2, 8, prefilled=False)
        for t in range(3):
            jl, jc = jax.jit(jm.decode_step)(jp, jnp.asarray(toks[:, t]), jc)
            l, c = m.decode_step(m.tree(), torch.from_numpy(toks[:, t]), c)
            assert l.shape == jl.shape == (2, m.cfg.num_codebooks, m.cfg.vocab)
            _close_logits(l, jl, float(np.abs(np.asarray(jl)).max()), f"step {t}")


# ---------------------------------------------------------------------------
# (h) the blockwise attention
# ---------------------------------------------------------------------------


def _qkv(cfg, S, nkv, groups, seed):
    rng = np.random.RandomState(seed)
    hd = cfg.resolved_head_dim
    qg = rng.randn(1, S, nkv, groups, hd).astype(np.float32)
    k = rng.randn(1, S, nkv, hd).astype(np.float32)
    v = rng.randn(1, S, nkv, hd).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    return qg, k, v, pos


@pytest.mark.parametrize("kind", ["global", "local", "chunked"])
def test_flash_attention_like_reference(kind):
    """S = 8192 (4 q blocks of 2048 x 8 k blocks of 1024), B = 1, the
    smoke width (2 kv heads x 2 groups x 64), f32, gemma2's softcap:
    against the reference's _flash_attention."""
    jcfg, cfg = _cfgs("gemma2-27b")
    qg, k, v, pos = _qkv(cfg, 8192, 2, 2, seed=7)
    want = jlayers._flash_attention(*map(jnp.asarray, (qg, k, v, pos, pos)), jcfg, kind)
    got = layers._flash_attention(*map(torch.from_numpy, (qg, k, v, pos, pos)), cfg, kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LAYER_RTOL, atol=LAYER_ATOL)


@pytest.mark.parametrize("S", [4097, 4352])
def test_flash_attention_matches_dense(S):
    """Past FLASH_THRESHOLD attention_apply takes the blockwise path; at S =
    4097 (q blocks of 2048 and k blocks of 1024, the last of each one token:
    the largest divisor, 241, is under half of each) and 4352 (4352 = 17 x
    256: q blocks of 1088, k blocks of 544) it equals the port's dense
    attention."""
    cfg = configs.get_smoke_config("internlm2-1.8b")
    qg, k, v, pos = (torch.from_numpy(a) for a in _qkv(cfg, S, 1, 2, seed=S))
    flash = layers._flash_attention(qg, k, v, pos, pos, cfg, "global")
    dense = layers._dense_attention(qg, k, v, pos, pos, None, cfg, "global")
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), rtol=LAYER_RTOL, atol=LAYER_ATOL)


# ---------------------------------------------------------------------------
# the reference's cache carried into the port; imports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma3-12b", "zamba2-2.7b", "rwkv6-1.6b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_from_a_reference_cache(arch, dtype):
    """The reference prefills 8 tokens and decodes one (its cache then
    mixes bf16, f32 and int32 leaves); convert.decode_cache carries the
    cache across, bf16 as uint16 bits, and the port's next logits match
    the reference's (f32: LOGIT_TOL; bf16: 2e-2 relative L2)."""
    jm, jp, m = _pair(arch, dtype)
    toks = _tokens(m.cfg, 2, 10, seed=6)
    jc = jm.init_cache(2, 16, prefilled=False)
    _, jc = jax.jit(jm.prefill)(jp, jnp.asarray(toks[:, :8]), cache=jc)
    _, jc = jax.jit(jm.decode_step)(jp, jnp.asarray(toks[:, 8]), jc)
    bits = jax.tree.map(lambda a: np.asarray(a).view(np.uint16)
                        if np.asarray(a).dtype.itemsize == 2 else np.asarray(a), jc)
    c = convert.decode_cache(m.cfg, bits)
    _check_cache(c, jc, "converted")
    for a, b in zip(jax.tree.leaves(jc), [v for d in c for _, v in sorted(d.items())]):
        np.testing.assert_array_equal(_np(b), _np(a))  # carried bit for bit
    want, _ = jax.jit(jm.decode_step)(jp, jnp.asarray(toks[:, 9]), jc)
    with torch.no_grad():
        got, _ = m.decode_step(m.tree(), torch.from_numpy(toks[:, 9]), c)
    if dtype == "float32":
        _close_logits(got, want, float(np.abs(np.asarray(want)).max()))
    else:
        w = _np(want)
        assert np.linalg.norm(_np(got) - w) / np.linalg.norm(w) < BF16_REL_L2
    with pytest.raises(ValueError, match="pattern positions"):
        convert.decode_cache(m.cfg, bits[:-1] if len(bits) > 1 else bits + bits)


def test_block_cache_for_every_kind():
    """block_init_cache gives the reference's leaves for every kind, and a
    prefilled recurrent cache's pos is seq_len."""
    jcfg, cfg = _cfgs("zamba2-2.7b")
    for kind in ("mamba2", "rwkv6", "shared_attn", "global", "local"):
        jcf = jconfigs.get_smoke_config("rwkv6-1.6b") if kind == "rwkv6" else jcfg
        cf = configs.get_smoke_config("rwkv6-1.6b") if kind == "rwkv6" else cfg
        want = jtransformer.block_init_cache(jcf, kind, 2, 12, prefilled=True)
        got = transformer.block_init_cache(cf, kind, 2, 12, prefilled=True, device="cpu")
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape and _dtype(got[k]) == str(want[k].dtype)
            np.testing.assert_array_equal(_np(got[k]), _np(want[k]))


def test_serving_imports_are_jax_free():
    code = ("import sys, repro_torch.serve, repro_torch.launch.serve; "
            "from repro_torch.serve import ServeEngine, Request, make_serve_step; "
            "assert 'jax' not in sys.modules and not any(m == 'repro' or "
            "m.startswith('repro.') for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
