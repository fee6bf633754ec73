"""The PyTorch port's Mamba2, RWKV6 and shared attention block against the
JAX package's, on the CPU at the smoke size.

* ``mamba2_apply`` and ``rwkv6_apply``: forward and the gradients of every
  parameter and of the input, in f32, on one chunk (S = 64) and on three
  (S = 192, the state carried across chunks); a sequence that is not a
  whole number of chunks (S = 150) is refused by both packages; a prompt
  into a decode cache and one decode step match the reference
  (``tests/test_torch_serve.py`` holds serving at large).
* The zamba2 (Mamba2 + shared attention) and rwkv6 smoke models: the
  logits and the loss's gradient on every leaf, f32.
* The flat layout, with zamba2's ``_shared`` placeholder and its unstacked
  ``shared_attn`` block: leaf paths, shapes, dtypes and the converted
  weights through ``tree_to_flat``, bit for bit, in f32 and bf16.

Inputs and weights come from numpy seeds (the models' from the reference's
``init``, carried across with ``convert.model_params``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (installs the jax compatibility shims)
from repro import configs as jconfigs
from repro.models import Model as JModel
from repro.models import ssm as jssm
from repro.train.flatten import tree_to_flat as j_tree_to_flat
from repro.train.loss import next_token_loss as j_loss
from repro_torch import configs, convert
from repro_torch.models import Model, ssm
from repro_torch.train import leaf_paths, next_token_loss, tree_to_flat
from repro_torch.train.flatten import leaves

ARCHS = ("zamba2-2.7b", "rwkv6-1.6b")
B = 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs test files in parallel
    processes, and several processes' full sets of spinning OpenMP threads
    on the same cores slow every file down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=dtype),
            dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype))


def _mixer_params(kind, cfg, seed=0):
    """f32 weights of one mixer, with every vector drawn away from its
    init (a zero ``u`` or ``A_log`` would leave paths untested)."""
    rng = np.random.RandomState(seed)
    d = cfg.d_model
    if kind == "mamba2":
        H, N = cfg.ssm_heads, cfg.ssm_state
        inner = H * 64
        return {"in_proj": rng.standard_normal((d, 2 * inner + 2 * N + H)) / np.sqrt(d),
                "out_proj": rng.standard_normal((inner, d)) / np.sqrt(inner),
                # decays whose cumulative log over a chunk stays inside f32's
                # exp: the scan's masked exp(clog_t - clog_s), s > t, is inf
                # past that, and 0 · inf makes the gradient NaN in both
                # packages alike
                "A_log": rng.uniform(-1.5, 0.0, H), "D": rng.uniform(0.5, 1.5, H),
                "dt_bias": rng.uniform(-1.0, 0.0, H),
                "norm_scale": rng.uniform(-0.2, 0.2, inner)}
    hd = cfg.rwkv_head_size
    H = d // hd
    p = {k: rng.standard_normal((d, d)) / np.sqrt(d) for k in ("wr", "wk", "wv", "wg", "wo")}
    p.update(w0=rng.uniform(-3.0, -1.0, d), w_proj=rng.standard_normal((d, d)) * 0.01,
             u=rng.uniform(-0.5, 0.5, (H, hd)), mu=rng.uniform(0.0, 1.0, (5, d)),
             ln_scale=rng.uniform(-0.2, 0.2, d))
    return p


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


APPLY = {"mamba2": (jssm.mamba2_apply, ssm.mamba2_apply),
         "rwkv6": (jssm.rwkv6_apply, ssm.rwkv6_apply)}
ARCH_OF = {"mamba2": "zamba2-2.7b", "rwkv6": "rwkv6-1.6b"}
# f32 bounds: forward relative L2 1e-5 and every gradient 1e-4. Measured:
# forward 9.4e-7 at most, gradients 3.4e-6 at most (the chunked scan's
# einsums contract in another order than XLA's).
FWD_REL, GRAD_REL = 1e-5, 1e-4


@pytest.mark.parametrize("S", [64, 192])
@pytest.mark.parametrize("kind", list(APPLY))
def test_mixer_matches_reference(kind, S):
    jcfg, cfg = _cfgs(ARCH_OF[kind])
    params = {k: v.astype(np.float32) for k, v in _mixer_params(kind, cfg).items()}
    rng = np.random.RandomState(1)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    japply, apply = APPLY[kind]

    def f(p, xx):
        y, _ = japply(p, xx, jcfg)
        return jnp.sum(y * cot), y

    (_, want), (jg, jgx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt = torch.tensor(x, requires_grad=True)
    y, cache = apply(p, xt, cfg)
    assert cache is None and y.shape == x.shape
    torch.sum(y * torch.from_numpy(cot)).backward()
    assert _rel(y.detach(), want) <= FWD_REL
    assert _rel(xt.grad, jgx) <= GRAD_REL
    for k in params:
        assert _rel(p[k].grad, jg[k]) <= GRAD_REL, k


@pytest.mark.parametrize("kind", list(APPLY))
def test_ragged_sequence_and_cache_refused(kind):
    """S = 150 is two chunks and a ragged tail: the reference asserts that
    the sequence is a whole number of chunks, and the port raises. A decode
    cache is taken: a 64-token prompt into the mixer's cache, then one
    decode step, each returning the reference's output (FWD_REL) and state
    (relative L2 1e-5)."""
    jcfg, cfg = _cfgs(ARCH_OF[kind])
    params = {k: v.astype(np.float32) for k, v in _mixer_params(kind, cfg).items()}
    x = np.zeros((1, 150, cfg.d_model), np.float32)
    japply, apply = APPLY[kind]
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    with pytest.raises(AssertionError):
        japply(jp, jnp.asarray(x), jcfg)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    with pytest.raises(ValueError, match="chunks"):
        apply(tp, torch.from_numpy(x), cfg)
    init = {"mamba2": (jssm.mamba2_init_cache, ssm.mamba2_init_cache),
            "rwkv6": (jssm.rwkv6_init_cache, ssm.rwkv6_init_cache)}[kind]
    extra = () if kind == "mamba2" else (cfg.d_model,)
    jc, c = init[0](jcfg, B, *extra), init[1](cfg, B, *extra, device="cpu")
    xs = np.random.RandomState(2).standard_normal((B, 65, cfg.d_model)).astype(np.float32)
    for part in (xs[:, :64], xs[:, 64:]):
        want, jc = japply(jp, jnp.asarray(part), jcfg, jc)
        got, c = apply(tp, torch.from_numpy(part), cfg, c)
        assert _rel(got, want) <= FWD_REL
        assert _rel(c["state"], jc["state"]) <= 1e-5
        np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jc["pos"]))


def _pair(arch, dtype="float32"):
    jcfg, cfg = _cfgs(arch, dtype)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    m = Model(cfg, device="cpu")
    m.load_state_dict(convert.model_params(cfg, jax.tree.map(np.asarray, jp)))
    return jm, jp, m


def _jpaths(jp):
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_flat_layout_bit_identical(arch, dtype):
    """The port's own model has the reference's leaves (paths, shapes,
    dtypes) — zamba2's ``blocks/1/_shared`` placeholder and its
    ``shared_attn`` block included — and the converted weights flatten to
    the reference's vector bit for bit."""
    _, jp, m = _pair(arch, dtype)
    own = Model(m.cfg, device="cpu").tree()
    assert leaf_paths(own) == leaf_paths(m.tree()) == _jpaths(jp)
    for a, b in zip(leaves(own), jax.tree.leaves(jp)):
        assert tuple(a.shape) == b.shape and str(a.dtype).split(".")[1] == str(b.dtype)
    if arch.startswith("zamba2"):
        assert "blocks/1/_shared" in leaf_paths(own)
        assert any(p.startswith("shared_attn/attn/") for p in leaf_paths(own))
        assert own["blocks"][1]["_shared"].dtype == torch.float32
    flat = tree_to_flat(m.tree()).numpy()
    np.testing.assert_array_equal(flat.view(np.uint32),
                                  np.asarray(j_tree_to_flat(jp)).view(np.uint32))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_logits_and_gradients_f32(arch):
    """The smoke model's logits (allclose rtol 1e-5, atol 1e-5) and the
    loss's gradient on every leaf (relative L2 1e-4 a leaf; the shared
    placeholder's and zamba2's unused ``ln2`` are zero in both) against the
    reference, f32, S = 128."""
    jm, jp, m = _pair(arch)
    toks = np.random.RandomState(0).randint(0, m.cfg.vocab, (B, 128)).astype(np.int32)
    want = np.asarray(jm.forward(jp, jnp.asarray(toks))[0])
    got, aux = m(torch.from_numpy(toks))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    assert float(aux) == 0.0
    jl, jg = jax.value_and_grad(
        lambda p: j_loss(jm.forward(p, jnp.asarray(toks))[0], jnp.asarray(toks)))(jp)
    loss = next_token_loss(m(torch.from_numpy(toks))[0], torch.from_numpy(toks))
    plist = leaves(m.tree())
    grads = torch.autograd.grad(loss, plist, allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for path, g, w in zip(leaf_paths(m.tree()), grads, jax.tree.leaves(jg)):
        if g is None:  # the placeholder, and zamba2's unused ln2: zero in the reference
            assert path.endswith(("_shared", "ln2/scale")) and not np.asarray(w).any(), path
            continue
        assert _rel(g, w) <= GRAD_REL, path


def _mamba2_sequential(p, x, cfg):
    """Mamba2 by its recurrence, one token at a time (the reference's decode
    step), in float64: S_t = a_t·S_{t-1} + dt_t·(B_t ⊗ x_t), y_t = S_t·C_t
    + D·x_t, then the gated norm and the output projection."""
    F = torch.nn.functional
    H, N, hd = cfg.ssm_heads, cfg.ssm_state, 64
    inner = H * hd
    B_, S_, _ = x.shape
    z, xi, Bm, Cm, dt = torch.split(x @ p["in_proj"], [inner, inner, N, N, H], dim=-1)
    xi = xi.reshape(B_, S_, H, hd)
    dt = F.softplus(dt + p["dt_bias"])
    a = torch.exp(-torch.exp(p["A_log"]) * dt)
    st = torch.zeros((B_, H, hd, N), dtype=x.dtype)
    ys = []
    for t in range(S_):
        st = st * a[:, t, :, None, None] + torch.einsum("bh,bhp,bn->bhpn", dt[:, t],
                                                        xi[:, t], Bm[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", st, Cm[:, t]))
    y = (torch.stack(ys, 1) + p["D"][None, None, :, None] * xi).reshape(B_, S_, inner)
    y = y * F.silu(z)
    y = y * torch.rsqrt(torch.mean(torch.square(y), -1, keepdim=True) + 1e-6)
    return (y * (1.0 + p["norm_scale"])) @ p["out_proj"]


def test_mamba2_masked_decay_keeps_the_gradient_finite():
    """Fast decays (A_log and dt_bias well above their inits) make a chunk's
    summed decay pass 88, where f32's exp overflows: the reference masks
    exp(clog_t - clog_s) after the exp, so its backward forms 0 · inf and its
    gradient is NaN; the port masks the exponent. The same forward as the
    reference (relative L2 1e-5); the port's f32 gradient finite and within
    1e-4 (relative L2) of the token-by-token recurrence in float64."""
    jcfg, cfg = _cfgs("zamba2-2.7b")
    params = {k: v.astype(np.float32) for k, v in _mixer_params("mamba2", cfg).items()}
    params["A_log"] = np.full_like(params["A_log"], 1.0)
    params["dt_bias"] = np.full_like(params["dt_bias"], 3.0)
    x = np.random.RandomState(1).standard_normal((B, 64, cfg.d_model)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jy = jssm.mamba2_apply(jp, jnp.asarray(x), jcfg)[0]
    jgx = jax.grad(lambda xx: jnp.sum(jssm.mamba2_apply(jp, xx, jcfg)[0]))(jnp.asarray(x))
    assert not np.isfinite(np.asarray(jgx)).all()  # the reference's NaN
    xt = torch.tensor(x, requires_grad=True)
    y, _ = ssm.mamba2_apply({k: torch.from_numpy(v) for k, v in params.items()}, xt, cfg)
    torch.sum(y).backward()
    x64 = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    torch.sum(_mamba2_sequential({k: torch.tensor(v, dtype=torch.float64)
                                  for k, v in params.items()}, x64, cfg)).backward()
    assert _rel(y.detach(), jy) <= FWD_REL
    assert np.isfinite(xt.grad.numpy()).all()
    assert _rel(xt.grad, x64.grad) <= GRAD_REL
