"""The PyTorch port's MoE MLP against the JAX package's.

In process, on the same f32 inputs made from a numpy seed:

* the routing of both paths' (``_dispatch_indices``, and the slots
  ``moe_apply`` fills): assignments, slots, gates and load shares exactly
  equal, with capacities that drop tokens and ones that do not;
* ``moe_apply`` forward, aux loss and gradients (of every parameter and of
  the input) for top-8 routing (the qwen3-moe smoke model's MoE widened to
  16 experts, top-8), top-1 with a shared expert (the llama4 smoke model's)
  and a capacity that drops tokens.

In a subprocess on a (4, 1) mesh of host devices with Auto axes: the
reference's ``_moe_apply_ep`` under ``shard_map`` (the experts sharded over
the four ranks, the dispatch through two all-to-alls) against the port's
single-card ``_moe_apply_ep`` of each rank's tokens over all experts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import run_multidevice
from repro.models import moe as ref_moe
from repro.models.config import MoEConfig as RefMoEConfig
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe


def _cfgs():
    qwen = get_smoke_config("qwen3-moe-235b-a22b")
    llama = get_smoke_config("llama4-maverick-400b-a17b")
    return {
        "top8": (qwen.d_model, dataclasses.replace(qwen.moe, num_experts=16, top_k=8)),
        "top1-shared": (llama.d_model, llama.moe),
        "drops": (qwen.d_model, dataclasses.replace(qwen.moe, capacity_factor=0.5)),
    }


CASES = _cfgs()
B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs test files in parallel
    processes, and several processes' full sets of spinning OpenMP threads
    on the same cores slow every file down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ref_cfg(moe_cfg):
    return RefMoEConfig(**dataclasses.asdict(moe_cfg))


def _params(d, moe_cfg, seed=0):
    """f32 weights: a router with unit scale, so that top-k picks are far
    apart (a scale-0.02 router gives near-uniform probabilities, where one
    ulp between two matmuls may flip a pick), and 1/sqrt(fan-in) experts."""
    rng = np.random.RandomState(seed)
    E, ff, s = moe_cfg.num_experts, moe_cfg.expert_d_ff, moe_cfg.num_shared_experts
    shapes = {"router": (d, E), "wi": (E, d, ff), "wg": (E, d, ff), "wo": (E, ff, d)}
    if s:
        shapes.update(shared_wi=(d, s * ff), shared_wg=(d, s * ff), shared_wo=(s * ff, d))
    return {k: (rng.standard_normal(v) / (1.0 if k == "router" else np.sqrt(v[-2])))
            .astype(np.float32) for k, v in shapes.items()}


def _x(d, seed=1, b=B, s=S):
    return np.random.RandomState(seed).standard_normal((b, s, d)).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# ---- routing: exactly equal in f32 ------------------------------------------------

@pytest.mark.parametrize("T,k,E,cf", [(64, 8, 16, 1.25), (64, 2, 4, 0.5), (8, 2, 4, 1.0),
                                      (200, 1, 4, 1.25), (3, 2, 4, 4.0)])
def test_dispatch_indices_exact(T, k, E, cf):
    """The same router probabilities give the same slots, tokens, gates and
    load shares, bit for bit, and the same capacity (floored at 4)."""
    rng = np.random.RandomState(T + k)
    logits = rng.standard_normal((T, E)).astype(np.float32) * 3
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    tok, gate, C, frac = ref_moe._dispatch_indices(jnp.asarray(probs), k, E, T, cf)
    mtok, mgate, mC, mfrac = moe._dispatch_indices(torch.tensor(probs), k, E, T, cf)
    assert mC == C == max(4, min(int(np.ceil(T * k / E * cf)), T))
    np.testing.assert_array_equal(mtok.numpy(), np.asarray(tok))
    np.testing.assert_array_equal(mgate.numpy().view(np.uint32), np.asarray(gate).view(np.uint32))
    np.testing.assert_array_equal(mfrac.numpy().view(np.uint32), np.asarray(frac).view(np.uint32))
    # moe_apply fills its slots with the same code at its own capacity,
    # floored at 8 (test_ep_and_dense_capacity_floors_differ holds it)
    assert moe._capacity(T, k, E, cf, floor=8) == max(8, min(int(np.ceil(T * k / E * cf)), T))


# ---- moe_apply: forward, aux and gradients ------------------------------------------

# f32 bounds: forward relative L2 1e-5 (measured 1.9e-6 at most), aux
# within 1e-6 (measured 9.3e-10), every gradient relative L2 1e-4
# (measured 2.7e-6 at most, the top-1 router's aside).
FWD_REL, AUX_ABS, GRAD_REL = 1e-5, 1e-6, 1e-4


def _ref_forward_grads(params, x, moe_cfg, cot):
    rcfg = _ref_cfg(moe_cfg)

    def f(p, xx):
        y, aux = ref_moe.moe_apply(p, xx, rcfg)
        return jnp.sum(y * cot) + 10.0 * aux, (y, aux)

    (_, (y, aux)), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return np.asarray(y), float(aux), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_reference(case):
    d, moe_cfg = CASES[case]
    params, x = _params(d, moe_cfg), _x(d)
    cot = np.random.RandomState(2).standard_normal(x.shape).astype(np.float32)
    y_ref, aux_ref, (g_ref, gx_ref) = _ref_forward_grads(params, x, moe_cfg, cot)
    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_apply(p, xt, moe_cfg)
    (torch.sum(y * torch.from_numpy(cot)) + 10.0 * aux).backward()
    assert _rel(y.detach(), y_ref) <= FWD_REL
    assert abs(float(aux.detach()) - aux_ref) <= AUX_ABS
    assert _rel(xt.grad, gx_ref) <= GRAD_REL
    for k in params:
        if k == "router" and moe_cfg.top_k == 1:
            # one renormalised gate is identically 1: its share of the router
            # gradient is rounding noise in both packages (measured 1e-6
            # apart on a gradient of 1e-3), so the bound is absolute
            assert float((p[k].grad - torch.from_numpy(g_ref[k])).abs().max()) <= 1e-5
        else:
            assert _rel(p[k].grad, g_ref[k]) <= GRAD_REL, k
    if case == "drops":  # some tokens really went past capacity
        T, E, k = B * S, moe_cfg.num_experts, moe_cfg.top_k
        C = moe._capacity(T, k, E, moe_cfg.capacity_factor, floor=8)
        _, assign = torch.topk(torch.softmax(torch.from_numpy(x.reshape(T, d))
                                             @ p["router"].detach(), -1), k)
        assert int(torch.bincount(assign.reshape(-1), minlength=E).max()) > C


def test_ep_and_dense_capacity_floors_differ():
    """8 tokens, top-2 of 4 experts at capacity factor 1: the EP path's
    capacity is 4 (tokens drop) and moe_apply's 8 (none can), in both
    packages; each path agrees with its reference counterpart."""
    d, moe_cfg = CASES["top1-shared"]
    moe_cfg = dataclasses.replace(moe_cfg, top_k=2, capacity_factor=1.0)
    params, x = _params(d, moe_cfg), _x(d, b=1, s=8)
    rcfg = _ref_cfg(moe_cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    dense = moe.moe_apply(tp, torch.from_numpy(x), moe_cfg)[0].numpy()
    assert _rel(dense, ref_moe.moe_apply(jp, jnp.asarray(x), rcfg)[0]) <= FWD_REL
    probs = torch.softmax(torch.from_numpy(x.reshape(8, d)) @ tp["router"], -1)
    ep_tok = moe._dispatch_indices(probs, 2, 4, 8, 1.0)[0]
    assert ep_tok.numel() == 4 * 4
    ep = moe._moe_apply_ep(tp, torch.from_numpy(x), moe_cfg, 4)[0].numpy()
    assert not np.allclose(ep, dense)


# ---- the expert-parallel forward against the reference's shard_map ---------------

EP_CODE = """
import repro  # the package's jax shims first
import dataclasses, jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, PartitionSpec as P
from repro.models.config import MoEConfig
from repro.models.moe import _moe_apply_ep
data = dict(np.load("@IN@"))
cfg = MoEConfig(**@CFG@)
mesh = jax.make_mesh((4, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
params = {k[2:]: jnp.asarray(v) for k, v in data.items() if k.startswith("p/")}
specs = {k: P("data") if k in ("wi", "wg", "wo") else P() for k in params}

def per_rank(p, x):
    y, aux = _moe_apply_ep(p, x[0], cfg, "data", 4)
    return y[None], aux[None]

f = jax.jit(jax.shard_map(per_rank, mesh=mesh, in_specs=(specs, P("data")),
                          out_specs=(P("data"), P("data")),
                          axis_names=frozenset({"data"}), check_vma=False))
with jax.set_mesh(mesh):
    y, aux = f(params, jnp.asarray(data["x"]))
np.savez("@OUT@", y=np.asarray(y), aux=np.asarray(aux))
print("EP_OK")
"""


@pytest.mark.parametrize("case", ["top8", "top1-shared"])
def test_ep_forward_matches_reference_shard_map(tmp_path, case):
    """Four ranks' tokens: rank r's output and aux loss from the
    reference's all-to-all dispatch equal the port's dispatch of the same
    tokens over all experts on one card (f32: relative L2 1e-5, aux within
    1e-6)."""
    d, moe_cfg = CASES[case]
    params = _params(d, moe_cfg)
    x = np.stack([_x(d, seed=10 + r) for r in range(4)])  # [4, B, S, d]
    np.savez(tmp_path / "in.npz", x=x, **{f"p/{k}": v for k, v in params.items()})
    code = (EP_CODE.replace("@IN@", str(tmp_path / "in.npz"))
            .replace("@OUT@", str(tmp_path / "out.npz"))
            .replace("@CFG@", repr(dataclasses.asdict(moe_cfg))))
    assert "EP_OK" in run_multidevice(code, devices=4, timeout=600)
    ref = np.load(tmp_path / "out.npz")
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    for r in range(4):
        y, aux = moe.moe_apply(tp, torch.from_numpy(x[r]), moe_cfg, ep_axis="data", ep_ranks=4)
        assert _rel(y.numpy(), ref["y"][r]) <= FWD_REL, r
        assert abs(float(aux) - float(ref["aux"][r])) <= AUX_ABS, r
