"""The vocabulary-parallel next-token loss against the reference's.

``train/loss.py::vocab_parallel_loss`` takes the logits split over a model
group by vocabulary, each rank its own words, and gives the mean next-token
CE and the gradient of its shard without gathering them. One
``RankPool`` of 6 gloo ranks at one intra-op thread runs it as model groups
of m = 2 (three groups) and m = 3 (two groups), over a vocabulary of 29
words that neither divides (``models/sharding.py::unit_share``: 15/14 and
10/10/9), on f32 logits made from a seed with numpy:

- plain [B, S, V] logits, with ``prefix_len``, the multi-codebook [B, S,
  nc, V] layout, and softcapped logits (the loss's gradient taken through
  the softcap to the logits before it);

against the reference's ``repro.train.loss.next_token_loss`` of the whole
logits and its ``jax.grad``. The ranks' shards of the gradient are joined
in rank order. And for the slice as a whole, ``Model.loss`` of the smoke
internlm2-1.8b with a 511-word vocabulary split over the group against
``next_token_loss`` of the one-process model's logits: the loss and every
leaf's gradient, and ``apply``'s gathered logits of the uneven shards.

Bounds (f32; measured on the CPU in the comment beside each): the loss
within ``LOSS_TOL`` relative, each gradient within ``GRAD_TOL`` of its
largest |word|. The shards' sums are added in rank order, the one-process
log-softmax's in one pass, so the two differ by the order of a sum of V
terms. The model's gradients pass through the tensor-parallel blocks, whose
partial products are summed over the ranks (``tests/test_torch_dist_tp.py``
bounds them), so they get ``MODEL_TOL``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.dist import RankPool, grid
from repro_torch.models import Model
from repro_torch.models.sharding import unit_share
from repro_torch.train.flatten import leaves, leaves_with_paths, tree_map
from repro_torch.train.loss import next_token_loss, param_grads, vocab_parallel_loss

RANKS, GROUPS = 6, (2, 3)
V, B, S, NC, PREFIX, SOFTCAP = 29, 3, 7, 2, 2, 5.0
CASES = ("plain", "prefix", "codebooks", "softcap")
MODEL_VOCAB = 511
LOSS_TOL = 1e-6     # relative (8.7e-8 at worst seen)
GRAD_TOL = 1e-6     # of the largest |gradient word| (4.0e-7 at worst seen)
MODEL_TOL = 1e-5    # the model's loss, logits and gradients (9.6e-7 at worst seen)


def _case(name):
    """(logits f32 [B, S(+P), (nc,) V], tokens int [B, S(, nc)], prefix_len,
    softcap) of a case, from a seed."""
    rng = np.random.RandomState(CASES.index(name))
    prefix = PREFIX if name == "prefix" else 0
    lead = (B, S + prefix) + ((NC,) if name == "codebooks" else ())
    logits = (rng.randn(*lead, V) * 3).astype(np.float32)
    tokens = rng.randint(0, V, (B, S) + ((NC,) if name == "codebooks" else ())).astype(np.int32)
    return logits, tokens, prefix, (SOFTCAP if name == "softcap" else None)


def _capped(z, cap):
    return z if cap is None else cap * torch.tanh(z / cap)


def _model_cfg():
    return dataclasses.replace(get_smoke_config("internlm2-1.8b"), dtype="float32",
                               vocab=MODEL_VOCAB, n_layers=1)


def _model_tokens():
    return torch.from_numpy(np.random.RandomState(11).randint(
        0, MODEL_VOCAB, (2, 12)).astype(np.int32))


# ---- the ranks ---------------------------------------------------------------------------

def _rank(world):
    out = {}
    for m in GROUPS:
        g = grid(world, m)
        tp = g.model
        lo, hi = unit_share(V, m, tp.rank)
        for name in CASES:
            logits, tokens, prefix, cap = _case(name)
            z = torch.from_numpy(logits[..., lo:hi].copy()).requires_grad_(True)
            loss = vocab_parallel_loss(_capped(z, cap), torch.from_numpy(tokens), lo, tp,
                                       prefix)
            loss.backward()
            out[(m, name)] = (loss.detach(), z.grad)
        cfg = _model_cfg()
        model = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(3),
                      tp_world=tp)
        toks = _model_tokens()
        p = tree_map(lambda t: t.detach().requires_grad_(True), model.tree())
        loss, _ = model.loss(p, toks)
        grads = param_grads(loss, leaves(p))
        with torch.no_grad():
            logits, _ = model.apply(model.tree(), toks)
        out[(m, "model")] = (loss.detach(), [g.detach() for g in grads], logits,
                             model.vocab_span)
    return out


# ---- the reference and the one-process model ---------------------------------------------

def _reference(name):
    import repro  # noqa: F401 - the package's jax shims first
    import jax
    import jax.numpy as jnp
    from repro.train.loss import next_token_loss as ref_loss
    logits, tokens, prefix, cap = _case(name)

    def f(z):
        return ref_loss(z if cap is None else cap * jnp.tanh(z / cap), jnp.asarray(tokens),
                        prefix)
    loss, grad = jax.value_and_grad(f)(jnp.asarray(logits))
    return float(loss), np.asarray(grad)


def _one_process():
    model = Model(_model_cfg(), device="cpu", generator=torch.Generator().manual_seed(3))
    toks = _model_tokens()
    p = tree_map(lambda t: t.detach().requires_grad_(True), model.tree())
    logits, aux = model.apply(p, toks)
    loss = next_token_loss(logits, toks)
    grads = param_grads(loss, leaves(p))
    return model, loss.detach(), [g.detach() for g in grads], logits.detach()


@pytest.fixture(scope="module")
def runs():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with RankPool(RANKS, "cpu", threads=1) as pool:
            ranks = [r["result"] for r in pool.run(_rank)]
    finally:
        torch.set_num_threads(n)
    return ranks


def _group(ranks, m):
    """The ranks of model group 0 of the m-rank grid (ranks 0 .. m − 1)."""
    return ranks[:m]


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)))
                 / max(np.max(np.abs(np.asarray(want, np.float64))), 1e-30))


# ---- the tests ----------------------------------------------------------------------------

@pytest.mark.parametrize("m", GROUPS)
@pytest.mark.parametrize("name", CASES)
def test_vocab_parallel_loss_matches_reference(runs, m, name):
    """Every rank of every group holds the same loss bits; the loss within
    ``LOSS_TOL`` of the reference's and the joined shards' gradient within
    ``GRAD_TOL`` of its ``jax.grad``."""
    want_loss, want_grad = _reference(name)
    group = _group(runs, m)
    for r in runs:
        assert torch.equal(r[(m, name)][0], group[0][(m, name)][0])
    got_loss = float(group[0][(m, name)][0])
    assert abs(got_loss - want_loss) <= LOSS_TOL * abs(want_loss), (got_loss, want_loss)
    grad = torch.cat([r[(m, name)][1] for r in group], dim=-1)
    assert grad.shape == want_grad.shape
    assert _rel(grad, want_grad) <= GRAD_TOL, _rel(grad, want_grad)


@pytest.mark.parametrize("m", GROUPS)
def test_model_loss_on_uneven_vocab_shards(runs, m):
    """``Model.loss`` on 511 words split over m ranks (256/255 and
    171/170/170): the loss and each leaf's gradient (a shard's against the
    same words of the one-process gradient, ``Split.cut``) within
    ``MODEL_TOL``; ``apply``'s gathered logits within it too, and every
    rank's the same bits."""
    from repro_torch.models.sharding import tp_dim
    model, loss, grads, logits = _one_process()
    group = _group(runs, m)
    assert [r[(m, "model")][3] for r in group] == [unit_share(MODEL_VOCAB, m, j)
                                                   for j in range(m)]
    for j, r in enumerate(group):
        got_loss, got_grads, got_logits, _ = r[(m, "model")]
        assert torch.equal(got_loss, group[0][(m, "model")][0])
        assert abs(float(got_loss) - float(loss)) <= MODEL_TOL * abs(float(loss))
        assert _rel(got_logits, logits) <= MODEL_TOL
        assert torch.equal(got_logits, group[0][(m, "model")][2])
        for (path, full), g, want in zip(leaves_with_paths(model.tree()), got_grads, grads):
            sp = tp_dim(path, full, model.cfg, m)
            cut = want if sp is None else sp.cut(want, j, m)
            assert g.shape == cut.shape, path
            assert _rel(g, cut) <= MODEL_TOL, (path, _rel(g, cut))
