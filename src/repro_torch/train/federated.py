"""FedAvg with SAFE-secure delta aggregation (the paper's use case).

The counterpart of the JAX package's ``train/federated.py`` on one card.
Each of the n learners takes ``k`` local AdamW steps from the round's
parameters; its model delta Δ_l = θ_l − θ_round, f32[P] in the
reference's flat layout (``train/flatten.py``), is row l of one [n, P]
matrix; ``SecureAggregator.aggregate`` publishes the mean of the rows —
weighted by the learners' sample counts when the aggregator is built with
``weighted=True`` (§5.6) — and the mean is applied to the parameters.

Where the reference runs the learners side by side, one per mesh rank,
the port runs them one after another on the card, learner-major as every
path of the port is. A learner's copy of the parameters and its optimizer
state are freed before the next learner starts. A dead learner still
trains, as in the reference; the round ignores its row.

``make_wire_federated`` (the wire runtime) is not ported yet (ROADMAP
Queue 1 item 5).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable

import torch

from repro_torch.core.aggregators import SecureAggregator
from repro_torch.optim.adamw import AdamW
from repro_torch.train.flatten import leaves, tree_map, tree_size, tree_unflatten
from repro_torch.train.loss import next_token_loss

if TYPE_CHECKING:  # the model package imports this package's flatten
    from repro_torch.models.transformer import Model


@dataclasses.dataclass
class FederatedBundle:
    """``round_fn(params, tokens, weights, counter, alive) -> (params,
    metrics)`` runs one round: ``deltas_fn``, then the aggregation, then
    ``apply_delta``. ``deltas_fn(params, tokens) -> (deltas f32[n, P],
    losses f32[n])`` is its first part, for callers that time or check the
    parts. ``init_state_fn`` (the identity: the round's state is the
    parameter tree) keeps the reference bundle's fields."""

    round_fn: Any
    init_state_fn: Any
    deltas_fn: Any


def make_local_update(
    model: Model,
    *,
    local_steps: int = 4,
    local_lr: float = 1e-3,
) -> Callable:
    """One learner's FedAvg local update.

    Returns ``local_update(params, tokens, out=None) -> (delta, mean_loss)``
    where ``params`` is a parameter tree (``Model.tree()``), ``tokens`` is
    int[local_steps, B, S] (one microbatch per local optimizer step) and
    ``delta`` is f32[P] in the flat layout, written into ``out`` when given.
    ``params`` is not modified.
    """
    cfg = model.cfg
    local_opt = AdamW(lr=local_lr, weight_decay=0.0, grad_clip=1.0)

    def local_update(params, tokens, out=None):
        if tokens.shape[0] != local_steps:
            raise ValueError(f"tokens: expected {local_steps} microbatches, "
                             f"got shape {tuple(tokens.shape)}")
        p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
        state = local_opt.init(p)
        losses = []
        for i in range(local_steps):
            batch = tokens[i]
            with torch.enable_grad():
                logits, aux = model.apply(p, batch)
                loss = next_token_loss(logits, batch, cfg.prefix_embeds) + aux
                grads = torch.autograd.grad(loss, leaves(p))
            del logits
            p, state = local_opt.update(tree_unflatten(p, grads), state, p)
            del grads
            p = tree_map(lambda t: t.requires_grad_(True), p)
            losses.append(loss.detach())
        if out is None:
            out = torch.empty(tree_size(params), dtype=torch.float32,
                              device=leaves(params)[0].device)
        off = 0
        for new, old in zip(leaves(p), leaves(params)):
            n = new.numel()
            # the reference's tree_to_flat(new) - tree_to_flat(old), leaf by leaf
            torch.sub(new.detach().reshape(-1).float(), old.detach().reshape(-1).float(),
                      out=out[off:off + n])
            off += n
        return out, torch.stack(losses).mean()

    return local_update


@torch.no_grad()
def apply_delta(params: Any, avg_delta: torch.Tensor) -> Any:
    """Merge a published average delta back into the parameter tree: the
    reference's ``flat_to_tree(tree_to_flat(params) + avg_delta)``, leaf by
    leaf (the same f32 add and cast back)."""
    avg_delta = avg_delta.float()
    off = 0

    def add(leaf):
        nonlocal off
        n = leaf.numel()
        merged = leaf.detach().reshape(-1).float() + avg_delta[off:off + n]
        off += n
        return merged.reshape(leaf.shape).to(leaf.dtype)

    return tree_unflatten(params, [add(leaf) for leaf in leaves(params)])


def make_federated_round(
    model: Model,
    aggregator: SecureAggregator,
    *,
    local_steps: int = 4,
    local_lr: float = 1e-3,
    return_delta: bool = False,
) -> FederatedBundle:
    """Build one FedAvg round: k local AdamW steps per learner, then the
    secure (weighted, when the aggregator's ``cfg.weighted``) mean of the
    deltas, applied to the parameters.

    ``round_fn(params, tokens, weights=None, counter=0, alive=None)``:
    ``params`` a parameter tree on the device the round runs on, ``tokens``
    int[n, local_steps, B, S], ``weights`` f32[n] sample counts, ``counter``
    the round's first counter word (advance it by P + 1 words a weighted
    round so no pad is reused), ``alive`` a 0/1 [n] bitmap. Returns the new
    tree and the metrics ``local_loss`` (mean over all n learners),
    ``delta_norm`` and, with ``return_delta``, ``avg_delta`` (f32[P]), as
    tensors on that device.
    """
    n = aggregator.cfg.num_learners
    local_update = make_local_update(model, local_steps=local_steps,
                                     local_lr=local_lr)

    def deltas_fn(params, tokens):
        tokens = torch.as_tensor(tokens)
        if tokens.dim() < 2 or tokens.shape[0] != n:
            raise ValueError(f"tokens: expected [{n}, {local_steps}, B, S], "
                             f"got shape {tuple(tokens.shape)}")
        dev = leaves(params)[0].device
        deltas = torch.empty((n, tree_size(params)), dtype=torch.float32, device=dev)
        losses = [local_update(params, tokens[l].to(dev), out=deltas[l])[1]
                  for l in range(n)]
        return deltas, torch.stack(losses)

    def round_fn(params, tokens, weights=None, counter=0, alive=None):
        deltas, losses = deltas_fn(params, tokens)
        avg_delta = aggregator.aggregate(deltas, int(counter), alive=alive,
                                         weights=weights)
        del deltas
        out_params = apply_delta(params, avg_delta)
        metrics = {"local_loss": losses.mean(),
                   "delta_norm": torch.sqrt(torch.sum(torch.square(avg_delta)))}
        if return_delta:
            metrics["avg_delta"] = avg_delta
        return out_params, metrics

    return FederatedBundle(round_fn=round_fn, init_state_fn=lambda p: p,
                           deltas_fn=deltas_fn)
