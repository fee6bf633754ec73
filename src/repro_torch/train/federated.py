"""FedAvg with SAFE-secure delta aggregation (the paper's use case).

The counterpart of the JAX package's ``train/federated.py`` on one card.
Each of the n learners takes ``k`` local AdamW steps from the round's
parameters; its model delta Δ_l = θ_l − θ_round, f32[P] in the
reference's flat layout (``train/flatten.py``), is row l of one [n, P]
matrix; ``SecureAggregator.aggregate`` publishes the mean of the rows —
weighted by the learners' sample counts when the aggregator is built with
``weighted=True`` (§5.6) — and the mean is applied to the parameters.

Two runtimes consume the same local update (``make_local_update``):

* ``make_federated_round`` — the whole round in process. Where the
  reference runs the learners side by side, one per mesh rank, the port
  runs them one after another on the card, learner-major. A learner's
  copy of the parameters and its optimizer state are freed before the
  next learner starts. A dead learner still trains, as in the reference;
  the round ignores its row. Given a mesh over a live process group it
  runs one learner per rank, as the reference does (``_rank_round``).
* ``make_wire_federated`` — one callable per learner, the paper's own
  deployment: ``net.client.run_federated_round_net`` (and
  ``run_federated_rounds_net``) runs them and ships their deltas through
  the SAFE chain over a real broker, the controller a mere message broker.
  The callables run the local steps on the model's device and hand the
  delta back as f32[P] numpy, so ``repro_torch.net`` stays numpy-only.

With model shards (a model built with ``tp_world``, the model group of a
('data', 'model') grid) the local steps run tensor-parallel, their loss
on each rank's vocabulary shard of the logits (``Model.loss``) and their
clip reading the norm over every rank's shards, and the delta's chunk goes
through the sharded round (``_tp_round``), with pods (``dist.grid``)
each pod's chunk meeting the other pods' over the pod group.

The two share the local update and one fixed-point and PRF substrate, so
a wire round's published delta is bit-identical to ``round_fn``'s for the
same counter, weights and alive bitmap (``tests/test_torch_federated.py``).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.aggregators import SecureAggregator
from repro_torch.dist import collectives
from repro_torch.dist.world import pod_world_of, rank_world
from repro_torch.optim.adamw import AdamW
from repro_torch.train.flatten import leaves, tree_map, tree_size, tree_unflatten, write_chunk
from repro_torch.train.loss import param_grads
from repro_torch.train.train_step import tp_norm, tp_padded_size

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
    padded_size: Optional[int] = None  # with model shards: the words a round pads, less the weight


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
    local_opt = AdamW(lr=local_lr, weight_decay=0.0, grad_clip=1.0)
    tp = model.tp_world

    def local_update(params, tokens, out=None):
        if tokens.shape[0] != local_steps:
            raise ValueError(f"tokens: expected {local_steps} microbatches, "
                             f"got shape {tuple(tokens.shape)}")
        p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
        state = local_opt.init(p)
        losses = []
        for i in range(local_steps):
            batch = tokens[i]
            with torch.enable_grad():  # with tp, the loss on this rank's vocabulary shard
                loss, aux = model.loss(p, batch)
                loss = loss + aux
                grads = param_grads(loss, leaves(p))
            gnorm = None if tp is None else tp_norm(grads, model.tp_dims, tp)
            p, state = local_opt.update(tree_unflatten(p, grads), state, p, gnorm)
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
    leaf (the same f32 add and cast back). ``avg_delta`` is f32[P], a tensor
    or a numpy array (as the wire round publishes it)."""
    avg_delta = torch.as_tensor(avg_delta, dtype=torch.float32).to(leaves(params)[0].device)
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
    mesh: Any = None,
    *,
    local_steps: int = 4,
    local_lr: float = 1e-3,
    learner_axis: str = "data",
    pod_axis: Optional[str] = None,
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

    ``pod_axis`` (the aggregator's, which it defaults to): hierarchical
    federation, as the reference's. ``tokens`` are int[P·n, local_steps, B, S], pod-major;
    each learner is weighted by its learner rank's entry of the f32[n]
    ``weights`` in every pod; the aggregator publishes the mean over pods.
    ``local_loss`` is what the reference's replicated output holds: its
    ``pmean`` runs over the learners only, and the value it returns is pod
    0's (``tests/test_torch_federated.py``).

    With a ``mesh`` that puts one learner on each rank of a live process
    group (a ``repro_torch.dist.World`` or a ``launch/mesh.py`` mesh over
    it; with ``pod_axis`` a ('pod', 'data') mesh), the round is the
    reference's ``per_rank_round``: ``round_fn`` takes this learner's
    int[local_steps, B, S] ``tokens`` and the f32[n] ``weights`` of every
    learner (or this one's scalar), and this rank's delta goes through
    ``aggregate_rank``; ``local_loss`` is the ``pmean`` of the learners'
    losses (pod 0's with pods) and ``deltas_fn`` is absent. The published
    delta and the new parameters are the one-card round's bit for bit.
    """
    n = aggregator.cfg.num_learners
    if pod_axis is not None and pod_axis != aggregator.cfg.pod_axis:
        raise ValueError(f"pod_axis={pod_axis!r} but the aggregator's is "
                         f"{aggregator.cfg.pod_axis!r}")
    pod_axis = aggregator.cfg.pod_axis
    local_update = make_local_update(model, local_steps=local_steps,
                                     local_lr=local_lr)
    world = rank_world(mesh, learner_axis)
    pod_world = None if pod_axis is None else pod_world_of(mesh, pod_axis)
    if model.tp_world is not None:
        if world is None:
            raise ValueError(f"{model.cfg.arch_id}: a model split over model ranks runs one "
                             "learner a ring rank (grid_worlds, or dist.grid with pods)")
        return _tp_round(model, aggregator, world, pod_world, local_update, return_delta)
    if world is not None:
        return _rank_round(aggregator, world, pod_world, local_update, return_delta)

    def deltas_fn(params, tokens):
        tokens = torch.as_tensor(tokens)
        if tokens.dim() < 2 or tokens.shape[0] % n or (pod_axis is None
                                                      and tokens.shape[0] != n):
            raise ValueError(f"tokens: expected [{'P·' if pod_axis else ''}{n}, "
                             f"{local_steps}, B, S], got shape {tuple(tokens.shape)}")
        dev = leaves(params)[0].device
        rows = tokens.shape[0]
        deltas = torch.empty((rows, tree_size(params)), dtype=torch.float32, device=dev)
        losses = [local_update(params, tokens[l].to(dev), out=deltas[l])[1]
                  for l in range(rows)]
        return deltas, torch.stack(losses)

    def round_fn(params, tokens, weights=None, counter=0, alive=None):
        deltas, losses = deltas_fn(params, tokens)
        pods = deltas.shape[0] // n
        if pod_axis is not None:
            deltas = deltas.view(pods, n, -1)
            if weights is not None:  # every pod's learner l weighs weights[l]
                w = torch.as_tensor(weights if isinstance(weights, torch.Tensor)
                                    else np.asarray(weights, np.float32))
                weights = w.reshape(1, n).expand(pods, n)
        avg_delta = aggregator.aggregate(deltas, int(counter), alive=alive,
                                         weights=weights)
        del deltas
        out_params = apply_delta(params, avg_delta)
        metrics = {"local_loss": losses.view(pods, n)[0].mean(),
                   "delta_norm": torch.sqrt(torch.sum(torch.square(avg_delta)))}
        if return_delta:
            metrics["avg_delta"] = avg_delta
        return out_params, metrics

    return FederatedBundle(round_fn=round_fn, init_state_fn=lambda p: p,
                           deltas_fn=deltas_fn)


def _rank_round(aggregator: SecureAggregator, world, pod_world, local_update: Callable,
                return_delta: bool) -> FederatedBundle:
    """``make_federated_round`` with one learner per rank (and with pods,
    one pod a rank of ``pod_world``)."""
    n = aggregator.cfg.num_learners
    aggregator.check_world(world, pod_world)

    def round_fn(params, tokens, weights=None, counter=0, alive=None):
        dev = leaves(params)[0].device
        w = None
        if weights is not None:
            w = torch.as_tensor(np.asarray(weights, np.float32)
                                if not isinstance(weights, torch.Tensor) else weights)
            w = w.reshape(-1)[world.rank if w.numel() == n else 0]
        delta, loss = local_update(params, torch.as_tensor(tokens).to(dev))
        avg_delta = aggregator.aggregate_rank(delta, int(counter), alive=alive, weights=w,
                                              world=world, pod_world=pod_world)
        del delta
        out_params = apply_delta(params, avg_delta)
        loss = collectives.pmean(loss, world)
        if pod_world is not None:  # the reference returns pod 0's learner mean
            loss = collectives.broadcast(loss, 0, pod_world)
        metrics = {"local_loss": loss,
                   "delta_norm": torch.sqrt(torch.sum(torch.square(avg_delta)))}
        if return_delta:
            metrics["avg_delta"] = avg_delta
        return out_params, metrics

    return FederatedBundle(round_fn=round_fn, init_state_fn=lambda p: p, deltas_fn=None)


def _tp_round(model: Model, aggregator: SecureAggregator, world, pod_world,
              local_update: Callable, return_delta: bool) -> FederatedBundle:
    """``make_federated_round`` on ('data', 'model'): learner ``world.rank``'s
    model shard ``tp.rank``. The local steps run tensor-parallel; the
    delta's chunk j of the full flat vector, padded to a multiple of 2·n·m
    (``train_step.tp_padded_size``), is assembled from the group's shards
    and goes through ring j's round (the weight word with the last chunk);
    the published chunks are all-gathered over the group and each rank adds
    its shards' words, as ``apply_delta`` adds the whole vector. The round
    reserves ``padded_size + 1`` words. With ``pod_world`` (the ('pod',
    'data', 'model') grid) the pods' chunks meet over the pod group and
    ``local_loss`` is pod 0's, as in ``_rank_round``."""
    n = aggregator.cfg.num_learners
    aggregator.check_world(world, pod_world)
    tp = model.tp_world
    m, j = tp.size, tp.rank
    layout = model.shard_layout()
    size = sum(sh.numel for sh in layout)
    padded = tp_padded_size(size, n, m)
    L = padded // m

    def round_fn(params, tokens, weights=None, counter=0, alive=None):
        dev = leaves(params)[0].device
        w = None
        if weights is not None:
            w = torch.as_tensor(np.asarray(weights, np.float32)
                                if not isinstance(weights, torch.Tensor) else weights)
            w = w.reshape(-1)[world.rank if w.numel() == n else 0]
        delta, loss = local_update(params, torch.as_tensor(tokens).to(dev))
        chunk = torch.zeros(L, dtype=torch.float32, device=dev)
        with torch.no_grad():
            write_chunk(layout, _split(delta, params), tp, chunk, j * L)
        del delta
        avg = aggregator.aggregate_rank(chunk, int(counter), alive=alive, weights=w,
                                        world=world, model_world=tp, pod_world=pod_world)
        del chunk
        full = collectives.all_gather(avg, tp, tiled=True)[:size]
        del avg
        with torch.no_grad():
            out_params = tree_unflatten(params, [
                (leaf.detach().float() + sh.of(full)).to(leaf.dtype)
                for leaf, sh in zip(leaves(params), layout)])
        loss = collectives.pmean(loss, world)
        if pod_world is not None:  # the reference returns pod 0's learner mean
            loss = collectives.broadcast(loss, 0, pod_world)
        metrics = {"local_loss": loss,
                   "delta_norm": torch.sqrt(torch.sum(torch.square(full)))}
        if return_delta:
            metrics["avg_delta"] = full
        return out_params, metrics

    return FederatedBundle(round_fn=round_fn, init_state_fn=lambda p: p, deltas_fn=None,
                           padded_size=padded)


def _split(flat: torch.Tensor, params: Any) -> list:
    """``flat`` (a tree's ``tree_to_flat`` layout) as views shaped as the
    tree's leaves."""
    out, off = [], 0
    for leaf in leaves(params):
        out.append(flat[off:off + leaf.numel()].view(leaf.shape))
        off += leaf.numel()
    return out


@dataclasses.dataclass
class WireFederated:
    """The model's half of wire-plane federated training.

    ``local_fns[node]`` maps the shared parameter tree to that learner's
    f32[P] numpy delta, and ``apply_fn`` (``apply_delta``) merges a
    published average delta: what ``net.client.run_federated_round_net``
    consumes. ``last_losses[node]`` is the mean loss of the node's last
    local update."""

    local_fns: Dict[int, Callable[[Any], np.ndarray]]
    apply_fn: Callable[[Any, Any], Any]
    payload_words: int
    last_losses: Dict[int, float]

    def words_per_round(self, weighted: bool = True) -> int:
        """Words one aggregation round carries (the weighted payload appends
        one weight word): what a persistent session's ``RoundCursor``
        advances by, and the stride of the in-process round's ``counter``
        for cross-plane bit parity."""
        return self.payload_words + (1 if weighted else 0)


def make_wire_federated(
    model: Model,
    tokens_by_learner: Dict[int, Any],
    *,
    local_steps: int = 4,
    local_lr: float = 1e-3,
) -> WireFederated:
    """Per-learner local-update callables for the wire runtime.

    ``tokens_by_learner`` maps 1-based node ids (the paper's numbering, the
    ids the broker's chains carry) to that learner's private
    int[local_steps, B, S] microbatches; they are copied to the model's
    device once. Each callable runs ``make_local_update`` on the device of
    the parameters it is given and returns the delta on the host."""
    local_update = make_local_update(model, local_steps=local_steps, local_lr=local_lr)
    dev = leaves(model.tree())[0].device
    losses: Dict[int, float] = {}

    def make_fn(node: int, toks):
        toks = torch.as_tensor(np.asarray(toks)).to(dev)

        def fn(params) -> np.ndarray:
            delta, loss = local_update(params, toks)
            losses[node] = float(loss)
            return delta.cpu().numpy()

        return fn

    local_fns = {node: make_fn(node, toks) for node, toks in sorted(tokens_by_learner.items())}
    return WireFederated(local_fns=local_fns, apply_fn=apply_delta,
                         payload_words=tree_size(model.tree()), last_losses=losses)
