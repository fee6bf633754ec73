"""The SAFE-secured data-parallel train step: on one card, or one learner
per rank.

The counterpart of the JAX package's ``train/train_step.py``. Every
step's gradient goes through the SAFE chain instead of an all-reduce
(the paper's Round 1 over the gradient):

  the n learners one after another (the reference's manual learner axis
  becomes dim 0, as in ``federated.py``)
  ├─ learner l's forward and backward on its batch; its gradient, flat in
  │    the reference's layout (``train/flatten.py``) and zero-padded to
  │    ``padded_size``, is row l of one f32[n, padded_size] matrix
  │    (f32[P, n, padded_size] with a pod axis)
  ├─ ``SecureAggregator.aggregate`` of that matrix at the step's counter,
  │    the initiator rotated by ``counter % (2n + 1)`` (§8)
  ├─ ZeRO-1 in the reference: each rank updates its 1/n slice of the f32
  │    master vector with ``FlatAdamW`` and all-gathers the slices. The
  │    update is elementwise, so on one card it is one ``FlatAdamW`` update
  │    of the whole master vector: the same math on the same words
  ├─ the parameters rebuilt from ``master[:sec_size]`` in their dtypes
  │    (with pods, from the reference's ``pmean`` over 'pod' of it)
  └─ with expert parallelism (``cfg.ep_axis``), the experts' update

Expert parallelism. A MoE's per-expert matrices (``moe/…/{wi,wg,wo}``,
``train/flatten.py::is_expert_path``) stay out of the SAFE partition, as
in the reference: there the experts are sharded over the learners and
their gradients summed by the all-to-all's transpose. On one card every
expert is local, so the step sums the learners' expert gradients in f32
(dead learners included: ``alive`` only touches SAFE), casts the sum once
to the parameters' dtype and updates them with a tree ``AdamW`` without
clipping, whose state is ``state["ep_opt"]``; ``sec_size`` counts the
SAFE partition alone. With pods the sum runs over all P·n learners, and
so it does across ranks (below): one copy of the experts, the
replicated array the reference's ``out_specs`` declare, where the
reference's step updates each pod's copy with its own pod's sum and so
keeps P copies that differ from the second step on. The reference's
step without ``ep_axis`` drops the expert leaves from the parameters it
returns; this step refuses a model with expert leaves and no
``ep_axis`` (``ValueError``).

``leafwise`` aggregates each parameter tensor of the SAFE partition in its
own round (key domain leaf index + 1, the step's counter in every domain)
and updates with the
tree ``AdamW`` (with ``grad_clip``) instead of the flat master; it switches
on by itself when the flat f32 vector would exceed 8 GB, as in the
reference.

One learner per rank. Given a ``mesh`` that puts one learner on each rank
of a live process group (a ``repro_torch.dist.World``, or a
``launch/mesh.py`` mesh over the group ``dist.init_world`` started; its
``learner_axis`` dimension is the learners), the step is the reference's
``per_rank_step``: this rank's forward and backward, ``aggregate_rank``,
ZeRO-1's slice update with a master, m and v of ``padded_size / n`` words,
and the tiled ``all_gather`` of the slices (``_rank_step``). Its
parameters are the one-card step's word for word. A MoE trains by the
reference's expert parallelism there: the model holds the rank's E/n
experts (``Model(cfg, ep_world=world)``) and its MoE blocks exchange
tokens with two all-to-alls, whose transpose sums the expert gradients
(float sums in another order than one card's, so within a bound of the
one-card step, not word for word). With the aggregator's pod axis the
mesh is ('pod', 'data') (``launch/mesh.py::make_pod_mesh``): the round
publishes the mean over pods and the gathered vector and the loss are
``pmean``'d over the pods, as the reference's ``per_rank_step`` does; its
parameters are the one-card pod step's word for word. A MoE with pods
sums each rank's expert gradients (its pod's sum, from the exchange)
over its pod group, the ranks holding the same experts in every pod, in
f32 a slice at a time, before the expert update: the one-card pod
step's sum over P·n learners, within a bound of it, and the pods' expert
shards and their moments equal word for word.

Model shards: a model built with ``tp_world`` (``Model(cfg,
tp_world=model)``, the model group of a ('data', 'model') grid from
``dist.grid_worlds`` or a mesh's ``model_world_of``) with ``mesh`` the
learners' ring of the same grid runs the reference's step on ('data',
'model') (``_tp_step``): rank l·m + j is learner l's model shard j. The
forward and backward are tensor-parallel over the model group, the loss
vocabulary-parallel on each rank's shard of the logits (``Model.loss``:
no rank gathers them, as the reference's GSPMD keeps 1/m of the
vocabulary's logits a device); the gradient's chunk j — words [j·L,
(j + 1)·L) of the flat vector padded to a multiple of 2·n·m, L =
padded_size / m — is assembled from the group's shards; ring j runs SAFE on it (``aggregate_rank(..., model_world=)``,
the reference's ``chain_model_sharded``: one chain per model shard, and
the published words those of one chain over the whole vector); ZeRO-1
runs over all n·m ranks, rank (l, j) updating the l-th of the n parts of
chunk j; the parts are all-gathered over the ring, then the chunks over
the model group, and each rank cuts its shards from the whole vector.
With the aggregator's pod axis and a ('pod', 'data', 'model') grid
(``dist.grid``, or such a ``DeviceMesh``) ring (p, j) runs chunk j's round
in pod p, the pods' chunks meet over the pod group, ZeRO-1 runs within
each pod, and the rebuilt vector and the loss take the reference's
``pmean`` over 'pod' (its pod512 ``train_4k`` program).
``chain_model_sharded`` says which of the two the reference compiles;
both publish the same words, so here it is accepted and the model's
``tp_world`` decides. A MoE there takes both splits (``Model(cfg,
tp_world=model, ep_world=ring)``): its experts stay out of the SAFE
partition, spread over ring j's learners, each rank holding [E/n, d, f/m]
of every expert matrix, and ``ep_opt`` updates those shards; with pods
their gradients are first summed over the pod group (·, l, j), which
holds the same shard in every pod. A ``mesh``
on a fake group (the dry run's) and the
reference's Megatron output anchors change no arithmetic. The reference's buffer
donation becomes in-place updates: with ``donate`` the step writes the new
master vector, moments and parameters into the state it is given, so the
caller keeps only the returned state (whose tensors are those same ones).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable, Optional

import torch

from repro_torch.core.aggregators import SecureAggregator
from repro_torch.core.chain import pod_mean_chunks, pod_mean_rank
from repro_torch.dist import collectives
from repro_torch.dist.world import model_world_of, pod_world_of, rank_world
from repro_torch.optim.adamw import AdamState, AdamW, FlatAdamW, copied
from repro_torch.train.flatten import (combine_trees, is_expert_path, leaf_paths, leaves,
                                       partition_tree, tree_map, tree_size, tree_unflatten,
                                       write_chunk)
from repro_torch.train.loss import next_token_loss, param_grads

if TYPE_CHECKING:  # the model package imports this package's flatten
    from repro_torch.models.transformer import Model

LEAFWISE_BYTES = 8e9  # flat f32 vectors above this aggregate leaf by leaf


@dataclasses.dataclass
class TrainStepBundle:
    """``step_fn(state, tokens, prefix=None, weights=None, counter=0,
    alive=None, mark=None) -> (state, metrics)`` takes one step;
    ``init_state_fn(params) -> state`` builds its state from a parameter
    tree. ``sec_size`` is the number of parameter words SAFE aggregates and
    ``padded_size`` the flat vector's length, a multiple of n."""

    step_fn: Any
    init_state_fn: Any
    sec_size: int
    padded_size: int
    leafwise: bool = False


def _write_flat(tree: Any, out: torch.Tensor) -> None:
    """The reference's ``tree_to_flat(tree)`` written into ``out[:size]``."""
    off = 0
    for leaf in leaves(tree):
        k = leaf.numel()
        out[off:off + k].copy_(leaf.detach().reshape(-1))
        off += k


@torch.no_grad()
def _rebuild(params: Any, flat: torch.Tensor, inplace: bool) -> Any:
    """The reference's ``flat_to_tree(flat, params)``: each leaf from its
    words of ``flat``, cast to the leaf's dtype; into the leaves themselves
    when ``inplace``."""
    new, off = [], 0
    for leaf in leaves(params):
        k = leaf.numel()
        src = flat[off:off + k].view(leaf.shape)
        off += k
        if inplace:
            new.append(leaf.copy_(src))
        else:
            new.append(src.to(leaf.dtype, copy=True))
    return tree_unflatten(params, new)


def _init_state(params: Any, n: int, padded_size: int, leafwise: bool, sec_opt: AdamW,
                ep_opt: Optional[AdamW], rows: Optional[tuple] = None) -> dict:
    """A train step's state from a parameter tree (its tensors, detached):
    the f32 master vector of the SAFE partition — words ``rows`` = (lo, hi)
    of it alone for a ZeRO-1 rank — and its moments, or leafwise the tree
    AdamW's state; the expert AdamW's state with ``ep_opt``."""
    params = tree_map(lambda t: t.detach(), params)
    sec_p, ep_p = _split(params)
    dev = leaves(params)[0].device
    sec_state = ep_state = None
    if leafwise:
        flat = torch.zeros(n, dtype=torch.float32, device=dev)  # placeholder
        s = sec_opt.init(sec_p)
        sec_state = AdamState(torch.zeros((), dtype=torch.int32), s.m, s.v)
    else:
        flat = torch.zeros(padded_size, dtype=torch.float32, device=dev)
        _write_flat(sec_p, flat)
        if rows is not None:
            flat = flat[rows[0]:rows[1]].clone()
    if ep_opt is not None:
        s = ep_opt.init(ep_p)
        ep_state = AdamState(torch.zeros((), dtype=torch.int32), s.m, s.v)
    return {"params": params, "master": flat, "fm": torch.zeros_like(flat),
            "fv": torch.zeros_like(flat), "fstep": torch.zeros((), dtype=torch.int32),
            "ep_opt": ep_state, "sec_opt": sec_state, "step": 0}


def _in_safe(path: str) -> bool:
    """Whether a leaf is in the SAFE partition (every leaf but the experts')."""
    return not is_expert_path(path)


def _split(params: Any) -> tuple:
    """(SAFE partition, expert partition) of a parameter tree."""
    return partition_tree(params, _in_safe)


def _check_ep_world(model: Model, world) -> None:
    """Raise unless the model holds the experts of rank ``world.rank`` of
    ``world`` (the learners' World, or the ring of a grid)."""
    ew = model.ep_world
    if world.size > 1 and (ew is None or (ew.rank, ew.size) != (world.rank, world.size)):
        raise ValueError(
            f"{model.cfg.arch_id}: expert parallelism across {world.size} ranks needs the "
            "model to hold this rank's experts: build it with Model(cfg, ep_world=world) on "
            "the learners' World (with model shards, the ring of grid_worlds)")


def _ep_update(opt: AdamW, ep_sum: list, state: AdamState, ep_params: Any,
               inplace: bool) -> tuple:
    """The expert update: the f32 sum of the learners' expert gradients,
    cast once to each parameter's dtype, through the tree ``AdamW`` without
    clipping (the reference's ``ep_opt``), leaf by leaf so that one leaf's
    cast gradient is alive at a time; into the given state and parameters
    when ``inplace``, else into copies. Returns (new expert partition, new
    state with an int32 step)."""
    step = int(state.step)
    if not inplace:
        ep_params, state = copied(ep_params), AdamState(step, copied(state.m), copied(state.v))
    for g, p, m, v in zip(ep_sum, leaves(ep_params), leaves(state.m), leaves(state.v)):
        opt.update_([g.to(p.dtype)], AdamState(step, [m], [v]), [p])
    return ep_params, AdamState(torch.tensor(step + 1, dtype=torch.int32), state.m, state.v)


def _pod_sum(ep_g: list, pod_world) -> list:
    """The expert gradients ``ep_g`` summed over the pod group, in place:
    ``collectives.MODEL_SLICE`` elements of a leaf's flat order at a time,
    each slice upcast to f32, ``psum``'d (all-gathered and added in pod
    rank order) and cast once to the gradient's dtype, so the step holds
    one slice's gather beside the gradients, not an f32 copy of a leaf.
    After the exchange's sum over the pod's learners, this is the sum over
    all P·n learners that the one-card step applies (``_learner_grads``)."""
    out = []
    with torch.no_grad():
        for g in ep_g:
            g = g.contiguous()  # autograd's gradients are: no copy
            flat = g.view(-1)
            for lo in range(0, flat.numel(), collectives.MODEL_SLICE):
                part = flat[lo:lo + collectives.MODEL_SLICE]
                part.copy_(collectives.psum(part.float(), pod_world))
            out.append(g)
    return out


def _learner_grads(model: Model, params: Any, tokens: torch.Tensor, prefix, mark,
                   leafwise: bool, sec_size: int, padded_size: int) -> tuple:
    """Each learner's loss (one a row of ``tokens``); its SAFE-partition
    gradient written into its row of the flat f32[rows, padded_size] matrix
    (or of one matrix per leaf when ``leafwise``); and the f32 sum over the
    learners of the expert gradients."""
    cfg = model.cfg
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    plist = leaves(p)
    is_ep = [is_expert_path(path) for path in leaf_paths(p)]
    dev, rows = plist[0].device, tokens.shape[0]
    if leafwise:
        mats = [torch.empty((rows, t.numel()), dtype=torch.float32, device=dev)
                for t, e in zip(plist, is_ep) if not e]
    else:
        mat = torch.empty((rows, padded_size), dtype=torch.float32, device=dev)
        mat[:, sec_size:].zero_()
    losses, ep_sum = [], None
    for l in range(rows):
        batch = tokens[l]
        with torch.enable_grad():
            logits, aux = model.apply(p, batch, None if prefix is None else prefix[l])
            loss = next_token_loss(logits, batch, cfg.prefix_embeds) + aux
            grads = param_grads(loss, plist)
        del logits
        losses.append(loss.detach())
        mark("forward_backward")
        with torch.no_grad():
            sec_g = [g for g, e in zip(grads, is_ep) if not e]
            if leafwise:
                for g, m in zip(sec_g, mats):
                    m[l].copy_(g.reshape(-1))
            else:
                _write_flat(sec_g, mat[l])
            ep_g = [g for g, e in zip(grads, is_ep) if e]
            if ep_sum is None:  # the reference's all-to-all transpose sums them
                ep_sum = [g.float() if g.dtype != torch.float32 and rows > 1 else g
                          for g in ep_g]
            else:
                for acc, g in zip(ep_sum, ep_g):
                    acc.add_(g)
        del grads, sec_g, ep_g
        mark("flatten")
    return torch.stack(losses), (mats if leafwise else mat), ep_sum


def make_train_step(
    model: Model,
    aggregator: SecureAggregator,
    mesh: Any = None,
    *,
    lr=3e-4,
    learner_axis: str = "data",
    pod_axis: Optional[str] = None,
    grad_clip: float = 1.0,
    weight_decay: float = 0.1,
    donate: bool = True,
    chain_model_sharded: bool = False,
    leafwise: Optional[bool] = None,
) -> TrainStepBundle:
    """Build the SAFE-aggregated train step of ``model`` (the reference's
    arguments; see the module docstring for those without effect here).

    ``step_fn(state, tokens, prefix=None, weights=None, counter=0,
    alive=None, mark=None)``: ``tokens`` int[n, B, S] (int[P·n, B, S],
    pod-major, with the aggregator's pod axis), ``prefix`` optional
    per-learner prefix embeddings, ``weights`` f32[n] (returned as the
    ``weight`` metric, not aggregated, as in the reference), ``counter``
    the step's first counter (``aggregator.reserve_round(padded_size + 2)``
    reserves a step's counters, so no pad is reused), ``alive`` a 0/1
    [n] bitmap. ``mark(name)``, when given, is called after each part of
    the step ("forward_backward" and "flatten" once per learner, then
    "aggregate", "optimizer", with expert parallelism "expert_optimizer",
    and "rebuild") so a caller can time the parts.
    Returns the new state and the metrics ``loss`` (mean over the
    learners), ``grad_scale`` (norm of the published gradient) and
    ``weight``, as 0-d tensors on the parameters' device."""
    cfg = model.cfg
    use_ep = cfg.ep_axis is not None
    world = rank_world(mesh, learner_axis)
    tp = model.tp_world
    if tp is None and model_world_of(mesh) is not None:
        raise ValueError(f"{cfg.arch_id}: the mesh has a model dimension of "
                         f"{model_world_of(mesh).size}: build the model with Model(cfg, "
                         "tp_world=model_world_of(mesh)) so it holds this rank's shards")
    if not use_ep and any(map(is_expert_path, leaf_paths(model.tree()))):
        raise ValueError(
            f"{cfg.arch_id}: the model has per-expert matrices (moe/wi, wg, wo) but "
            "cfg.ep_axis is None. The JAX package's step keeps them out of the SAFE "
            "partition and, without ep_axis, returns parameters without them "
            "(src/repro/train/train_step.py:214), so its next step fails in "
            "moe_apply; this port refuses instead. Set ep_axis='data' and ep_ranks to "
            "the learner count (the experts' gradients are then summed over the "
            "learners and updated outside the SAFE chain), or train by FedAvg, "
            "whose payload carries every leaf.")
    agg_pods = aggregator.cfg.pod_axis
    if pod_axis is not None and pod_axis != agg_pods:
        raise ValueError(f"pod_axis={pod_axis!r} but the aggregator's is {agg_pods!r}")
    n = aggregator.cfg.num_learners
    flat_opt = FlatAdamW(lr=lr, weight_decay=weight_decay)
    ep_opt = AdamW(lr=lr, weight_decay=weight_decay, grad_clip=None)
    sec_opt = AdamW(lr=lr, weight_decay=weight_decay, grad_clip=grad_clip)

    if tp is not None:
        if world is None:
            raise ValueError(f"{cfg.arch_id}: a model split over model ranks steps with one "
                             "learner a ring rank: pass the learners' ring (grid_worlds) or "
                             "the ('data', 'model') mesh")
        pod_world = None if agg_pods is None else pod_world_of(mesh, agg_pods)
        aggregator.check_world(world, pod_world)
        if use_ep:
            _check_ep_world(model, world)
        sec_size = sum(sh.numel for sh in model.shard_layout(_in_safe))
        if leafwise is None:
            leafwise = sec_size * 4 > LEAFWISE_BYTES
        return _tp_step(model, aggregator, world, tp, pod_world, flat_opt, sec_opt,
                        ep_opt if use_ep else None, sec_size,
                        tp_padded_size(sec_size, n, tp.size), leafwise, donate)
    sec_size = tree_size(_split(model.tree())[0])
    shard_len = -(-sec_size // n)
    padded_size = shard_len * n
    if leafwise is None:
        leafwise = sec_size * 4 > LEAFWISE_BYTES
    if world is not None:
        pod_world = None if agg_pods is None else pod_world_of(mesh, agg_pods)
        aggregator.check_world(world, pod_world)
        if use_ep and world.size > 1:
            _check_ep_world(model, world)
        return _rank_step(model, aggregator, world, pod_world, flat_opt, sec_opt, ep_opt,
                          sec_size, padded_size, leafwise, donate, use_ep)

    def init_state_fn(params):
        """The step's state from a parameter tree. The state's parameters
        are the tree's tensors (detached), so a donating step updates them
        where they are."""
        return _init_state(params, n, padded_size, leafwise, sec_opt, ep_opt if use_ep else None)

    def step_fn(state, tokens, prefix=None, weights=None, counter=0, alive=None,
                mark: Optional[Callable[[str], None]] = None):
        mark = mark or (lambda name: None)
        params = state["params"]
        sec_p, ep_p = _split(params)
        dev = leaves(params)[0].device
        tokens = torch.as_tensor(tokens).to(dev)
        if tokens.dim() < 2 or tokens.shape[0] % n or (agg_pods is None and tokens.shape[0] != n):
            raise ValueError(f"tokens: expected [{'P·' if agg_pods else ''}{n}, B, S], "
                             f"got shape {tuple(tokens.shape)}")
        pods = tokens.shape[0] // n
        if prefix is not None:
            prefix = torch.as_tensor(prefix).to(dev)
        weights = torch.ones(n) if weights is None else torch.as_tensor(weights)
        counter = int(counter) & 0xFFFFFFFF
        rotate = counter % (2 * n + 1)  # §8: rotate the initiator every round

        def as_values(m):  # [P·n, V] -> [P, n, V] for the pod axis
            return m.view(pods, n, -1) if agg_pods else m

        losses, grads, ep_sum = _learner_grads(model, params, tokens, prefix, mark,
                                               leafwise, sec_size, padded_size)
        if leafwise:
            avg = [aggregator.aggregate(as_values(m), counter, alive=alive, domain=idx + 1,
                                        rotate=rotate).view(leaf.shape)
                   for idx, (m, leaf) in enumerate(zip(grads, leaves(sec_p)))]
            del grads
            mark("aggregate")
            grad_norm = torch.sqrt(sum(torch.sum(torch.square(a)) for a in avg))
            s = state["sec_opt"]
            update = sec_opt.update_ if donate else sec_opt.update
            new_sec, s = update(tree_unflatten(sec_p, avg), AdamState(int(s.step), s.m, s.v),
                                sec_p)
            sec_state = AdamState(torch.tensor(s.step, dtype=torch.int32), s.m, s.v)
            master, fm, fv, fstep = state["master"], state["fm"], state["fv"], state["fstep"]
        else:
            avg = aggregator.aggregate(as_values(grads), counter, alive=alive, rotate=rotate)
            del grads
            mark("aggregate")
            grad_norm = torch.sqrt(torch.sum(torch.square(avg[:sec_size])))
            fs = AdamState(int(state["fstep"]), state["fm"], state["fv"])
            master, fs = flat_opt.update(avg, fs, state["master"], inplace=donate)
            del avg
            fm, fv, fstep = fs.m, fs.v, torch.tensor(fs.step, dtype=torch.int32)
            sec_state = None
        mark("optimizer")
        ep_state = None
        if use_ep:  # the experts' summed gradients, outside the SAFE boundary
            new_ep, ep_state = _ep_update(ep_opt, ep_sum, state["ep_opt"], ep_p, donate)
            del ep_sum
            mark("expert_optimizer")
        if not leafwise:
            # the reference's pmean of the gathered vector over the pods, whose
            # copies are equal: computed all the same (not an identity for every P)
            src = master if pods == 1 else pod_mean_chunks(
                master, lambda part: [part] * pods, out=torch.empty_like(master))
            new_sec = _rebuild(sec_p, src[:sec_size], inplace=donate)
            del src
        new = combine_trees(new_sec, new_ep) if use_ep else new_sec
        mark("rebuild")
        metrics = {"loss": losses.view(pods, n).mean(dim=1).mean(),
                   "grad_scale": grad_norm,
                   "weight": weights.reshape(-1)[0].to(device=dev, dtype=torch.float32)}
        new_state = {"params": new, "master": master, "fm": fm, "fv": fv, "fstep": fstep,
                     "ep_opt": ep_state, "sec_opt": sec_state, "step": state["step"] + 1}
        return new_state, metrics

    return TrainStepBundle(step_fn=step_fn, init_state_fn=init_state_fn,
                           sec_size=sec_size, padded_size=padded_size, leafwise=leafwise)


def _rank_step(model: Model, aggregator: SecureAggregator, world, pod_world,
               flat_opt: FlatAdamW, sec_opt: AdamW, ep_opt: AdamW, sec_size: int,
               padded_size: int, leafwise: bool, donate: bool,
               use_ep: bool) -> TrainStepBundle:
    """The train step with one learner per rank (the reference's
    ``per_rank_step``): this rank's forward and backward, its padded flat
    gradient through ``aggregate_rank``, then ZeRO-1 — ``FlatAdamW`` on
    this rank's slice [rank·shard_len, (rank + 1)·shard_len) of the master
    vector, whose state (master, m, v) holds that slice alone, and a tiled
    ``all_gather`` of the updated slices over the learners, from which
    every rank rebuilds the parameters. The loss is ``pmean``'d. Leafwise,
    each leaf is its own round and the tree ``AdamW`` updates every leaf on
    every rank, as on one card.

    Expert parallelism (``use_ep``, the model holding this rank's E/n
    experts): the forward and backward exchange tokens and cotangents with
    the other ranks (``models/moe.py``), so the expert gradient autograd
    gives is the sum over every learner's tokens (the reference's
    all-to-all transpose); the tree ``AdamW`` without clipping updates the
    rank's experts, its m and v (``state["ep_opt"]``) this rank's slice. A
    dead learner still takes part in both exchanges: ``alive`` touches SAFE
    alone.

    Pods (``pod_world``, one rank a pod for this learner): the round
    publishes the mean over pods (``aggregate_rank``), the gathered vector
    is ``pmean``'d over the pods as the reference does, and so is the loss
    after its mean over the learners. With experts, each expert gradient
    is summed over the pod group before the update (``_pod_sum``), so
    every pod applies the sum over all P·n learners to the same shard.

    ``step_fn(state, tokens, prefix=None, weights=None, counter=0,
    alive=None, mark=None)``: ``tokens`` this learner's int[B, S],
    ``prefix`` its prefix embeddings, ``weights`` the f32[n] weights of
    every learner (or this one's scalar; returned as the ``weight``
    metric), ``counter`` and ``alive`` the same on every rank. Everything
    else is the one-card step's, and without experts the parameters are the
    one-card step's word for word."""
    n, r = world.size, world.rank
    shard_len = padded_size // n
    lo, hi = r * shard_len, (r + 1) * shard_len

    def init_state_fn(params):
        """The step's state, the master vector's slice of this rank only."""
        return _init_state(params, n, padded_size, leafwise, sec_opt,
                           ep_opt if use_ep else None, (lo, hi))

    def step_fn(state, tokens, prefix=None, weights=None, counter=0, alive=None,
                mark: Optional[Callable[[str], None]] = None):
        mark = mark or (lambda name: None)
        params = state["params"]
        sec_p, ep_p = _split(params)
        dev = leaves(params)[0].device
        tokens = torch.as_tensor(tokens).to(dev)
        if tokens.dim() < 2:
            raise ValueError(f"tokens: expected this learner's [B, S], got shape "
                             f"{tuple(tokens.shape)}")
        if prefix is not None:
            prefix = torch.as_tensor(prefix).to(dev)[None]
        w = torch.ones(()) if weights is None else torch.as_tensor(weights).reshape(-1)
        w = w.reshape(-1)[r if w.numel() == n else 0]
        counter = int(counter) & 0xFFFFFFFF
        rotate = counter % (2 * n + 1)  # §8: rotate the initiator every round
        agg = dict(alive=alive, rotate=rotate, world=world, pod_world=pod_world)

        losses, grads, ep_g = _learner_grads(model, params, tokens[None], prefix, mark,
                                             leafwise, sec_size, padded_size)
        if leafwise:
            avg = [aggregator.aggregate_rank(m[0], counter, domain=idx + 1, **agg)
                   .view(leaf.shape) for idx, (m, leaf) in enumerate(zip(grads, leaves(sec_p)))]
            del grads
            mark("aggregate")
            grad_norm = torch.sqrt(sum(torch.sum(torch.square(a)) for a in avg))
            s = state["sec_opt"]
            update = sec_opt.update_ if donate else sec_opt.update
            new_sec, s = update(tree_unflatten(sec_p, avg), AdamState(int(s.step), s.m, s.v),
                                sec_p)
            sec_state = AdamState(torch.tensor(s.step, dtype=torch.int32), s.m, s.v)
            master, fm, fv, fstep = state["master"], state["fm"], state["fv"], state["fstep"]
            mark("optimizer")
        else:
            avg = aggregator.aggregate_rank(grads[0], counter, **agg)
            del grads
            mark("aggregate")
            grad_norm = torch.sqrt(torch.sum(torch.square(avg[:sec_size])))
            fs = AdamState(int(state["fstep"]), state["fm"], state["fv"])
            master, fs = flat_opt.update(avg[lo:hi], fs, state["master"], inplace=donate)
            del avg
            fm, fv, fstep = fs.m, fs.v, torch.tensor(fs.step, dtype=torch.int32)
            sec_state = None
            mark("optimizer")
            flat = collectives.all_gather(master, world, tiled=True)  # ZeRO-1's gather
            if pod_world is not None:  # the reference's pmean of it over the pods
                flat = pod_mean_rank(flat, pod_world)
            mark("all_gather")
            new_sec = _rebuild(sec_p, flat[:sec_size], inplace=donate)
            del flat
        ep_state = None
        if use_ep:  # the experts' gradients, summed by the exchange's transpose
            if pod_world is not None:  # and over the pods
                ep_g = _pod_sum(ep_g, pod_world)
            new_ep, ep_state = _ep_update(ep_opt, ep_g, state["ep_opt"], ep_p, donate)
            del ep_g
            mark("expert_optimizer")
        new = combine_trees(new_sec, new_ep) if use_ep else new_sec
        mark("rebuild")
        loss = collectives.pmean(losses[0], world)
        if pod_world is not None:
            loss = collectives.pmean(loss, pod_world)
        metrics = {"loss": loss, "grad_scale": grad_norm,
                   "weight": w.to(device=dev, dtype=torch.float32)}
        new_state = {"params": new, "master": master, "fm": fm, "fv": fv, "fstep": fstep,
                     "ep_opt": ep_state, "sec_opt": sec_state, "step": state["step"] + 1}
        return new_state, metrics

    return TrainStepBundle(step_fn=step_fn, init_state_fn=init_state_fn,
                           sec_size=sec_size, padded_size=padded_size, leafwise=leafwise)


def tp_padded_size(words: int, n: int, m: int) -> int:
    """The flat vector's length with m model shards: ``words`` padded to a
    multiple of 2·n·m, so each chunk (padded / m words) starts on a
    counter and splits into n ZeRO-1 parts."""
    q = 2 * n * m
    return -(-int(words) // q) * q


def tp_norm(tensors: list, splits: list, tp) -> torch.Tensor:
    """The f32 norm of a tree split over the model group ``tp`` (``splits``:
    each leaf's ``Split``, None where replicated): the squares of each cut
    segment summed here and ``psum``'d over the group, each replicated leaf
    or segment (the same on every rank) counted once."""
    cut, rep = [], []
    for t, sp in zip(tensors, splits):
        if sp is None:
            rep.append(t)
        else:
            c, r = sp.pieces(t, tp.rank, tp.size)
            cut += c
            rep += r

    def sq(ts):
        total = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
        for t in ts:
            total = total + torch.sum(torch.square(t.float()))
        return total
    return torch.sqrt(collectives.psum(sq(cut), tp) + sq(rep))


def _tp_step(model: Model, aggregator: SecureAggregator, world, tp, pod_world,
             flat_opt: FlatAdamW, sec_opt: AdamW, ep_opt: Optional[AdamW], sec_size: int,
             padded_size: int, leafwise: bool, donate: bool) -> TrainStepBundle:
    """The train step on ('data', 'model'): learner ``world.rank``'s model
    shard ``tp.rank`` (see the module docstring). The state's parameters
    are this rank's shards and its master, m and v the l-th of n parts of
    chunk j (``padded_size / (n·m)`` words) of the SAFE partition's flat
    vector. ``init_state_fn`` is collective over the model group (it
    assembles the chunk from the shards).

    Leafwise, each leaf is its own round (key domain leaf index + 1) on
    the shards' words: a split leaf's round runs over the concatenation of
    its m shards (shard j's words, padded to rank 0's count made even, on
    ring j, so no all-gather and, with uneven shards, no two rings on one
    counter; a segmented leaf's replicated segments ride in every
    shard and each ring publishes the same mean of them), a replicated
    leaf's over its own m chunks, gathered afterwards; the tree ``AdamW``
    clips by the norm over every rank's shards (``tp_norm``) and updates
    the shards. Each leaf's published mean is the one-card leafwise
    round's, word for word; its pads follow the shards' order.

    Expert parallelism (``ep_opt``; the model built with ``ep_world`` the
    ring): as in ``_rank_step``, the per-expert matrices stay out of the
    SAFE partition; the forward and backward exchange tokens over ring j,
    whose transpose sums every learner's tokens (dead ones included) into
    the rank's [E/n, d, f/m] expert gradient, and the tree ``AdamW``
    without clipping updates those shards, its m and v in
    ``state["ep_opt"]``.

    Pods (``pod_world``, the ('pod', 'data', 'model') grid): ring (p, j)
    runs chunk j's round in pod p and the pods' chunks meet over the pod
    group (``aggregate_rank``); ZeRO-1 runs over the n·m ranks of each
    pod; the rebuilt flat vector takes the reference's ``pmean`` over
    'pod', and so does the loss; the expert shards' gradients are summed
    over the pod group (``_pod_sum``) before ``ep_opt`` applies them.

    ``step_fn(state, tokens, prefix=None, weights=None, counter=0,
    alive=None, mark=None)`` as ``_rank_step``'s: ``tokens`` this learner's
    int[B, S], the same on every rank of its model group."""
    n, l = world.size, world.rank
    m, j = tp.size, tp.rank
    L = padded_size // m
    part = L // n
    c0 = j * L
    use_ep = ep_opt is not None
    layout = model.shard_layout(_in_safe)
    splits = [sh.split for sh in layout]

    def init_state_fn(params):
        """The step's state: this rank's shards (detached), its part of
        chunk j of the master vector and, with experts, their AdamW state."""
        params = tree_map(lambda t: t.detach(), params)
        sec_p, ep_p = _split(params)
        dev = leaves(params)[0].device
        sec_state = ep_state = None
        if leafwise:
            flat = torch.zeros(n, dtype=torch.float32, device=dev)  # placeholder
            s = sec_opt.init(sec_p)
            sec_state = AdamState(torch.zeros((), dtype=torch.int32), s.m, s.v)
        else:
            chunk = torch.zeros(L, dtype=torch.float32, device=dev)
            write_chunk(layout, leaves(sec_p), tp, chunk, c0)
            flat = chunk[l * part:(l + 1) * part].clone()
        if use_ep:
            s = ep_opt.init(ep_p)
            ep_state = AdamState(torch.zeros((), dtype=torch.int32), s.m, s.v)
        return {"params": params, "master": flat, "fm": torch.zeros_like(flat),
                "fv": torch.zeros_like(flat), "fstep": torch.zeros((), dtype=torch.int32),
                "ep_opt": ep_state, "sec_opt": sec_state, "step": 0}

    def leafwise_round(grads, counter, agg):
        """Each leaf's published gradient, shaped as this rank's shard."""
        avg = []
        for idx, (g, sh) in enumerate(zip(grads, layout)):
            v = g.detach().reshape(-1).float()
            if sh.split is None:  # a replicated leaf: its m chunks, one a ring
                k = -(-v.numel() // (2 * m)) * 2
                v = torch.nn.functional.pad(v, (0, k * m - v.numel()))[j * k:(j + 1) * k]
            else:  # the shard's own words, padded to rank 0's (the most), made even,
                k = sh.shard_numel(0)  # so the rings' counter ranges never overlap
                k += k & 1
                v = torch.nn.functional.pad(v, (0, k - v.numel()))
            a = aggregator.aggregate_rank(v.contiguous(), counter, domain=idx + 1, **agg)
            if sh.split is None:
                a = collectives.all_gather(a, tp, tiled=True)
            avg.append(a[:g.numel()].view(g.shape))
        return avg

    def step_fn(state, tokens, prefix=None, weights=None, counter=0, alive=None,
                mark: Optional[Callable[[str], None]] = None):
        mark = mark or (lambda name: None)
        params = state["params"]
        sec_p, ep_p = _split(params)
        dev = leaves(params)[0].device
        tokens = torch.as_tensor(tokens).to(dev)
        if tokens.dim() < 2:
            raise ValueError(f"tokens: expected this learner's [B, S], got shape "
                             f"{tuple(tokens.shape)}")
        if prefix is not None:
            prefix = torch.as_tensor(prefix).to(dev)
        w = torch.ones(()) if weights is None else torch.as_tensor(weights).reshape(-1)
        w = w.reshape(-1)[l if w.numel() == n else 0]
        counter = int(counter) & 0xFFFFFFFF
        rotate = counter % (2 * n + 1)  # §8: rotate the initiator every round
        agg = dict(alive=alive, rotate=rotate, world=world, model_world=tp,
                   pod_world=pod_world)

        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        is_ep = [is_expert_path(path) for path in leaf_paths(p)]
        with torch.enable_grad():  # the loss on this rank's vocabulary shard
            loss, aux = model.loss(p, tokens, prefix)
            loss = loss + aux
            grads = param_grads(loss, leaves(p))
        del p
        sec_g = [g for g, e in zip(grads, is_ep) if not e]
        ep_g = [g for g, e in zip(grads, is_ep) if e]
        del grads
        mark("forward_backward")
        if leafwise:
            avg = leafwise_round(sec_g, counter, agg)
            del sec_g
            mark("aggregate")
            grad_norm = tp_norm(avg, splits, tp)
            s = state["sec_opt"]
            update = sec_opt.update_ if donate else sec_opt.update
            new_sec, s = update(tree_unflatten(sec_p, avg), AdamState(int(s.step), s.m, s.v),
                                sec_p, grad_norm)
            sec_state = AdamState(torch.tensor(s.step, dtype=torch.int32), s.m, s.v)
            master, fm, fv, fstep = state["master"], state["fm"], state["fv"], state["fstep"]
            mark("optimizer")
        else:
            chunk = torch.zeros(L, dtype=torch.float32, device=dev)
            with torch.no_grad():
                write_chunk(layout, sec_g, tp, chunk, c0)
            del sec_g
            mark("flatten")
            avg = aggregator.aggregate_rank(chunk, counter, **agg)
            del chunk
            mark("aggregate")
            mine = avg[:max(0, min(L, sec_size - c0))]
            grad_norm = torch.sqrt(collectives.psum(torch.sum(torch.square(mine)), tp))
            fs = AdamState(int(state["fstep"]), state["fm"], state["fv"])
            master, fs = flat_opt.update(avg[l * part:(l + 1) * part], fs, state["master"],
                                         inplace=donate)
            del avg, mine
            fm, fv, fstep = fs.m, fs.v, torch.tensor(fs.step, dtype=torch.int32)
            sec_state = None
            mark("optimizer")
            # ZeRO-1's gather: the parts over the ring, then the chunks over the group
            flat = collectives.all_gather(collectives.all_gather(master, world, tiled=True),
                                          tp, tiled=True)
            if pod_world is not None:  # the reference's pmean of it over the pods
                flat = pod_mean_rank(flat, pod_world)
            mark("all_gather")
            with torch.no_grad():
                if donate:
                    new_sec = tree_unflatten(sec_p, [leaf.copy_(sh.of(flat)) for leaf, sh in
                                                     zip(leaves(sec_p), layout)])
                else:
                    new_sec = tree_unflatten(sec_p, [sh.of(flat).to(leaf.dtype, copy=True)
                                                     .contiguous() for leaf, sh in
                                                     zip(leaves(sec_p), layout)])
            del flat
        ep_state = None
        if use_ep:  # the experts' gradients, summed over ring j by the exchange's transpose
            if pod_world is not None:  # and over the pods
                ep_g = _pod_sum(ep_g, pod_world)
            new_ep, ep_state = _ep_update(ep_opt, ep_g, state["ep_opt"], ep_p, donate)
            mark("expert_optimizer")
        del ep_g
        new = combine_trees(new_sec, new_ep) if use_ep else new_sec
        mark("rebuild")
        loss = collectives.pmean(loss.detach(), world)
        if pod_world is not None:
            loss = collectives.pmean(loss, pod_world)
        metrics = {"loss": loss, "grad_scale": grad_norm,
                   "weight": w.to(device=dev, dtype=torch.float32)}
        new_state = {"params": new, "master": master, "fm": fm, "fv": fv, "fstep": fstep,
                     "ep_opt": ep_state, "sec_opt": sec_state, "step": state["step"] + 1}
        return new_state, metrics

    return TrainStepBundle(step_fn=step_fn, init_state_fn=init_state_fn,
                           sec_size=sec_size, padded_size=padded_size, leafwise=leafwise)
