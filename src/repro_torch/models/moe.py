"""Mixture-of-Experts MLP with capacity-based dispatch.

The counterpart of the JAX package's ``models/moe.py``, routing step for
step as the reference routes:

  1. the router's logits in the activations' dtype, the softmax in f32,
     top-k over E experts, the k gates renormalised to sum to 1;
  2. the Switch aux loss, E · Σ_e (share of assignments to e) · (mean
     router probability of e), times ``aux_loss_weight``;
  3. the token→expert assignments sorted by expert (a stable sort, so
     tokens keep their order within an expert), each expert's first C
     assignments given its slots of an [E, C, d] buffer and the rest
     dropped to a scratch row (a dropped token passes through the
     residual unchanged);
  4. the expert products on [E, C, d] buffers (``torch.bmm``; the
     reference leaves them to XLA, no Pallas kernel), and a gate-weighted
     scatter-add back to the tokens.

The two routing paths floor the capacity differently, as the reference's
do: ``moe_apply`` at 8 slots, ``_dispatch_indices`` (the expert-parallel
path) at 4.

Serving across ranks (``route``: the Worlds whose ranks hold the rows of
the global batch, the data ranks and, with pods, the pod ranks) routes as
the reference's GSPMD routes the global batch wherever its serving does
not take expert parallelism (decode, and the prefill of a MoE of fewer
than ``EP_PREFILL_EXPERTS`` experts, ``launch/input_specs.py``): the
capacity C from the global T (every rank's rows; floor 8), and an
assignment's place in its expert from the global order — the rows lie in
rank order, so it is this rank's stable position plus the assignments of
that expert on the ranks before it (one ``all_gather`` of an int[E] a
rank, and one more over the pods). A rank keeps exactly the assignments
the reference keeps (global place < C) and sends them in slots
[0, min(C, T)) of its [E, ·, d] buffer (its own place: a rank holds at
most T of an expert's assignments); the expert products are row by row,
so a kept token's output does not depend on its slot.

Expert parallelism (``ep_axis``) in the reference shards the experts over
the learners and exchanges the dispatch buffers with two all-to-alls.
With one learner a rank (a ``repro_torch.dist.World`` of n ranks, the
model holding its E/n experts, ``Model(cfg, ep_world=world)``), the port
does the same exchange: dispatch [n, E/n, C, d] → ``all_to_all`` → [E/n,
n·C, d] → the three expert products → ``all_to_all`` back → the
gate-weighted combine; autograd carries the cotangents back through the
exchange (its transpose), so each rank's expert gradient sums every
learner's tokens. On one card, where every expert is local, rank r's
output for its own tokens is a dispatch of those tokens with
``_dispatch_indices``'s capacity, computed by the experts wherever they
live; the products are row by row, so ``_moe_apply_ep`` is that dispatch
over all E experts, with nothing standing in for the exchange, and the
train step sums the learners' expert gradients.

Tensor parallelism (``tp``, the model group's World; the reference's
``mshard(h, "data", None, "model")``): each rank holds its f/m columns of
every expert's ``wi``/``wg`` and rows of ``wo`` ([E/n, d, f/m] with expert
parallelism, ring j of the grid being the ranks of model index j). The
dispatch buffer enters the expert products through ``copy_to_model``,
each rank makes its partial product and one ``reduce_from_model`` sums
them in rank order; the shared experts split as the MLP does. The router
stays replicated: it reads the replicated block input outside any
parallel region, so its gradient is already whole on each rank, and its
routing is the same bits on every rank of the group because that input
is (``reduce_from_model`` sums in one fixed order).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.dist import collectives
from repro_torch.dist.collectives import copy_to_model, reduce_from_model
from repro_torch.models.layers import _dense_init


#: the reference's serving routes a MoE of at least this many experts
#: rank by rank in prefill (``launch/input_specs.py::use_expert_parallel``)
EP_PREFILL_EXPERTS = 64
#: ``kept`` a list: each routing of ``moe_apply`` / ``_moe_apply_ep``
#: appends the assignments each expert kept on this rank (int64[E])
route_stats = {"kept": None}


def _record_kept(slot: torch.Tensor, sorted_e: torch.Tensor, E: int, C: int) -> None:
    if route_stats["kept"] is not None:
        kept = torch.zeros(E, dtype=torch.int64, device=slot.device)
        route_stats["kept"].append(kept.index_add_(0, sorted_e, (slot < E * C).long()).cpu())


def expert_init(generator: torch.Generator, shape, device, rows: range) -> torch.Tensor:
    """Expert matrices f32[E, a, b] drawn one expert at a time (scaled as
    ``_dense_init`` scales [E, a, b]), of which only the experts in
    ``rows`` are kept: a rank's shard equals those rows of the matrix drawn
    with ``rows = range(E)`` from the same generator, and never more than
    one other expert's matrix is alive."""
    scale = 1.0 / np.sqrt(shape[0])
    out = torch.empty((len(rows),) + tuple(shape[1:]), dtype=torch.float32, device=device)
    if out.device.type == "meta":
        return out
    for e in range(shape[0]):
        w = torch.randn(shape[1:], generator=generator, device=device, dtype=torch.float32)
        if e in rows:
            torch.mul(w, scale, out=out[e - rows.start])
    return out


def moe_init(generator: torch.Generator, d: int, moe_cfg, device,
             rows: range = None) -> dict:
    """The MoE leaves; the per-expert matrices hold the experts in ``rows``
    (all E by default: a rank's shard under expert parallelism)."""
    E, ff = moe_cfg.num_experts, moe_cfg.expert_d_ff
    rows = range(E) if rows is None else rows
    params = {
        "router": _dense_init(generator, (d, E), device, scale=0.02),
        "wi": expert_init(generator, (E, d, ff), device, rows),
        "wg": expert_init(generator, (E, d, ff), device, rows),
        "wo": expert_init(generator, (E, ff, d), device, rows),
    }
    if moe_cfg.num_shared_experts:
        s = moe_cfg.num_shared_experts
        params["shared_wi"] = _dense_init(generator, (d, s * ff), device)
        params["shared_wg"] = _dense_init(generator, (d, s * ff), device)
        params["shared_wo"] = _dense_init(generator, (s * ff, d), device)
    return params


def _probs(params: dict, xt: torch.Tensor) -> torch.Tensor:
    """Router probabilities f32[T, E]: logits in the activations' dtype,
    the softmax in f32."""
    return torch.softmax((xt @ params["router"].to(xt.dtype)).float(), dim=-1)


def _top_k(probs: torch.Tensor, k: int):
    """(renormalised gates f32[T, k], assignments [T, k], the share of
    assignments each expert got f32[E])."""
    T, E = probs.shape
    gate_vals, assign = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    counts = torch.zeros(E, dtype=torch.float32, device=probs.device).index_add_(
        0, assign.reshape(-1), torch.ones(T * k, dtype=torch.float32, device=probs.device))
    return gate_vals, assign, counts / (T * k)


def _aux(probs: torch.Tensor, frac: torch.Tensor, moe_cfg) -> torch.Tensor:
    """The Switch load-balance loss."""
    return moe_cfg.num_experts * torch.sum(frac * probs.mean(0)) * moe_cfg.aux_loss_weight


def _slots(assign: torch.Tensor, E: int, C: int, T: int, route=None, cap: int = 0):
    """Capacity-capped dispatch of [T, k] assignments: (dispatch_tok
    int64[E·C] — the token in each slot, T for an empty one —, order, the
    slot of each sorted assignment with E·C for a dropped one). ``route``
    (serving across ranks, see the module docstring): an assignment is
    kept where its place in the global order is below ``cap``, the global
    capacity, and C is this rank's slots an expert."""
    k = assign.shape[1]
    dev = assign.device
    flat_assign = assign.reshape(-1)
    order = torch.argsort(flat_assign, stable=True)
    sorted_e = flat_assign[order]
    experts = torch.arange(E, device=dev)
    seg_start = torch.searchsorted(sorted_e, experts)
    pos_in_e = torch.arange(T * k, device=dev) - seg_start[sorted_e]
    keep = pos_in_e < C
    if route is not None:  # each expert's count: its segment of the sorted assignments
        counts = torch.searchsorted(sorted_e, experts, right=True) - seg_start
        keep = _ranks_before(counts, route)[sorted_e] + pos_in_e < cap
    slot = torch.where(keep, sorted_e * C + pos_in_e, E * C)
    _record_kept(slot, sorted_e, E, C)
    token_of = torch.div(order, k, rounding_mode="floor")
    dispatch_tok = torch.full((E * C + 1,), T, dtype=torch.int64, device=dev)
    dispatch_tok = dispatch_tok.scatter(0, slot, token_of)[:E * C]
    return dispatch_tok, order, slot


def _ranks_before(counts: torch.Tensor, route) -> torch.Tensor:
    """Each expert's assignments on the ranks before this one in the
    global batch's row order (int64[E]): ``route`` is (the data ranks'
    World, the pods' World or None), the rows pod-major."""
    data, pods = route
    seen = collectives.all_gather(counts, data)                      # [n, E]
    before = seen[:data.rank].sum(0)
    if pods is not None:
        earlier = collectives.all_gather(seen.sum(0), pods)[:pods.rank]  # [p, E]
        before = before + earlier.sum(0)
    return before


def _rows_of(route) -> int:
    """The ranks whose rows make the global batch."""
    data, pods = route
    return data.size * (1 if pods is None else pods.size)


def _capacity(T: int, k: int, E: int, capacity_factor: float, floor: int) -> int:
    C = int(np.ceil(T * k / E * capacity_factor))
    return max(floor, min(C, T))


def _products(params: dict, xe: torch.Tensor, tp=None) -> torch.Tensor:
    """The three expert products of [E', C', d] dispatch buffers, expert by
    expert (``torch.bmm``) with the local expert matrices [E', ...]. With
    ``tp`` (the model group's World) the matrices hold this rank's f/m
    expert columns: the buffer enters through ``copy_to_model``, each rank
    makes a partial product and ``reduce_from_model`` sums them."""
    dt = xe.dtype
    xe = copy_to_model(xe, tp)
    h = torch.bmm(xe, params["wi"].to(dt)) * F.silu(torch.bmm(xe, params["wg"].to(dt)))
    return reduce_from_model(torch.bmm(h, params["wo"].to(dt)), tp)


def _combine(xt: torch.Tensor, ye: torch.Tensor, dispatch_tok: torch.Tensor,
             gate_of_slot: torch.Tensor) -> torch.Tensor:
    """The slots' outputs [E·C, d] weighted by their gates and scatter-added
    back to the tokens: [T, d] in the activations' dtype."""
    T, d = xt.shape
    contrib = ye.reshape(-1, d) * gate_of_slot[:, None]
    return xt.new_zeros((T + 1, d)).index_add(0, dispatch_tok, contrib)[:T]


def _dispatch(xt: torch.Tensor, dispatch_tok: torch.Tensor) -> torch.Tensor:
    """The dispatch buffer [E·C, d]: each slot's token, zeros in an empty slot."""
    return torch.cat([xt, xt.new_zeros((1, xt.shape[1]))], 0)[dispatch_tok]


def _experts(params: dict, xt: torch.Tensor, dispatch_tok: torch.Tensor,
             gate_of_slot: torch.Tensor, E: int, C: int, tp=None) -> torch.Tensor:
    """The [E, C, d] expert products of the dispatched tokens, weighted by
    their gates and scatter-added back to the tokens: [T, d] in the
    activations' dtype (before the shared experts)."""
    xe = _dispatch(xt, dispatch_tok).view(E, C, xt.shape[1])
    return _combine(xt, _products(params, xe, tp), dispatch_tok, gate_of_slot)


def _shared(params: dict, xt: torch.Tensor, moe_cfg, y: torch.Tensor, tp=None) -> torch.Tensor:
    """``y`` plus the shared experts' SwiGLU (split over ``tp`` as the MLP)."""
    if not moe_cfg.num_shared_experts:
        return y
    dt = xt.dtype
    xs = copy_to_model(xt, tp)
    hs = (xs @ params["shared_wi"].to(dt)) * F.silu(xs @ params["shared_wg"].to(dt))
    return y + reduce_from_model(hs @ params["shared_wo"].to(dt), tp)


def moe_apply(params: dict, x: torch.Tensor, moe_cfg, ep_axis=None,
              ep_ranks: int = 1, ep_world=None, tp=None, route=None) -> tuple:
    """x: [B, S, d] -> (y, aux_loss). With ``ep_axis`` set, the
    expert-parallel routing of ``_moe_apply_ep`` (across the ranks of
    ``ep_world`` when given; ``route``: serving's routing of the global
    batch). ``tp``: the model group's World (expert-ff and the shared
    experts over the model ranks; see the module docstring)."""
    if ep_axis is not None:
        return _moe_apply_ep(params, x, moe_cfg, ep_ranks, ep_world, tp, route)
    B, S, d = x.shape
    E, k = moe_cfg.num_experts, moe_cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    probs = _probs(params, xt)
    gate_vals, assign, frac = _top_k(probs, k)
    aux = _aux(probs, frac, moe_cfg)
    C = _capacity(T, k, E, moe_cfg.capacity_factor, floor=8)
    dispatch_tok, order, slot = _slots(assign, E, C, T)
    gates_sorted = gate_vals.reshape(-1)[order].to(x.dtype)
    gate_of_slot = x.new_zeros((E * C + 1,)).scatter(0, slot, gates_sorted)[:E * C]
    y = _experts(params, xt, dispatch_tok, gate_of_slot, E, C, tp)
    return _shared(params, xt, moe_cfg, y, tp).reshape(B, S, d), aux


def _dispatch_indices(probs: torch.Tensor, k: int, E: int, T: int,
                      capacity_factor: float, route=None):
    """The expert-parallel path's routing: (dispatch_tok[E·C], gate_of_slot
    f32[E·C], C, frac), its capacity floored at 4; with ``route``, the
    global batch's (capacity floored at 8, from every rank's T; C is this
    rank's slots an expert, see the module docstring)."""
    gate_vals, assign, frac = _top_k(probs, k)
    if route is None:
        C = cap = _capacity(T, k, E, capacity_factor, floor=4)
    else:
        cap = _capacity(T * _rows_of(route), k, E, capacity_factor, floor=8)
        C = min(cap, T)
    dispatch_tok, order, slot = _slots(assign, E, C, T, route, cap)
    gates_sorted = gate_vals.reshape(-1)[order]
    gate_of_slot = probs.new_zeros((E * C + 1,)).scatter(0, slot, gates_sorted)[:E * C]
    return dispatch_tok, gate_of_slot, C, frac


def _moe_apply_ep(params: dict, x: torch.Tensor, moe_cfg, n_ranks: int,
                  world=None, tp=None, route=None) -> tuple:
    """One learner's expert-parallel MoE: its tokens dispatched with
    ``_dispatch_indices``'s capacity C (floor 4, from this rank's T; with
    ``route``, serving's routing of the global batch) to the E experts. ``n_ranks`` must divide E, as the reference's exchange needs.
    Without ``world`` (or on a World of one rank) every expert is local
    (one card, see the module docstring). With ``world`` the rank holds
    experts [r·E/n, (r+1)·E/n) and the reference's two tiled all-to-alls
    move the [n, E/n, C, d] dispatch buffer to the experts' ranks and the
    products back. With ``tp`` each rank of the model group exchanges over
    its own ring (the ranks of its model index) and makes its partial
    expert-ff product, summed by ``reduce_from_model`` before the return
    exchange."""
    E, k = moe_cfg.num_experts, moe_cfg.top_k
    if E % n_ranks:
        raise ValueError(f"{E} experts do not shard over {n_ranks} ranks")
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    probs = _probs(params, xt)
    if route is not None and (world is None or world.size == 1):
        route = None  # one process: its rows are the global batch
    dispatch_tok, gate_of_slot, C, frac = _dispatch_indices(
        probs, k, E, T, moe_cfg.capacity_factor, route)
    aux = _aux(probs, frac, moe_cfg)
    gate = gate_of_slot.to(x.dtype)
    if world is None or world.size == 1:
        y = _experts(params, xt, dispatch_tok, gate, E, C, tp)
    else:
        n = world.size
        if n != n_ranks:
            raise ValueError(f"ep_ranks={n_ranks} but the expert World has {n} ranks")
        E_loc = E // n
        if params["wi"].shape[0] != E_loc:
            raise ValueError(f"rank {world.rank} holds {params['wi'].shape[0]} experts, not "
                             f"its {E_loc} of {E}: build the model with Model(cfg, "
                             "ep_world=world)")
        # rank r receives from every rank s the tokens s sends r's experts
        xe = collectives.all_to_all(_dispatch(xt, dispatch_tok).view(n, E_loc, C, d), world)
        xe = xe.view(n, E_loc, C, d).transpose(0, 1).reshape(E_loc, n * C, d)
        ye = _products(params, xe, tp)
        ye = ye.view(E_loc, n, C, d).transpose(0, 1).contiguous()
        ye = collectives.all_to_all(ye, world)  # back to the senders, global-expert major
        y = _combine(xt, ye, dispatch_tok, gate)
    return _shared(params, xt, moe_cfg, y, tp).reshape(B, S, d), aux
