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

Expert parallelism (``ep_axis``) in the reference shards the experts over
the learners and exchanges the dispatch buffers with two all-to-alls.
Rank r's output for its own tokens is then a dispatch of those tokens with
``_dispatch_indices``'s capacity, computed by the experts wherever they
live; the products are row by row, so on one card, where every expert is
local, ``_moe_apply_ep`` is that dispatch over all E experts, with nothing
standing in for the exchange. The expert gradients the reference sums
through the all-to-all's transpose are summed by the train step.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense_init


def moe_init(generator: torch.Generator, d: int, moe_cfg, device) -> dict:
    E, ff = moe_cfg.num_experts, moe_cfg.expert_d_ff
    params = {
        "router": _dense_init(generator, (d, E), device, scale=0.02),
        "wi": _dense_init(generator, (E, d, ff), device),
        "wg": _dense_init(generator, (E, d, ff), device),
        "wo": _dense_init(generator, (E, ff, d), device),
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


def _slots(assign: torch.Tensor, E: int, C: int, T: int):
    """Capacity-capped dispatch of [T, k] assignments: (dispatch_tok
    int64[E·C] — the token in each slot, T for an empty one —, order, the
    slot of each sorted assignment with E·C for a dropped one)."""
    k = assign.shape[1]
    dev = assign.device
    flat_assign = assign.reshape(-1)
    order = torch.argsort(flat_assign, stable=True)
    sorted_e = flat_assign[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    pos_in_e = torch.arange(T * k, device=dev) - seg_start[sorted_e]
    slot = torch.where(pos_in_e < C, sorted_e * C + pos_in_e, E * C)
    token_of = torch.div(order, k, rounding_mode="floor")
    dispatch_tok = torch.full((E * C + 1,), T, dtype=torch.int64, device=dev)
    dispatch_tok = dispatch_tok.scatter(0, slot, token_of)[:E * C]
    return dispatch_tok, order, slot


def _capacity(T: int, k: int, E: int, capacity_factor: float, floor: int) -> int:
    C = int(np.ceil(T * k / E * capacity_factor))
    return max(floor, min(C, T))


def _experts(params: dict, xt: torch.Tensor, dispatch_tok: torch.Tensor,
             gate_of_slot: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """The [E, C, d] expert products of the dispatched tokens, weighted by
    their gates and scatter-added back to the tokens: [T, d] in the
    activations' dtype (before the shared experts)."""
    T, d = xt.shape
    dt = xt.dtype
    xpad = torch.cat([xt, xt.new_zeros((1, d))], 0)
    xe = xpad[dispatch_tok].view(E, C, d)
    h = torch.bmm(xe, params["wi"].to(dt)) * F.silu(torch.bmm(xe, params["wg"].to(dt)))
    ye = torch.bmm(h, params["wo"].to(dt))
    contrib = ye.reshape(E * C, d) * gate_of_slot[:, None]
    return xt.new_zeros((T + 1, d)).index_add(0, dispatch_tok, contrib)[:T]


def _shared(params: dict, xt: torch.Tensor, moe_cfg, y: torch.Tensor) -> torch.Tensor:
    if not moe_cfg.num_shared_experts:
        return y
    dt = xt.dtype
    hs = (xt @ params["shared_wi"].to(dt)) * F.silu(xt @ params["shared_wg"].to(dt))
    return y + hs @ params["shared_wo"].to(dt)


def moe_apply(params: dict, x: torch.Tensor, moe_cfg, ep_axis=None,
              ep_ranks: int = 1) -> tuple:
    """x: [B, S, d] -> (y, aux_loss). With ``ep_axis`` set, the
    expert-parallel routing of ``_moe_apply_ep``."""
    if ep_axis is not None:
        return _moe_apply_ep(params, x, moe_cfg, ep_ranks)
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
    y = _experts(params, xt, dispatch_tok, gate_of_slot, E, C)
    return _shared(params, xt, moe_cfg, y).reshape(B, S, d), aux


def _dispatch_indices(probs: torch.Tensor, k: int, E: int, T: int,
                      capacity_factor: float):
    """The expert-parallel path's routing: (dispatch_tok[E·C], gate_of_slot
    f32[E·C], C, frac), its capacity floored at 4."""
    gate_vals, assign, frac = _top_k(probs, k)
    C = _capacity(T, k, E, capacity_factor, floor=4)
    dispatch_tok, order, slot = _slots(assign, E, C, T)
    gates_sorted = gate_vals.reshape(-1)[order]
    gate_of_slot = probs.new_zeros((E * C + 1,)).scatter(0, slot, gates_sorted)[:E * C]
    return dispatch_tok, gate_of_slot, C, frac


def _moe_apply_ep(params: dict, x: torch.Tensor, moe_cfg, n_ranks: int) -> tuple:
    """One learner's expert-parallel MoE on one card: its tokens dispatched
    with ``_dispatch_indices``'s capacity to all E experts (see the module
    docstring). ``n_ranks`` must divide E, as the reference's exchange
    needs."""
    E, k = moe_cfg.num_experts, moe_cfg.top_k
    if E % n_ranks:
        raise ValueError(f"{E} experts do not shard over {n_ranks} ranks")
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    probs = _probs(params, xt)
    dispatch_tok, gate_of_slot, C, frac = _dispatch_indices(
        probs, k, E, T, moe_cfg.capacity_factor)
    aux = _aux(probs, frac, moe_cfg)
    y = _experts(params, xt, dispatch_tok, gate_of_slot.to(x.dtype), E, C)
    return _shared(params, xt, moe_cfg, y).reshape(B, S, d), aux
