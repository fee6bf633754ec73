"""Carry state from the JAX package into the port.

These functions take the JAX package's objects as plain data — a
``ChainConfig``'s fields as a dict (``dataclasses.asdict``), its uint32 key
arrays, an ``AggSession``'s fields, a model's parameter tree and its
decode cache, all numpy — and build the port's objects from them.
``shard_experts`` and ``gather_experts`` carry the full-E expert leaves
(the reference's layout, or the one-card port's) into a rank's shard under
expert parallelism across ranks, and back; ``shard_model`` cuts a
``model_params`` state to a model rank's tensor-parallel shards.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import numpy as np
import torch

from repro_torch.core.session import AggSession
from repro_torch.core.types import ChainConfig, RoundKeys
from repro_torch.train.flatten import is_expert_path, leaves_with_paths, tree_unflatten

_SESSION_FIELDS = tuple(f.name for f in dataclasses.fields(AggSession))


def model_params(cfg, tree) -> Dict[str, torch.Tensor]:
    """The port's ``Model`` state (``load_state_dict``) from the reference's
    parameter tree, as ``jax.tree.map(np.asarray, params)`` gives it.

    Each leaf takes the dtype the port's model stores it in for ``cfg``:
    every kind's leaves alike (the MoE router, experts and shared experts,
    the stacked SSM vectors, zamba2's ``_shared`` placeholder and its
    unstacked ``shared_attn`` block), by the reference's rule that a bf16
    model keeps leaves of two or more dims in bf16.
    bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays or as their uint16
    bit patterns (an ``.npz`` holds them so) and are carried bit for bit,
    never through f32. The leaves stay on the CPU; ``load_state_dict``
    copies them to the model's device."""
    bf16 = cfg.dtype == "bfloat16"
    state = {}
    for path, leaf in leaves_with_paths(tree):
        a = np.asarray(leaf)
        if bf16 and a.ndim >= 2:
            if a.dtype.itemsize != 2 or a.dtype.name not in ("bfloat16", "uint16"):
                raise ValueError(f"{path}: expected bf16 or its uint16 bits, got {a.dtype}")
            t = _bf16(a)
        else:
            if a.dtype != np.float32:
                raise ValueError(f"{path}: expected float32, got {a.dtype}")
            t = torch.from_numpy(np.array(a))
        state[path.replace("/", ".")] = t
    return state


def shard_model(cfg, state: Dict[str, torch.Tensor], rank: int,
                ranks: int) -> Dict[str, torch.Tensor]:
    """``model_params``'s state (the full leaves) cut to model rank
    ``rank`` of ``ranks``'s shards (``models/sharding.py::shard_leaf``), for
    ``Model(cfg, tp_world=...).load_state_dict``: the tests start both
    packages from the same weights."""
    from repro_torch.models.sharding import check_tp, shard_leaf
    check_tp(cfg, ranks)
    return {k: shard_leaf(k.replace(".", "/"), v, cfg, rank, ranks) for k, v in state.items()}


def _is_expert(path: str) -> bool:
    return is_expert_path(path.replace(".", "/"))


def shard_experts(tree: Any, rank: int, ranks: int) -> Any:
    """``tree`` (a parameter tree, a ``model_params`` state dict, a train
    state with its ``ep_opt``) with every expert leaf — [n_units, E, ...],
    ``train/flatten.py::is_expert_path``, dotted keys too — cut to rank
    ``rank``'s experts [r·E/n, (r+1)·E/n) along dim 1, as a rank's model
    holds them (``Model(cfg, ep_world=world)``); other leaves as they are."""
    def cut(path, leaf):
        if not _is_expert(path):
            return leaf
        E = leaf.shape[1]
        if E % ranks:
            raise ValueError(f"{path}: {E} experts do not shard over {ranks} ranks")
        per = E // ranks
        return leaf[:, rank * per:(rank + 1) * per]
    return tree_unflatten(tree, [cut(p, leaf) for p, leaf in leaves_with_paths(tree)])


def gather_experts(shards: Sequence[Any]) -> Any:
    """The full-E tree of the ranks' ``shards`` (trees of one structure, in
    rank order): each expert leaf concatenated along dim 1, every other
    leaf rank 0's."""
    paths = leaves_with_paths(shards[0])
    per_rank = [[leaf for _, leaf in leaves_with_paths(t)] for t in shards]
    out = []
    for i, (path, leaf) in enumerate(paths):
        if _is_expert(path):
            parts = [rank_leaves[i] for rank_leaves in per_rank]
            leaf = (torch.cat(parts, dim=1) if isinstance(leaf, torch.Tensor)
                    else np.concatenate(parts, axis=1))
        out.append(leaf)
    return tree_unflatten(shards[0], out)


def _bf16(a: np.ndarray) -> torch.Tensor:
    """A bf16 tensor from an ``ml_dtypes.bfloat16`` array or its uint16
    bits, bit for bit."""
    return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)


_CACHE_KEYS = {"mamba2": {"state", "pos"}, "rwkv6": {"state", "prev", "pos"}}


def decode_cache(cfg, ref_cache) -> list:
    """The port's stacked decode cache (``Model.init_cache``'s layout) from
    the reference's, as ``jax.tree.map(np.asarray, cache)`` gives it: one
    dict a pattern position, leaves [n_units, ...].

    Each leaf keeps its dtype — the reference's caches mix them (bf16
    attention k and v that turn to the activations' dtype at the first
    decode step, RWKV6's bf16 ``prev``, f32 states, int32 ``pos``); bf16
    arrives as ``ml_dtypes.bfloat16`` arrays or their uint16 bits and is
    carried bit for bit. The leaves stay on the CPU, as ``model_params``'s
    do; a caller moves them to its device."""
    if len(ref_cache) != len(cfg.pattern):
        raise ValueError(f"expected {len(cfg.pattern)} pattern positions, got {len(ref_cache)}")
    out = []
    for pos, (kind, c) in enumerate(zip(cfg.pattern, ref_cache)):
        want = _CACHE_KEYS.get(kind, {"k", "v", "pos"})
        if set(c) != want:
            raise ValueError(f"position {pos} ({kind}): expected keys {sorted(want)}, "
                             f"got {sorted(c)}")
        leaves = {}
        for k, leaf in c.items():
            a = np.asarray(leaf)
            if a.shape[:1] != (cfg.n_units,):
                raise ValueError(f"position {pos} {k}: expected {cfg.n_units} units, "
                                 f"got shape {a.shape}")
            if a.dtype.itemsize == 2 and a.dtype.name in ("bfloat16", "uint16"):
                t = _bf16(a)
            elif a.dtype in (np.float32, np.int32):
                t = torch.from_numpy(np.array(a))
            else:
                raise ValueError(f"position {pos} {k}: unexpected dtype {a.dtype}")
            leaves[k] = t
        out.append(leaves)
    return out


def chain_config(fields: dict) -> ChainConfig:
    """The port's ChainConfig from the reference's fields."""
    return ChainConfig(**{f.name: fields[f.name]
                          for f in dataclasses.fields(ChainConfig)})


def round_keys(provisioning_seed, learner_seed, counter_base) -> RoundKeys:
    """RoundKeys from the reference's key arrays.

    ``learner_seed`` is the [n, 2] stack of every rank's
    ``RoundKeys.learner_seed`` (the reference holds one row per rank).
    """
    prov = np.asarray(provisioning_seed, np.uint32).reshape(2)
    learner = np.asarray(learner_seed, np.uint32)
    if learner.ndim != 2 or learner.shape[1] != 2:
        raise ValueError(f"learner_seed: expected [n, 2], got {learner.shape}")
    return RoundKeys(provisioning_seed=prov, learner_seed=learner,
                     counter_base=int(np.asarray(counter_base).astype(np.uint64))
                     & 0xFFFFFFFF)


def agg_session(fields: dict, device="cuda") -> AggSession:
    """An AggSession from the reference's fields, with its values on
    ``device``. Optional ``rounds_done`` and ``counter_next`` carry a
    session that has already run rounds (its results are not carried)."""
    kw = {k: fields[k] for k in _SESSION_FIELDS if k in fields}
    kw["values"] = torch.as_tensor(np.asarray(kw["values"], np.float32)).to(device)
    sess = AggSession(**kw)
    sess.rounds_done = int(fields.get("rounds_done", 0))
    sess.reserve_counter(int(fields.get("counter_next", 0)))
    return sess
