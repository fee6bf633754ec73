"""Carry state from the JAX package into the port.

These functions take the JAX package's objects as plain data — a
``ChainConfig``'s fields as a dict (``dataclasses.asdict``), its uint32 key
arrays, an ``AggSession``'s fields and a model's parameter tree, all numpy
— and build the port's objects from them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core.session import AggSession
from repro_torch.core.types import ChainConfig, RoundKeys
from repro_torch.train.flatten import leaves_with_paths

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
            t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
        else:
            if a.dtype != np.float32:
                raise ValueError(f"{path}: expected float32, got {a.dtype}")
            t = torch.from_numpy(np.array(a))
        state[path.replace("/", ".")] = t
    return state


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
