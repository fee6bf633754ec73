"""Carry state from the JAX package into the port.

SAFE has no weights: its state is configuration and key material. These
functions take the JAX package's objects as plain data — a
``ChainConfig``'s fields as a dict (``dataclasses.asdict``), its uint32 key
arrays and an ``AggSession``'s fields, all numpy — and build the port's
objects from them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.session import AggSession
from repro_torch.core.types import ChainConfig, RoundKeys

_SESSION_FIELDS = tuple(f.name for f in dataclasses.fields(AggSession))


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
