"""Aggregator interface — SAFE and its baselines on one device.

``SecureAggregator.aggregate`` takes the learner-major [n, V] matrix
(pod-major [P, n, V] with a pod axis) and returns the published [V] mean:
the JAX package's ``aggregate_sharded`` without the mesh, plus the
per-round initiator ``rotate`` its per-rank ``aggregate`` takes. Every
mode of the reference runs: insec, saf, safe (sequential or pipelined)
and bon, each with or without ``pod_axis``. It runs on ``device`` (the
card by default); values given elsewhere are moved there first.

Key provisioning (DESIGN.md §6): a ``provisioning_seed`` models the
Round-0 out-of-band exchange (hop keys are KDF(provisioning, i, j)); each
learner's private seed is KDF(learner_master, rank). Keys are derived on
the host with the numpy mirror of the PRF.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

from repro_torch.core.bon import bon_aggregate
from repro_torch.core.chain import (chain_aggregate_pipelined,
                                    chain_aggregate_sequential)
from repro_torch.core.insec import insec_aggregate
from repro_torch.core.session import seed_words
from repro_torch.core.types import ChainConfig, RoundKeys
from repro_torch.crypto.np_impl import derive_key_np, threefry2x32_np
from repro_torch.crypto.prf import RoundCounter


def make_round_keys(provisioning_seed: int, learner_master: int,
                    counter_base: int, num_learners: int,
                    domain: int = 0) -> RoundKeys:
    """RoundKeys of every rank: the reference's ``make_round_keys``
    evaluated for ranks 0..n-1 at once.

    ``domain`` separates keystreams when one round aggregates several
    vectors (leaf-wise aggregation of a parameter tree): each domain gets
    independent derived keys, so the 32-bit counter space is per leaf."""
    prov = derive_key_np(seed_words(provisioning_seed), domain)
    master = derive_key_np(seed_words(learner_master), domain)
    ranks = np.arange(num_learners, dtype=np.uint32)
    y0, y1 = threefry2x32_np(master, ranks, np.uint32(0x9E3779B9))
    return RoundKeys(provisioning_seed=prov,
                     learner_seed=np.stack([y0, y1], axis=1),
                     counter_base=int(counter_base) & 0xFFFFFFFF)


@dataclasses.dataclass
class SecureAggregator:
    """Secure mean over the learner dim of an [n, V] matrix.

    mode is ``cfg.mode``: insec | saf | safe | bon; ``cfg.pipelined``
    selects the segment pipeline for saf/safe.
    """

    cfg: ChainConfig
    provisioning_seed: int = 0xC0FFEE
    learner_master: int = 0x5EED
    device: str = "cuda"
    _counters: RoundCounter = dataclasses.field(default_factory=RoundCounter)

    def reserve_round(self, nwords: int) -> int:
        """Reserve fresh counter space for one aggregation round; returns
        its first counter word.

        SAFE uses one pad word per payload word per edge; BON uses one per
        pair. A single monotone space sized by the worst case keeps the
        no-reuse invariant simple. Raises ``OverflowError`` before any
        range would wrap past 2^32 (a key rotation is then due)."""
        return self._counters.reserve(int(nwords))

    def aggregate(self, values, counter_base: int = 0, alive=None,
                  weights=None, domain: int = 0, rotate: int = 0) -> torch.Tensor:
        """Secure mean of f32[n, V] learner-major values -> f32[V].

        With ``cfg.pod_axis`` the values are f32[P, n, V], one [n, V]
        matrix per pod, and the result is the mean over pods. ``alive`` is
        a 0/1 [n] bitmap (every pod's), ``weights`` f32[n] (with pods
        f32[P, n], one per learner of each pod; read when ``cfg.weighted``,
        ignored by BON as by the reference), ``rotate`` the initiator
        rotation of the sequential schedule (§8; the pipelined one has no
        initiator to rotate), ``domain`` the key domain (0 for one flat
        vector; the train step's leafwise mode gives leaf i domain i + 1)."""
        values = torch.as_tensor(values, dtype=torch.float32).to(self.device).contiguous()
        cfg = self.cfg
        if cfg.mode == "insec":
            return insec_aggregate(values, cfg, alive, weights)
        keys = make_round_keys(self.provisioning_seed, self.learner_master,
                               counter_base, cfg.num_learners, domain)
        if cfg.mode == "bon":
            return bon_aggregate(values, keys, cfg, alive)
        if cfg.pipelined:
            return chain_aggregate_pipelined(values, keys, cfg, alive, weights)
        return chain_aggregate_sequential(values, keys, cfg, alive, weights, rotate)

    def aggregate_tree(self, tree: Dict[str, torch.Tensor], counter_base: int = 0,
                       alive=None, weights=None) -> Dict[str, torch.Tensor]:
        """Secure mean of a dict of [n, ...] tensors ([P, n, ...] with a pod
        axis), flattened in sorted-key order (as ``ravel_pytree`` flattens
        a dict) into one f32 round."""
        names = sorted(tree)
        lead = 1 if self.cfg.pod_axis is None else 2
        leaves = [torch.as_tensor(tree[k]) for k in names]
        flat = torch.cat([t.to(self.device, torch.float32).reshape(*t.shape[:lead], -1)
                          for t in leaves], dim=-1)
        avg = self.aggregate(flat, counter_base, alive, weights)
        out, off = {}, 0
        for name, t in zip(names, leaves):
            size = math.prod(t.shape[lead:])
            out[name] = avg[off:off + size].reshape(t.shape[lead:]).to(t.dtype)
            off += size
        return out


def make_aggregator(
    mode: str,
    num_learners: int,
    axis: str = "data",
    *,
    pipelined: bool = False,
    subgroups: int = 1,
    weighted: bool = False,
    pod_axis=None,
    scale_bits: int = 16,
    unroll: bool = True,
    provisioning_seed: int = 0xC0FFEE,
    learner_master: int = 0x5EED,
    device: str = "cuda",
) -> SecureAggregator:
    """Factory with the reference's arguments, plus the device to run on."""
    cfg = ChainConfig(axis=axis, num_learners=num_learners,
                      scale_bits=scale_bits, mode=mode, pipelined=pipelined,
                      subgroups=subgroups, weighted=weighted,
                      pod_axis=pod_axis, unroll=unroll)
    return SecureAggregator(cfg, provisioning_seed, learner_master, device)
