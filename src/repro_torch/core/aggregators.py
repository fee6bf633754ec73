"""Aggregator interface — SAFE and its baselines.

``SecureAggregator.aggregate`` takes the learner-major [n, V] matrix
(pod-major [P, n, V] with a pod axis) on one device and returns the
published [V] mean: the JAX package's ``aggregate_sharded`` without the
mesh, plus the per-round initiator ``rotate`` its per-rank ``aggregate``
takes. Every mode of the reference runs: insec, saf, safe (sequential or
pipelined) and bon, each with or without ``pod_axis``. It runs on
``device`` (the card by default); values given elsewhere are moved there
first.

With one learner per process (``repro_torch.dist``), ``aggregate_rank``
is the reference's per-rank ``aggregate`` and ``aggregate_sharded`` its
``shard_map`` entry over a live process group. With model shards
(``model_world``, the reference's ``chain_model_sharded``) the vector is
cut into m equal chunks of even length L, and model rank j's ring — the
ranks holding shard j of each learner — runs the round over words
[s_j, s_j + L), s_j = j·L, of the vector: the same round with the counter
base moved by s_j/2, which gives every word the pad of its place in the
whole vector (word i is lane i & 1 of counter base + i // 2, and s_j is
even). So the published chunk is the one-card mean's words, the
sequential and BON ciphertexts are the one-card round's words, and no
pad of the reserved range is used twice. A weighted round's weight word
rides with the last chunk. With a pod axis the ranks
form a ('pod', 'data') grid (``launch/mesh.py::make_pod_mesh``): each pod
runs the round over its learners' ``World`` and the pods' results meet
over the pod ``World`` (``chain.pod_mean_rank``); with model shards too
(the ('pod', 'data', 'model') grid, ``dist.grid``) each pod's ring j runs
chunk j's round and the pods' chunks meet over the pod group.

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

from repro_torch.core.bon import bon_aggregate, bon_rank
from repro_torch.core.chain import (chain_aggregate_pipelined, chain_aggregate_sequential,
                                    chain_rank_pipelined, chain_rank_sequential, pod_mean_rank)
from repro_torch.core.insec import insec_aggregate, insec_rank
from repro_torch.core.session import seed_words
from repro_torch.core.types import ChainConfig, RoundKeys
from repro_torch.crypto.np_impl import derive_key_np, threefry2x32_np
from repro_torch.crypto.prf import RoundCounter
from repro_torch.dist.world import pod_world_of, rank_world


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
        """Reserve fresh counter space for one aggregation round of
        ``nwords`` payload words; returns its first counter.

        Every pad is ``keystream_pair_lanes``: one Threefry counter yields
        two words, so a round draws ``round_counters(nwords)`` counters per
        key, and that is what is reserved. Callers keep passing words
        (``padded_size + 2`` a train step, ``P + 1`` a weighted round).
        Raises ``OverflowError`` before any range would pass 2^32 counters
        (a key rotation is then due)."""
        return self._counters.reserve(self.round_counters(nwords))

    def reserve_counters(self, ncounters: int) -> int:
        """Reserve ``ncounters`` counters outright (a resumed run skips the
        counters its checkpoint says are spent); returns the first."""
        return self._counters.reserve(int(ncounters))

    def round_counters(self, nwords: int) -> int:
        """Counters a round of ``nwords`` words draws from each key: half
        the words it pads, rounded up. The pipelined schedule pads each
        group's payload to m equal segments (m·⌈nwords/m⌉ words), so it
        draws for those; the sequential schedule, BON and every pod draw
        for ``nwords``."""
        nwords = int(nwords)
        if nwords < 0:
            raise ValueError(f"nwords must be >= 0, got {nwords}")
        if self.cfg.pipelined and self.cfg.mode in ("safe", "saf"):
            m = self.cfg.group_size
            nwords = m * -(-nwords // m)
        return -(-nwords // 2)

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

    def check_world(self, world, pod_world=None, pods=None) -> None:
        """Raise unless ``world`` holds one learner a rank of this
        aggregator and ``pod_world`` is there exactly when the aggregator
        has a pod axis, with one rank a pod (``pods``, when the caller's
        data says how many)."""
        if world.size != self.cfg.num_learners:
            raise ValueError(f"{world.size} ranks for {self.cfg.num_learners} learners: one "
                             "learner a rank")
        if self.cfg.pod_axis is None:
            if pod_world is not None:
                raise ValueError("a pod World was given, but the aggregator has no pod axis")
            return
        if pod_world is None:
            raise ValueError(f"pod_axis={self.cfg.pod_axis!r}: the per-rank round needs the "
                             "pod World too (rank_world(mesh, 'pod') of a ('pod', 'data') "
                             "mesh, launch/mesh.py::make_pod_mesh)")
        if pods is not None and pods != pod_world.size:
            raise ValueError(f"a pod World of {pod_world.size} ranks for {pods} pods: one "
                             "pod a rank of the pod World")

    def _rank_weight(self, weights, world, pod_world):
        """This rank's scalar weight from its scalar, the f32[n] weights of
        every learner (the same in every pod) or, with pods, f32[P, n]."""
        if weights is None:
            return None
        w = torch.as_tensor(weights if isinstance(weights, torch.Tensor)
                            else np.asarray(weights, np.float32)).reshape(-1)
        n = self.cfg.num_learners
        if w.numel() == 1:
            return w.reshape(())
        if w.numel() == n:
            return w[world.rank]
        if pod_world is None or w.numel() % n:
            raise ValueError(f"weights: expected a scalar, {n} or [P, {n}] entries, got "
                             f"{w.numel()}")
        self.check_world(world, pod_world, w.numel() // n)
        return w.reshape(-1, n)[pod_world.rank, world.rank]

    def aggregate_rank(self, values, counter_base: int = 0, alive=None, weights=None,
                       domain: int = 0, rotate: int = 0, *, world,
                       pod_world=None, model_world=None) -> torch.Tensor:
        """Secure mean with one learner per rank: the reference's per-rank
        ``aggregate`` (inside ``shard_map``), over ``world``
        (``repro_torch.dist``). ``values`` is this rank's f32[V], ``alive``
        the 0/1 [n] bitmap (the same on every rank, and in every pod),
        ``weights`` this rank's scalar weight, or the f32[n] (or with pods
        f32[P, n]) weights of every learner (read when ``cfg.weighted``),
        ``rotate`` and ``domain`` as in ``aggregate``. With the pod axis,
        ``pod_world`` links this learner's rank across the pods: each pod's
        round runs over its ``world``, then the pods' results are
        all-gathered in pod order and averaged as the one-card
        ``pod_mean``. Keys and the initiator election are derived on the
        host from the same seeds on every rank; nothing of them is sent.
        Returns the published f32[V] mean on every rank, bit for bit
        ``aggregate``'s of the stacked rows.

        ``model_world`` (the model group of a ('data', 'model') grid,
        ``dist.grid_worlds``): ``values`` is chunk j (its model rank) of
        the vector, every chunk of one even length L; ``world`` is the ring
        of the ranks holding chunk j, and the result is words [j·L,
        (j + 1)·L) of the published mean (see the module docstring). With
        ``pod_world`` too (the ('pod', 'data', 'model') grid,
        ``dist.grid``), ring (p, j) runs chunk j's round in pod p and the
        pods' chunks meet over the pod group: words [j·L, (j + 1)·L) of the
        one-card ``pod_rounds``' mean. Every rank of the grid calls it at
        once."""
        self.check_world(world, pod_world)
        values = torch.as_tensor(values, dtype=torch.float32).to(world.device).contiguous()
        if values.dim() != 1:
            raise ValueError(f"values: expected this rank's [V] vector, got {tuple(values.shape)}")
        if model_world is not None and model_world.size > 1:
            if values.shape[0] % 2:
                raise ValueError(f"a chunk of {values.shape[0]} words: model-sharded chunks "
                                 "have an even length, so each starts on a counter")
            counter_base = int(counter_base) + model_world.rank * (values.shape[0] // 2)
        else:
            model_world = None
        weight = self._rank_weight(weights, world, pod_world)
        cfg = dataclasses.replace(self.cfg, pod_axis=None)
        if cfg.mode == "insec":
            avg = insec_rank(values, cfg, world, alive, weight)
        else:
            keys = make_round_keys(self.provisioning_seed, self.learner_master,
                                   counter_base, cfg.num_learners, domain)
            if cfg.mode == "bon":
                avg = bon_rank(values, keys, cfg, world, alive)
            elif cfg.pipelined:
                avg = chain_rank_pipelined(values, keys, cfg, world, alive, weight,
                                           model_world)
            else:
                avg = chain_rank_sequential(values, keys, cfg, world, alive, weight, rotate,
                                            model_world)
        return avg if pod_world is None else pod_mean_rank(avg, pod_world)

    def aggregate_sharded(self, mesh, global_values, counter_base: int = 0, alive=None,
                          weights=None) -> torch.Tensor:
        """The reference's ``aggregate_sharded`` on a live process group: each
        rank takes its row of the learner-major f32[n, V] ``global_values``
        (and the f32[n] ``weights``) and returns the published [V] mean, the
        same on every rank. ``mesh`` is a ``repro_torch.dist.World`` or a
        ``DeviceMesh`` over the live group (its ``cfg.axis`` dimension holds
        the learners); with the pod axis a ('pod', 'data') mesh
        (``launch/mesh.py::make_pod_mesh``), ``global_values`` pod-major
        f32[P, n, V] and ``weights`` f32[P, n] (or f32[n] for every pod)."""
        world = rank_world(mesh, self.cfg.axis)
        if world is None:
            raise ValueError("aggregate_sharded needs a World or a mesh over the live "
                             "process group init_world started")
        values = torch.as_tensor(global_values)
        pod_world = None
        if self.cfg.pod_axis is not None:
            pod_world = pod_world_of(mesh, self.cfg.pod_axis)
            if pod_world is None:
                raise ValueError(f"pod_axis={self.cfg.pod_axis!r} needs a ('pod', 'data') "
                                 "mesh, not a World")
            if values.dim() != 3:
                raise ValueError(f"values: with pod_axis={self.cfg.pod_axis!r} expected "
                                 f"[P, n, V], got {tuple(values.shape)}")
            self.check_world(world, pod_world, values.shape[0])
            row = values[pod_world.rank, world.rank]
        else:
            row = values[world.rank]
        return self.aggregate_rank(row, counter_base, alive, weights, world=world,
                                   pod_world=pod_world)

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
