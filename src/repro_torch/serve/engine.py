"""Batched serving: continuous prefill and decode.

The counterpart of the JAX package's ``serve/engine.py``.
``make_serve_step`` gives the one-token decode step: ONE new token a row
against a KV cache (or recurrent state). ``ServeEngine`` is the host-side
loop: a fixed batch of slots, each holding one request's cache; a queued
request is prefilled alone into a cache of ``max_seq`` and copied into a
free slot of every stacked leaf, and a finished one leaves its slot. Every
slot decodes every step, an empty one with token 0, so the decode step
keeps one shape. Sampling is greedy (argmax) or, with ``temperature >
0``, an f32 softmax moved to the host and one
``np.random.RandomState(seed).choice`` a row, as the reference samples.

Everything runs under ``torch.inference_mode()``: the model's leaves are
``nn.Parameter``s, and a graph kept a decode step would grow without
bound. The engine runs on the model's device. ``cache_pspecs`` gives the
reference's partition specs of a cache over a mesh; across ranks a
rank's ``Model.init_cache`` is its part of them, and ``make_serve_step(model,
mesh)`` its step. ``ServeEngine`` stays on one card, as the reference's
takes no mesh.

The decode step takes the cache it is given as donated, as the
reference's decode dry run does (``jax.jit(decode_step,
donate_argnums=(2,))``): the attention k and v are written into the
caller's tensors where the dtypes agree (the bf16 path), so the cache
returned shares their storage and the caller keeps only the returned one
(``ServeEngine`` does; ``Model.decode_step``).

The engine does not serve a multi-codebook model (musicgen), and neither
does the reference's: the admitted token is the argmax of the flattened
[nc, vocab] logits, the decode step then embeds a token row without its
codebook axis (each package reads codebook 0's column for every codebook;
``Model._embed``), and the first ``step`` raises ``TypeError`` where it
turns a row of nc sampled tokens into one int.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.models.transformer import Model
from repro_torch.train.flatten import tree_map


def cache_pspecs(cache, batch_sharded: bool, seq_axis: Optional[str] = None,
                 model_size: int = 1):
    """Partition specs (tuples, one entry per dim) of a stacked decode cache
    (``Model.init_cache``'s list of dicts; any leaf with a ``shape``).

    batch_sharded: shard the batch dim over 'data' (decode_32k).
    seq_axis: shard the attention-cache sequence dim instead (long_500k,
    batch=1 — the beyond-paper sequence-parallel KV layout).
    Attention k/v are [n_units, B, S_c, n_kv, hd]; recurrent states
    [n_units, B, H, ...]; pos [n_units, B]. Head dims shard over 'model'
    only when divisible (GQA kv counts are often < the TP degree). The same
    rules by leaf rank as the reference's."""
    def heads(leaf, dim):
        return "model" if leaf.shape[dim] % max(model_size, 1) == 0 else None

    def spec_for(leaf):
        nd = len(leaf.shape)
        if nd == 5:  # attention kv
            if batch_sharded:
                return (None, "data", None, heads(leaf, 3), None)
            if seq_axis:
                return (None, None, seq_axis, heads(leaf, 3), None)
            return (None, None, None, heads(leaf, 3), None)
        if nd == 4:  # mamba2 / rwkv6 state [U, B, H, ...]
            return (None, "data" if batch_sharded else None, heads(leaf, 2), None)
        if nd == 3:  # rwkv prev [U, B, d]
            return (None, "data" if batch_sharded else None, None)
        if nd == 2:  # pos [U, B]
            return (None, "data") if batch_sharded else ()
        return ()

    return tree_map(spec_for, cache)


def _members(world) -> Optional[list]:
    """The default group's ranks of ``world``, in its rank order."""
    return None if world is None else [world.global_rank(r) for r in range(world.size)]


def make_serve_step(model: Model, mesh=None, *, seq_axis: Optional[str] = None) -> Callable:
    """(params, tokens, cache) -> (logits, cache): one token a row, under
    ``torch.inference_mode()``.

    ``mesh`` (the reference's argument): a ``DeviceMesh`` over the live
    group, or a ``dist.Grid``, with this rank one of its positions. The
    model's Worlds must be the mesh's — its ``tp_world`` the 'model'
    dimension, its ``ep_world`` (a MoE's) the 'data' one — and the step is
    then this rank's: its batch rows (over ('pod', 'data')) and its shards.
    ``seq_axis`` (long_500k's layout, ``cache_pspecs``' argument): the
    attention caches' slots lie over that dimension's ranks
    (``Model.init_cache(..., seq_world=)``)."""
    from repro_torch.dist.world import model_world_of, rank_world
    seq_world = None
    if mesh is not None:
        tp = model_world_of(mesh)
        if _members(tp) != _members(model.tp_world):
            raise ValueError(f"{model.cfg.arch_id}: the model's tp_world is not the mesh's "
                             "'model' dimension: build it with Model(cfg, "
                             "tp_world=model_world_of(mesh))")
        if model.ep_world is not None and (_members(model.ep_world)
                                           != _members(rank_world(mesh, "data"))):
            raise ValueError(f"{model.cfg.arch_id}: the model's ep_world is not the mesh's "
                             "'data' dimension")
        if seq_axis is not None:
            seq_world = rank_world(mesh, seq_axis)
    elif seq_axis is not None:
        raise ValueError("seq_axis names a dimension of the mesh: give the mesh")

    def serve_step(params, tokens, cache):
        with torch.inference_mode():
            return model.decode_step(params, tokens, cache, seq_world=seq_world)

    return serve_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # int32[S]
    max_new: int = 32
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Host-side batched serving loop over ``batch_slots`` slots of
    ``max_seq`` positions each. ``params`` is the reference-shaped tree
    (``model.tree()``)."""

    def __init__(self, model: Model, params: dict, batch_slots: int = 4,
                 max_seq: int = 512, temperature: float = 0.0, seed: int = 0):
        self.model = model
        self.params = params
        self.slots = batch_slots
        self.max_seq = max_seq
        self.temperature = temperature
        self.rng = np.random.RandomState(seed)
        self.device = model.embed.device
        with torch.inference_mode():
            self.cache = model.init_cache(batch_slots, max_seq, prefilled=False)
        self.slot_req: list = [None] * batch_slots
        self.queue: list = []
        self.steps = 0

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slot_req):
            if r is None:
                return i
        return None

    @torch.inference_mode()
    def _admit(self) -> None:
        while self.queue and (slot := self._free_slot()) is not None:
            req = self.queue.pop(0)
            self.slot_req[slot] = req
            # prefill this request alone, then copy its cache into the slot
            one = self.model.init_cache(1, self.max_seq, prefilled=False)
            toks = torch.as_tensor(np.asarray(req.prompt)[None, :], dtype=torch.int32,
                                   device=self.device)
            logits, one = self.model.prefill(self.params, toks, cache=one)
            req.generated = [int(torch.argmax(logits[0]))]
            for full_c, one_c in zip(self.cache, one):
                for k, full in full_c.items():
                    full[:, slot] = one_c[k][:, 0]  # cast to the slot cache's dtype

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        p = torch.softmax(logits / self.temperature, dim=-1).cpu().numpy()
        return np.array([self.rng.choice(p.shape[-1], p=row) for row in p])

    @torch.inference_mode()
    def step(self) -> None:
        """Admit, then one decode step for every slot."""
        self._admit()
        if all(r is None for r in self.slot_req):
            return
        last = np.zeros((self.slots,), np.int32)
        for i, r in enumerate(self.slot_req):
            if r is not None and r.generated:
                last[i] = r.generated[-1]
        logits, self.cache = self.model.decode_step(
            self.params, torch.as_tensor(last, device=self.device), self.cache)
        nxt = self._sample(logits)
        self.steps += 1
        for i, r in enumerate(self.slot_req):
            if r is None:
                continue
            r.generated.append(int(nxt[i]))
            if len(r.generated) >= r.max_new:
                r.done = True
                self.slot_req[i] = None

    def run_until_done(self, max_steps: int = 10_000) -> None:
        while (self.queue or any(self.slot_req)) and self.steps < max_steps:
            self.step()
