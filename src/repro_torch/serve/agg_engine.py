"""Multi-session aggregation engine: S concurrent SAFE rounds per step.

A fixed batch of S *slots*, each holding one tenant's
:class:`~repro_torch.core.session.AggSession`. Every ``step()`` admits
queued sessions into free slots and advances every occupied slot by one
aggregation round through ``chain_aggregate_batched``: one
``chain_combine_batched`` launch per hop carries every session's hop.
Finished sessions are evicted. Empty slots are left out of the batch (the
JAX engine runs them masked and discards their output).

Per-slot independence is total: keys, counter spaces, alive bitmaps and
initiator rotations are per session, and each session-round is
bit-identical to a standalone ``SecureAggregator.aggregate`` with the
same counter base and rotation. Slots share (n, V, mode, topology).

With a ``world`` (``repro_torch.dist``: one learner a rank), the engine is
the reference's ``shard_map`` program over the learner axis: each rank
holds its [S, V] rows, ``submit`` takes this rank's f32[V] row of a
session, keys are derived per session (and per rank) from the same seeds
on every rank, and ``chain_rank_batched`` runs each step. The host
scheduling — admission, eviction, rotation and counters — is the same
code on the same calls on every rank, so the ranks step the same sessions
in the same slots; each published mean is every rank's, bit for bit the
one-card engine's. Behind one broker, rank 0's ``serve.rank_engine.
EngineLead`` sends every rank its rows of each session before each step.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.aggregators import make_round_keys
from repro_torch.core.chain import chain_aggregate_batched, chain_rank_batched
from repro_torch.core.session import AggSession
from repro_torch.core.types import ChainConfig


class AggregationEngine:
    """Slot-based scheduler batching S SAFE sessions per step.

    Args:
      cfg: shared ChainConfig (mode 'safe' or 'saf').
      slots: S — max concurrent sessions per step.
      payload_words: V — per-learner vector length every session uses.
      device: where the rounds run (the card by default; with ``world``,
        the world's device).
      world: one learner a rank (``repro_torch.dist.World`` of n ranks), or
        None for the learner-major engine on one device.
    """

    def __init__(self, cfg: ChainConfig, slots: int = 8,
                 payload_words: int = 1024, device: str = "cuda", world=None):
        if cfg.mode not in ("safe", "saf"):
            raise ValueError("AggregationEngine batches the chain modes "
                             f"('safe'/'saf'), got {cfg.mode!r}")
        self.cfg = cfg
        self.slots = slots
        self.V = payload_words
        self.n = cfg.num_learners
        if world is not None and world.size != self.n:
            raise ValueError(f"{world.size} ranks for {self.n} learners: one learner a rank")
        self.world = world
        self.device = torch.device(device) if world is None else world.device
        # counter words one round consumes (weighted carries Σw as an
        # extra ring word) — sessions advance their counter by this much
        self.words_per_round = self.V + 1 if cfg.weighted else self.V
        self.slot_sessions: List[Optional[AggSession]] = [None] * slots
        self.queue: List[AggSession] = []
        self.steps = 0
        self.rounds_completed = 0
        self._next_sid = 0
        #: optional completion hook: called synchronously from step() with
        #: each AggSession the moment it finishes its last round.
        self.on_complete: Optional[Callable[[AggSession], None]] = None

    def submit(self, values, *, rounds: int = 1,
               provisioning_seed: int = 0xC0FFEE,
               learner_master: int = 0x5EED,
               alive: Optional[np.ndarray] = None,
               weights: Optional[np.ndarray] = None,
               rotate0: int = 0) -> AggSession:
        """Queue a session. values: f32[n, V] (with a ``world``, this rank's
        f32[V] row), moved to the engine's device; ``alive`` and
        ``weights`` are every learner's [n] on every rank."""
        values = torch.as_tensor(values, dtype=torch.float32).to(self.device)
        want = (self.n, self.V) if self.world is None else (self.V,)
        if tuple(values.shape) != want:
            raise ValueError(
                f"session shape {tuple(values.shape)} != engine slots' {want}")
        if self.world is not None:  # AggSession sizes its defaults by the rows
            alive = np.ones(self.n, np.float32) if alive is None else alive
            weights = np.ones(self.n, np.float32) if weights is None else weights
        if rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {rounds}")
        sess = AggSession(self._next_sid, values, provisioning_seed,
                          learner_master, rounds, alive, weights, rotate0)
        self._next_sid += 1
        self.queue.append(sess)
        return sess

    def _admit(self) -> None:
        for i, s in enumerate(self.slot_sessions):
            if s is None and self.queue:
                self.slot_sessions[i] = self.queue.pop(0)

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slot_sessions)

    def step(self) -> int:
        """Admit + advance every occupied slot one round. Returns the
        number of session-rounds completed this step."""
        self._admit()
        occupied = [(i, s) for i, s in enumerate(self.slot_sessions)
                    if s is not None]
        if not occupied:
            return 0
        rots = [s.rotate for _, s in occupied]
        keys = [make_round_keys(s.provisioning_seed, s.learner_master,
                                s.reserve_counter(self.words_per_round), self.n)
                for _, s in occupied]
        args = (torch.stack([s.values for _, s in occupied]),
                np.stack([k.provisioning_seed for k in keys]),
                np.stack([k.learner_seed for k in keys]),
                [k.counter_base for k in keys],
                self.cfg)
        kw = dict(weights=np.stack([s.weights for _, s in occupied]), rotate=rots)
        alive = np.stack([s.alive for _, s in occupied])
        if self.world is None:
            out = chain_aggregate_batched(*args, alive, **kw)
        else:
            out = chain_rank_batched(*args, self.world, alive, **kw)

        for (i, sess), published in zip(occupied, out):
            sess.record_result(published)
            if sess.done:
                self.slot_sessions[i] = None
                if self.on_complete is not None:
                    self.on_complete(sess)
        self.steps += 1
        self.rounds_completed += len(occupied)
        return len(occupied)

    def run_until_done(self, max_steps: int = 10_000) -> None:
        while (self.queue or self.active) and self.steps < max_steps:
            self.step()
