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
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.aggregators import make_round_keys
from repro_torch.core.chain import chain_aggregate_batched
from repro_torch.core.session import AggSession
from repro_torch.core.types import ChainConfig


class AggregationEngine:
    """Slot-based scheduler batching S SAFE sessions per step.

    Args:
      cfg: shared ChainConfig (mode 'safe' or 'saf').
      slots: S — max concurrent sessions per step.
      payload_words: V — per-learner vector length every session uses.
      device: where the rounds run (the card by default).
    """

    def __init__(self, cfg: ChainConfig, slots: int = 8,
                 payload_words: int = 1024, device: str = "cuda"):
        if cfg.mode not in ("safe", "saf"):
            raise ValueError("AggregationEngine batches the chain modes "
                             f"('safe'/'saf'), got {cfg.mode!r}")
        self.cfg = cfg
        self.slots = slots
        self.V = payload_words
        self.n = cfg.num_learners
        self.device = torch.device(device)
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
        """Queue a session. values: f32[n, V] (moved to the engine's device)."""
        values = torch.as_tensor(values, dtype=torch.float32).to(self.device)
        if tuple(values.shape) != (self.n, self.V):
            raise ValueError(
                f"session shape {tuple(values.shape)} != engine slots' "
                f"({self.n}, {self.V})")
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
        out = chain_aggregate_batched(
            torch.stack([s.values for _, s in occupied]),
            np.stack([k.provisioning_seed for k in keys]),
            np.stack([k.learner_seed for k in keys]),
            [k.counter_base for k in keys],
            self.cfg,
            np.stack([s.alive for _, s in occupied]),
            weights=np.stack([s.weights for _, s in occupied]),
            rotate=rots)

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
