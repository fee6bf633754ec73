"""Aggregation sessions — per-tenant state for the multi-session engine.

The port's copy of the JAX package's ``core/session.py``. One
:class:`AggSession` is one tenant's aggregation stream: its own key
material, its own monotone counter space (pads are never reused across
that session's rounds), its own alive bitmap / weights, and its own
initiator-rotation schedule (§8). Round r of a session uses
counter_base = r * words_per_round and rotate = rotate0 + r, exactly what
``SecureAggregator`` + ``RoundCounter`` give a standalone loop — which is
what makes the engine's batched output bit-identical to S independent
runs.

The one change from the reference: a session's ``values`` and
``results`` are torch tensors, kept on the engine's device between rounds.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.crypto.prf import RoundCounter


class RoundCursor:
    """Per-round counter-base bookkeeping for persistent multi-round
    sessions: round r's pads start at a fresh base, so key material
    survives R rounds with no pad reuse.

    ``words_per_round`` is the vector length the pads cover (payload
    words, +1 when weighted). Reservation delegates to
    :class:`~repro_torch.crypto.prf.RoundCounter`, inheriting its
    pre-mutation uint32 overflow guard: when the counter space runs out
    the session must rotate keys (Round 0 again), never silently wrap.
    """

    def __init__(self, words_per_round: int, counter0: int = 0):
        if words_per_round < 1:
            raise ValueError(
                f"words_per_round must be >= 1, got {words_per_round}")
        self.words_per_round = int(words_per_round)
        self._rc = RoundCounter()
        if counter0:
            self._rc.reserve(int(counter0))  # externally consumed space

    @property
    def rounds_remaining(self) -> int:
        """Rounds still reservable before a Round-0 key rotation is due."""
        return self._rc.remaining // self.words_per_round

    def next_round(self) -> int:
        """Reserve and return the next round's counter base."""
        return self._rc.reserve(self.words_per_round)


def seed_words(seed: int) -> np.ndarray:
    """uint32[2] little-endian words of a 64-bit seed — the exact host
    conversion ``make_round_keys`` applies before key derivation."""
    return np.array([seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF], np.uint32)


@dataclasses.dataclass
class AggSession:
    """One tenant's aggregation stream (host control-plane state).

    Attributes:
      sid: engine-assigned session id.
      values: f32[n, V] tensor — the learner-major contribution matrix for
        the next round (re-read each round, so a trainer can update it
        between rounds).
      provisioning_seed / learner_master: this session's Round-0 key
        material (independent per tenant).
      rounds: how many aggregation rounds the session requests.
      alive: f32[n] liveness bitmap (None = all alive).
      weights: f32[n] per-learner weights (only read by weighted configs).
      rotate0: initiator rotation of round 0; round r uses rotate0 + r.
    """

    sid: int
    values: torch.Tensor
    provisioning_seed: int = 0xC0FFEE
    learner_master: int = 0x5EED
    rounds: int = 1
    alive: Optional[np.ndarray] = None
    weights: Optional[np.ndarray] = None
    rotate0: int = 0

    def __post_init__(self) -> None:
        self.values = torch.as_tensor(self.values, dtype=torch.float32)
        if self.alive is None:
            self.alive = np.ones((self.values.shape[0],), np.float32)
        self.alive = np.asarray(self.alive, np.float32)
        if self.weights is None:
            self.weights = np.ones((self.values.shape[0],), np.float32)
        self.weights = np.asarray(self.weights, np.float32)
        self.results: List[torch.Tensor] = []
        self.rounds_done: int = 0
        self._counters = RoundCounter()

    # ---- engine interface ------------------------------------------------
    @property
    def done(self) -> bool:
        return self.rounds_done >= self.rounds

    @property
    def rotate(self) -> int:
        """Initiator rotation for the upcoming round (§8)."""
        return self.rotate0 + self.rounds_done

    def reserve_counter(self, nwords: int) -> int:
        """Fresh counter base for the upcoming round (no pad reuse)."""
        return self._counters.reserve(nwords)

    def record_result(self, published: torch.Tensor) -> None:
        self.results.append(published)
        self.rounds_done += 1

    def key_words(self) -> tuple[np.ndarray, np.ndarray]:
        """(provisioning, master) uint32[2] word pairs."""
        return seed_words(self.provisioning_seed), seed_words(self.learner_master)
