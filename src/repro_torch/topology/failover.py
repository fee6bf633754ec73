"""Host control-plane liveness: the alive bitmap the data plane consumes.

The port's copy of the JAX package's ``topology/failover.py``. Between
aggregation rounds the host decides which learners participate and hands
the round an f32[n] bitmap: dead ranks forward and re-pad without
contributing, and the published mean divides by popcount(alive) (§5.3).
Across rounds this tracker keeps those verdicts, so the next round's
chain is compacted up front.

``report_failure`` / ``report_recovery`` are the integration points. A
learner is also declared dead after ``max_strikes`` consecutive missed
heartbeats (``tick`` advances the clock).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.topology.base import MIN_PRIVACY_GROUP, RingTopology


@dataclasses.dataclass
class AliveTracker:
    """Per-learner liveness with strike-based failure declaration.

    Attributes:
      topology: ring geometry (for compaction and privacy checks).
      max_strikes: consecutive missed heartbeats before a rank is
        declared dead (1 = declare on first report).
    """

    topology: RingTopology
    max_strikes: int = 1

    def __post_init__(self) -> None:
        n = self.topology.num_learners
        self._strikes = np.zeros((n,), np.int32)
        self._dead = np.zeros((n,), bool)

    # ---- verdict inputs --------------------------------------------------
    def report_failure(self, rank: int) -> None:
        """One missed heartbeat / failed posting for ``rank``."""
        self._strikes[rank] += 1
        if self._strikes[rank] >= self.max_strikes:
            self._dead[rank] = True

    def report_recovery(self, rank: int) -> None:
        """Rank rejoined (the paper's nodes re-register between rounds)."""
        self._strikes[rank] = 0
        self._dead[rank] = False

    def tick(self, heartbeats: Optional[np.ndarray] = None) -> None:
        """Advance one monitoring interval. ``heartbeats`` is bool[n]
        (True = seen this interval); absent ranks accrue a strike."""
        if heartbeats is None:
            return
        hb = np.asarray(heartbeats, bool)
        self._strikes[hb] = 0
        self._dead[hb] = False
        for r in np.nonzero(~hb)[0]:
            self.report_failure(int(r))

    # ---- data-plane outputs ---------------------------------------------
    def alive(self) -> np.ndarray:
        """f32[n] bitmap for the device plane (replicated across ranks)."""
        return (~self._dead).astype(np.float32)

    def survivors(self) -> int:
        return int((~self._dead).sum())

    def compact_chains(self, node_base: int = 0) -> Dict[int, List[int]]:
        """Per-group chain order with dead ranks removed (§5.3)."""
        return self.topology.compact(self.alive(), node_base)

    def elect_initiators(self, rotate: int = 0) -> List[int]:
        """Initiator rank per group for the next round (§5.4 + §8)."""
        return self.topology.elect_initiators(self.alive(), rotate)

    def degraded_groups(self) -> List[int]:
        """Groups that dropped below the >= 3 alive-member privacy bound —
        the host should merge or pause them rather than run the round."""
        out = []
        alive = self.alive()
        for g in range(self.topology.subgroups):
            if self.topology.group_alive(alive, g).sum() < MIN_PRIVACY_GROUP:
                out.append(g)
        return out
