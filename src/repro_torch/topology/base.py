"""Ring topologies — the shape of a SAFE chain.

The port's copy of the JAX package's ``topology/base.py``: one flat ring
or g subgroup rings over n learners (pods: ``hierarchy.py``). All of it
is host arithmetic on Python ints and numpy: the alive bitmap and the
rotation are host data, so initiator election runs on the host before
any kernel launches.

Ranks are 0-based and contiguous: group g owns ranks [g·m, (g+1)·m) where
m = group_size.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: minimum learners per ring for the paper's privacy argument (§5.3/§5.5):
#: with 2, each member recovers the other's value by subtracting its own.
MIN_PRIVACY_GROUP = 3


def elect_initiator_local(group_alive, rotate) -> int:
    """Local index of the elected initiator on one subgroup ring: the
    first alive local index scanning cyclically from the rotation offset
    (§5.4 re-election + §8 round-order randomization). With no member
    alive it is the rotation offset itself.

    Args:
      group_alive: float/bool[m] liveness of this ring's members.
      rotate: int — per-round rotation offset (taken mod m).
    """
    group_alive = np.asarray(group_alive)
    m = group_alive.shape[-1]
    rot = int(rotate) % m
    rolled = np.roll(group_alive, -rot)
    return (int(np.argmax(rolled > 0)) + rot) % m


@dataclasses.dataclass(frozen=True)
class RingTopology:
    """g disjoint rings over one learner axis (g = 1 is the flat chain).

    Attributes:
      num_learners: chain length n.
      subgroups: number of parallel rings g (paper §5.5). Must divide
        num_learners.
    """

    num_learners: int
    subgroups: int = 1

    def __post_init__(self) -> None:
        if self.subgroups < 1 or self.num_learners % self.subgroups != 0:
            raise ValueError(
                f"subgroups ({self.subgroups}) must divide num_learners "
                f"({self.num_learners})")

    # ---- structure -------------------------------------------------------
    @property
    def group_size(self) -> int:
        return self.num_learners // self.subgroups

    def validate_privacy(self) -> None:
        """Raise unless every ring meets the >= 3-member privacy bound."""
        if self.group_size < MIN_PRIVACY_GROUP:
            raise ValueError(
                f"each ring needs >= {MIN_PRIVACY_GROUP} members for the "
                f"privacy guarantee (got group_size={self.group_size}; "
                "paper §5.3/§5.5)")

    # ---- per-rank ring geometry -----------------------------------------
    def group_of(self, rank):
        return rank // self.group_size

    def group_start(self, rank):
        m = self.group_size
        return (rank // m) * m

    def local_index(self, rank):
        return rank % self.group_size

    def successor(self, rank):
        """Next rank on this rank's ring (the node it posts aggregates to)."""
        m = self.group_size
        g0 = self.group_start(rank)
        return g0 + (rank - g0 + 1) % m

    def predecessor(self, rank):
        m = self.group_size
        g0 = self.group_start(rank)
        return g0 + (rank - g0 + m - 1) % m

    def neighbors(self, rank):
        """(predecessor, successor) on this rank's ring."""
        return self.predecessor(rank), self.successor(rank)

    # ---- whole-topology views -------------------------------------------
    def ring_permutation(self) -> List[Tuple[int, int]]:
        """(src, dst) pairs for a +1 shift along every ring."""
        return [(r, self.successor(r)) for r in range(self.num_learners)]

    def successor_map(self) -> np.ndarray:
        """int32[n] — successor_map[r] is r's ring successor."""
        return np.array([self.successor(r) for r in range(self.num_learners)],
                        np.int32)

    def group_chains(self, node_base: int = 0) -> Dict[int, List[int]]:
        """Chain (ring) order per group, as node ids offset by
        ``node_base``."""
        m = self.group_size
        return {
            g: [g * m + i + node_base for i in range(m)]
            for g in range(self.subgroups)
        }

    # ---- liveness / election --------------------------------------------
    def group_alive(self, alive, group: int):
        """Slice of the full alive bitmap covering ``group``."""
        m = self.group_size
        return alive[group * m:(group + 1) * m]

    def elect_initiators(self, alive: Optional[Sequence] = None,
                         rotate: int = 0) -> List[int]:
        """Elected initiator *rank* of every group."""
        if alive is None:
            alive = np.ones((self.num_learners,), np.float32)
        alive = np.asarray(alive, np.float32)
        return [g * self.group_size
                + elect_initiator_local(self.group_alive(alive, g), rotate)
                for g in range(self.subgroups)]

    def hop_order(self, alive, rotate: int, group: int) -> List[int]:
        """Ranks of ``group`` in the order a round visits them: the elected
        initiator first, then each later local index cyclically. Dead ranks
        keep their place: they forward and re-pad without contributing."""
        m = self.group_size
        g0 = group * m
        init = elect_initiator_local(self.group_alive(alive, group), rotate)
        return [g0 + (init + t) % m for t in range(m)]

    def compact(self, alive: Optional[Sequence] = None,
                node_base: int = 0) -> Dict[int, List[int]]:
        """Alive-bitmap compaction: per-group chain order with dead
        members removed (§5.3)."""
        if alive is None:
            alive = np.ones((self.num_learners,), np.float32)
        alive = np.asarray(alive, np.float32)
        chains = {}
        for g, chain in self.group_chains(node_base).items():
            chains[g] = [node for node in chain
                         if alive[node - node_base] > 0]
        return chains


def make_topology(num_learners: int, subgroups: int = 1,
                  pods: int = 1) -> "RingTopology":
    """Factory: flat chain, subgroup rings, or hierarchical pods.

    Returns a RingTopology for pods == 1, else a HierarchicalTopology
    (``num_learners`` per pod; imported here, as hierarchy imports base).
    """
    if pods <= 1:
        return RingTopology(num_learners, subgroups)
    from repro_torch.topology.hierarchy import HierarchicalTopology
    return HierarchicalTopology(pods, RingTopology(num_learners, subgroups))
