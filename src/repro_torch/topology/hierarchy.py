"""Hierarchical federation topology (paper §5.10).

The port's copy of the JAX package's ``topology/hierarchy.py``.
``HierarchicalTopology`` = P identical pods, each running its own
RingTopology (intra-pod chains + subgroup rings), with the pod level a
plain average of pod results: child controllers post their anonymized
group averages to the parent, which never needs encryption because every
posted value is already a mean over >= 3 learners.

Device plane: the JAX package puts the pods on a second mesh axis
(``cfg.pod_axis``) and takes a ``pmean`` over it; the port runs the pods
as dim 0 of a pod-major [P, n, V] tensor, each pod on ``self.pod``'s ring
geometry, and means their published results (``core.chain.pod_mean``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.topology.base import RingTopology


@dataclasses.dataclass(frozen=True)
class HierarchicalTopology:
    """P pods × one RingTopology per pod.

    Global rank layout is pod-major: global rank = pod * n + local rank,
    matching a ("pod", "data") mesh flattened in C order and the port's
    [P, n, V] values.
    """

    pods: int
    pod: RingTopology

    def __post_init__(self) -> None:
        if self.pods < 1:
            raise ValueError("pods must be >= 1")

    @property
    def num_learners(self) -> int:
        """Total learners across all pods."""
        return self.pods * self.pod.num_learners

    @property
    def subgroups(self) -> int:
        return self.pod.subgroups

    @property
    def group_size(self) -> int:
        return self.pod.group_size

    def validate_privacy(self) -> None:
        self.pod.validate_privacy()

    # ---- global-rank geometry (delegates to the pod ring) ----------------
    def pod_of(self, rank):
        return rank // self.pod.num_learners

    def pod_local(self, rank):
        return rank % self.pod.num_learners

    def successor(self, rank):
        base = self.pod_of(rank) * self.pod.num_learners
        return base + self.pod.successor(self.pod_local(rank))

    def predecessor(self, rank):
        base = self.pod_of(rank) * self.pod.num_learners
        return base + self.pod.predecessor(self.pod_local(rank))

    def successor_map(self) -> np.ndarray:
        return np.array([self.successor(r) for r in range(self.num_learners)],
                        np.int32)

    def group_chains(self, node_base: int = 0) -> Dict[int, Dict[int, List[int]]]:
        """{pod: {group: [node ids]}} — per-pod chain orders. Node ids are
        global (pod-major) plus ``node_base``."""
        n = self.pod.num_learners
        return {
            p: {
                g: [p * n + node for node in chain]
                for g, chain in self.pod.group_chains(node_base).items()
            }
            for p in range(self.pods)
        }

    def elect_initiators(self, alive: Optional[Sequence] = None,
                         rotate: int = 0) -> Dict[int, List[int]]:
        """{pod: [initiator global rank per group]}."""
        n = self.pod.num_learners
        if alive is None:
            alive = np.ones((self.num_learners,), np.float32)
        alive = np.asarray(alive, np.float32)
        return {
            p: [p * n + r
                for r in self.pod.elect_initiators(alive[p * n:(p + 1) * n],
                                                   rotate)]
            for p in range(self.pods)
        }
