"""Configuration types for the SAFE aggregation core of the PyTorch port."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.crypto.fixedpoint import DEFAULT_SCALE_BITS
from repro_torch.topology import RingTopology


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    """Static configuration of a secure-aggregation chain.

    The same fields as the JAX package's ``ChainConfig``, so a
    configuration carries across unchanged (``repro_torch.convert``).

    Attributes:
      axis: name of the learner axis. There is no mesh in the port: the
        learners are dim 0 of a learner-major [n, V] tensor.
      num_learners: chain length n.
      scale_bits: fixed-point fractional bits for the ring encoding.
      mode: 'safe'  — chain with hop pads + initiator mask (paper SAFE);
            'saf'   — chain with initiator mask only (paper SAF);
            'insec' — plain mean of raw values (paper INSEC baseline);
            'bon'   — pairwise-mask baseline (Bonawitz et al. CCS'17).
      pipelined: False — the paper's sequential whole-vector chain;
            True — the rotated-initiator segment pipeline (saf/safe).
      subgroups: number of parallel chains g (paper §5.5). Must divide
        num_learners; each subgroup needs >= 3 members.
      weighted: carry a per-learner weight through the aggregate so the
        published value is the weighted mean (paper §5.6).
      pod_axis: hierarchical federation (§5.10): when set, the values are
        pod-major [P, n, V] and the published value is the mean over pods
        of each pod's. Its name is kept for the reference; there is no
        mesh axis.
      unroll: hop-loop unrolling in the JAX package's HLO; the port runs
        its hops eagerly and ignores it.
    """

    axis: str = "data"
    num_learners: int = 16
    scale_bits: int = DEFAULT_SCALE_BITS
    mode: str = "safe"
    pipelined: bool = False
    subgroups: int = 1
    weighted: bool = False
    pod_axis: Optional[str] = None
    unroll: bool = True

    def __post_init__(self) -> None:
        if self.mode not in ("safe", "saf", "insec", "bon"):
            raise ValueError(f"unknown mode {self.mode!r}")
        topo = RingTopology(self.num_learners, self.subgroups)
        if self.mode in ("safe", "saf"):
            topo.validate_privacy()

    @property
    def topology(self) -> RingTopology:
        return RingTopology(self.num_learners, self.subgroups)

    @property
    def group_size(self) -> int:
        return self.num_learners // self.subgroups


@dataclasses.dataclass(frozen=True)
class RoundKeys:
    """One round's key material, host-side numpy.

    provisioning_seed: uint32[2] derived provisioning key; the hop pair
      keys are derived from it (models the out-of-band Round-0 exchange).
    learner_seed: uint32[n, 2] per-learner private seeds, row r for rank r
      (the initiator mask R is a keystream from the initiator's row).
    counter_base: first fresh counter word of this round (host-allocated
      through ``crypto.prf.RoundCounter`` so pads are never reused).
    """

    provisioning_seed: np.ndarray
    learner_seed: np.ndarray
    counter_base: int
