"""Ring topology layer of the PyTorch port: successor maps, initiator
election and alive-bitmap compaction (flat chain, subgroup rings and
hierarchical pods)."""
from repro_torch.topology.base import (
    MIN_PRIVACY_GROUP,
    RingTopology,
    elect_initiator_local,
    make_topology,
)
from repro_torch.topology.failover import AliveTracker
from repro_torch.topology.hierarchy import HierarchicalTopology

__all__ = [
    "MIN_PRIVACY_GROUP",
    "RingTopology",
    "AliveTracker",
    "HierarchicalTopology",
    "elect_initiator_local",
    "make_topology",
]
