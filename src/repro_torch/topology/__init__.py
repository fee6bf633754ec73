"""Ring topology layer of the PyTorch port: successor maps, initiator
election and alive-bitmap compaction (flat chain and subgroup rings)."""
from repro_torch.topology.base import (
    MIN_PRIVACY_GROUP,
    RingTopology,
    elect_initiator_local,
    make_topology,
)
from repro_torch.topology.failover import AliveTracker

__all__ = [
    "MIN_PRIVACY_GROUP",
    "RingTopology",
    "AliveTracker",
    "elect_initiator_local",
    "make_topology",
]
