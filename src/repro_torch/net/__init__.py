"""Wire plane of the PyTorch port: the SAFE control plane over a real
async transport.

The port's copy of the JAX package's ``net``, with the same wire codec
byte for byte, so the port's brokers and learners interoperate with the
reference's. `repro_torch.net` runs the *same* learner state machines
(``core/machines.py``) and the *same* broker semantics
(``core/controller.Controller``) as the discrete-event simulation, but
over actual sockets: a binary wire codec (``wire``), an asyncio broker
server with long-poll scheduling and the §5.3 progress monitor
(``broker``), a learner runtime mapping generator yields onto awaits
(``client``), pluggable transport faults (``faults``), and a
multi-tenant load harness (``loadgen``). ``shard`` scales the broker
out: N worker processes behind one ``SO_REUSEPORT`` port, sessions
consistently hashed to shards by session id (PROTOCOL.md §12).

Host code on numpy by design: these modules launch nothing on a device
and import torch only through the package's ``core`` and ``crypto``, so a
broker or learner runs on a host without a card. The engine plane takes an
already-constructed ``serve.AggregationEngine`` by injection, and that
engine's tensors live on its own device (the card by default).
"""
from repro_torch.net.broker import DEFAULT_CHUNK_BUDGET_BYTES, SafeBroker
from repro_torch.net.client import (
    BonNetResult,
    HierNetResult,
    NetResult,
    PersistentNetSession,
    ShardDeadError,
    WireClient,
    auto_chunk_words,
    backoff_delay,
    drive_learner,
    run_bon_round_net,
    run_federated_round_net,
    run_federated_rounds_net,
    run_hierarchical_round_net,
    run_safe_round_net,
)
from repro_torch.net.faults import (
    WAN_PROFILES,
    Chain,
    ChurnInterceptor,
    DropInterceptor,
    DropPacket,
    HeavyTailLatencyInterceptor,
    Interceptor,
    LatencyInterceptor,
    LearnerCrashed,
    deep_edge_faults,
    make_wan_interceptor,
)
from repro_torch.net.shard import ShardBroker, ShardedBroker, shard_of
from repro_torch.net.loadgen import (
    LoadReport,
    SLOReport,
    run_bon_scale,
    run_engine_load,
    run_hierarchical_scale,
    run_paper_scale,
    run_protocol_load,
    run_shard_failover_load,
    run_slo_load,
)

__all__ = [
    "SafeBroker",
    "DEFAULT_CHUNK_BUDGET_BYTES",
    "auto_chunk_words",
    "backoff_delay",
    "ShardBroker",
    "ShardedBroker",
    "shard_of",
    "WireClient",
    "NetResult",
    "BonNetResult",
    "HierNetResult",
    "ShardDeadError",
    "PersistentNetSession",
    "drive_learner",
    "run_safe_round_net",
    "run_bon_round_net",
    "run_hierarchical_round_net",
    "run_federated_round_net",
    "run_federated_rounds_net",
    "Interceptor",
    "Chain",
    "LatencyInterceptor",
    "DropInterceptor",
    "ChurnInterceptor",
    "HeavyTailLatencyInterceptor",
    "DropPacket",
    "LearnerCrashed",
    "deep_edge_faults",
    "WAN_PROFILES",
    "make_wan_interceptor",
    "LoadReport",
    "SLOReport",
    "run_engine_load",
    "run_protocol_load",
    "run_paper_scale",
    "run_bon_scale",
    "run_hierarchical_scale",
    "run_shard_failover_load",
    "run_slo_load",
]
