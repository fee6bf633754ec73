"""SAFE across processes: one learner per ``torch.distributed`` rank.

``world`` starts the process group (``init_world``; ``spawn`` for n ranks
on one host) and ``collectives`` holds the counterparts of the JAX
package's ``jax.lax`` collectives over it. The per-rank rounds are
``core.SecureAggregator.aggregate_rank`` and ``aggregate_sharded``; the
per-rank FedAvg round and train step take a ``world`` (or a live mesh).
With model shards (``grid_worlds``, or a ('data', 'model') mesh and
``model_world_of``) a learner's model is split over its model group by
Megatron tensor parallelism (``Model(cfg, tp_world=...)``); ``grid``
gives a rank its pod, ring and model Worlds of the ('pod', 'data',
'model') grid.
Importing this package starts no process group.
"""
from repro_torch.dist import collectives
from repro_torch.dist.world import (TRANSPORTS, Grid, RankPool, World, close_world, grid,
                                   grid_worlds, init_world, model_world_of, pod_world_of,
                                   rank_world, spawn)

__all__ = ["World", "Grid", "TRANSPORTS", "init_world", "close_world", "rank_world",
           "model_world_of", "pod_world_of", "grid", "grid_worlds", "RankPool", "spawn",
           "collectives"]
