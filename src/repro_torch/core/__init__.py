"""SAFE secure aggregation core of the PyTorch port.

``chain`` (SAFE/SAF: sequential, pipelined and S-session batched), ``bon``
(the Bonawitz baseline) and ``insec`` (plain mean), behind
``aggregators.SecureAggregator``; ``session`` holds the engine's
per-tenant state.
"""
from repro_torch.core.aggregators import (SecureAggregator, make_aggregator,
                                          make_round_keys)
from repro_torch.core.bon import bon_aggregate
from repro_torch.core.chain import (chain_aggregate_batched,
                                    chain_aggregate_pipelined,
                                    chain_aggregate_sequential, pod_mean)
from repro_torch.core.insec import insec_aggregate
from repro_torch.core.session import AggSession, RoundCursor, seed_words
from repro_torch.core.types import ChainConfig, RoundKeys

__all__ = [
    "ChainConfig",
    "RoundKeys",
    "SecureAggregator",
    "make_aggregator",
    "make_round_keys",
    "chain_aggregate_sequential",
    "chain_aggregate_pipelined",
    "chain_aggregate_batched",
    "bon_aggregate",
    "pod_mean",
    "insec_aggregate",
    "AggSession",
    "RoundCursor",
    "seed_words",
]
