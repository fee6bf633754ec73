"""Serving layer of the PyTorch port: the multi-session aggregation engine."""
from repro_torch.serve.agg_engine import AggregationEngine

__all__ = ["AggregationEngine"]
