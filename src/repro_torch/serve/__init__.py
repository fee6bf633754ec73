"""Serving layer of the PyTorch port: the prefill/decode engine and the
multi-session aggregation engine."""
from repro_torch.serve.agg_engine import AggregationEngine
from repro_torch.serve.engine import Request, ServeEngine, make_serve_step

__all__ = ["ServeEngine", "Request", "make_serve_step", "AggregationEngine"]
