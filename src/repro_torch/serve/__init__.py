"""Serving layer of the PyTorch port: the prefill/decode engine, the
multi-session aggregation engine, and that engine one learner a rank
behind one broker (``EngineLead`` on rank 0, ``follow`` on the others)."""
from repro_torch.serve.agg_engine import AggregationEngine
from repro_torch.serve.engine import Request, ServeEngine, make_serve_step
from repro_torch.serve.rank_engine import EngineLead, follow

__all__ = ["ServeEngine", "Request", "make_serve_step", "AggregationEngine", "EngineLead",
           "follow"]
