"""SAFE secure aggregation, ported to PyTorch and CUDA for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package sits beside it
with the same subpackage and module names and imports nothing of it, nor
JAX. The learners of a round are dim 0 of a learner-major [n, V] tensor
on one card, and the masking arithmetic runs in hand-written CUDA
kernels (``kernels``, sources in ``csrc``) whose plain PyTorch versions
serve CPU tensors.

Entry points: ``core.make_aggregator`` / ``core.SecureAggregator`` (one
round) and ``serve.AggregationEngine`` (many sessions per step). Both run
on the card unless given ``device="cpu"``.
"""
