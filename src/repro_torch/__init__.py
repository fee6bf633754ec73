"""SAFE secure aggregation, ported to PyTorch and CUDA for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package sits beside it
with the same subpackage and module names and imports nothing of it, nor
JAX. The learners of a round are dim 0 of a learner-major [n, V] tensor
on one card, and the masking arithmetic runs in hand-written CUDA
kernels (``kernels``, sources in ``csrc``) whose plain PyTorch versions
serve CPU tensors.

Entry points:

- ``core.make_aggregator`` / ``core.SecureAggregator`` (one round on the
  device data plane) and ``serve.AggregationEngine`` (many sessions per
  step); both run on the card unless given ``device="cpu"``.
- ``core.protocol.run_safe_round`` (and ``core.bon_protocol.run_bon_round``):
  the message-level protocol as a discrete-event simulation on the host.
- ``net.SafeBroker`` and ``net.run_safe_round_net``: the same protocol
  over TCP, with the reference's wire codec byte for byte. A broker given
  an ``AggregationEngine`` serves networked tenants through that engine,
  on the engine's device. ``net.loadgen`` drives many tenants at once.
- ``train.make_federated_round`` (FedAvg) and ``train.make_train_step``
  (each step's gradient averaged by SAFE, then FlatAdamW), on the card
  unless the model is on the CPU; ``python -m repro_torch.launch.train``
  runs either, with checkpoints (``ckpt``) in the reference's format.
"""
