"""Training in the PyTorch port: the SAFE-aggregated train step (with
expert parallelism for MoE), the FedAvg round in process and its wire
callables, their loss, metrics and the flat parameter layout SAFE
aggregates."""
from repro_torch.train.federated import (FederatedBundle, WireFederated, apply_delta,
                                         make_federated_round, make_local_update,
                                         make_wire_federated)
from repro_torch.train.flatten import (combine_trees, flat_to_tree, is_expert_path,
                                       leaf_paths, partition_tree, tree_size,
                                       tree_to_flat)
from repro_torch.train.loss import next_token_loss
from repro_torch.train.metrics import MetricsLogger
from repro_torch.train.train_step import TrainStepBundle, make_train_step

__all__ = [
    "make_train_step", "TrainStepBundle", "MetricsLogger",
    "FederatedBundle", "apply_delta", "make_federated_round", "make_local_update",
    "WireFederated", "make_wire_federated",
    "flat_to_tree", "leaf_paths", "tree_size", "tree_to_flat", "next_token_loss",
    "partition_tree", "combine_trees", "is_expert_path",
]
