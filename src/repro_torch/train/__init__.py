"""Training in the PyTorch port: the SAFE-aggregated train step, the
FedAvg round, their loss, metrics and the flat parameter layout SAFE
aggregates."""
from repro_torch.train.federated import (FederatedBundle, apply_delta,
                                         make_federated_round, make_local_update)
from repro_torch.train.flatten import (flat_to_tree, leaf_paths, tree_size,
                                       tree_to_flat)
from repro_torch.train.loss import next_token_loss
from repro_torch.train.metrics import MetricsLogger
from repro_torch.train.train_step import TrainStepBundle, make_train_step

__all__ = [
    "make_train_step", "TrainStepBundle", "MetricsLogger",
    "FederatedBundle", "apply_delta", "make_federated_round", "make_local_update",
    "flat_to_tree", "leaf_paths", "tree_size", "tree_to_flat", "next_token_loss",
]
