"""Training in the PyTorch port: the FedAvg round, its loss and the flat
parameter layout SAFE aggregates."""
from repro_torch.train.federated import (FederatedBundle, apply_delta,
                                         make_federated_round, make_local_update)
from repro_torch.train.flatten import (flat_to_tree, leaf_paths, tree_size,
                                       tree_to_flat)
from repro_torch.train.loss import next_token_loss

__all__ = [
    "FederatedBundle", "apply_delta", "make_federated_round", "make_local_update",
    "flat_to_tree", "leaf_paths", "tree_size", "tree_to_flat", "next_token_loss",
]
