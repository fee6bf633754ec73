"""Data pipeline of the PyTorch port: synthetic federated token streams
(numpy; the same batches as the JAX package's for the same seed)."""
from repro_torch.data.synthetic import (FederatedTokenStream, SyntheticMixture,
                                        make_federated_batches)

__all__ = ["FederatedTokenStream", "SyntheticMixture", "make_federated_batches"]
