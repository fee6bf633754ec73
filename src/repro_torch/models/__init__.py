"""Model zoo of the PyTorch port over the copied configurations: the
decoder substrate (attention kinds global, local and chunked), the MoE
MLP, the Mamba2 and RWKV6 token mixers and zamba2's shared attention
block — every block kind of the reference, on the train and prefill path."""
from repro_torch.models.config import ModelConfig, MoEConfig, reduced
from repro_torch.models.transformer import Model

__all__ = ["ModelConfig", "MoEConfig", "reduced", "Model"]
