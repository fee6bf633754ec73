"""Model zoo of the PyTorch port: the dense decoder substrate (attention
kinds global, local and chunked) over the copied configurations."""
from repro_torch.models.config import ModelConfig, MoEConfig, reduced
from repro_torch.models.transformer import Model

__all__ = ["ModelConfig", "MoEConfig", "reduced", "Model"]
