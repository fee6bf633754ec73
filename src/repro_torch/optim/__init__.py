"""Optimizers and schedules of the PyTorch port (no library optimizer)."""
from repro_torch.optim.adamw import AdamState, AdamW
from repro_torch.optim.schedules import cosine_schedule, linear_warmup_cosine

__all__ = ["AdamState", "AdamW", "cosine_schedule", "linear_warmup_cosine"]
