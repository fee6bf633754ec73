"""Learning-rate schedules (the counterpart of the JAX package's
``optim/schedules.py``): functions of the step, an integer tensor, that
return an f32 0-d tensor."""
from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.1):
    def lr(step):
        s = torch.as_tensor(step).float()
        t = torch.clamp(s / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return base_lr * (final_frac + (1 - final_frac) * cos)
    return lr


def linear_warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1), final_frac)

    def lr(step):
        step = torch.as_tensor(step)
        s = step.float()
        warm = base_lr * s / max(warmup_steps, 1)
        return torch.where(s < warmup_steps, warm, cos(step - warmup_steps))
    return lr
