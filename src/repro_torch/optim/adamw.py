"""AdamW, tree form (the counterpart of the JAX package's ``AdamW``).

``FlatAdamW`` (the ZeRO-1 flat-shard form) waits for the train-step
slice (ROADMAP Queue 1 item 6).

The update follows the reference's arithmetic and dtypes: m and v are
f32, the clip multiplies the gradients by an f32 scale, and the new
parameter is computed in f32 and cast back to the parameter's dtype.
One place differs from a plain PyTorch port: in JAX a bf16 gradient
times the strong f32 clip scale is an f32 array, so the moments are
updated from unrounded clipped gradients; in PyTorch a bf16 tensor times
an f32 0-d tensor stays bf16. The clip therefore multiplies ``g.float()``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.train.flatten import leaves, tree_map


class AdamState(NamedTuple):
    step: int
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0

    def _lr(self, step: int):
        if callable(self.lr):
            return self.lr(torch.tensor(step, dtype=torch.int32))
        return float(np.float32(self.lr))

    def init(self, params) -> AdamState:
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        return AdamState(0, zeros, tree_map(torch.clone, zeros))

    @torch.no_grad()
    def update(self, grads, state: AdamState, params):
        """One step: returns (new_params, new_state); the inputs are not
        modified. ``grads`` and ``params`` are trees of one structure."""
        step = state.step + 1
        if self.grad_clip is not None:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in leaves(grads)))
            scale = torch.clamp_max(self.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
            grads = tree_map(lambda g: g.float() * scale, grads)
        b1, b2 = self.b1, self.b2
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(), state.m, grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()),
                     state.v, grads)
        # bias corrections in f32 on the host, as the reference computes
        # them from the f32 step count
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))
        lr = self._lr(step)

        def upd(p, m_, v_):
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + self.eps)
            if self.weight_decay:  # the reference adds 0 * p when it is 0
                u = u + self.weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype)

        new_params = tree_map(upd, params, m, v)
        return new_params, AdamState(step, m, v)
