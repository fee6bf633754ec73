"""AdamW — tree form (``AdamW``) and flat form (``FlatAdamW``), the
counterparts of the JAX package's two optimizers.

``FlatAdamW`` updates a flat f32 vector: the reference's ZeRO-1 shard
update, which the train step runs on the whole master vector on one card
(the update is elementwise, so the shards' updates side by side are the
whole vector's).

The tree form's update follows the reference's arithmetic and dtypes: m
and v are f32, the clip multiplies the gradients by an f32 scale, and the
new parameter is computed in f32 and cast back to the parameter's dtype.
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


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, as XLA's and CUDA's ``sqrtf`` are.
    PyTorch's vectorised f32 sqrt on the CPU is one ulp off on about 0.6%
    of words; through float64 it is exact."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


@dataclasses.dataclass(frozen=True)
class FlatAdamW:
    """AdamW on a flat f32 vector (elementwise), in the reference's order
    of operations: every product, quotient and sum the reference writes is
    one rounded f32 operation here too, and none is fused (no ``alpha=``,
    no ``addcmul``), and the square root is correctly rounded, so on the
    CPU the result equals the reference's word for word
    (``tests/test_torch_launch.py``).
    The state's ``step`` is a Python int; ``m`` and ``v`` are f32 tensors."""

    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def _lr(self, step: int):
        if callable(self.lr):
            return self.lr(torch.tensor(step, dtype=torch.int32))
        return float(np.float32(self.lr))

    def init(self, nelem: int, device="cuda") -> AdamState:
        z = torch.zeros(int(nelem), dtype=torch.float32, device=device)
        return AdamState(0, z, torch.zeros_like(z))

    @torch.no_grad()
    def update(self, grad: torch.Tensor, state: AdamState, param: torch.Tensor,
               inplace: bool = False):
        """One step on f32 vectors: returns (new_param, new_state).

        With ``inplace`` the new moments and parameter are written into
        ``state.m``, ``state.v`` and ``param`` (which must be f32) and
        returned; the inputs are then spent, as donated buffers are in the
        reference. Without it, nothing given is modified."""
        step = state.step + 1
        g = grad.float()
        b1, b2 = self.b1, self.b2
        m = state.m if inplace else state.m.clone()
        v = state.v if inplace else state.v.clone()
        m.mul_(b1).add_(g * (1 - b1))                  # b1 * m + (1 - b1) * g
        v.mul_(b2).add_(torch.square(g).mul_(1 - b2))  # b2 * v + (1 - b2) * g^2
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))
        u = m / bc1
        u.div_(_sqrt(v / bc2).add_(self.eps))         # (m / bc1) / (sqrt(v / bc2) + eps)
        p = param.float()
        u.add_(self.weight_decay * p)                 # u + weight_decay * p
        u.mul_(self._lr(step))
        new = p.sub_(u) if inplace else p - u         # p - lr * u
        return new, AdamState(step, m, v)
