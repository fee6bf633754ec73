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

    def update(self, grads, state: AdamState, params, gnorm=None):
        """One step: returns (new_params, new_state); the inputs are not
        modified. ``grads`` and ``params`` are trees of one structure.
        ``update_`` on copies of the moments and parameters."""
        return self.update_(grads, AdamState(state.step, copied(state.m), copied(state.v)),
                            copied(params), gnorm)

    @torch.no_grad()
    def update_(self, grads, state: AdamState, params, gnorm=None):
        """One step in place: the new moments and parameters are written into
        ``state.m``, ``state.v`` and ``params`` (contiguous tensors), leaf by
        leaf and ``_CHUNK`` words at a time, so the temporaries are a
        chunk's, not a tree's (the update is elementwise). Returns (params,
        new state). ``gnorm``: the norm the clip reads, where the tree
        holds only part of the gradient (a model rank's shards; the caller
        gives the norm over every rank's), else the tree's own."""
        step = state.step + 1
        scale = None
        if self.grad_clip is not None:
            if gnorm is None:
                gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                       for g in leaves(grads)))
            scale = torch.clamp_max(self.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
        b1, b2 = self.b1, self.b2
        # bias corrections in f32 on the host, as the reference computes
        # them from the f32 step count
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))
        lr = self._lr(step)
        for g, m, v, p in zip(leaves(grads), leaves(state.m), leaves(state.v), leaves(params)):
            g, m, v, p = g.reshape(-1), m.view(-1), v.view(-1), p.view(-1)
            for s in range(0, p.numel(), _CHUNK):
                gc = g[s:s + _CHUNK].float()
                if scale is not None:
                    gc = gc * scale
                mc, vc, pc = m[s:s + _CHUNK], v[s:s + _CHUNK], p[s:s + _CHUNK]
                mc.mul_(b1).add_(gc * (1 - b1))                  # b1 * m + (1 - b1) * g
                vc.mul_(b2).add_(torch.square(gc).mul_(1 - b2))  # b2 * v + (1 - b2) * g^2
                u = _div(mc, bc1) / (torch.sqrt(_div(vc, bc2)) + self.eps)
                if self.weight_decay:  # the reference adds 0 * p when it is 0
                    u = u + self.weight_decay * pc.float()
                pc.copy_(pc.float() - lr * u)  # cast back to the parameter's dtype
        return params, AdamState(step, state.m, state.v)


_CHUNK = 1 << 26  # words a pass of ``AdamW.update_``: 256 MiB of f32 temporaries


def copied(tree):
    """A contiguous copy of every tensor of a tree (``update_`` writes
    through flat views)."""
    return tree_map(lambda t: t.clone(memory_format=torch.contiguous_format), tree)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, correctly rounded on every device. A CUDA tensor divided by a
    Python number is multiplied by the number's rounded reciprocal instead
    (PyTorch's scalar-divisor shortcut), which is one ulp off on some
    words; a divisor that is a 0-d tensor on x's device (made by a fill,
    no copy from the host) takes the true division."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


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
    no ``addcmul``), the quotients are true divisions (``_div``) and the
    square root is correctly rounded, so the result equals the reference's
    word for word: on the CPU (``tests/test_torch_launch.py``) and on the
    card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 5).
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
        u = _div(m, bc1)
        u.div_(_sqrt(_div(v, bc2)).add_(self.eps))    # (m / bc1) / (sqrt(v / bc2) + eps)
        p = param.float()
        u.add_(self.weight_decay * p)                 # u + weight_decay * p
        u.mul_(self._lr(step))
        new = p.sub_(u) if inplace else p - u         # p - lr * u
        return new, AdamState(step, m, v)


# Imported last: ``repro_torch.train``'s package imports this module's
# classes, so ``import repro_torch.optim`` before ``repro_torch.train`` must
# have defined them by the time the cycle comes back here.
from repro_torch.train.flatten import leaves, tree_map  # noqa: E402
