"""Three SAFE-secured training steps of the plain decoder, in float32.

Each learner's gradient (the mean loss over its sequences, one sequence
at a time) is encoded in fixed point, summed over the learners mod 2^32
and decoded to the mean, as a SAFE round publishes it
(``fixedpoint.py``); AdamW then updates the float32 parameters in the
program's order of operations:
    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
    u = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd p
    p = p - lr u
The readings are what the benchmark compares: each step's mean loss over
the learners, each leaf's norm of the first step's published gradient,
and each leaf's norm of the parameters' change after the last step.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from perfbench.reference.decoder import Matmul, sequence_loss


def train_steps(weights: Dict[str, torch.Tensor], batches: Sequence[torch.Tensor], cfg: dict,
                opt: dict, lr: float, scale_bits: int = 16, mm: Matmul = torch.matmul,
                learners: Optional[List[int]] = None, alter: bool = False,
                loss: Callable = sequence_loss) -> dict:
    """``weights``: the initial parameters by path (any float dtype);
    ``batches``: int[n, B, S] tokens a step; ``loss``: a sequence's loss
    (``loss(params, tokens, cfg, mm)``, the model's reference's
    ``sequence_loss``); ``learners``: whose gradients
    enter the mean (all by default); ``alter``: add 1 to the first word of
    the published gradient (the first leaf in path order), a fault. Returns {"losses": [..],
    "grad_norms": {path: norm}, "change_norms": {path: norm}}."""
    params = {k: w.detach().float().clone().requires_grad_(True) for k, w in weights.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    scale = float(2 ** scale_bits)
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    losses, grad_norms = [], {}
    for t, tokens in enumerate(batches, start=1):
        n, B = tokens.shape[0], tokens.shape[1]
        used = list(range(n)) if learners is None else list(learners)
        acc = {k: torch.zeros(p.shape, dtype=torch.int64, device=p.device)
               for k, p in params.items()}
        step_losses = []
        for l in used:
            total = 0.0
            for b in range(B):
                part = loss(params, tokens[l, b], cfg, mm) / B
                part.backward()
                total += float(part.detach())
            step_losses.append(total)
            with torch.no_grad():
                for k, p in params.items():
                    acc[k] += torch.round(p.grad * scale).to(torch.int64)
                    p.grad = None
        losses.append(sum(step_losses) / len(step_losses))
        count = torch.full((), float(len(used)), dtype=torch.float32)
        with torch.no_grad():
            bc1 = 1.0 - b1 ** t
            bc2 = 1.0 - b2 ** t
            for k, p in params.items():
                total = ((acc[k] + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)
                g = total.to(torch.float32) / scale / count.to(p.device)
                del acc[k]
                if alter and k == min(params):
                    g.view(-1)[0] += 1.0
                if t == 1:
                    grad_norms[k] = float(torch.linalg.vector_norm(g.double()))
                m[k].mul_(b1).add_(g * (1 - b1))
                v[k].mul_(b2).add_(g.square() * (1 - b2))
                u = (m[k] / bc1) / ((v[k] / bc2).sqrt() + eps)
                p.sub_((u + wd * p) * lr)
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm((p - weights[k].float()).double()))
                  for k, p in params.items()}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def gaps(program: dict, reference: dict, rel_floor: float = 1e-3) -> dict:
    """The numbers compared: ``loss_gap``, the worst step's |loss - ref| /
    |ref|; ``grad_gap``, the worst leaf's |norm - ref norm| over the larger
    of the leaf's reference norm and the median leaf's; ``change_gap`` the
    same of the parameters' change, over the leaves whose reference
    gradient is at least ``rel_floor`` of the median leaf's (a leaf whose
    gradient is nought to rounding moves under Adam by round-off alone)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(program["losses"], reference["losses"]))

    def worst(key, keep):
        ref = reference[key]
        med = sorted(ref.values())[len(ref) // 2]
        return max(abs(program[key][k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep)

    gref = reference["grad_norms"]
    gmed = sorted(gref.values())[len(gref) // 2]
    moved = [k for k, g in gref.items() if g >= rel_floor * gmed]
    return {"loss_gap": loss, "grad_gap": worst("grad_norms", list(gref)),
            "change_gap": worst("change_norms", moved)}


def leaf_gaps(program: dict, reference: dict, key: str) -> dict:
    """Each leaf's gap of ``key`` ("grad_norms" or "change_norms"), as
    ``gaps`` measures the worst of them: where a number reads high, which
    leaf sets it."""
    ref = reference[key]
    med = sorted(ref.values())[len(ref) // 2]
    return {k: abs(program[key][k] - ref[k]) / max(ref[k], med, 1e-30) for k in ref}
