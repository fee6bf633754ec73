"""Next-token cross-entropy over the zoo's output conventions (the
counterpart of the JAX package's ``train/loss.py``), and the parameters' gradients."""
from __future__ import annotations

import torch


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    prefix_len: int = 0) -> torch.Tensor:
    """Mean next-token CE.

    logits: [B, S(+P), V] or [B, S(+P), nc, V] (multi-codebook);
    tokens:  [B, S] or [B, S, nc]. ``prefix_len`` positions at the front
    of the logits (modality-frontend embeddings) carry no loss.
    """
    if prefix_len:
        logits = logits[:, prefix_len:]
    # predict token t+1 from position t
    logits = logits[:, :-1]
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return torch.mean(nll)


def param_grads(loss: torch.Tensor, params: list) -> list:
    """d loss / d each of ``params``, a zero tensor for a leaf the loss does
    not use (the shared block's placeholder), as ``jax.grad`` gives."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
