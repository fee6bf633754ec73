"""Next-token cross-entropy over the zoo's output conventions (the
counterpart of the JAX package's ``train/loss.py``), its
vocabulary-parallel form over a model group, and the parameters'
gradients."""
from __future__ import annotations

import torch

from repro_torch.dist import collectives


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


class _VocabParallelNLL(torch.autograd.Function):
    """The mean next-token NLL from this rank's vocabulary shard (see
    ``vocab_parallel_loss``). Forward: the shard's max, ``pmax``'d; the
    shard's Σ exp(l − max), ``psum``'d; lse = max + log Σ; the target's
    logit from the rank that holds it (a masked pick, ``psum``'d);
    nll = −(l_t − lse) over the positions [prefix_len, S − 1), and their
    mean. Backward, on the shard alone (the cotangent of the head's input
    crosses the ranks in ``copy_to_model``'s backward): with s = −g/N, each
    word's −exp(l − lse)·s and the target's s − exp(l_t − lse)·s, zero at
    the positions that carry no loss. These are ``log_softmax``'s and its
    backward's operations in their order, so a row whose Σ the shards'
    partial sums give to the last bit is the one-card loss's, bit for
    bit."""

    @staticmethod
    def forward(ctx, logits, targets, v0, prefix_len, world):
        V = logits.shape[-1]
        if V:
            local_max = logits.amax(-1)
        else:  # a rank that holds no word
            local_max = logits.new_full(logits.shape[:-1], float("-inf"))
        mx = collectives.pmax(local_max, world)
        total = collectives.psum(torch.sub(logits, mx[..., None]).exp_().sum(-1), world)
        lse = mx + torch.log(total)
        used = slice(prefix_len, logits.shape[1] - 1)
        local = targets - v0
        inside = (local >= 0) & (local < V)
        local = local.clamp(0, max(V - 1, 0))
        picked = (torch.gather(logits[:, used], -1, local[..., None])[..., 0] if V
                  else torch.zeros_like(mx[:, used]))
        target = collectives.psum(torch.where(inside, picked, 0), world)
        nll = -(target - lse[:, used])
        ctx.save_for_backward(logits, lse, local, inside)
        ctx.used, ctx.n = used, nll.numel()
        return nll.mean()

    @staticmethod
    def backward(ctx, g):
        logits, lse, local, inside = ctx.saved_tensors
        s = -(g / ctx.n)
        p = torch.sub(logits, lse[..., None]).exp_()
        grad = p.mul_(-s)
        if grad.shape[-1]:
            used = grad[:, ctx.used]
            p_t = torch.exp(torch.gather(logits[:, ctx.used], -1, local[..., None])
                            - lse[:, ctx.used][..., None])
            at = torch.where(inside[..., None], s - p_t * s,
                             torch.gather(used, -1, local[..., None]))
            used.scatter_(-1, local[..., None], at)
        grad[:, :ctx.used.start] = 0
        grad[:, ctx.used.stop:] = 0
        return grad, None, None, None, None


def vocab_parallel_loss(logits: torch.Tensor, tokens: torch.Tensor, v0: int, world,
                        prefix_len: int = 0) -> torch.Tensor:
    """``next_token_loss`` of logits split over ``world``'s ranks by
    vocabulary, from this rank's shard alone: ``logits`` f32 [B, S(+P),
    V_j] or [B, S(+P), nc, V_j], the logits of words [v0, v0 + V_j) (after
    any softcap); ``tokens`` as ``next_token_loss`` takes them. Every rank
    of ``world`` gets the same bits (``pmax`` and ``psum`` are an
    all-gather and a reduction in rank order); the gradient lands on this
    rank's shard only. Off the one-card loss by the sum's order over the
    shards (tests/test_torch_vocab_parallel.py)."""
    targets = tokens[:, 1:].long()
    return _VocabParallelNLL.apply(logits, targets, int(v0), int(prefix_len), world)


def param_grads(loss: torch.Tensor, params: list) -> list:
    """d loss / d each of ``params``, a zero tensor for a leaf the loss does
    not use (the shared block's placeholder), as ``jax.grad`` gives."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
