"""A plain float32 dense GQA decoder (InternLM2's block) and its training
loss, in PyTorch with no kernel of the program.

Per block (pre-norm, residual):
    h = rmsnorm(x) * (1 + ln1);  q, k, v = h Wq, h Wk, h Wv
    q, k = rope(q), rope(k)      (rotate-half, theta from the config)
    a = softmax(q k^T / sqrt(head_dim) + causal mask) v   (each kv head
        read by n_heads / n_kv_heads query heads)
    x = x + a Wo
    h = rmsnorm(x) * (1 + ln2);  x = x + (h Wi * silu(h Wg)) Wo'
then rmsnorm with (1 + final_norm), logits = x H^T with the output head H
(``lm_head``, or the embedding E where ``tie_embeddings``), and the mean
next-token cross-entropy. Embeddings are read as E[token] * sqrt(d_model).
Each departure from the published model is the configuration's
(``configs/internlm2-1.8b.json``: ``departures``).

The parameters are a dict keyed by path as the program stores them
(``blocks/0/attn/wq`` stacked over the layers, and so on; ``layout``
lists them from the configuration's widths). ``matmul`` is
every product's implementation: ``torch.matmul`` in float32 (with TF32
off, which ``no_tf32`` sets) for the reference, or a lower precision for
the control. Each block is recomputed in the backward
(``torch.utils.checkpoint``), so a 4,096-token sequence fits beside the
parameters, gradients and moments.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict

import torch
from torch.utils.checkpoint import checkpoint

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [S, H, hd]; position p rotates pair (i, i + hd/2) by p / theta^(2i/hd)."""
    S, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    a, b = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def block(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: dict, mm: Matmul) -> torch.Tensor:
    """One layer on x [S, d]; ``p`` holds this layer's slices."""
    S = x.shape[0]
    nh, nkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    h = rmsnorm(x, p["ln1"], cfg["norm_eps"])
    q = rope(mm(h, p["wq"]).view(S, nh, hd), cfg["rope_theta"])
    k = rope(mm(h, p["wk"]).view(S, nkv, hd), cfg["rope_theta"])
    v = mm(h, p["wv"]).view(S, nkv, hd)
    g = nh // nkv
    k = k.repeat_interleave(g, dim=1)          # query head i reads kv head i // g
    v = v.repeat_interleave(g, dim=1)
    scores = mm(q.transpose(0, 1), k.permute(1, 2, 0)) / math.sqrt(hd)  # [H, S, S]
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    a = mm(probs, v.transpose(0, 1)).transpose(0, 1).reshape(S, nh * hd)
    x = x + mm(a, p["wo"])
    h = rmsnorm(x, p["ln2"], cfg["norm_eps"])
    return x + mm(mm(h, p["wi"]) * torch.nn.functional.silu(mm(h, p["wg"])), p["mlp_wo"])


def layout(cfg: dict) -> Dict[str, tuple]:
    """Each parameter's path (as the program's decoder stores it, layers
    stacked per leaf), shape, initial scale (the standard deviation of its
    N(0, 1) draw; 0 for the norms' scales, stored as 1 + scale) and dtype.
    Matrices take 1/sqrt(fan_in), the embedding the configuration's
    ``embed_std``, the untied head 1/sqrt(d_model); the final norm's scale
    stays float32, as the program keeps vectors."""
    d, L, ff = cfg["d_model"], cfg["n_layers"], cfg["d_ff"]
    q, kv = cfg["n_heads"] * cfg["head_dim"], cfg["n_kv_heads"] * cfg["head_dim"]
    bf = torch.bfloat16 if cfg["dtype"] == "bfloat16" else torch.float32
    b = "blocks/0/"
    out = {b + "attn/wk": ((L, d, kv), d ** -0.5, bf), b + "attn/wo": ((L, q, d), q ** -0.5, bf),
           b + "attn/wq": ((L, d, q), d ** -0.5, bf), b + "attn/wv": ((L, d, kv), d ** -0.5, bf),
           b + "ln1/scale": ((L, d), 0.0, bf), b + "ln2/scale": ((L, d), 0.0, bf),
           b + "mlp/wg": ((L, d, ff), d ** -0.5, bf), b + "mlp/wi": ((L, d, ff), d ** -0.5, bf),
           b + "mlp/wo": ((L, ff, d), ff ** -0.5, bf),
           "embed": ((cfg["vocab"], d), cfg["init"]["embed_std"], bf),
           "final_norm/scale": ((d,), 0.0, torch.float32)}
    if not cfg["tie_embeddings"]:
        out["lm_head"] = ((cfg["vocab"], d), d ** -0.5, bf)
    return out


def _matmul_params(cfg: dict) -> int:
    """The parameters of the products a token goes through: the blocks'
    projections and the output head (the embedding is a lookup, whether or
    not the head is tied to it)."""
    d, hd = cfg["d_model"], cfg["head_dim"]
    per_layer = d * hd * (2 * cfg["n_heads"] + 2 * cfg["n_kv_heads"]) + 3 * d * cfg["d_ff"]
    return cfg["n_layers"] * per_layer + cfg["vocab"] * d


def train_flops(cfg: dict, learners: int, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 x the matmul parameters x the
    tokens, plus causal attention's score and value products, forward and
    backward (3 x the forward's 2 x 2 x S^2 / 2 x heads x head_dim a
    sequence and layer). The recompute of checkpointed blocks is not
    counted: it is work the program chose, not the model's."""
    tokens = learners * batch * seq
    attention = (3 * 2 * seq * seq * cfg["n_heads"] * cfg["head_dim"] * cfg["n_layers"]
                 * learners * batch)
    return 6.0 * _matmul_params(cfg) * tokens + attention


def forward_flops_dense(cfg: dict, batch: int, seq: int) -> float:
    """A forward's FLOPs with the full S x S score and value products, as
    a FLOP counter of a dense attention counts them: the cross-check of
    ``train_flops``'s parts."""
    return (2.0 * _matmul_params(cfg) * batch * seq
            + 4.0 * seq * seq * cfg["n_heads"] * cfg["head_dim"] * cfg["n_layers"] * batch)


def _layer(params: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    b = "blocks/0/"
    return {"ln1": params[b + "ln1/scale"][i], "ln2": params[b + "ln2/scale"][i],
            "wq": params[b + "attn/wq"][i], "wk": params[b + "attn/wk"][i],
            "wv": params[b + "attn/wv"][i], "wo": params[b + "attn/wo"][i],
            "wi": params[b + "mlp/wi"][i], "wg": params[b + "mlp/wg"][i],
            "mlp_wo": params[b + "mlp/wo"][i]}


def sequence_loss(params: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg: dict,
                  mm: Matmul = torch.matmul) -> torch.Tensor:
    """Mean next-token cross-entropy of one sequence ``tokens`` [S]."""
    E = params["embed"]
    x = E[tokens] * math.sqrt(cfg["d_model"])
    for i in range(cfg["n_layers"]):
        x = checkpoint(block, x, _layer(params, i), cfg, mm, use_reentrant=False)
    x = rmsnorm(x, params["final_norm/scale"], cfg["norm_eps"])
    head = E if cfg["tie_embeddings"] else params["lm_head"]
    logits = mm(x[:-1], head.t())
    return torch.nn.functional.cross_entropy(logits, tokens[1:])
